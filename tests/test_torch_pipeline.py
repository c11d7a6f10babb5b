"""The port's aligned-face pipeline against the JAX package's, on the CPU
in f32: restore_face_stream with the per-chunk state reset and the 1-frame
duplication, the aligned process_image / process_image_sequence paths, the
API's device lifecycle and .pth loading, and the image conversions.

The JAX side runs with KEEP_TPU_NO_PHASE512=1, though at this 64-px size
neither package packs (tests/test_torch_phase_pack.py holds the packed
512-level path).
Restored faces are uint8: the two sides agree to 1 level (f32 noise of
~1e-4 can flip a rounding). process_image and process_image_sequence also
run with cv2 unimportable, as on the card machine, against the JAX
processor's cv2 resizes.
"""
import sys

import numpy as np
import pytest
import jax
import torch

from comfyui_keep_tpu.models.gmflow import GMFlow as JGMFlow
from comfyui_keep_tpu.models.keep import KEEP as JKEEP
from comfyui_keep_tpu.pipeline.processor import \
    KEEPFaceProcessor as JProcessor
from comfyui_keep_tpu.utils import image as jimage
from comfyui_keep_torch import api
from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
from comfyui_keep_torch.utils import image as timage
from comfyui_keep_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=())


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models():
    kt = _perturbed(JKEEP.init(jax.random.PRNGKey(0), **TINY), 0)
    gt = _perturbed(JGMFlow.init(jax.random.PRNGKey(1), num_layers=2), 1)
    keep = KEEP(device="cpu", **TINY)
    keep.load_state_dict(params_from_jax(kt, keep))
    gm = GMFlow(num_layers=2, device="cpu")
    gm.load_state_dict(params_from_jax(gt, gm))
    return kt, gt, keep, gm


@pytest.fixture(scope="module")
def procs(models):
    """(JAX processor, port processor) on the same weights; the JAX one
    reads KEEP_TPU_NO_PHASE512 when it is built."""
    kt, gt, keep, gm = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEEP_TPU_NO_PHASE512", "1")
        ref = JProcessor(kt, TINY, gmflow_params=gt)
    return ref, KEEPFaceProcessor(keep, gm, device="cpu")


def _max_level_diff(a, b):
    return np.abs(a.astype(int) - b.astype(int)).max()


def _faces(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def test_restore_face_stream_matches_jax(procs):
    """4 faces in chunks of 3: one 3-frame chunk, then a 1-frame chunk that
    is duplicated and its first output kept."""
    ref_proc, proc = procs
    faces = _faces(4)
    ref = ref_proc.restore_face_stream(faces, max_clip_length=3)
    ours = proc.restore_face_stream(faces, max_clip_length=3)
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert o.dtype == np.uint8 and o.shape == (64, 64, 3)
        assert _max_level_diff(o, r) <= 1


@pytest.mark.parametrize("n_faces", [5, 4])
def test_carried_chunks_stream_matches_jax(procs, n_faces):
    """carry_chunks=True: chunks of 3, the Kalman state and CFA features
    carried across the boundary, whose flow GMFlow takes from the previous
    chunk's last input frame; a 1-frame last chunk (4 faces) is not
    duplicated. The first chunk equals the reset stream's; a later one
    differs from it."""
    ref_proc, proc = procs
    faces = _faces(n_faces, seed=4)
    ref = ref_proc.restore_face_stream(faces, max_clip_length=3,
                                       carry_chunks=True)
    ours = proc.restore_face_stream(faces, max_clip_length=3,
                                    carry_chunks=True)
    assert len(ours) == len(ref) == n_faces
    for o, r in zip(ours, ref):
        assert o.dtype == np.uint8 and o.shape == (64, 64, 3)
        assert _max_level_diff(o, r) <= 1
    reset = proc.restore_face_stream(faces, max_clip_length=3)
    for a, b in zip(ours[:3], reset[:3]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(ours[3:], reset[3:]))


def test_process_image_aligned_matches_jax(procs):
    """Resize to the face size, restore (a duplicated 1-frame chunk), resize
    by the upscale factor (Lanczos, which can spread a 1-level difference
    to 2)."""
    ref_proc, proc = procs
    img = _faces(1, seed=2)[0][:50]
    ref = ref_proc.process_image(img, 1.5, has_aligned=True)
    ours = proc.process_image(img, 1.5, has_aligned=True)
    assert ours.shape == ref.shape == (96, 96, 3)
    assert _max_level_diff(ours, ref) <= 2


def test_process_image_sequence_aligned_matches_jax(procs):
    """Aligned frames come back as the upscaled input frames (the restored
    faces are pasted nowhere, as in the JAX package and the reference)."""
    ref_proc, proc = procs
    frames = _faces(3, seed=3)
    ref = ref_proc.process_image_sequence(frames, 2.0, has_aligned_frames=True)
    ours = proc.process_image_sequence(frames, 2.0, has_aligned_frames=True)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    seen = []
    stream = proc.restore_face_stream
    proc.restore_face_stream = lambda *a, **kw: seen.append(kw) or stream(
        *a, **kw)
    try:
        proc.process_image_sequence(frames, has_aligned_frames=True,
                                    max_clip_length=2, carry_chunks=True)
    finally:
        del proc.restore_face_stream
    assert seen == [{"carry_chunks": True}]
    with pytest.raises(NotImplementedError):
        proc.process_image_sequence(frames, has_aligned_frames=False)
    with pytest.raises(NotImplementedError):
        proc.process_image(frames[0], has_aligned=False)


@pytest.mark.parametrize("shape,factor", [((50, 64), 1.5), ((64, 64), 1.0),
                                          ((64, 64), 2.0), ((40, 40), 1.0)])
def test_process_image_without_opencv_matches_jax(procs, monkeypatch, shape,
                                                   factor):
    """cv2 cannot be imported (as on the card machine): the port's resizes
    (LINEAR to the face size, skipped at 64x64; LANCZOS4 by the factor,
    skipped at 1) against the JAX processor's cv2.resize, at the JAX
    comparison's tolerance."""
    ref_proc, proc = procs
    img = _faces(1, seed=6)[0][:shape[0], :shape[1]]
    ref = ref_proc.process_image(img, factor, has_aligned=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = proc.process_image(img, factor, has_aligned=True)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    assert _max_level_diff(ours, ref) <= 2


@pytest.mark.parametrize("factor", [2.0, 1.0, 1.5])
def test_process_image_sequence_without_opencv_matches_jax(procs, monkeypatch,
                                                           factor):
    """cv2 cannot be imported: the aligned frames (one not at the face
    size) come back resized by the factor, equal to the JAX processor's."""
    ref_proc, proc = procs
    frames = _faces(3, seed=7)
    frames[1] = frames[1][:48, :40]
    ref = ref_proc.process_image_sequence(frames, factor,
                                          has_aligned_frames=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = proc.process_image_sequence(frames, factor,
                                       has_aligned_frames=True)
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)


def test_chunks_reset_state_and_single_frames_duplicate(procs):
    proc = procs[1]
    faces = _faces(4, seed=1)
    stream = proc.restore_face_stream(faces, max_clip_length=3)
    head = proc.restore_face_stream(faces[:3], max_clip_length=3)
    tail = proc.restore_clip(np.stack([timage.bgr_u8_to_rgb_pm1(faces[3])] * 2))
    for a, b in zip(stream[:3], head):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stream[3], timage.rgb_pm1_to_bgr_u8(tail[0]))
    assert proc.restore_face_stream([]) == []


def test_api_pack_lifecycle_and_processor_dtype():
    pack = api.load_models(seed=3, cfg_overrides=TINY)
    assert pack.keep.cfg["img_size"] == 64
    assert next(pack.keep.parameters()).device.type == "cpu"
    pack.load_device(torch.float32, device="cpu")
    proc = pack.processor(device="cpu")
    assert proc.keep is pack.keep and proc.gmflow is pack.gmflow
    assert proc.device.type == "cpu"
    bf = pack.processor(torch.bfloat16, device="cpu")
    assert next(bf.keep.parameters()).dtype == torch.bfloat16
    assert next(pack.keep.parameters()).dtype == torch.float32
    again = api.load_models(seed=3, cfg_overrides=TINY)
    assert again is not pack
    for a, b in zip(pack.keep.state_dict().values(),
                    again.keep.state_dict().values()):
        assert torch.equal(a, b)
    assert pack.offload() is pack


def test_processor_runs_on_the_card_unless_asked_for_the_cpu(models):
    """A processor given models on the host and no device raises; a pack
    that was never given a device is moved to the card by `processor`, and
    so never runs on the CPU silently (where there is no card, the move
    fails)."""
    keep, gm = models[2], models[3]
    with pytest.raises(ValueError, match="not on cuda"):
        KEEPFaceProcessor(keep, gm)
    pack = api.load_models(seed=3, cfg_overrides=TINY)
    if torch.cuda.is_available():
        assert pack.processor().device.type == "cuda"
        assert next(pack.gmflow.parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pack.processor()
        with pytest.raises((AssertionError, RuntimeError)):
            api.restore_sequence(pack, _faces(2), has_aligned_frames=True)


def test_image_conversions_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    np.testing.assert_allclose(timage.bgr_u8_to_rgb_pm1(img),
                               jimage.bgr_u8_to_rgb_pm1(img), atol=1e-6)
    x = rng.uniform(-1.2, 1.2, (7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.rgb_pm1_to_bgr_u8(x),
                                  jimage.rgb_pm1_to_bgr_u8(x))


def test_load_models_from_reference_pth(tmp_path):
    """A reference-layout checkpoint: params_ema preferred, `module.`
    prefix, legacy cross_fuse / fuse_convs_dict names, the flow net under
    flownet.model."""
    keep = KEEP(device="cpu", generator=torch.Generator().manual_seed(4),
                **TINY)
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(5))
    sd = {}
    for k, v in keep.state_dict().items():
        k = k.replace("cfa.", "cross_fuse.").replace("cft.", "fuse_convs_dict.")
        sd["module." + k] = v
    sd.update({"module.flownet.model." + k: v
               for k, v in gm.state_dict().items()})
    path = tmp_path / "keep.pth"
    torch.save({"params": {}, "params_ema": sd}, path)
    pack = api.load_models(keep_ckpt=str(path), cfg_overrides=TINY)
    for mine, theirs in ((pack.keep, keep), (pack.gmflow, gm)):
        want = theirs.state_dict()
        for k, a in mine.state_dict().items():
            assert torch.equal(a, want[k]), k
