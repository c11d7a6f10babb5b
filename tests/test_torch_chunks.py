"""Batched chunk serving in the port against the JAX package, on the CPU in
f32: KEEP.apply_chunks, KEEP's need_upscale, and restore_face_stream's
grouped dispatch in its three forms.

The processors run tests/test_torch_pipeline.py's TINY KEEP and a 2-layer
GMFlow on one set of weights (a JAX tree carried by params_from_jax), at
64x64 with max_clip_length=3 and chunks_per_dispatch=2, so 6, 7 and 10
faces take the grouped path (a group of 2 chunks; 7 adds a duplicated
1-frame tail, 10 a third full chunk and a 1-frame tail that go chunk by
chunk). The JAX processor picks its form from the environment
(KEEP_TPU_BATCH_CHUNKS / KEEP_TPU_STAGE_BATCH /
KEEP_TPU_CHUNKS_PER_DISPATCH), the port's from its keywords. Restored faces
agree within 1 uint8 level, as the stream tests of
tests/test_torch_pipeline.py; KEEP's outputs within its golden tolerances
5e-3 / 1e-2 (tests/test_keep_golden.py:108).
"""
from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models.gmflow import GMFlow as JGMFlow
from comfyui_keep_tpu.models.keep import KEEP as JKEEP
from comfyui_keep_tpu.pipeline.processor import \
    KEEPFaceProcessor as JProcessor
from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
from comfyui_keep_torch.utils.convert import params_from_jax
from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1, rgb_pm1_to_bgr_u8
from tests.test_torch_pipeline import TINY

torch.set_num_threads(2)
KEEP_TOL = dict(atol=5e-3, rtol=1e-2)
# the JAX forwards jitted: op by op they take several times longer on the CPU
japply_chunks = jax.jit(partial(JKEEP.apply_chunks, **TINY))
japply = jax.jit(partial(JKEEP.apply, remat=False, return_aux=True, **TINY),
                 static_argnames=("need_upscale",))
JAX_FORM_ENV = {"map": {}, "batch": {"KEEP_TPU_BATCH_CHUNKS": "1"},
                "stage": {"KEEP_TPU_STAGE_BATCH": "1"}}


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models():
    kt = _perturbed(JKEEP.init(jax.random.PRNGKey(2), **TINY), 2)
    gt = _perturbed(JGMFlow.init(jax.random.PRNGKey(3), num_layers=2), 3)
    keep = KEEP(device="cpu", **TINY)
    keep.load_state_dict(params_from_jax(kt, keep))
    gm = GMFlow(num_layers=2, device="cpu")
    gm.load_state_dict(params_from_jax(gt, gm))
    return kt, gt, keep, gm


@pytest.fixture(scope="module")
def jax_proc(models):
    kt, gt, _, _ = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEEP_TPU_NO_PHASE512", "1")
        return JProcessor(kt, TINY, gmflow_params=gt)


def _faces(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def _max_level_diff(a, b):
    return max(np.abs(x.astype(int) - y.astype(int)).max()
               for x, y in zip(a, b))


@pytest.mark.parametrize("n", [6, 7, 10])
@pytest.mark.parametrize("form", ["map", "batch", "stage"])
def test_grouped_stream_matches_jax_form(models, jax_proc, monkeypatch, form,
                                         n):
    _, _, keep, gm = models
    faces = _faces(n, seed=n)
    monkeypatch.setenv("KEEP_TPU_CHUNKS_PER_DISPATCH", "2")
    for k, v in JAX_FORM_ENV[form].items():
        monkeypatch.setenv(k, v)
    ref = jax_proc.restore_face_stream(faces, max_clip_length=3)
    proc = KEEPFaceProcessor(keep, gm, device="cpu", chunk_batching=form,
                             chunks_per_dispatch=2)
    ours = proc.restore_face_stream(faces, max_clip_length=3)
    assert len(ours) == len(ref) == n
    assert all(o.dtype == np.uint8 and o.shape == (64, 64, 3) for o in ours)
    assert _max_level_diff(ours, ref) <= 1


def test_map_form_equals_the_chunk_loop_bitwise(models):
    """"map" (the default) is the per-chunk loop: 10 faces, every chunk
    through restore_clip on its own (the 1-frame tail duplicated), equal
    bit for bit, whatever chunks_per_dispatch."""
    _, _, keep, gm = models
    faces = _faces(10, seed=11)
    proc = KEEPFaceProcessor(keep, gm, device="cpu")
    assert proc.chunk_batching == "map"
    x = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces])
    loop = [rgb_pm1_to_bgr_u8(o) for s in (0, 3, 6)
            for o in proc.restore_clip(x[s:s + 3])]
    loop.append(rgb_pm1_to_bgr_u8(proc.restore_clip(
        np.concatenate([x[9:], x[9:]]))[0]))
    for cap in (2, 8):
        proc.chunks_per_dispatch = cap
        ours = proc.restore_face_stream(faces, max_clip_length=3)
        for a, b in zip(ours, loop):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form,group_calls", [
    ("map", [("apply", 1)] * 3),
    ("batch", [("apply", 2), ("apply", 1)]),
    ("stage", [("apply_chunks", 2), ("apply", 1)])])
def test_forms_dispatch_one_call_per_group(models, monkeypatch, form,
                                           group_calls):
    """9 faces in chunks of 3, chunks_per_dispatch=2: one group of 2, then
    the third chunk alone. "batch" and "stage" run GMFlow and KEEP once for
    the group (B = 2), "map" once per chunk; the leftover chunk always goes
    through KEEP.apply."""
    _, _, keep, gm = models
    proc = KEEPFaceProcessor(keep, gm, device="cpu", chunk_batching=form,
                             chunks_per_dispatch=2)
    calls = []
    for name in ("apply", "apply_chunks"):
        fn = getattr(proc.keep, name)
        monkeypatch.setattr(proc.keep, name, lambda x, *a, _n=name, _f=fn,
                            **kw: calls.append((_n, x.shape[0])) or _f(
                                x, *a, **kw))
    proc.restore_face_stream(_faces(9, seed=12), max_clip_length=3)
    assert calls == group_calls


def test_unknown_chunk_batching_is_refused(models):
    _, _, keep, gm = models
    with pytest.raises(ValueError, match="chunk_batching"):
        KEEPFaceProcessor(keep, gm, device="cpu", chunk_batching="vmap")


@pytest.fixture(scope="module")
def chunk_inputs():
    rng = np.random.default_rng(13)
    x = rng.random((3, 3, 64, 64, 3), dtype=np.float32) * 2 - 1
    flows = tuple((rng.standard_normal((3, 2, 64, 64)) * 2).astype(np.float32)
                  for _ in range(2))
    return x, flows


def test_apply_chunks_matches_jax(models, chunk_inputs):
    """G = 3 chunks of 3 frames with flows: the batched encoder, gains and
    frame 0, then each chunk's recurrence, against JAX's apply_chunks (no
    pick flips at this seed: the outputs agree to ~5e-5)."""
    kt, _, keep, _ = models
    x, flows = chunk_inputs
    ref = japply_chunks(kt, jnp.asarray(x),
                        flows=tuple(map(jnp.asarray, flows)))
    ours = keep.apply_chunks(torch.as_tensor(x),
                             flows=tuple(map(torch.as_tensor, flows)))
    assert ours.shape == (3, 3, 64, 64, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **KEEP_TOL)


def test_apply_chunks_teacher_forced_matches_jax_per_chunk(models,
                                                           chunk_inputs):
    """force_indices (G, T, L): each chunk's picks taken from JAX's
    KEEP.apply on that chunk alone and forced on the port's apply_chunks;
    the outputs against those per-chunk JAX runs (apply_chunks is G
    independent applies)."""
    kt, _, keep, _ = models
    x, flows = chunk_inputs
    refs, picks = [], []
    for c in range(3):
        ref, aux = japply(kt, jnp.asarray(x[c:c + 1]), flows=tuple(
            jnp.asarray(f[c:c + 1]) for f in flows))
        refs.append(np.asarray(ref)[0])
        picks.append(np.asarray(aux["logits"]).argmax(-1))
    ours = keep.apply_chunks(torch.as_tensor(x),
                             flows=tuple(map(torch.as_tensor, flows)),
                             force_indices=torch.as_tensor(np.stack(picks)))
    np.testing.assert_allclose(ours.numpy(), np.stack(refs), **KEEP_TOL)


def test_apply_chunks_single_frame_returns_frame_zero(models, chunk_inputs):
    kt, _, keep, _ = models
    x = chunk_inputs[0][:, :1]
    ref = japply_chunks(kt, jnp.asarray(x))
    ours = keep.apply_chunks(torch.as_tensor(x))
    assert ours.shape == (3, 1, 64, 64, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **KEEP_TOL)


def test_apply_chunks_equals_apply_per_chunk(models, chunk_inputs):
    """One step function serves both: apply_chunks equals KEEP.apply on
    each chunk up to the batched stages' summation order."""
    _, _, keep, _ = models
    x, flows = chunk_inputs
    ours = keep.apply_chunks(torch.as_tensor(x),
                             flows=tuple(map(torch.as_tensor, flows)))
    for c in range(3):
        one = keep.apply(torch.as_tensor(x[c:c + 1]), flows=tuple(
            torch.as_tensor(f[c:c + 1]) for f in flows))
        np.testing.assert_allclose(ours[c].numpy(), one[0].numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_need_upscale_matches_jax(models):
    """need_upscale: 16x16 frames resized x4 (bilinear, align_corners
    False) before the encoder; zero flows at the upscaled size. Picks
    forced from the JAX run."""
    kt, _, keep, _ = models
    x = np.random.default_rng(14).random((1, 2, 16, 16, 3),
                                         dtype=np.float32) * 2 - 1
    ref, aux = japply(kt, jnp.asarray(x), need_upscale=True)
    picks = np.asarray(aux["logits"]).argmax(-1).reshape(1, 2, -1)
    ours, oaux = keep.apply(torch.as_tensor(x), need_upscale=True,
                            return_aux=True,
                            force_indices=torch.as_tensor(picks))
    assert ours.shape == (1, 2, 64, 64, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **KEEP_TOL)
    np.testing.assert_allclose(oaux["logits"].numpy(),
                               np.asarray(aux["logits"]), **KEEP_TOL)
