"""The port's training data path without OpenCV against OpenCV and the JAX
package's data pipeline, on the CPU.

- utils/png.py: bitwise to cv2.imread(IMREAD_COLOR) on files cv2 writes
  and on files of each row filter; unsupported forms raise.
- utils/cvops.py's OpenCV forms of the degradation chain on float32
  frames: filter2D (21x21, reflect-101) within 1e-6, INTER_AREA within
  1e-6, INTER_LINEAR and INTER_CUBIC within 1e-5 (OpenCV's vector code
  rounds in another order); utils/diffjpeg.py against JAX's within 1e-5;
  the JPEG stand-in for video compression against cv2's JPEG at the same
  quality: a mean |d| under 6 levels of 255 on blurred colour noise, 2.5
  on its gray (measured 3.5-3.8 and 0.67-1.63 at CRF 18-34: libjpeg's
  integer DCT and its chroma upsampling against the float form).
- degradations and transforms draw what JAX's draw from the same seeded
  streams, bitwise; EnlargedSampler and DataLoader give JAX's batches.
- a VFHQRealDegradationDataset item equals JAX's within 1e-5 with both
  seeded alike (JAX's global streams, the port's own) and the video
  compression replaced by the identity in both;
- train_pipeline on a synthetic clip: 2 KEEPGANModel iterations, a save,
  and an auto-resume that picks up at iteration 2 with the saved tensors.
The 512^2 case is marked slow.
"""
import copy
import os
import random
import struct
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from comfyui_keep_tpu.data import build_dataset as jbuild_dataset
from comfyui_keep_tpu.data import datasets as JDS
from comfyui_keep_tpu.data import degradations as JD
from comfyui_keep_tpu.data import transforms as JT
from comfyui_keep_tpu.data.prefetch import DataLoader as JDataLoader
from comfyui_keep_tpu.data.samplers import EnlargedSampler as JSampler
from comfyui_keep_torch.data import build_dataset, datasets as TDS
from comfyui_keep_torch.data import degradations as TD
from comfyui_keep_torch.data import transforms as TT
from comfyui_keep_torch.data.prefetch import (CPUPrefetcher, CUDAPrefetcher,
                                             DataLoader)
from comfyui_keep_torch.data.samplers import EnlargedSampler
from comfyui_keep_torch.models.vqgan import VQHQEncoder
from comfyui_keep_torch.utils import cvops, png

torch.set_num_threads(2)


def smooth_u8(rng, shape):
    return cv2.GaussianBlur((rng.random(shape) * 255).astype(np.uint8),
                            (0, 0), 2)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_png_decoder_bitwise_to_cv2(tmp_path, channels, content):
    rng = np.random.default_rng(channels)
    img = smooth_u8(rng, (37, 53, 4)) if content == "smooth" else (
        rng.random((37, 53, 4)) * 255).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img[..., :channels]
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    ours = png.imread_bgr(path)
    assert ours.dtype == np.uint8 and ours.shape == (37, 53, 3)
    np.testing.assert_array_equal(ours, cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_each_row_filter(tmp_path, filt):
    """The encoder's rows of one filter (and of all five mixed) read back
    by cv2 and by the decoder as the image written."""
    rng = np.random.default_rng(10 + filt)
    img = smooth_u8(rng, (23, 31, 3))
    path = str(tmp_path / "x.png")
    for filters in (filt, [(filt + y) % 5 for y in range(23)]):
        png.imwrite_bgr(path, img, filters)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
        np.testing.assert_array_equal(png.imread_bgr(path), img)


def _with_header(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields replaced (CRC recomputed)."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:16] + body + crc + data[33:]


def test_png_unsupported_forms_raise(tmp_path):
    img = smooth_u8(np.random.default_rng(0), (8, 8, 3))
    data = png.encode(img)
    for bad in (_with_header(data, interlace=1), _with_header(data, ctype=3),
                _with_header(data, depth=16), _with_header(data, depth=4),
                data[:20] + b"x" + data[21:], b"GIF89a" + data[6:]):
        with pytest.raises(ValueError):
            png.decode(bad)
    # 16-bit files decode (KITTI's flow maps), in the file's RGB order
    ok, buf = cv2.imencode(".png", img.astype(np.uint16) * 257)
    np.testing.assert_array_equal(png.decode(buf.tobytes()),
                                  img[:, :, ::-1].astype(np.uint16) * 257)


# ---------------------------------------------------------------------------
# the degradation chain's OpenCV forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["iso", "aniso", "generalized_aniso",
                                  "plateau_aniso"])
def test_filter2d_vs_cv2(kind):
    rng = np.random.default_rng(1)
    k = JD.random_mixed_kernels([kind], [1.0], 21, (0.2, 3), (0.2, 3),
                                rng=np.random.default_rng(2))
    for shape in ((64, 64, 3), (40, 52, 3), (30, 33)):
        img = rng.random(shape, np.float32)
        ref = cv2.filter2D(img, -1, k)
        ours = cvops.filter2d_f32(torch.as_tensor(img), k).numpy()
        assert ours.shape == ref.shape and ours.dtype == np.float32
        assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("src,dst", [((64, 64), (16, 16)), ((64, 64), (32, 32)),
                                     ((50, 70), (23, 31)), ((64, 48), (64, 48))])
@pytest.mark.parametrize("method", ["area", "linear", "cubic"])
def test_resizes_vs_cv2(src, dst, method):
    flag, fn, tol = {
        "area": (cv2.INTER_AREA, cvops.resize_area_f32, 1e-6),
        "linear": (cv2.INTER_LINEAR, cvops.resize_linear_f32, 1e-5),
        "cubic": (cv2.INTER_CUBIC, cvops.resize_cubic_f32, 1e-5)}[method]
    img = np.random.default_rng(3).random(src + (3,), np.float32)
    ref = cv2.resize(img, dst[::-1], interpolation=flag)
    ours = fn(torch.as_tensor(img), dst[::-1]).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= tol
    if method == "cubic":   # upscaling too, the edge taps clamped
        ref = cv2.resize(img, (90, 100), interpolation=flag)
        assert np.abs(fn(torch.as_tensor(img), (90, 100)).numpy()
                      - ref).max() <= tol


def test_diff_jpeg_vs_jax():
    import jax.numpy as jnp
    from comfyui_keep_tpu.utils import diffjpeg as JJ
    from comfyui_keep_torch.utils import diffjpeg as TJ
    x = np.random.default_rng(4).random((2, 40, 56, 3), np.float32)
    for diff in (True, False):
        for q in (30, 70, 95):
            ours = TJ.diff_jpeg(torch.as_tensor(x), q, differentiable=diff)
            ref = np.asarray(JJ.diff_jpeg(jnp.asarray(x), q,
                                          differentiable=diff))
            assert ours.shape == x.shape
            assert np.abs(ours.numpy() - ref).max() <= 1e-5


def test_jpeg_fallback_vs_cv2():
    """The video compression's stand-in: per-frame JPEG at JAX's CRF
    mapping, against cv2.imencode / imdecode at that quality."""
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.random((128, 128, 3)).astype(np.float32),
                           (0, 0), 3)
    img = (img - img.min()) / (img.max() - img.min())
    gray = np.repeat(img[..., :1], 3, axis=2)
    for crf in (18, 25, 34):
        q = TD.crf_to_jpeg_quality(crf)
        assert q == int(np.interp(crf, [15, 40], [95, 30]))
        for frame, limit in ((img, 6.0), (gray, 2.5)):
            ours = TD.add_jpg_compression(frame, q)
            ref = JD.add_jpg_compression(frame, q)
            assert ours.dtype == np.float32 and ours.shape == frame.shape
            assert np.abs(ours - ref).mean() * 255 <= limit
            np.testing.assert_array_equal(np.round(ours * 255), ours * 255)
    clip = TD.add_video_compression([img, gray], crf=25)
    assert len(clip) == 2 and clip[0].dtype == np.float32


def test_degradation_draws_vs_jax():
    """Kernels and noise from one seeded RandomState in both packages."""
    img = np.random.default_rng(6).random((24, 20, 3), np.float32)
    kinds = ["iso", "aniso", "generalized_iso", "generalized_aniso",
             "plateau_iso", "plateau_aniso"]
    for seed in range(6):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(
            TD.random_mixed_kernels(kinds, [1] * 6, 21, rng=a),
            JD.random_mixed_kernels(kinds, [1] * 6, 21, rng=b))
        for gray_prob in (0.0, 1.0):
            np.testing.assert_array_equal(
                TD.random_add_gaussian_noise(img, (0, 10), gray_prob, rng=a),
                JD.random_add_gaussian_noise(img, (0, 10), gray_prob, rng=b))
            np.testing.assert_array_equal(
                TD.random_add_poisson_noise(img, (0, 1), gray_prob, rng=a),
                JD.random_add_poisson_noise(img, (0, 1), gray_prob, rng=b))
    np.testing.assert_array_equal(TD.circular_lowpass_kernel(1.3, 21, 25),
                                  JD.circular_lowpass_kernel(1.3, 21, 25))


def test_transforms_vs_jax():
    rng = np.random.default_rng(7)
    gts = [rng.random((32, 24, 3), np.float32) for _ in range(3)]
    lqs = [rng.random((16, 12, 3), np.float32) for _ in range(3)]
    flows = [rng.random((32, 24, 2), np.float32) for _ in range(2)]
    for seed in range(8):
        a, b = random.Random(seed), random.Random(seed)
        ours = TT.paired_random_crop(gts, lqs, 16, 2, rng=a)
        ref = JT.paired_random_crop(gts, lqs, 16, 2, rng=b)
        for x, y in zip(ours[0] + ours[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(x, y)
        ours = TT.augment(gts, True, True, flows=flows, return_status=True,
                          rng=a)
        ref = JT.augment(gts, True, True, flows=flows, return_status=True,
                         rng=b)
        assert ours[2] == ref[2]
        for x, y in zip(ours[0] + ours[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TT.mod_crop(gts[0], 5),
                                  JT.mod_crop(gts[0], 5))
    u8 = (gts[0] * 255).astype(np.uint8)
    for img in (u8, gts[0]):
        np.testing.assert_array_equal(TT.img_rotate(img, 30, scale=1.1),
                                      JT.img_rotate(img, 30, scale=1.1))


# ---------------------------------------------------------------------------
# samplers and loaders
# ---------------------------------------------------------------------------

class _Items:
    """Item i: {"x": a (2, 3) array of i, "key": str(i)}; raises at
    `bad`."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"item {i} is broken")
        return {"x": np.full((2, 3), i, np.float32), "key": str(i)}


def _keys(loader):
    return [b["key"] for b in loader]


def test_sampler_and_loader_vs_jax():
    for replicas, rank, ratio in ((1, 0, 1), (2, 0, 3), (2, 1, 3), (3, 2, 2)):
        ours = EnlargedSampler(7, replicas, rank, ratio)
        ref = JSampler(7, replicas, rank, ratio)
        assert len(ours) == len(ref)
        for epoch in range(3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref)
    ds = _Items(11)
    for kw in ({"batch_size": 3, "shuffle": True, "seed": 4},
               {"batch_size": 3, "shuffle": False, "drop_last": False},
               {"batch_size": 2, "sampler": None, "shuffle": True,
                "num_workers": 2, "seed": 1}):
        ours, ref = DataLoader(ds, **kw), JDataLoader(ds, **kw)
        assert len(ours) == len(ref)
        for epoch in range(2):
            ours.epoch = ref.epoch = epoch
            assert _keys(ours) == _keys(ref)
    sampled = dict(batch_size=2, sampler=EnlargedSampler(11, 1, 0, 2),
                   num_workers=3)
    ours = DataLoader(ds, **sampled)
    ref = JDataLoader(ds, **{**sampled, "sampler": JSampler(11, 1, 0, 2)})
    got = list(ours)
    assert [b["key"] for b in got] == _keys(ref)
    assert all(b["x"].shape == (2, 2, 3) for b in got)


def test_loader_and_prefetcher_raise_a_worker_error():
    for workers in (0, 2):
        seen = []
        with pytest.raises(RuntimeError, match="item 5"):
            for b in DataLoader(_Items(8, bad=5), batch_size=2,
                                num_workers=workers):
                seen.append(b["key"])
        assert seen == [["0", "1"], ["2", "3"]]
    pf = CUDAPrefetcher(DataLoader(_Items(8, bad=5), batch_size=2),
                        device="cpu")
    pf.reset()
    assert pf.next()["key"] == ["0", "1"]
    assert pf.next()["key"] == ["2", "3"]
    with pytest.raises(RuntimeError, match="item 5"):
        pf.next()


def test_cuda_prefetcher_on_the_cpu():
    """On a CPU device: tensors copied from the batch's arrays, other values
    as they are, None at the end of the epoch, and again after reset; the
    CPUPrefetcher hands the loader's numpy batches on as they are."""
    cpu = CPUPrefetcher(DataLoader(_Items(5), batch_size=2))
    assert [cpu.next()["key"] for _ in range(2)] == [["0", "1"], ["2", "3"]]
    assert cpu.next() is None
    pf = CUDAPrefetcher(DataLoader(_Items(5), batch_size=2), device="cpu")
    for _ in range(2):
        pf.reset()
        got = []
        while (b := pf.next()) is not None:
            assert torch.is_tensor(b["x"]) and b["x"].device.type == "cpu"
            got.append(b["key"])
        assert got == [["0", "1"], ["2", "3"]]


# ---------------------------------------------------------------------------
# the VFHQ dataset and the loop
# ---------------------------------------------------------------------------

def write_clip(root, frames, size, seed=0, name="clip_000"):
    """A VFHQ-layout clip of smooth random frames and its meta file."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "gt", name))
    for i in range(frames):
        png.imwrite_bgr(os.path.join(root, "gt", name, f"{i:08d}.png"),
                        smooth_u8(rng, (size, size, 3)))
    meta = os.path.join(root, "meta.txt")
    with open(meta, "w") as f:
        f.writelines(f"{name}/{frames}/{i}\n" for i in range(frames))
    return os.path.join(root, "gt"), meta


def _identity(frames, codec="libx264", crf=23, fps=25):
    return [f.astype(np.float32) for f in frames]


def vfhq_items_vs_jax(tmp_path, monkeypatch, size, num_frame, scale, seeds,
                      indices):
    gt_root, meta = write_clip(str(tmp_path), 12, size)
    opt = {"type": "VFHQDataset", "dataroot_gt": gt_root,
           "meta_info_file": meta, "num_frame": num_frame, "scale": scale,
           "interval_list": [1, 2], "random_reverse": True}
    monkeypatch.setattr(JDS, "add_video_compression", _identity)
    monkeypatch.setattr(TDS, "add_video_compression", _identity)
    ours, ref = build_dataset(opt), jbuild_dataset(opt)
    global_rs = np.random.mtrand._rand
    # JAX draws each kernel and noise from a fresh default_rng(); routed
    # here to numpy's global RandomState, which the port's own one mirrors
    monkeypatch.setattr(np.random, "default_rng", lambda *a: global_rs)
    for seed in seeds:
        ours.seed_streams(seed)
        random.seed(seed)
        np.random.seed(seed)
        for i in indices:
            r, o = ref[i], ours[i]
            assert o["key"] == r["key"]
            assert o["lq"].shape == r["lq"].shape == (
                num_frame, size // scale, size // scale, 3)
            for k in ("lq", "gt"):
                assert o[k].dtype == np.float32
                assert np.abs(o[k] - r[k]).max() <= 1e-5, (seed, i, k)


def test_vfhq_item_vs_jax(tmp_path, monkeypatch):
    vfhq_items_vs_jax(tmp_path, monkeypatch, 64, 4, 2, (0, 1, 2, 3),
                      (0, 5, 11))


@pytest.mark.slow
def test_vfhq_item_vs_jax_512(tmp_path, monkeypatch):
    vfhq_items_vs_jax(tmp_path, monkeypatch, 512, 8, 4, (0,), (4,))


TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=1,
            attn_resolutions=(16,), codebook_size=32, emb_dim=32, dim_embd=32,
            n_head=4, n_layers=1, latent_size=256, cft_list=("32",),
            cfa_list=(), cfa_nhead=2, cfa_dim=8, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=("32",))


def stage3_tiny(root, gt_root, meta, scale=1):
    return {
        "name": "tiny_gan", "is_train": True, "manual_seed": 0,
        "model_type": "KEEPGANModel",
        "network_g": {"type": "KEEP", **TINY,
                      "fix_modules": ["quantize", "generator"]},
        "network_d": {"type": "Discriminator3D", "args": {"nf": 8}},
        "datasets": {"train": {
            "type": "VFHQDataset", "dataroot_gt": gt_root,
            "meta_info_file": meta, "num_frame": 2, "batch_size_per_gpu": 1,
            "scale": scale}},
        "train": {"total_iter": 2, "use_hq_feat_loss": True,
                  "cross_entropy_loss": True,
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                  "temporal_opt": {"type": "L1Loss", "loss_weight": 0.1},
                  "gan_opt": {"type": "GANLoss", "gan_type": "hinge",
                              "loss_weight": 1e-2},
                  "optim_g": {"type": "Adam", "lr": 5e-5},
                  "optim_d": {"type": "Adam", "lr": 5e-5},
                  "ema_decay": 0.995},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
        "path": {"experiments_root": os.path.join(root, "exp"),
                 "models": os.path.join(root, "exp", "models"),
                 "training_states": os.path.join(root, "exp",
                                                 "training_states"),
                 "log": os.path.join(root, "exp")}}


def test_train_pipeline_gan_saves_and_resumes(tmp_path, monkeypatch):
    from comfyui_keep_torch.training import train as train_mod
    from comfyui_keep_torch.training.trainers import KEEPGANTrainer
    gt_root, meta = write_clip(str(tmp_path), 6, 64)
    opt = stage3_tiny(str(tmp_path), gt_root, meta)
    hq = VQHQEncoder(device="cpu", generator=torch.Generator().manual_seed(1),
                     **{k: TINY[k] for k in ("img_size", "nf", "ch_mult",
                                             "res_blocks", "attn_resolutions",
                                             "codebook_size", "emb_dim")})
    kw = {"hq_vqgan": hq, "device": "cpu"}
    state, logs = train_mod.train_pipeline(opt, trainer_kwargs=kw)
    assert state.iter == 2 and state.epoch == 1
    assert {"l_g_gan", "l_d", "l_d_real", "l_d_fake", "time",
            "data_time"} <= logs.keys()
    run = logs.pop("run")
    assert all(np.isfinite(v) for v in logs.values())
    assert isinstance(run["trainer"], KEEPGANTrainer)
    assert (run["start_iter"], run["restored"], run["resume_s"]) == (
        0, None, None)
    assert len(run["step_s"]) == 2 and len(run["save_s"]) == 1
    assert run["batch"]["gt"].shape == (1, 2, 64, 64, 3)
    models = tmp_path / "exp" / "models"
    assert os.listdir(models) == ["net_g_2.pth"]
    assert os.listdir(tmp_path / "exp" / "training_states") == ["2.state"]
    saved = torch.load(models / "net_g_2.pth", weights_only=True)["params"]

    seen = {}
    step = KEEPGANTrainer.train_step

    def spy(self, st, batch):
        if not seen:
            seen["iter"] = st.iter
            seen["equal"] = all(torch.equal(v, saved[k]) for k, v
                                in st.model.state_dict().items())
            seen["d_steps"] = {int(s["step"]) for s
                               in self.d_optimizer.state.values()}
        return step(self, st, batch)
    monkeypatch.setattr(KEEPGANTrainer, "train_step", spy)
    state2, logs2 = train_mod.train_pipeline({**opt, "auto_resume": True},
                                             max_iters=3, trainer_kwargs=kw)
    assert seen == {"iter": 2, "equal": True, "d_steps": {2}}
    assert state2.iter == 3
    run2 = logs2["run"]
    assert run2["start_iter"] == 2 and len(run2["step_s"]) == 1
    assert run2["restored"].get("kept", 0) == 0
    assert run2["restored"]["loaded"] > 0
    assert run2["resume_s"] > 0 and run2["save_s"] == []
    assert not (tmp_path / "exp").with_name("exp_archived").exists()
    assert sorted(os.listdir(tmp_path)) == ["exp", "gt", "meta.txt"]

    # a val phase now builds its loader; an unknown model_type then raises
    # the registry's KeyError
    with pytest.raises(KeyError, match="NoSuchModel"):
        bad = copy.deepcopy(opt)
        bad["datasets"]["val"] = dict(bad["datasets"]["train"])
        bad["model_type"] = "NoSuchModel"
        train_mod.train_pipeline(bad, trainer_kwargs=kw)


def test_default_dataset_scale_gives_keep_a_quarter_size_clip(tmp_path):
    """The stage-III yml sets no dataset scale, and the dataset's default is
    4: a 64^2 clip gives 16^2 LQ frames, which KEEP at img_size 64 refuses
    without need_upscale (in both packages). The reference trains on such
    quarter-size LQ, upscaled inside KEEP, and so do the port's KEEP
    trainers: at img_size / 4 they run KEEP with need_upscale (flows, none
    here, on the upscaled clip). Their training and eval forwards are held
    to JAX's KEEP.apply(need_upscale=True) on the same weights (a perturbed
    JAX init, the pick layer's LayerNorm scale 0 so both packages pick one
    code: KEEP_TOL of tests/test_torch_chunks.py, 5e-3 / 1e-2), and
    train_pipeline trains one step from the yml's dataset section (scale
    unset; num_frame cut to 2 for the CPU) at img_size 64."""
    import jax
    import jax.numpy as jnp
    from comfyui_keep_tpu.models.keep import KEEP as JKEEP
    from comfyui_keep_torch.models.keep import KEEP
    from comfyui_keep_torch.training import train as train_mod
    from comfyui_keep_torch.training.trainers import (KEEPGANTrainer,
                                                      KEEPTrainer)
    from comfyui_keep_torch.utils.convert import params_from_jax
    from comfyui_keep_torch.utils.options import yaml_load
    gt_root, meta = write_clip(str(tmp_path), 4, 64)
    yml = yaml_load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "options", "train_keep_stage3_gan.yml"))
    dataset_opt = {**yml["datasets"]["train"], "dataroot_gt": gt_root,
                   "meta_info_file": meta, "num_frame": 2}
    assert "scale" not in dataset_opt
    ds = build_dataset(dataset_opt)
    item = ds[1]
    assert item["lq"].shape == (2, 16, 16, 3)
    assert item["gt"].shape == (2, 64, 64, 3)
    lq = torch.as_tensor(item["lq"])[None]
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(0),
               **TINY)
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            net.apply(lq)

    rng = np.random.default_rng(40)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(
            np.shape(a)).astype(np.float32),
        JKEEP.init(jax.random.PRNGKey(4), **TINY))
    tree["idx_pred_layer"][0]["scale"] = np.zeros_like(
        tree["idx_pred_layer"][0]["scale"])
    net.load_state_dict(params_from_jax(tree, net))
    ref = np.asarray(JKEEP.apply(tree, jnp.asarray(item["lq"])[None],
                                 need_upscale=True, remat=False, **TINY))
    tr = KEEPTrainer({"model_type": "KEEPModel", "manual_seed": 0,
                      "network_g": {"type": "KEEP", **TINY},
                      "train": {"pixel_opt": {"type": "L1Loss"}}},
                     device="cpu")
    assert tr.need_upscale(lq) and not tr.need_upscale(
        torch.as_tensor(item["gt"])[None])
    got = tr.forward(net, lq)
    _, _, outs = tr._loss_outs(net, {"lq": lq, "gt": torch.as_tensor(
        item["gt"])[None]})
    for o in (got, outs.detach()):
        assert o.shape == ref.shape == (1, 2, 64, 64, 3)
        np.testing.assert_allclose(o.numpy(), ref, atol=5e-3, rtol=1e-2)
    with pytest.raises(ValueError, match="LQ frames of 32x32"):
        tr.need_upscale(torch.zeros(1, 2, 32, 32, 3))

    opt = stage3_tiny(str(tmp_path), gt_root, meta)
    opt["datasets"]["train"] = {**dataset_opt, "batch_size_per_gpu": 1}
    opt["train"]["total_iter"] = 1
    hq = VQHQEncoder(device="cpu", generator=torch.Generator().manual_seed(1),
                     **{k: TINY[k] for k in ("img_size", "nf", "ch_mult",
                                             "res_blocks", "attn_resolutions",
                                             "codebook_size", "emb_dim")})
    state, logs = train_mod.train_pipeline(
        opt, trainer_kwargs={"hq_vqgan": hq, "device": "cpu"})
    run = logs.pop("run")
    assert isinstance(run["trainer"], KEEPGANTrainer) and state.iter == 1
    assert run["batch"]["lq"].shape == (1, 2, 16, 16, 3)
    assert {"l_g_gan", "l_d", "l_pix"} <= logs.keys()
    assert all(np.isfinite(v) for v in logs.values())


def test_keep_training_refuses_other_lq_scales(tmp_path):
    """A KEEP trainer's dataset at any scale but 1 or 4 raises in
    train_pipeline, naming datasets.train.scale."""
    from comfyui_keep_torch.training import train as train_mod
    gt_root, meta = write_clip(str(tmp_path), 4, 64)
    opt = stage3_tiny(str(tmp_path), gt_root, meta, scale=2)
    hq = VQHQEncoder(device="cpu", generator=torch.Generator().manual_seed(1),
                     **{k: TINY[k] for k in ("img_size", "nf", "ch_mult",
                                             "res_blocks", "attn_resolutions",
                                             "codebook_size", "emb_dim")})
    with pytest.raises(ValueError, match="datasets.train.scale is 2"):
        train_mod.train_pipeline(opt, trainer_kwargs={"hq_vqgan": hq,
                                                      "device": "cpu"})