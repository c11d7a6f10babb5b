"""Validation and the test run of the PyTorch port against the JAX package,
on the CPU: validate_images / validate_videos on the same outputs,
test_pipeline on options/test_keep.yml's options (a tiny MSRResNet, PNG
pairs, the weights as a .pth for the port and an .npz for the JAX package),
the save_img layouts, train_pipeline with a val phase, the paired datasets
and data/util.py, and chip_smoke.py's TEST_OPT held to the yml.

Tolerances: metrics within 1e-4 relative (PSNR and SSIM of the same 8-bit
images; the networks' outputs agree to ~1e-6, so a rounding to 8 bits may
flip at a tie); saved images within one level; the rest bit for bit.
"""
import copy
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from comfyui_keep_tpu.data import build_dataset as jbuild_dataset
from comfyui_keep_tpu.data import util as jutil
from comfyui_keep_tpu.training import train as jtrain
from comfyui_keep_tpu.training import validation as jval
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict, save_npz
from comfyui_keep_torch.data import build_dataset
from comfyui_keep_torch.data import util as tutil
from comfyui_keep_torch.data.prefetch import DataLoader
from comfyui_keep_torch.training import train as ttrain
from comfyui_keep_torch.training import validation as tval
from comfyui_keep_torch.training.trainers import SRTrainer
from comfyui_keep_torch.utils import png

from tests.torch_port_helpers import pyyaml_opt, same_values, state_numpy

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_RTOL = 1e-4
METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 4},
           "ssim": {"type": "calculate_ssim", "crop_border": 4}}


def write_pairs(root, n=3, lq=16, scale=4, seed=0):
    """n PNG pairs in <root>/gt and <root>/lq, smooth enough for SSIM."""
    rng = np.random.default_rng(seed)
    for sub in ("gt", "lq"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        gt = cv2.GaussianBlur(rng.integers(0, 256, (lq * scale, lq * scale,
                                                    3), np.uint8), (5, 5), 0)
        small = cv2.resize(gt, (lq, lq), interpolation=cv2.INTER_AREA)
        png.imwrite_bgr(os.path.join(root, "gt", f"img{i:03d}.png"), gt)
        png.imwrite_bgr(os.path.join(root, "lq", f"img{i:03d}.png"), small)
    return os.path.join(root, "lq"), os.path.join(root, "gt")


def tiny_opt(root, **extra):
    """options/test_keep.yml's options on a tiny MSRResNet and the pairs
    under root."""
    with open(os.path.join(REPO, "options", "test_keep.yml")) as f:
        opt = yaml.safe_load(f)
    lq, gt = write_pairs(root)
    opt["network_g"].update(num_feat=16, num_block=2)
    opt["datasets"]["test_1"].update(dataroot_lq=lq, dataroot_gt=gt)
    opt.update(extra)
    return opt


def test_chip_smoke_test_opt_matches_the_yml():
    """chip_smoke.py reads options/test_keep.yml with the port's YAML reader
    (the card machine has no pyyaml): its opt equals pyyaml's load of the
    yml, value for value, type for type, in order."""
    sys.path.insert(0, REPO)
    import chip_smoke
    ours = chip_smoke.test_opt()
    assert same_values(ours, pyyaml_opt(os.path.join(REPO, "options",
                                                     "test_keep.yml")))
    assert ours["path"]["pretrain_network_g"] is None


def same_metrics(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, dict):
            same_metrics(ours[k], v)
        else:
            assert abs(ours[k] - v) <= METRIC_RTOL * abs(v), (k, ours[k], v)


def net_fn(lq):
    """A deterministic stand-in for a x4 net (numpy or tensor in)."""
    x = np.asarray(lq, np.float32)
    return np.clip(x.repeat(4, -2).repeat(4, -3) * 0.9 + 0.05, 0, 1)


def test_validate_images_equals_jax(tmp_path):
    lq, gt = write_pairs(str(tmp_path), n=4)
    opt = {"type": "PairedImageDataset", "dataroot_lq": lq,
           "dataroot_gt": gt, "scale": 4}
    ours_saved, ref_saved = {}, {}
    ours = tval.validate_images(
        net_fn, DataLoader(build_dataset(opt), batch_size=1, drop_last=False),
        METRICS, save_fn=lambda im, n: ours_saved.__setitem__(n, im))
    from comfyui_keep_tpu.data.prefetch import DataLoader as JLoader
    ref = jval.validate_images(
        net_fn, JLoader(jbuild_dataset(opt), batch_size=1, drop_last=False),
        METRICS, save_fn=lambda im, n: ref_saved.__setitem__(n, im))
    same_metrics(ours, ref)
    assert ours_saved.keys() == ref_saved.keys() == {
        f"img{i:03d}" for i in range(4)}
    for k in ref_saved:
        np.testing.assert_array_equal(ours_saved[k], ref_saved[k])
    # rank 1 of 2 takes the odd items
    half = tval.validate_images(
        net_fn, DataLoader(build_dataset(opt), batch_size=1, drop_last=False),
        METRICS, rank=1, world=2)
    ref_half = jval.validate_images(
        net_fn, JLoader(jbuild_dataset(opt), batch_size=1, drop_last=False),
        METRICS, rank=1, world=2)
    same_metrics(half, ref_half)


def test_validate_videos_and_flip_ensemble_equal_jax():
    rng = np.random.default_rng(1)
    items = [{"lq": rng.random((1, 3, 12, 12, 3), dtype=np.float32),
              "gt": rng.random((1, 3, 48, 48, 3), dtype=np.float32),
              "folder": [f"clip{i}"]} for i in range(3)]
    saved = []
    per, avg = tval.validate_videos(net_fn, items, METRICS,
                                    save_fn=lambda im, n: saved.append(n))
    ref_per, ref_avg = jval.validate_videos(net_fn, items, METRICS)
    same_metrics(per, ref_per)
    same_metrics(avg, ref_avg)
    assert saved[:2] == ["clip0/00000000", "clip0/00000001"]
    per1, _ = tval.validate_videos(net_fn, items, METRICS, rank=1, world=2)
    ref1, _ = jval.validate_videos(net_fn, items, METRICS, rank=1, world=2)
    same_metrics(per1, ref1)

    def fwd(x):
        return x * np.arange(1, x.shape[1] + 1)[None, :, None, None, None]
    x = items[0]["lq"]
    np.testing.assert_allclose(
        tval.flip_seq_self_ensemble(fwd, x),
        np.asarray(jval.flip_seq_self_ensemble(fwd, jnp.asarray(x))),
        rtol=1e-6)
    np.testing.assert_allclose(     # the tensor form
        tval.flip_seq_self_ensemble(
            lambda t: t * torch.arange(1, 4)[None, :, None, None, None],
            torch.as_tensor(x)).numpy(),
        tval.flip_seq_self_ensemble(fwd, x), rtol=1e-6)


@pytest.mark.parametrize("save_img", [False, True])
def test_test_pipeline_on_test_keep_yml_equals_jax(tmp_path, save_img):
    """test_pipeline on the yml's options: the port's net as a .pth, the
    same weights as the JAX package's .npz; metrics and saved images."""
    opt = tiny_opt(str(tmp_path))
    tr = SRTrainer(opt, device="cpu")
    model = tr.init_model()
    pth = str(tmp_path / "net_g.pth")
    torch.save({"params": model.state_dict()}, pth)
    npz = str(tmp_path / "net_g.npz")
    save_npz(npz, {"params": convert_state_dict(state_numpy(model))})
    ours_opt = copy.deepcopy(opt)
    ref_opt = copy.deepcopy(opt)
    ours_opt["path"]["pretrain_network_g"] = pth
    ref_opt["path"]["pretrain_network_g"] = npz
    if save_img:
        for o, d in ((ours_opt, "vis_ours"), (ref_opt, "vis_ref")):
            o["val"]["save_img"] = True
            o["path"]["visualization"] = str(tmp_path / d)
    ours = ttrain.test_pipeline(ours_opt, trainer_kwargs={"device": "cpu"})
    ref = jtrain.test_pipeline(ref_opt)
    assert list(ours) == ["demo"]
    same_metrics(ours, ref)
    assert ours["demo"]["psnr"] > 0
    if save_img:      # <vis>/<dataset>/<img>_<run name>.png
        names = sorted(os.listdir(tmp_path / "vis_ref" / "demo"))
        assert names == sorted(os.listdir(tmp_path / "vis_ours" / "demo"))
        assert names == [f"img{i:03d}_keep_test.png" for i in range(3)]
        for n in names:
            a = cv2.imread(str(tmp_path / "vis_ours" / "demo" / n))
            b = cv2.imread(str(tmp_path / "vis_ref" / "demo" / n))
            assert np.abs(a.astype(int) - b).max() <= 1


def test_train_pipeline_validates_every_val_freq(tmp_path):
    """SRModel, 2 iterations with a val phase at val_freq 1: the results at
    each iteration, the last equal to validating the final net, the
    training-run save_img layout <vis>/<img>/<img>_<iter>.png."""
    root = str(tmp_path)
    lq, gt = write_pairs(os.path.join(root, "data"), n=2)
    vis = os.path.join(root, "exp", "visualization")
    opt = {"name": "sr_val", "is_train": True, "manual_seed": 0,
           "model_type": "SRModel",
           "network_g": {"type": "MSRResNet", "num_feat": 16, "num_block": 2,
                         "upscale": 4},
           "datasets": {
               "train": {"type": "PairedImageDataset", "dataroot_lq": lq,
                         "dataroot_gt": gt, "scale": 4, "phase": "train",
                         "gt_size": 32, "batch_size_per_gpu": 2},
               "val": {"type": "PairedImageDataset", "name": "pairs",
                       "dataroot_lq": lq, "dataroot_gt": gt, "scale": 4}},
           "train": {"total_iter": 2,
                     "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                     "optim_g": {"type": "Adam", "lr": 1e-4}},
           "val": {"val_freq": 1, "save_img": True, "metrics": METRICS},
           "logger": {"print_freq": 1, "save_checkpoint_freq": 100},
           "path": {"experiments_root": os.path.join(root, "exp"),
                    "models": os.path.join(root, "exp", "models"),
                    "training_states": os.path.join(root, "exp", "states"),
                    "log": os.path.join(root, "exp"),
                    "visualization": vis}}
    state, logs = ttrain.train_pipeline(opt, trainer_kwargs={"device": "cpu"})
    run = logs["run"]
    assert sorted(run["val"]) == [1, 2] and len(run["val_s"]) == 2
    assert logs["val/pairs/psnr"] == run["val"][2]["pairs"]["psnr"]
    again = ttrain.run_validation(
        run["trainer"], state.model,
        [("pairs", "PairedImageDataset", DataLoader(
            build_dataset(opt["datasets"]["val"]), batch_size=1,
            drop_last=False))], METRICS)
    same_metrics(again, run["val"][2])
    assert sorted(os.listdir(vis)) == ["img000", "img001"]
    assert sorted(os.listdir(os.path.join(vis, "img000"))) == [
        "img000_1.png", "img000_2.png"]


def test_paired_dataset_equals_jax_with_streams_alike(tmp_path):
    import random
    lq, gt = write_pairs(str(tmp_path), n=2)
    opt = {"type": "PairedImageDataset", "dataroot_lq": lq,
           "dataroot_gt": gt, "scale": 4, "phase": "train", "gt_size": 32}
    ours, ref = build_dataset(opt), jbuild_dataset(opt)
    ours.seed_streams(5)
    random.seed(5)
    for i in (0, 1, 0):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].shape == ((8, 8, 3) if k == "lq" else (32, 32, 3))
    single = {"type": "SingleImageDataset", "dataroot_lq": lq}
    np.testing.assert_array_equal(build_dataset(single)[1]["lq"],
                                  jbuild_dataset(single)[1]["lq"])


def test_data_util_equals_jax(tmp_path):
    lq, gt = write_pairs(str(tmp_path), n=3)
    for pad in ("replicate", "reflection", "reflection_circle", "circle"):
        for crt in (0, 1, 5, 9):
            assert tutil.generate_frame_indices(crt, 10, 5, pad) == \
                jutil.generate_frame_indices(crt, 10, 5, pad)
    seq, names = tutil.read_img_seq(gt, return_imgname=True)
    ref_seq, ref_names = jutil.read_img_seq(gt, return_imgname=True)
    np.testing.assert_array_equal(seq, ref_seq)
    assert names == ref_names
    assert tutil.paired_paths_from_folder([lq, gt], ["lq", "gt"], "{}") == \
        jutil.paired_paths_from_folder([lq, gt], ["lq", "gt"], "{}")
    meta = str(tmp_path / "meta.txt")
    with open(meta, "w") as f:
        f.write("img001.png (64,64,3)\nimg002.png (64,64,3)\n")
    assert tutil.paired_paths_from_meta_info_file(
        [lq, gt], ["lq", "gt"], meta, "{}") == \
        jutil.paired_paths_from_meta_info_file([lq, gt], ["lq", "gt"], meta,
                                               "{}")
    assert tutil.paths_from_folder(gt) == jutil.paths_from_folder(gt)
    np.testing.assert_array_equal(tutil.generate_gaussian_kernel(),
                                  jutil.generate_gaussian_kernel())
    x = np.random.default_rng(2).random((1, 2, 40, 44, 3), dtype=np.float32)
    for scale in (2, 4):
        np.testing.assert_allclose(
            tutil.duf_downsample(torch.as_tensor(x), scale=scale).numpy(),
            np.asarray(jutil.duf_downsample(jnp.asarray(x), scale=scale)),
            atol=1e-6)
    # the lmdb path lists read meta_info.txt alone (no lmdb package)
    for name, lines in (("a.lmdb", "k1.png (8,8,3) 1\nk2.png (8,8,3) 1\n"),
                        ("b.lmdb", "k2.png (8,8,3) 1\nk1.png (8,8,3) 1\n"),
                        ("c.lmdb", "k1.png (8,8,3) 1\n")):
        os.makedirs(tmp_path / name)
        (tmp_path / name / "meta_info.txt").write_text(lines)
    a, b, c = (str(tmp_path / n) for n in ("a.lmdb", "b.lmdb", "c.lmdb"))
    assert tutil.paths_from_lmdb(a) == jutil.paths_from_lmdb(a) == \
        ["k1", "k2"]
    assert tutil.paired_paths_from_lmdb([a, b], ["lq", "gt"]) == \
        jutil.paired_paths_from_lmdb([a, b], ["lq", "gt"])
    for args in (([a, c], ["lq", "gt"]), ([a, gt], ["lq", "gt"])):
        with pytest.raises(ValueError):
            tutil.paired_paths_from_lmdb(*args)
    with pytest.raises(ValueError, match="lmdb format"):
        tutil.paths_from_lmdb(gt)
