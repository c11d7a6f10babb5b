"""The rest of the port's data against the JAX package's, on the CPU, on
small synthetic PNG folders written with OpenCV (cv2, the tests' oracle):

- the datasets beyond VFHQ's and the paired / single image sets, each
  built by build_dataset under its JAX name; their items on the same
  seed (the JAX package's global streams, the port's own) bit for bit:
  the same keys, frame indices, crops and flips; VideoTestDUFDataset's
  DUF downsample within 1e-6 (XLA's convolution and torch's sum in other
  orders);
- data/gaussian_kernels.py: each sampler (strict or not, with and without
  noise) and each random_mixed_kernels type on seeded streams bit for bit,
  and the unknown type's ValueError;
- the lmdb forms (utils/lmdb_util.py, FileClient's lmdb backend,
  data/util.py:paths_from_lmdb, utils/flow.py:make_lmdb_from_imgs) of both
  packages on a dict-backed stand-in for the lmdb package, which a fixture
  installs in sys.modules: decoded images and meta_info.txt lines, not PNG
  bytes (the port's encoder filters rows otherwise than libpng).
"""
import os
import pickle
import random
import sys
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from comfyui_keep_tpu.data import build_dataset as jbuild_dataset
from comfyui_keep_tpu.data import gaussian_kernels as JG
from comfyui_keep_tpu.data import util as jutil
from comfyui_keep_tpu.utils import file_client as jfc
from comfyui_keep_tpu.utils import flow as jflow
from comfyui_keep_tpu.utils import lmdb_util as jlmdb
from comfyui_keep_torch.data import build_dataset
from comfyui_keep_torch.data import gaussian_kernels as TG
from comfyui_keep_torch.data import util as tutil
from comfyui_keep_torch.utils import file_client as tfc
from comfyui_keep_torch.utils import flow as tflow
from comfyui_keep_torch.utils import lmdb_util as tlmdb

torch.set_num_threads(2)
DUF_ATOL = 1e-6


def smooth_u8(rng, shape):
    return cv2.GaussianBlur((rng.random(shape) * 255).astype(np.uint8),
                            (0, 0), 2)


def write_frames(folder, names, size, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        cv2.imwrite(os.path.join(folder, name), smooth_u8(rng, size + (3,)))


def seed_all(ds, seed):
    ds.seed_streams(seed)
    random.seed(seed)
    np.random.seed(seed)


def assert_items_equal(o, r, atol=0.0):
    assert o.keys() == r.keys()
    for k, v in r.items():
        if isinstance(v, np.ndarray) or hasattr(v, "shape"):
            v = np.asarray(v)
            assert o[k].shape == v.shape and o[k].dtype == v.dtype, k
            if atol:
                np.testing.assert_allclose(o[k], v, rtol=0, atol=atol,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(o[k], v, err_msg=k)
        else:
            assert o[k] == v, k


def compare(opt, seeds=(0, 1, 2), indices=None, atol=0.0):
    ours, ref = build_dataset(opt), jbuild_dataset(opt)
    assert type(ours).__name__ == type(ref).__name__
    assert len(ours) == len(ref)
    indices = range(len(ref)) if indices is None else indices
    for seed in seeds:
        if hasattr(ours, "seed_streams"):
            seed_all(ours, seed)
        for i in indices:
            assert_items_equal(ours[i], ref[i], atol)


# ---------------------------------------------------------------------------
# image sets
# ---------------------------------------------------------------------------

def test_ffhq_items_equal_jax(tmp_path):
    gt = str(tmp_path / "ffhq")
    write_frames(gt, [f"{i:05d}.png" for i in range(3)], (24, 20), 0)
    compare({"type": "FFHQDataset", "dataroot_gt": gt, "use_hflip": True,
             "mean": (0.4, 0.5, 0.6), "std": (0.5, 0.25, 0.5)},
            seeds=(0, 1, 2, 3))


def test_realesrgan_items_equal_jax(tmp_path, monkeypatch):
    gt = str(tmp_path / "hq")
    write_frames(gt, [f"{i:03d}.png" for i in range(3)], (32, 32), 1)
    # JAX draws each mixed kernel from a fresh default_rng(); routed to
    # numpy's global RandomState, which the port's own one mirrors
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a: np.random.mtrand._rand)
    opt = {"type": "RealESRGANDataset", "dataroot_gt": gt,
           "use_hflip": True, "use_rot": True, "sinc_prob": 0.3,
           "sinc_prob2": 0.3, "final_sinc_prob": 0.5}
    compare(opt, seeds=range(6))


def test_realesrgan_paired_items_equal_jax(tmp_path):
    gt, lq = str(tmp_path / "gt"), str(tmp_path / "lq")
    names = ["a.png", "b.png"]
    write_frames(gt, names, (32, 32), 2)
    write_frames(lq, names, (16, 16), 3)
    compare({"type": "RealESRGANPairedDataset", "dataroot_gt": gt,
             "dataroot_lq": lq, "phase": "train", "gt_size": 16,
             "scale": 2}, seeds=(0, 1, 2, 3))


# ---------------------------------------------------------------------------
# video sets
# ---------------------------------------------------------------------------

def write_reds(root, clips, frames, size, scale):
    """REDS layout: gt/<clip>/%08d.png, lq/<clip>/%08d.png at size /
    scale, and the meta file "<clip> <frames> (h,w,3)"."""
    for j, clip in enumerate(clips):
        names = [f"{i:08d}.png" for i in range(frames)]
        write_frames(os.path.join(root, "gt", clip), names, size, 10 + j)
        write_frames(os.path.join(root, "lq", clip), names,
                     (size[0] // scale, size[1] // scale), 20 + j)
    meta = os.path.join(root, "meta.txt")
    with open(meta, "w") as f:
        f.writelines(f"{c} {frames} ({size[0]},{size[1]},3)\n"
                     for c in clips)
    return os.path.join(root, "gt"), os.path.join(root, "lq"), meta


@pytest.mark.parametrize("phase", ["train", "val"])
def test_reds_items_equal_jax(tmp_path, phase):
    gt, lq, meta = write_reds(str(tmp_path), ["001", "002"], 6, (32, 32), 4)
    compare({"type": "REDSDataset", "dataroot_gt": gt, "dataroot_lq": lq,
             "meta_info_file": meta, "num_frame": 3, "interval_list": [1, 2],
             "random_reverse": True, "scale": 4, "gt_size": 16,
             "phase": phase}, seeds=(0, 1))


@pytest.mark.parametrize("test_mode", [False, True])
def test_reds_recurrent_items_equal_jax(tmp_path, test_mode):
    gt, lq, meta = write_reds(str(tmp_path), ["000", "001"], 6, (32, 32), 4)
    opt = {"type": "REDSRecurrentDataset", "dataroot_gt": gt,
           "dataroot_lq": lq, "meta_info_file": meta, "num_frame": 3,
           "interval_list": [1, 2], "random_reverse": True, "scale": 4,
           "gt_size": 16, "test_mode": test_mode}
    compare(opt, seeds=(0, 1))
    ours = build_dataset(opt)
    assert {k.split("/")[0] for k in ours.keys} == (
        {"000"} if test_mode else {"001"})
    for part in ("official", "REDS4"):
        assert build_dataset({**opt, "val_partition": part}).keys == \
            jbuild_dataset({**opt, "val_partition": part}).keys
    with pytest.raises(ValueError, match="Wrong validation partition"):
        build_dataset({**opt, "val_partition": "nope"})


def write_vimeo(root, keys, size, scale):
    for j, key in enumerate(keys):
        names = [f"im{i}.png" for i in range(1, 8)]
        write_frames(os.path.join(root, "gt", key), names, size, 30 + j)
        write_frames(os.path.join(root, "lq", key), names,
                     (size[0] // scale, size[1] // scale), 40 + j)
    meta = os.path.join(root, "meta.txt")
    with open(meta, "w") as f:
        f.writelines(f"{k} 7 ({size[0]},{size[1]},3)\n" for k in keys)
    return os.path.join(root, "gt"), os.path.join(root, "lq"), meta


@pytest.mark.parametrize("kind", ["Vimeo90KDataset",
                                  "Vimeo90KRecurrentDataset",
                                  "VideoTestVimeo90KDataset"])
def test_vimeo_items_equal_jax(tmp_path, kind):
    gt, lq, meta = write_vimeo(str(tmp_path), ["00001/0001", "00001/0002"],
                               (16, 24), 2)
    opt = {"type": kind, "dataroot_gt": gt, "dataroot_lq": lq,
           "meta_info_file": meta, "num_frame": 5, "scale": 2, "gt_size": 8,
           "phase": "train", "random_reverse": True, "flip_sequence": True}
    compare(opt, seeds=(0, 1, 2))


def write_video_test(root, folders, frames, size, scale):
    for j, folder in enumerate(folders):
        names = [f"{i:08d}.png" for i in range(frames)]
        write_frames(os.path.join(root, "gt", folder), names, size, 50 + j)
        write_frames(os.path.join(root, "lq", folder), names,
                     (size[0] // scale, size[1] // scale), 60 + j)
    return os.path.join(root, "gt"), os.path.join(root, "lq")


@pytest.mark.parametrize("padding", ["replicate", "reflection",
                                     "reflection_circle", "circle"])
def test_video_test_items_equal_jax(tmp_path, padding):
    gt, lq = write_video_test(str(tmp_path), ["calendar", "city"], 6,
                              (16, 16), 2)
    compare({"type": "VideoTestDataset", "dataroot_gt": gt,
             "dataroot_lq": lq, "num_frame": 3, "padding": padding},
            seeds=(0,))
    meta = str(tmp_path / "meta.txt")
    with open(meta, "w") as f:
        f.write("city 6 (16,16,3)\n")
    compare({"type": "VideoTestDataset", "dataroot_lq": lq,
             "meta_info_file": meta, "num_frame": 5, "padding": padding},
            seeds=(0,))


def test_video_test_duf_and_recurrent_items_equal_jax(tmp_path):
    gt, lq = write_video_test(str(tmp_path), ["walk"], 5, (64, 64), 4)
    opt = {"type": "VideoTestDUFDataset", "dataroot_gt": gt,
           "dataroot_lq": lq, "num_frame": 3, "padding": "reflection",
           "scale": 4, "use_duf_downsampling": True}
    compare(opt, seeds=(0,), atol=DUF_ATOL)
    compare({**opt, "use_duf_downsampling": False}, seeds=(0,))
    compare({"type": "VideoRecurrentTestDataset", "dataroot_gt": gt,
             "dataroot_lq": lq}, seeds=(0,))
    compare({"type": "VideoRecurrentTestDataset", "dataroot_lq": lq},
            seeds=(0,))


@pytest.mark.parametrize("need_align", [False, True])
def test_single_vfhq_items_equal_jax(tmp_path, need_align):
    root = str(tmp_path / "vfhq")
    write_frames(os.path.join(root, "clip_a"),
                 [f"{i:08d}.png" for i in range(3)], (48, 48), 70)
    meta = str(tmp_path / "global_meta.txt")
    with open(meta, "w") as f:
        f.write("train/clip_a/3\n")
    info_dir = str(tmp_path / "info")
    os.makedirs(info_dir)
    rng = np.random.default_rng(71)
    with open(os.path.join(info_dir, "clip_a.txt"), "w") as f:
        f.write("header line\n")
        for i in range(3):
            lm = np.array([[18, 20], [30, 20], [24, 27], [19, 33], [29, 33]],
                          np.float64) + rng.normal(0, 1.0, (5, 2))
            f.write(f"{i:08d} " + " ".join(f"{v:.4f}" for v in lm.ravel())
                    + "\n")
    compare({"type": "SingleVFHQDataset", "dataroot_gt": root,
             "global_meta_info_file": meta, "normalize": True,
             "need_align": need_align, "dataroot_meta_info": info_dir},
            seeds=(0, 1, 2))


# ---------------------------------------------------------------------------
# gaussian_kernels
# ---------------------------------------------------------------------------

SAMPLERS = {
    "random_bivariate_skew_Gaussian_center": ((0.6, 3), (0.6, 3),
                                              (-np.pi, np.pi)),
    "random_bivariate_anisotropic_Gaussian": ((0.6, 3), (0.6, 3),
                                              (-np.pi, np.pi)),
    "random_bivariate_isotropic_Gaussian": ((0.6, 3),),
    "random_bivariate_generalized_Gaussian": ((0.6, 3), (0.6, 3),
                                              (-np.pi, np.pi), (0.5, 8)),
    "random_bivariate_plateau_type1": ((0.6, 3), (0.6, 3),
                                       (-np.pi, np.pi), (1, 2)),
    "random_bivariate_plateau_type1_iso": ((0.6, 3), (1, 2)),
}


def _equal_draws(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_draws(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_gaussian_kernel_samplers_equal_jax(name):
    ranges = SAMPLERS[name]
    for seed, strict, noise in ((0, False, None), (1, True, None),
                                (2, False, (0.75, 1.25)),
                                (3, True, (0.75, 1.25))):
        np.random.seed(seed)
        ref = getattr(JG, name)(11, *ranges, noise_range=noise,
                                strict=strict)
        ours = getattr(TG, name)(11, *ranges, noise_range=noise,
                                 strict=strict,
                                 rng=np.random.RandomState(seed))
        _equal_draws(ours, ref)


@pytest.mark.parametrize("kind", ["iso", "aniso", "skew", "generalized",
                                  "plateau_iso", "plateau_aniso"])
def test_gaussian_mixed_kernels_equal_jax(kind):
    kinds = ["iso", "aniso", "skew", "generalized", "plateau_iso",
             "plateau_aniso"]
    probs = [1.0 if k == kind else 0.0 for k in kinds]
    for seed, noise in ((0, None), (1, (0.8, 1.2))):
        random.seed(seed)
        np.random.seed(seed)
        ref = JG.random_mixed_kernels(kinds, probs, 13, noise_range=noise)
        ours = TG.random_mixed_kernels(kinds, probs, 13, noise_range=noise,
                                       rng=np.random.RandomState(seed),
                                       py_rng=random.Random(seed))
        np.testing.assert_array_equal(ours, ref)
        assert ours.shape == (13, 13)
        assert abs(ours.sum() - 1) < 1e-12


def test_gaussian_kernels_unknown_type_and_plain_forms():
    for mod in (TG, JG):
        with pytest.raises(ValueError, match="unknown kernel type"):
            mod.random_mixed_kernels(["disk"], [1.0], 7)
    grid = TG.mesh_grid(9)[0]
    skew = [[0.3, -0.2], [0.1, 0.4]]
    np.testing.assert_array_equal(TG.cdf2(skew, grid), JG.cdf2(skew, grid))
    k = TG.bivariate_skew_Gaussian(9, 1.5, 0.8, 0.3, skew)
    np.testing.assert_array_equal(k, JG.bivariate_skew_Gaussian(
        9, 1.5, 0.8, 0.3, skew))
    assert TG.mass_center_shift(9, k) == JG.mass_center_shift(9, k)
    with pytest.raises(ValueError, match="odd"):
        TG.random_bivariate_isotropic_Gaussian(8, (1, 2))


# ---------------------------------------------------------------------------
# lmdb, on a stand-in for the lmdb package
# ---------------------------------------------------------------------------

class _StandInEnv:
    """lmdb.Environment's surface that the two packages use, over a dict
    pickled to <path>/data.mdb at each commit."""

    def __init__(self, path, map_size=None, readonly=False, lock=True,
                 readahead=True, **kwargs):
        self.file = os.path.join(path, "data.mdb")
        if readonly and not os.path.exists(self.file):
            raise FileNotFoundError(path)
        os.makedirs(path, exist_ok=True)
        self.data = {}
        if os.path.exists(self.file):
            with open(self.file, "rb") as f:
                self.data = pickle.load(f)

    def begin(self, write=False):
        return _StandInTxn(self, write)

    def close(self):
        pass


class _StandInTxn:
    def __init__(self, env, write):
        self.env, self.write, self.pending = env, write, {}

    def put(self, key, value):
        assert self.write
        self.pending[bytes(key)] = bytes(value)
        return True

    def get(self, key):
        return self.env.data.get(bytes(key))

    def commit(self):
        self.env.data.update(self.pending)
        self.pending = {}
        with open(self.env.file, "wb") as f:
            pickle.dump(self.env.data, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.write:
            self.commit()


@pytest.fixture
def lmdb_stand_in(monkeypatch):
    mod = types.ModuleType("lmdb")
    mod.open = _StandInEnv
    monkeypatch.setitem(sys.modules, "lmdb", mod)
    return mod


def write_lmdb_sources(root):
    """Colour, gray and RGBA PNGs (written by cv2)."""
    os.makedirs(root)
    rng = np.random.default_rng(80)
    imgs = {"c0": smooth_u8(rng, (12, 10, 3)), "c1": smooth_u8(rng, (9, 7, 3)),
            "g0": smooth_u8(rng, (8, 8)),
            "a0": smooth_u8(rng, (6, 5, 4))}
    for k, v in imgs.items():
        cv2.imwrite(os.path.join(root, f"{k}.png"), v)
    return imgs


def _meta(path):
    with open(os.path.join(path, "meta_info.txt")) as f:
        return f.read()


@pytest.mark.parametrize("threads", [False, True])
def test_lmdb_builder_equals_jax(tmp_path, lmdb_stand_in, threads):
    src = str(tmp_path / "src")
    imgs = write_lmdb_sources(src)
    keys = sorted(imgs)
    names = [f"{k}.png" for k in keys]
    ours, ref = str(tmp_path / "ours.lmdb"), str(tmp_path / "ref.lmdb")
    tlmdb.make_lmdb_from_imgs(src, ours, names, keys, batch=2,
                              compress_level=3, multiprocessing_read=threads,
                              n_thread=2)
    jlmdb.make_lmdb_from_imgs(src, ref, names, keys, batch=2,
                              compress_level=3)
    assert _meta(ours) == _meta(ref)
    for o, r, k in zip(tlmdb.imgs_from_lmdb(ours, keys),
                       jlmdb.imgs_from_lmdb(ref, keys), keys):
        np.testing.assert_array_equal(o, r, err_msg=k)
        np.testing.assert_array_equal(o, imgs[k], err_msg=k)
    # either package reads the other's database
    for o, r in zip(tlmdb.imgs_from_lmdb(ref, keys),
                    jlmdb.imgs_from_lmdb(ours, keys)):
        np.testing.assert_array_equal(o, r)
    assert tutil.paths_from_lmdb(ours) == jutil.paths_from_lmdb(ref) == keys
    assert tutil.paired_paths_from_lmdb([ours, ref], ["lq", "gt"]) == \
        jutil.paired_paths_from_lmdb([ours, ref], ["lq", "gt"])
    with pytest.raises(ValueError, match="end with '.lmdb'"):
        tlmdb.LmdbMaker(str(tmp_path / "x"))


def test_lmdb_file_client_and_flow_builder_equal_jax(tmp_path,
                                                     lmdb_stand_in):
    src = str(tmp_path / "src")
    imgs = write_lmdb_sources(src)
    colour = ["c0", "c1"]
    a, b = str(tmp_path / "a.lmdb"), str(tmp_path / "b.lmdb")
    tflow.make_lmdb_from_imgs(src, a, [f"{k}.png" for k in colour], colour,
                              batch=1)
    jflow.make_lmdb_from_imgs(src, b, [f"{k}.png" for k in colour], colour,
                              batch=1)
    assert _meta(a) == _meta(b)
    ours = tfc.FileClient("lmdb", db_paths=[a, b], client_keys=["a", "b"])
    ref = jfc.FileClient("lmdb", db_paths=[a, b], client_keys=["a", "b"])
    for key in colour:
        for ck in ("a", "b"):
            got = tfc.imfrombytes(ours.get(key, ck), float32=True)
            want = jfc.imfrombytes(ref.get(key, ck), float32=True)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tfc.imfrombytes(ours.get(key, ck)), imgs[key])
    with pytest.raises(ValueError, match="same length"):
        tfc.FileClient("lmdb", db_paths=[a], client_keys=["a", "b"])


def test_lmdb_forms_name_the_missing_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb package"):
        tfc.FileClient("lmdb", db_paths=str(tmp_path / "x.lmdb"))
    with pytest.raises(ImportError, match="lmdb package"):
        tlmdb.make_lmdb_from_imgs(str(tmp_path), str(tmp_path / "y.lmdb"),
                                  ["a.png"], ["a"])
