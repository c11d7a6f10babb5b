"""Training datasets (reference wm_basicsr/data/*_dataset.py), ported from
comfyui_keep_tpu/data/datasets.py: the KEEP training data,
VFHQRealDegradationDataset (reference vfhq_real_degradation2_
dataset.py:22-410), and the image pairs of SR training and validation,
PairedImageDataset and SingleImageDataset; the other datasets are ROADMAP
Queue 1 item 6.7.

Items are numpy NHWC float32 dicts, batched by data/prefetch.py. Frames are
PNG, read by utils/png.py (the card machine has no OpenCV), and the
degradation chain's OpenCV calls are utils/cvops.py's.
"""
import os
import random
from typing import Dict

import numpy as np
import torch

from comfyui_keep_torch.data.degradations import (add_video_compression,
                                                  random_add_gaussian_noise,
                                                  random_mixed_kernels)
from comfyui_keep_torch.data.transforms import augment, paired_random_crop
from comfyui_keep_torch.utils import cvops, png
from comfyui_keep_torch.utils.file_client import FileClient, imfrombytes
from comfyui_keep_torch.utils.registry import DATASET_REGISTRY

# cv2.INTER_AREA / INTER_LINEAR / INTER_CUBIC of float32 frames, in the
# order of resize_prob
RESIZES = (cvops.resize_area_f32, cvops.resize_linear_f32,
           cvops.resize_cubic_f32)


def scandir(path, suffix=None, recursive=False):
    """Sorted file paths under `path`, relative to it (the top level only
    unless recursive), optionally those ending in `suffix`."""
    out = []
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if suffix is None or f.endswith(suffix):
                out.append(os.path.relpath(os.path.join(root, f), path))
        if not recursive:
            break
    return sorted(out)


def _normalize_pm1(x):
    return (x - 0.5) / 0.5


def _read_img(path):
    """cv2.imread(path) / 255 of a PNG: (H, W, 3) float32 BGR in [0, 1]."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return png.imread_bgr(path).astype(np.float32) / 255.0


class _Streams:
    """A dataset's own random.Random and np.random.RandomState, which the
    loader seeds (seed_streams) as np.random.seed / random.seed seed the
    global streams the JAX package draws from."""

    def seed_streams(self, seed: int):
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)


@DATASET_REGISTRY.register(name="PairedImageDataset")
class PairedImageDataset(_Streams):
    """GT / LQ PNG pairs of one name in dataroot_gt and dataroot_lq
    (reference paired_image_dataset.py). phase "train": a random gt_size
    crop (the LQ's at gt_size / scale), then flips and rotation
    (use_hflip, use_rot), drawn from the dataset's Python stream. Items:
    {"lq", "gt" (H, W, 3) RGB float32 in [0, 1], "lq_path", "gt_path"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.lq_folder = opt["dataroot_lq"]
        self.paths = [{"gt_path": os.path.join(self.gt_folder, p),
                       "lq_path": os.path.join(self.lq_folder, p)}
                      for p in scandir(self.gt_folder)]
        self.scale = opt.get("scale", 1)
        self.seed_streams(0)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        d = self.paths[index]
        img_gt, img_lq = _read_img(d["gt_path"]), _read_img(d["lq_path"])
        if self.opt.get("phase") == "train":
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, self.opt["gt_size"], self.scale,
                rng=self.py_rng)
            img_gt, img_lq = augment([img_gt, img_lq],
                                     self.opt.get("use_hflip", True),
                                     self.opt.get("use_rot", True),
                                     rng=self.py_rng)
        return {"lq": img_lq[..., ::-1].copy(), "gt": img_gt[..., ::-1].copy(),
                "lq_path": d["lq_path"], "gt_path": d["gt_path"]}


@DATASET_REGISTRY.register(name="SingleImageDataset")
class SingleImageDataset:
    """The PNGs of dataroot_lq: {"lq" (H, W, 3) RGB float32 in [0, 1],
    "lq_path"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.lq_folder = opt["dataroot_lq"]
        self.paths = [os.path.join(self.lq_folder, p)
                      for p in scandir(self.lq_folder)]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        return {"lq": _read_img(self.paths[index])[..., ::-1].copy(),
                "lq_path": self.paths[index]}


def _frames(fn, imgs):
    """fn over a list of float32 numpy frames, through torch CPU tensors."""
    return [fn(torch.from_numpy(np.ascontiguousarray(v))).numpy()
            for v in imgs]


@DATASET_REGISTRY.register(name="VFHQRealDegradationDataset")
class VFHQRealDegradationDataset:
    """KEEP training clips with online degradation.

    meta_info_file lines: `<clip_rel_path>/<clip_length>/<frame_idx>`;
    frames live in `dataroot_gt/<clip_name>/*.png`. An item: a num_frame
    window around frame_idx (interval from interval_list, moved inside the
    clip if needed, reversed with random_reverse), flipped / rotated
    alike, then blur (one random kernel, cv2.filter2D's reflect-101
    border) -> Gaussian noise -> downscale by `scale` (area, linear or
    cubic by resize_prob) -> Gaussian noise -> video compression (CRF from
    crf_range) -> RGB, normalised to [-1, 1]. {"lq": (T, H/scale, W/scale,
    3), "gt": (T, H, W, 3), "key"}.

    The random draws come from a random.Random and a np.random.RandomState
    that the dataset owns, in the JAX package's order (it draws from
    Python's and numpy's global streams, and a fresh default_rng() per
    kernel and noise, where this takes the RandomState): seeded alike, the
    two give the same degradations. The loader seeds them
    (seed_streams)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.num_frame = opt.get("num_frame", 8)
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)
        self.scale = opt.get("scale", 4)
        self.kernel_list = opt.get("kernel_list",
                                   ["iso", "aniso", "generalized_iso",
                                    "generalized_aniso", "plateau_iso",
                                    "plateau_aniso"])
        self.kernel_prob = opt.get("kernel_prob",
                                   [0.405, 0.225, 0.108, 0.027, 0.108, 0.027])
        self.blur_kernel_size = opt.get("blur_kernel_size", 21)
        self.blur_x_sigma = opt.get("blur_x_sigma", [0.2, 3])
        self.blur_y_sigma = opt.get("blur_y_sigma", [0.2, 3])
        self.noise_range = opt.get("noise_range", [0, 10])
        self.crf_range = opt.get("crf_range", [18, 35])
        self.vcodec = opt.get("vcodec", ["libx264"])
        self.vcodec_prob = opt.get("vcodec_prob", [1.0])
        self.resize_prob = opt.get("resize_prob", [0.3, 0.4, 0.3])
        self.normalize = opt.get("normalize", True)
        io = dict(opt.get("io_backend", {"type": "disk"}))
        self.file_client = FileClient(io.pop("type"), **io)
        with open(opt["meta_info_file"]) as f:
            self.keys = [line.strip() for line in f if line.strip()]
        self.seed_streams(0)

    def seed_streams(self, seed: int):
        """Seed the dataset's Python and numpy streams (as random.seed and
        np.random.seed seed the global ones)."""
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.keys)

    def _read(self, path):
        return imfrombytes(self.file_client.get(path), float32=True)

    def __getitem__(self, index):
        py, nr = self.py_rng, self.np_rng
        key = self.keys[index]
        clip_length = int(key.split("/")[-2])
        frame_idx = int(key.split("/")[-1])
        clip_name = "/".join(key.split("/")[:-2]).split("/")[-1]
        paths = scandir(os.path.join(self.gt_root, clip_name))

        interval = py.choice(self.interval_list)
        while (clip_length - self.num_frame * interval) < 0:
            interval = py.choice(self.interval_list)
        half = self.num_frame // 2 * interval
        start, end = frame_idx - half, frame_idx + half
        while start < 0 or end > clip_length:
            frame_idx = py.randint(half, clip_length - half)
            start, end = frame_idx - half, frame_idx + half
        neighbors = list(range(start, end, interval))
        if self.random_reverse and py.random() < 0.5:
            neighbors.reverse()
        if len(neighbors) != self.num_frame:
            raise ValueError(f"{key}: {len(neighbors)} frames, want "
                             f"{self.num_frame}")

        img_gts = [self._read(os.path.join(self.gt_root, clip_name,
                                           paths[n])) for n in neighbors]
        img_gts = augment(img_gts, self.opt.get("use_flip", True),
                          self.opt.get("use_rot", True), rng=py)

        kernel = random_mixed_kernels(self.kernel_list, self.kernel_prob,
                                      self.blur_kernel_size,
                                      self.blur_x_sigma, self.blur_y_sigma,
                                      rng=nr)
        img_lqs = _frames(lambda v: cvops.filter2d_f32(v, kernel), img_gts)
        img_lqs = [random_add_gaussian_noise(v, self.noise_range,
                                             gray_prob=0.5, rng=nr)
                   for v in img_lqs]
        oh, ow = img_gts[0].shape[:2]
        resize = py.choices(RESIZES, self.resize_prob)[0]
        rh, rw = int(oh // self.scale), int(ow // self.scale)
        img_lqs = _frames(lambda v: resize(v, (rw, rh)), img_lqs)
        img_lqs = [random_add_gaussian_noise(v, self.noise_range,
                                             gray_prob=0.5, rng=nr)
                   for v in img_lqs]
        crf = nr.randint(self.crf_range[0], self.crf_range[1])
        codec = py.choices(self.vcodec, self.vcodec_prob)[0]
        img_lqs = add_video_compression(img_lqs, codec=codec, crf=crf)

        gt = np.stack([v[..., ::-1] for v in img_gts]).astype(np.float32)
        lq = np.stack([v[..., ::-1] for v in img_lqs]).astype(np.float32)
        if self.normalize:
            gt = _normalize_pm1(gt)
            lq = _normalize_pm1(lq)
        return {"lq": lq, "gt": gt, "key": key}


# the reference registers the class as 'VFHQDataset'
# (vfhq_real_degradation2_dataset.py:149), the JAX package under both names
DATASET_REGISTRY.register(VFHQRealDegradationDataset, name="VFHQDataset")
