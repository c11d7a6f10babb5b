"""Training and test datasets (reference wm_basicsr/data/*_dataset.py),
ported from comfyui_keep_tpu/data/datasets.py, each registered under the
JAX registry's name: the KEEP training data, VFHQRealDegradationDataset
(reference vfhq_real_degradation2_dataset.py:22-410) and
SingleVFHQDataset; the image sets of SR training and validation
(PairedImageDataset, SingleImageDataset, FFHQDataset, RealESRGANDataset,
RealESRGANPairedDataset); the video sets (REDS, Vimeo90K, their recurrent
forms and the video test sets).

A dataset that draws owns its streams, a random.Random and a
np.random.RandomState that the loader seeds (seed_streams), and draws from
them in the JAX package's order, which draws from Python's and numpy's
global streams: seeded alike, the two give the same items.

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
                                                  circular_lowpass_kernel,
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


@DATASET_REGISTRY.register(name="FFHQDataset")
class FFHQDataset(_Streams):
    """A flat folder of face PNGs (reference ffhq_dataset.py): each item
    flipped with use_hflip (the dataset's Python stream), RGB, normalised
    by mean / std (default 0.5 each, i.e. to [-1, 1]). {"gt" (H, W, 3)
    float32, "gt_path"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.paths = [os.path.join(self.gt_folder, p)
                      for p in scandir(self.gt_folder)]
        self.mean = opt.get("mean", (0.5, 0.5, 0.5))
        self.std = opt.get("std", (0.5, 0.5, 0.5))
        self.seed_streams(0)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        img = augment(_read_img(self.paths[index]),
                      self.opt.get("use_hflip", True), False,
                      rng=self.py_rng)
        img = (img[..., ::-1] - np.asarray(self.mean)) / np.asarray(self.std)
        return {"gt": img.astype(np.float32), "gt_path": self.paths[index]}


def _rgb_stack(frames):
    """BGR frames -> (T, H, W, 3) float32 RGB."""
    return np.stack([v[..., ::-1] for v in frames]).astype(np.float32)


@DATASET_REGISTRY.register(name="VideoTestDataset")
class VideoTestDataset:
    """The sliding-window test set (reference video_test_dataset.py:14-131):
    one item per frame, the num_frame LQ window around it picked by
    generate_frame_indices with `padding`, the frame's GT when dataroot_gt
    is given, and the reference's bookkeeping: folder, idx "i/n", border
    (1 within num_frame // 2 of either end). The folders are the first
    path part of each meta_info_file line, else dataroot_lq's
    subdirectories. {"lq" (T, H, W, 3), "gt" (H, W, 3) RGB float32,
    "folder", "idx", "border"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt.get("dataroot_gt")
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 5)
        self.padding = opt.get("padding", "reflection_circle")
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"]) as f:
                self.folders = sorted({line.split()[0].split("/")[0]
                                       for line in f if line.strip()})
        else:
            self.folders = sorted(
                d for d in os.listdir(self.lq_root)
                if os.path.isdir(os.path.join(self.lq_root, d)))
        self.items = []          # (folder, frame index, frames, border)
        self.frame_paths = {}
        for folder in self.folders:
            paths = scandir(os.path.join(self.lq_root, folder))
            self.frame_paths[folder] = paths
            n, half = len(paths), self.num_frame // 2
            self.items.extend((folder, i, n, int(i < half or i >= n - half))
                              for i in range(n))

    def __len__(self):
        return len(self.items)

    def _window(self, index):
        from comfyui_keep_torch.data.util import generate_frame_indices
        folder, idx, n, border = self.items[index]
        select = generate_frame_indices(idx, n, self.num_frame,
                                        padding=self.padding)
        return folder, idx, n, border, select

    def _gt(self, folder, i):
        paths = scandir(os.path.join(self.gt_root, folder))
        return _read_img(os.path.join(self.gt_root, folder, paths[i]))

    def __getitem__(self, index):
        folder, idx, n, border, select = self._window(index)
        paths = self.frame_paths[folder]
        out = {"lq": _rgb_stack(_read_img(os.path.join(
                   self.lq_root, folder, paths[i])) for i in select),
               "folder": folder, "idx": f"{idx}/{n}", "border": border}
        if self.gt_root:
            out["gt"] = self._gt(folder, idx)[..., ::-1].astype(
                np.float32).copy()
        return out


@DATASET_REGISTRY.register(name="VideoTestDUFDataset")
class VideoTestDUFDataset(VideoTestDataset):
    """VideoTestDataset for DUF (reference video_test_dataset.py:202-249):
    with use_duf_downsampling the LQ window is made from the GT frames by
    data/util.py:duf_downsample (13-tap Gaussian, `scale`), and the GT is
    the window's centre frame."""

    def __getitem__(self, index):
        if not self.opt.get("use_duf_downsampling"):
            return super().__getitem__(index)
        from comfyui_keep_torch.data.util import duf_downsample
        folder, idx, n, border, select = self._window(index)
        gts = _rgb_stack(self._gt(folder, i) for i in select)
        lq = duf_downsample(torch.from_numpy(gts), kernel_size=13,
                            scale=self.opt.get("scale", 4)).numpy()
        return {"lq": lq.astype(np.float32), "folder": folder,
                "idx": f"{idx}/{n}", "border": border,
                "gt": gts[len(select) // 2]}


@DATASET_REGISTRY.register(name="VideoRecurrentTestDataset")
class VideoRecurrentTestDataset:
    """Whole clips for recurrent nets (reference video_test_dataset.py:
    252-284): one item per dataroot_lq subfolder, {"lq" (T, H, W, 3), "gt"
    (T, sH, sW, 3) when dataroot_gt is given, "folder"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt.get("dataroot_gt")
        self.lq_root = opt["dataroot_lq"]
        self.folders = sorted(
            d for d in os.listdir(self.lq_root)
            if os.path.isdir(os.path.join(self.lq_root, d)))

    def __len__(self):
        return len(self.folders)

    def __getitem__(self, index):
        folder = self.folders[index]
        out = {"folder": folder}
        for key, root in (("lq", self.lq_root), ("gt", self.gt_root)):
            if root:
                d = os.path.join(root, folder)
                out[key] = _rgb_stack(_read_img(os.path.join(d, p))
                                      for p in scandir(d))
        return out


@DATASET_REGISTRY.register(name="VideoTestVimeo90KDataset")
class VideoTestVimeo90KDataset:
    """Vimeo90K-Test (reference video_test_dataset.py:134-199): one item a
    meta_info_file key, the num_frame LQ window of im1..im7 centred on im4
    and the GT im4. {"lq", "gt", "folder", "idx", "border" (0)}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 7)
        with open(opt["meta_info_file"]) as f:
            self.keys = [line.split()[0] for line in f if line.strip()]
        self.neighbor_list = [i + (9 - self.num_frame) // 2
                              for i in range(self.num_frame)]

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        key = self.keys[index]
        lq = _rgb_stack(_read_img(os.path.join(self.lq_root, key,
                                               f"im{i}.png"))
                        for i in self.neighbor_list)
        gt = _read_img(os.path.join(self.gt_root, key, "im4.png"))[..., ::-1]
        return {"lq": lq, "gt": gt.astype(np.float32).copy(),
                "folder": key, "idx": f"{index}/{len(self.keys)}",
                "border": 0}


def _clip_keys(meta_info_file):
    """{clip: frame count} and the per-frame keys "clip/%08d" of a REDS
    meta_info_file (lines "<clip> <frames> ...")."""
    lengths, keys = {}, []
    with open(meta_info_file) as f:
        for line in f:
            if not line.strip():
                continue
            clip, n_frames = line.split()[:2]
            lengths[clip] = int(n_frames)
            keys.extend(f"{clip}/{i:08d}" for i in range(int(n_frames)))
    return lengths, keys


@DATASET_REGISTRY.register(name="REDSDataset")
class REDSDataset(_Streams):
    """REDS sliding windows (reference reds_dataset.py): keys "clip/frame",
    the num_frame neighbours of the key frame at an interval from
    interval_list (the centre moved inside the clip if the window leaves
    it), reversed with random_reverse, and the centre frame's GT; phase
    "train" crops gt_size (the LQ's at gt_size / scale) and flips /
    rotates. Draws from the dataset's Python stream in the JAX package's
    order. {"lq" (T, H, W, 3), "gt" (sH, sW, 3) RGB float32, "key"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 5)
        self.num_half = self.num_frame // 2
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)
        self.scale = opt.get("scale", 4)
        self.keys = _clip_keys(opt["meta_info_file"])[1]
        self.seed_streams(0)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        py = self.py_rng
        clip, frame = self.keys[index].rsplit("/", 1)
        center = int(frame)
        interval = py.choice(self.interval_list)
        reach = self.num_half * interval
        total = len(scandir(os.path.join(self.gt_root, clip)))
        while center - reach < 0 or center + reach >= total:
            center = py.randint(reach, total - 1 - reach)
        neighbors = list(range(center - reach, center + reach + 1, interval))
        if self.random_reverse and py.random() < 0.5:
            neighbors.reverse()
        lqs = [_read_img(os.path.join(self.lq_root, clip, f"{i:08d}.png"))
               for i in neighbors]
        gt = _read_img(os.path.join(self.gt_root, clip, f"{center:08d}.png"))
        if self.opt.get("phase") == "train":
            gt, lqs = paired_random_crop(gt, lqs, self.opt.get("gt_size", 256),
                                         self.scale, rng=py)
            out = augment([gt] + lqs, self.opt.get("use_hflip", True),
                          self.opt.get("use_rot", True), rng=py)
            gt, lqs = out[0], out[1:]
        return {"lq": _rgb_stack(lqs),
                "gt": gt[..., ::-1].astype(np.float32).copy(),
                "key": self.keys[index]}


@DATASET_REGISTRY.register(name="REDSRecurrentDataset")
class REDSRecurrentDataset(_Streams):
    """REDS for recurrent nets (reference reds_dataset.py:209-345): per-frame
    keys without (or, with test_mode, only) the val_partition clips (REDS4:
    000, 011, 015, 020; official: 240-269); an item is the num_frame paired
    LQ / GT frames from the key frame at an interval from interval_list
    (the start redrawn when the window would pass the clip's end),
    reversed with random_reverse; phase "train" (the default) crops
    gt_size and flips / rotates them alike. Draws from the dataset's
    Python stream in the JAX package's order. {"lq" (T, H, W, 3), "gt"
    (T, sH, sW, 3) RGB float32, "key"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 15)
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)
        self.scale = opt.get("scale", 4)
        self.clip_len, keys = _clip_keys(opt["meta_info_file"])
        part = opt.get("val_partition", "REDS4")
        if part == "REDS4":
            val = {"000", "011", "015", "020"}
        elif part == "official":
            val = {f"{v:03d}" for v in range(240, 270)}
        else:
            raise ValueError(f"Wrong validation partition {part}. "
                             "Supported ones are ['official', 'REDS4'].")
        test = bool(opt.get("test_mode"))
        self.keys = [k for k in keys if (k.split("/")[0] in val) == test]
        self.seed_streams(0)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        py = self.py_rng
        clip, frame = self.keys[index].rsplit("/", 1)
        interval = py.choice(self.interval_list)
        span = self.num_frame * interval
        start = int(frame)
        if start > self.clip_len[clip] - span:
            start = py.randint(0, self.clip_len[clip] - span)
        neighbors = list(range(start, start + span, interval))
        if self.random_reverse and py.random() < 0.5:
            neighbors.reverse()
        lqs = [_read_img(os.path.join(self.lq_root, clip, f"{i:08d}.png"))
               for i in neighbors]
        gts = [_read_img(os.path.join(self.gt_root, clip, f"{i:08d}.png"))
               for i in neighbors]
        if self.opt.get("phase", "train") == "train":
            gts, lqs = paired_random_crop(gts, lqs,
                                          self.opt.get("gt_size", 256),
                                          self.scale, rng=py)
            out = augment(gts + lqs, self.opt.get("use_hflip", True),
                          self.opt.get("use_rot", True), rng=py)
            gts, lqs = out[:self.num_frame], out[self.num_frame:]
        return {"lq": _rgb_stack(lqs), "gt": _rgb_stack(gts),
                "key": self.keys[index]}


@DATASET_REGISTRY.register(name="Vimeo90KDataset")
class Vimeo90KDataset(_Streams):
    """Vimeo90K septuplets (reference vimeo90k_dataset.py): meta_info_file
    keys "clip/seq", the num_frame LQ frames of im1..im7 centred on im4 and
    the GT im4; phase "train" crops and flips / rotates (the dataset's
    Python stream). {"lq" (T, H, W, 3), "gt" (sH, sW, 3), "key"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.lq_root = opt["dataroot_lq"]
        self.num_frame = opt.get("num_frame", 7)
        self.scale = opt.get("scale", 4)
        with open(opt["meta_info_file"]) as f:
            self.keys = [line.split()[0] for line in f if line.strip()]
        self.neighbor_list = [i + (9 - self.num_frame) // 2
                              for i in range(self.num_frame)]
        self.seed_streams(0)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        key = self.keys[index]
        lqs = [_read_img(os.path.join(self.lq_root, key, f"im{i}.png"))
               for i in self.neighbor_list]
        gt = _read_img(os.path.join(self.gt_root, key, "im4.png"))
        if self.opt.get("phase") == "train":
            gt, lqs = paired_random_crop(gt, lqs, self.opt.get("gt_size", 256),
                                         self.scale, rng=self.py_rng)
            out = augment([gt] + lqs, self.opt.get("use_hflip", True),
                          self.opt.get("use_rot", True), rng=self.py_rng)
            gt, lqs = out[0], out[1:]
        return {"lq": _rgb_stack(lqs),
                "gt": gt[..., ::-1].astype(np.float32).copy(), "key": key}


@DATASET_REGISTRY.register(name="Vimeo90KRecurrentDataset")
class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    """Vimeo90K for recurrent nets (reference vimeo90k_dataset.py:120-198):
    the paired LQ / GT frames of the window, reversed with random_reverse,
    cropped and flipped / rotated alike in phase "train" (the default), and
    with flip_sequence mirrored to twice the frames. {"lq", "gt" (T, ...),
    "key"}."""

    def __init__(self, opt: Dict):
        super().__init__(opt)
        self.flip_sequence = opt.get("flip_sequence", False)
        self.random_reverse = opt.get("random_reverse", False)

    def __getitem__(self, index):
        key = self.keys[index]
        neighbors = list(self.neighbor_list)
        if self.random_reverse and self.py_rng.random() < 0.5:
            neighbors.reverse()
        lqs = [_read_img(os.path.join(self.lq_root, key, f"im{i}.png"))
               for i in neighbors]
        gts = [_read_img(os.path.join(self.gt_root, key, f"im{i}.png"))
               for i in neighbors]
        if self.opt.get("phase", "train") == "train":
            gts, lqs = paired_random_crop(gts, lqs,
                                          self.opt.get("gt_size", 256),
                                          self.scale, rng=self.py_rng)
            out = augment(gts + lqs, self.opt.get("use_hflip", True),
                          self.opt.get("use_rot", True), rng=self.py_rng)
            gts, lqs = out[:len(neighbors)], out[len(neighbors):]
        lq, gt = _rgb_stack(lqs), _rgb_stack(gts)
        if self.flip_sequence:
            lq = np.concatenate([lq, lq[::-1]], axis=0)
            gt = np.concatenate([gt, gt[::-1]], axis=0)
        return {"lq": lq, "gt": gt, "key": key}


@DATASET_REGISTRY.register(name="RealESRGANDataset")
class RealESRGANDataset(_Streams):
    """Real-ESRGAN's inputs (reference realesrgan_dataset.py): the GT image,
    flipped / rotated, and the blur kernels of the degradation that the
    trainer's feed runs on the card (training/realesrgan_feed.py): two
    kernels, each a sinc (sinc_prob) or one of degradations'
    random_mixed_kernels (kernel_list, kernel_prob, blur_sigma, with the
    "2" options for the second), of a size in 7..21 zero-padded to 21,
    and a final sinc kernel (final_sinc_prob, else the identity). The
    sizes come from the dataset's Python stream, the rest from its numpy
    RandomState, in the JAX package's order (which draws from the global
    streams, and each mixed kernel from a fresh default_rng() where this
    takes the RandomState). {"gt" (H, W, 3) RGB float32, "kernel1",
    "kernel2", "sinc_kernel" (21, 21) float32, "gt_path"}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.paths = [os.path.join(self.gt_folder, p)
                      for p in scandir(self.gt_folder)]
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]
        self.seed_streams(0)

    def __len__(self):
        return len(self.paths)

    def _kernel(self, suffix: str):
        o, nr = self.opt, self.np_rng
        ks = self.py_rng.choice(self.kernel_range)
        if nr.uniform() < o.get(f"sinc_prob{suffix}", 0.1):
            omega_c = nr.uniform(np.pi / 3 if ks < 13 else np.pi / 5, np.pi)
            k = circular_lowpass_kernel(omega_c, ks)
        else:
            sigma = o.get(f"blur_sigma{suffix}", [0.2, 3])
            k = random_mixed_kernels(
                o.get(f"kernel_list{suffix}",
                      ["iso", "aniso", "generalized_iso", "generalized_aniso",
                       "plateau_iso", "plateau_aniso"]),
                o.get(f"kernel_prob{suffix}",
                      [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]),
                ks, sigma, sigma, rng=nr)
        pad = (21 - ks) // 2
        return np.pad(k, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index):
        gt = augment(_read_img(self.paths[index]),
                     self.opt.get("use_hflip", True),
                     self.opt.get("use_rot", True), rng=self.py_rng)
        kernel1 = self._kernel("")
        kernel2 = self._kernel("2")
        if self.np_rng.uniform() < self.opt.get("final_sinc_prob", 0.8):
            ks = self.py_rng.choice(self.kernel_range)
            sinc = circular_lowpass_kernel(
                self.np_rng.uniform(np.pi / 3, np.pi), ks,
                pad_to=21).astype(np.float32)
        else:
            sinc = np.zeros((21, 21), np.float32)
            sinc[10, 10] = 1
        return {"gt": gt[..., ::-1].astype(np.float32).copy(),
                "kernel1": kernel1, "kernel2": kernel2, "sinc_kernel": sinc,
                "gt_path": self.paths[index]}


@DATASET_REGISTRY.register(name="RealESRGANPairedDataset")
class RealESRGANPairedDataset(PairedImageDataset):
    """Real-ESRGAN's paired set (reference realesrgan_paired_dataset.py):
    PairedImageDataset's reads, crops and flips."""


@DATASET_REGISTRY.register(name="SingleVFHQDataset")
class SingleVFHQDataset(_Streams):
    """Single VFHQ GT frames (reference vfhq_real_degradation2_dataset.py:
    23-147): the keys "clip/%08d length/%08d frame" of every frame of the
    clips in global_meta_info_file (lines "<clip path>/<length>"), each
    frame read through the io_backend's FileClient, with need_align aligned
    to the FFHQ template by its landmarks (dataroot_meta_info/<clip>.txt,
    the lines starting with "0", five x y pairs after the first word;
    facelib/helper.py:FaceAligner on the CPU), flipped / rotated (the
    dataset's Python stream), and with `normalize` mapped to [-1, 1].
    {"in", "gt" (the same (H, W, 3) float32 frame), "key"}: the
    degradation is left to the model."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root = opt["dataroot_gt"]
        self.normalize = opt.get("normalize", False)
        self.need_align = opt.get("need_align", False)
        self.keys = []
        with open(opt["global_meta_info_file"]) as fin:
            for line in fin:
                line = line.strip()
                if not line:
                    continue
                clip_path = "/".join(line.split("/")[:-1])
                clip_length = int(line.split("/")[-1])
                self.keys.extend(f"{clip_path}/{clip_length:08d}/{i:08d}"
                                 for i in range(clip_length))
        io = dict(opt.get("io_backend", {"type": "disk"}))
        self.file_client = FileClient(io.pop("type"), **io)
        if self.need_align:
            from comfyui_keep_torch.facelib.helper import FaceAligner
            self.dataroot_meta_info = opt["dataroot_meta_info"]
            self.face_aligner = FaceAligner(upscale_factor=1, face_size=512,
                                            crop_ratio=(1, 1), device="cpu")
        self.seed_streams(0)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        key = self.keys[index]
        clip_name = key.split("/")[-3]
        frame_idx = int(key.split("/")[-1])
        frame_dir = os.path.join(self.gt_root, clip_name)
        paths = sorted(os.listdir(frame_dir))
        img_gt = imfrombytes(self.file_client.get(
            os.path.join(frame_dir, paths[frame_idx]), "gt"), float32=True)
        if self.need_align:
            info = os.path.join(self.dataroot_meta_info, f"{clip_name}.txt")
            with open(info, encoding="utf-8") as f:
                clip_info = [ln.strip() for ln in f
                             if ln.strip().startswith("0")]
            lm = np.array([float(v) for v in
                           clip_info[frame_idx].split(" ")[1:]]).reshape(5, 2)
            img_gt = self.face_aligner.align_single_face(img_gt, lm)
        img_gt = augment(img_gt, self.opt.get("use_flip", True),
                         self.opt.get("use_rot", True), rng=self.py_rng)
        if self.normalize:
            img_gt = (img_gt - 0.5) / 0.5
        img = np.ascontiguousarray(img_gt, np.float32)
        return {"in": img, "gt": img.copy(), "key": key}
