"""Dataset paths and frame helpers (reference wm_basicsr/data/data_util.py),
ported from comfyui_keep_tpu/data/util.py: NHWC layouts as the JAX package
keeps them, frames read through utils/png.py. The lmdb forms read the
meta_info.txt that utils/lmdb_util.py writes beside the database."""
import os.path as osp
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from comfyui_keep_torch.data.datasets import scandir
from comfyui_keep_torch.data.transforms import mod_crop
from comfyui_keep_torch.utils import png


def read_img_seq(path, require_mod_crop: bool = False, scale: int = 1,
                 return_imgname: bool = False):
    """A frame directory (or a list of PNG paths, sorted) -> (T, H, W, 3)
    float32 RGB in [0, 1] (mod-cropped to `scale` if asked), and with
    return_imgname the frames' names without extension."""
    paths = sorted(path) if isinstance(path, (list, tuple)) \
        else [osp.join(path, p) for p in scandir(path)]
    imgs = [png.imread_bgr(p).astype(np.float32) / 255.0 for p in paths]
    if require_mod_crop:
        imgs = [mod_crop(img, scale) for img in imgs]
    out = np.stack([img[..., ::-1] for img in imgs], axis=0)
    if return_imgname:
        return out, [osp.splitext(osp.basename(p))[0] for p in paths]
    return out


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = "reflection") -> List[int]:
    """The num_frames (odd) indices around crt_idx, padded at the clip's
    ends by 'replicate', 'reflection', 'reflection_circle' or 'circle'."""
    if num_frames % 2 != 1:
        raise ValueError("num_frames should be an odd number.")
    if padding not in ("replicate", "reflection", "reflection_circle",
                       "circle"):
        raise ValueError(f"Wrong padding mode: {padding}.")
    max_frame_num = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            pad_idx = {"replicate": 0, "reflection": -i,
                       "reflection_circle": crt_idx + num_pad - i,
                       "circle": num_frames + i}[padding]
        elif i > max_frame_num:
            pad_idx = {"replicate": max_frame_num,
                       "reflection": max_frame_num * 2 - i,
                       "reflection_circle": (crt_idx - num_pad)
                       - (i - max_frame_num),
                       "circle": i - num_frames}[padding]
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def paired_paths_from_folder(folders: Sequence[str], keys: Sequence[str],
                             filename_tmpl: str):
    """[{"<in>_path", "<gt>_path"}] for each GT file and its input, named
    filename_tmpl.format(GT's stem) + GT's extension."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError("two folders and two keys")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    if len(input_paths) != len(gt_paths):
        raise ValueError(f"{input_key} and {gt_key} datasets have different "
                         f"number of images: {len(input_paths)}, "
                         f"{len(gt_paths)}.")
    paths = []
    for gt_path in gt_paths:
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        if input_name not in input_paths:
            raise ValueError(f"{input_name} is not in {input_key}_paths.")
        paths.append({f"{input_key}_path": osp.join(input_folder, input_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl):
    """As paired_paths_from_folder, the GT names from the first word of
    each line of meta_info_file."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError("two folders and two keys")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file) as fin:
        gt_names = [line.strip().split(" ")[0] for line in fin if line.strip()]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({f"{input_key}_path": osp.join(input_folder, input_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths


def _lmdb_keys(folder):
    """The keys of an lmdb folder: each meta_info.txt line's name without
    its extension."""
    with open(osp.join(folder, "meta_info.txt")) as fin:
        return [line.split(".")[0] for line in fin if line.strip()]


def paired_paths_from_lmdb(folders, keys):
    """[{"<in>_path": key, "<gt>_path": key}] of two .lmdb folders holding
    the same keys (data_util.py:95-153)."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError("two folders and two keys")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (input_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError(f"{input_key} folder and {gt_key} folder should both "
                         "be in lmdb format.")
    input_keys = set(_lmdb_keys(input_folder))
    gt_keys = _lmdb_keys(gt_folder)
    if input_keys != set(gt_keys):
        raise ValueError(f"Keys in {input_key}_folder and {gt_key}_folder "
                         "are different.")
    return [{f"{input_key}_path": k, f"{gt_key}_path": k} for k in gt_keys]


def paths_from_folder(folder):
    return [osp.join(folder, p) for p in scandir(folder)]


def paths_from_lmdb(folder):
    """The keys of a .lmdb folder (data_util.py:251-264)."""
    if not folder.endswith(".lmdb"):
        raise ValueError(f"Folder {folder} should be in lmdb format.")
    return _lmdb_keys(folder)


def generate_gaussian_kernel(kernel_size: int = 13, sigma: float = 1.6):
    """A centred Dirac smoothed by scipy's gaussian_filter (float64)."""
    from scipy.ndimage import gaussian_filter
    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x: torch.Tensor, kernel_size: int = 13,
                   scale: int = 4) -> torch.Tensor:
    """DUF's Gaussian downsampling of (B, T, H, W, C) or (T, H, W, C)
    frames: each channel reflect-padded by kernel_size // 2 + 2 scale,
    filtered by generate_gaussian_kernel(kernel_size, 0.4 scale) at stride
    `scale`, and 2 border pixels cropped."""
    if scale not in (2, 3, 4):
        raise ValueError(f"Only support scale (2, 3, 4), but got {scale}.")
    squeeze = x.dim() == 4
    if squeeze:
        x = x[None]
    b, t, h, w, c = x.shape
    xf = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2).reshape(
        b * t * c, 1, h, w)
    pad = kernel_size // 2 + scale * 2
    xf = F.pad(xf, (pad, pad, pad, pad), mode="reflect")
    k = torch.as_tensor(generate_gaussian_kernel(kernel_size, 0.4 * scale),
                        dtype=xf.dtype, device=xf.device)
    y = F.conv2d(xf, k[None, None], stride=scale)[:, :, 2:-2, 2:-2]
    hh, ww = y.shape[-2:]
    y = y.reshape(b * t, c, hh, ww).permute(0, 2, 3, 1).reshape(
        b, t, hh, ww, c)
    return y[0] if squeeze else y
