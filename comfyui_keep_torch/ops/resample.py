"""Resizing, pooling and padding with torch semantics, NCHW."""
from typing import Tuple

import torch.nn.functional as F


def upsample_nearest_2x(x):
    """Nearest-neighbour x2 upsample of (N, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x, out_hw: Tuple[int, int], align_corners: bool = False):
    """Bilinear resize of (N, C, H, W) to out_hw (no antialiasing)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x, out_hw: Tuple[int, int]):
    """Nearest resize of (N, C, H, W) as torch mode="nearest":
    source index floor(dst * in / out)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")


def avg_pool_2x(x):
    """2x2 stride-2 average pool of (N, C, H, W) (an odd last row or column
    dropped)."""
    return F.avg_pool2d(x, 2)


def max_pool(x, window: int, stride: int, padding: int = 0):
    """MaxPool2d of (N, C, H, W); the padding never wins (-inf)."""
    return F.max_pool2d(x, window, stride, padding)


def reflect_pad(x, p: int):
    """Pad H and W of (N, C, H, W) by p, reflected without repeating the
    edge (torch ReflectionPad2d, numpy's "reflect")."""
    return F.pad(x, (p, p, p, p), mode="reflect")
