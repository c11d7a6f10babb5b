"""Resizing with torch F.interpolate semantics, NCHW."""
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
