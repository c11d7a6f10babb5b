"""Grid sampling and flow warping with torch F.grid_sample semantics.

Images are NCHW; grids (N, Ho, Wo, 2) with [..., 0] = x and [..., 1] = y in
[-1, 1]. The coordinate arithmetic runs in f32 whatever the image dtype (a
bf16 coordinate near x = 500 is quantised to ~2 px), as in the JAX package.
"""
from typing import Tuple

import torch
import torch.nn.functional as F

from comfyui_keep_torch.ops.resample import resize_bilinear


def grid_sample(img, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True):
    out = F.grid_sample(img.float(), grid.float(), mode=mode,
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.to(img.dtype)


def flow_warp_xy(x, fx, fy, interp_mode: str = "bilinear",
                 padding_mode: str = "zeros", align_corners: bool = True):
    """Warp x (N, C, H, W) by a flow given as x/y planes (N, H, W)
    (reference arch_util.py flow_warp: align_corners normalisation
    2 v / (size - 1) - 1)."""
    n, _, h, w = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    vx = gx[None] + fx.float()
    vy = gy[None] + fy.float()
    nx = 2.0 * vx / max(w - 1, 1) - 1.0
    ny = 2.0 * vy / max(h - 1, 1) - 1.0
    return grid_sample(x, torch.stack([nx, ny], dim=-1), mode=interp_mode,
                       padding_mode=padding_mode, align_corners=align_corners)


def flow_warp(x, flow, interp_mode: str = "bilinear",
              padding_mode: str = "zeros", align_corners: bool = True):
    """Warp x (N, C, H, W) by a dense flow (N, H, W, 2) [dx, dy]."""
    return flow_warp_xy(x, flow[..., 0], flow[..., 1], interp_mode,
                        padding_mode, align_corners)


def resize_flow(flow, out_hw: Tuple[int, int], align_corners: bool = False):
    """Resize a dense flow (N, H, W, 2) to out_hw: the displacements are
    scaled by out/in per axis, then resized bilinearly without
    antialiasing (reference arch_util.py resize_flow)."""
    h, w = flow.shape[1], flow.shape[2]
    ratio = torch.tensor([out_hw[1] / w, out_hw[0] / h], dtype=flow.dtype,
                         device=flow.device)
    out = resize_bilinear((flow * ratio).permute(0, 3, 1, 2), out_hw,
                          align_corners=align_corners)
    return out.permute(0, 2, 3, 1)
