"""Colour-space conversions, MATLAB / ITU-R BT.601 convention (reference
wm_basicsr/utils/color_util.py), the port's copy of
comfyui_keep_tpu/utils/color.py. numpy inputs: uint8 [0, 255] or float32
[0, 1], output in the same convention; `rgb2ycbcr_pt` is the batched
tensor twin.
"""
import numpy as np
import torch

_YCBCR_W = np.array([[65.481, -37.797, 112.0],
                     [128.553, -74.203, -93.786],
                     [24.966, 112.0, -18.214]], np.float64)
_YCBCR_B = np.array([16.0, 128.0, 128.0], np.float64)


def _to_float01(img):
    t = img.dtype
    img = img.astype(np.float32)
    if t != np.uint8:
        return img, t
    return img / 255.0, t


def _from_float255(out, t):
    if t == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(np.float32)


def rgb2ycbcr(img, y_only=False):
    img, t = _to_float01(img)
    if y_only:
        out = img @ _YCBCR_W[:, 0] + 16.0
    else:
        out = img @ _YCBCR_W + _YCBCR_B
    return _from_float255(out, t)


def bgr2ycbcr(img, y_only=False):
    return rgb2ycbcr(img[..., ::-1], y_only)


def ycbcr2rgb(img):
    img, t = _to_float01(img)
    img = img * 255.0
    inv = np.linalg.inv(_YCBCR_W.T) * 255.0
    out = (img - _YCBCR_B) @ inv * 255.0
    return _from_float255(out, t)


def ycbcr2bgr(img):
    return ycbcr2rgb(img)[..., ::-1]


def to_y_channel(img):
    """metric_util.to_y_channel: float [0,255] BGR HWC -> Y [0,255] (h,w,1)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0


def rgb2ycbcr_pt(img, y_only=False):
    """Tensor twin for batched (N, 3, H, W) RGB images in [0, 1]; returns
    [0, 1] ((N, 1, H, W) with y_only)."""
    w = torch.as_tensor(_YCBCR_W, dtype=img.dtype, device=img.device)
    b = torch.as_tensor(_YCBCR_B, dtype=img.dtype, device=img.device)
    x = img.permute(0, 2, 3, 1)
    out = x @ w[:, 0:1] + 16.0 if y_only else x @ w + b
    return out.permute(0, 3, 1, 2) / 255.0
