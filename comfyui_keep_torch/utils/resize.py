"""OpenCV's `cv2.resize` for uint8 images, so the port's pipeline needs no
OpenCV: INTER_LINEAR and INTER_LANCZOS4, bit for bit; and INTER_LANCZOS4
for uint16 images (RealESRGANer's 16-bit output). A numpy image is
resized on the CPU and comes back as numpy; a tensor is resized on its own
device (the card, for the pipeline's full-frame resizes) in the same
integer arithmetic.

It follows OpenCV's fixed-point path for 8-bit data (imgproc resize.cpp,
`resizeGeneric_` with its uchar specialisations):
- source coordinates at pixel centres, `(d + 0.5) * scale - 0.5` in double
  with `scale = 1 / (dsize / ssize)`, rounded to float, split into an
  integer part (floor) and a float fraction;
- coefficients computed in float and converted to `short` at
  INTER_RESIZE_COEF_SCALE = 2048 (round half to even);
- an integer horizontal pass over replicated edges, then a vertical pass:
  for LANCZOS4 the sum of eight rows rounded by a shift of 22 bits and
  saturated to uint8; for LINEAR OpenCV's own uchar form,
  `((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2`.
LINEAR clamps the horizontal fraction to 0 past either edge, not the
vertical one (its edge rows are replicated); LANCZOS4 clamps neither.
For 16-bit data OpenCV's LANCZOS4 stays in float (`HResizeLanczos4<ushort,
float, float>`, `VResizeLanczos4` with a float-to-ushort cast): the same
eight float32 weights, each pass a float32 sum of products in tap order
(no fused multiply-add), rounded half to even and saturated at the end.
tests/test_torch_resize.py holds the uint8 modes to cv2.resize bitwise,
tests/test_torch_cvops.py the uint16 one.
"""
import math
from typing import Tuple

import numpy as np
import torch

COEF_SCALE = 2048       # INTER_RESIZE_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _source_coords(dst_n: int, src_n: int, inv_scale=None):
    """Integer source index and float32 fraction of each output position;
    inv_scale is OpenCV's dst / src ratio (cv2.resize's fx or fy when
    given, else dst_n / src_n)."""
    scale = 1.0 / (inv_scale if inv_scale else dst_n / src_n)
    f = ((np.arange(dst_n, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _lanczos4(x: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateLanczos4 for each float32 fraction in x: (n, 8)
    float32 weights, normalised by their float sum. The sine and cosine
    come from the C library, as OpenCV's std::sin / std::cos do."""
    out = np.empty((len(x), 8), np.float32)
    for r, xv in enumerate(x.astype(np.float32)):
        x3 = xv + np.float32(3)
        y0 = float(-x3) * math.pi * 0.25
        s0, c0 = math.sin(y0), math.cos(y0)
        total = np.float32(0)
        for i, (a, b) in enumerate(_LANCZOS_CS):
            yi = x3 - np.float32(i)
            if abs(yi) >= np.float32(1e-6):
                y = float(-yi) * math.pi * 0.25
                out[r, i] = np.float32((a * s0 + b * c0) / (y * y))
            else:
                out[r, i] = np.float32(1e30)
            total = total + out[r, i]
        out[r] *= np.float32(1) / total
    return out


def _taps(dst_n: int, src_n: int, lanczos: bool, clamp_fraction: bool,
          inv_scale=None):
    """(dst_n, k) source indices (edges replicated) and int coefficients."""
    s, f = _source_coords(dst_n, src_n, inv_scale)
    if lanczos:
        c = _lanczos4(f)
        idx = s[:, None] + np.arange(8) - 3
    else:
        if clamp_fraction:
            f = np.where((s < 0) | (s >= src_n - 1), np.float32(0), f)
            s = np.clip(s, 0, src_n - 1)
        c = np.stack([np.float32(1) - f, f], -1)
        idx = s[:, None] + np.arange(2)
    coef = np.rint(c * np.float32(COEF_SCALE)).astype(np.int64)
    return np.clip(idx, 0, src_n - 1), coef


def resize(img, dsize: Tuple[int, int], interpolation: str = "linear",
           fx=None, fy=None):
    """cv2.resize(img, dsize, fx, fy, interpolation=INTER_LINEAR or
    INTER_LANCZOS4) for a uint8 (H, W) or (H, W, C) image, numpy or a
    tensor (the result is of the same kind), or INTER_LANCZOS4 for a numpy
    uint16 image; dsize is (width,
    height), as in OpenCV; interpolation is "linear" or "lanczos4". Given fx
    and fy (and dsize (0, 0)), the size is (round(w fx), round(h fy)),
    rounded half to even, and source coordinates map by 1 / fx and 1 / fy,
    not by the sizes' ratio, as OpenCV maps them."""
    is_tensor = torch.is_tensor(img)
    u16 = not is_tensor and img.dtype == np.uint16
    if ((img.dtype != (torch.uint8 if is_tensor else np.uint8) and not u16)
            or img.ndim not in (2, 3)):
        raise ValueError(f"resize takes an (H, W[, C]) uint8 image (or a "
                         f"numpy uint16 one), got {img.dtype} "
                         f"{tuple(img.shape)}")
    if interpolation not in ("linear", "lanczos4"):
        raise ValueError(f"interpolation {interpolation!r}: 'linear' or "
                         f"'lanczos4'")
    sh, sw = img.shape[:2]
    if fx or fy:
        if tuple(dsize) != (0, 0) or not (fx and fy):
            raise ValueError("give dsize (0, 0) with both fx and fy")
        dsize = (round(sw * fx), round(sh * fy))
    w, h = int(dsize[0]), int(dsize[1])
    if w < 1 or h < 1:
        raise ValueError(f"dsize {dsize}: width and height must be >= 1")
    if (sh, sw) == (h, w) and not (fx or fy):
        return img.clone() if is_tensor else img.copy()
    lanczos = interpolation == "lanczos4"
    if u16:
        if not lanczos:
            raise ValueError("a uint16 image resizes by 'lanczos4' only")
        return _lanczos4_u16(img, w, h)
    t = img if is_tensor else torch.from_numpy(np.ascontiguousarray(img))
    dev = t.device
    x = t.reshape(sh, sw, -1).to(torch.int64)
    ix, ax = (torch.as_tensor(a, device=dev) for a in _taps(
        w, sw, lanczos, clamp_fraction=True, inv_scale=fx))
    iy, ay = (torch.as_tensor(a, device=dev) for a in _taps(
        h, sh, lanczos, clamp_fraction=False, inv_scale=fy))
    rows = sum(x[:, ix[:, k]] * ax[None, :, k, None]
               for k in range(ix.shape[1]))              # (sh, w, C) int
    if lanczos:
        acc = sum(rows[iy[:, k]] * ay[:, k, None, None]
                  for k in range(iy.shape[1]))
        out = (acc + (1 << 21)) >> 22
    else:
        acc = sum((ay[:, k, None, None] * (rows[iy[:, k]] >> 4)) >> 16
                  for k in range(2))
        out = (acc + 2) >> 2
    out = out.clamp(0, 255).to(torch.uint8).reshape((h, w) + tuple(
        img.shape[2:]))
    return out if is_tensor else out.numpy()


def _lanczos4_u16(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """OpenCV's LANCZOS4 for a uint16 (H, W[, C]) numpy image, in float32:
    rows, then columns, each a sum over the eight taps in order."""
    sh, sw = img.shape[:2]
    x = torch.from_numpy(img.reshape(sh, sw, -1).astype(np.float32))
    sx, fx = _source_coords(w, sw)
    sy, fy = _source_coords(h, sh)
    ax, ay = torch.from_numpy(_lanczos4(fx)), torch.from_numpy(_lanczos4(fy))
    ix = torch.from_numpy(np.clip(sx[:, None] + np.arange(8) - 3, 0, sw - 1))
    iy = torch.from_numpy(np.clip(sy[:, None] + np.arange(8) - 3, 0, sh - 1))
    rows = x[:, ix[:, 0]] * ax[None, :, 0, None]
    for k in range(1, 8):
        rows = rows + x[:, ix[:, k]] * ax[None, :, k, None]
    acc = rows[iy[:, 0]] * ay[:, 0, None, None]
    for k in range(1, 8):
        acc = acc + rows[iy[:, k]] * ay[:, k, None, None]
    out = torch.round(acc).clamp(0, 65535).to(torch.int32).numpy()
    return out.astype(np.uint16).reshape((h, w) + img.shape[2:])
