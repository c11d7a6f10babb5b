"""OpenCV's `cv2.resize` for uint8 images in numpy, so the port's pipeline
needs no OpenCV: INTER_LINEAR and INTER_LANCZOS4, bit for bit.

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
tests/test_torch_resize.py holds both modes to cv2.resize bitwise.
"""
import math
from typing import Tuple

import numpy as np

COEF_SCALE = 2048       # INTER_RESIZE_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _source_coords(dst_n: int, src_n: int):
    """Integer source index and float32 fraction of each output position."""
    scale = 1.0 / (dst_n / src_n)
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


def _taps(dst_n: int, src_n: int, lanczos: bool, clamp_fraction: bool):
    """(dst_n, k) source indices (edges replicated) and int coefficients."""
    s, f = _source_coords(dst_n, src_n)
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


def resize(img: np.ndarray, dsize: Tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=INTER_LINEAR or INTER_LANCZOS4)
    for a uint8 (H, W) or (H, W, C) image; dsize is (width, height), as in
    OpenCV; interpolation is "linear" or "lanczos4"."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes an (H, W[, C]) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    if interpolation not in ("linear", "lanczos4"):
        raise ValueError(f"interpolation {interpolation!r}: 'linear' or "
                         f"'lanczos4'")
    w, h = int(dsize[0]), int(dsize[1])
    if w < 1 or h < 1:
        raise ValueError(f"dsize {dsize}: width and height must be >= 1")
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img.copy()
    lanczos = interpolation == "lanczos4"
    x = img.reshape(sh, sw, -1).astype(np.int64)
    ix, ax = _taps(w, sw, lanczos, clamp_fraction=True)
    iy, ay = _taps(h, sh, lanczos, clamp_fraction=False)
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
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (h, w) + img.shape[2:])
