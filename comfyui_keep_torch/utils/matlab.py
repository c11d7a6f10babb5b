"""MATLAB-compatible image resize (bicubic, antialiasing), reference
wm_basicsr/utils/matlab_functions.py imresize; the port's copy of
comfyui_keep_tpu/utils/matlab.py (numpy). NIQE's half-scale step uses it.
"""
import numpy as np


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) +
            (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _weights_indices(in_len, out_len, scale, antialiasing):
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = 4.0 / scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1  # 0-based candidate indices
    dist = u[:, None] - (idx + 1)
    if scale < 1 and antialiasing:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    # MATLAB symmetric (mirror) border handling: indices reflect off edges
    aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx = aux[np.mod(idx.astype(np.int64), 2 * in_len)]
    # trim all-zero weight columns
    nz = np.any(w != 0, axis=0)
    return w[:, nz], idx[:, nz]


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """img: (H, W) or (H, W, C) float; MATLAB imresize bicubic."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    out_h, out_w = int(np.ceil(h * scale)), int(np.ceil(w * scale))

    wh, ih = _weights_indices(h, out_h, scale, antialiasing)
    ww, iw = _weights_indices(w, out_w, scale, antialiasing)

    tmp = np.einsum("op,opwc->owc", wh, img[ih, :, :])
    out = np.einsum("wp,hwpc->hwc", ww, tmp[:, iw, :])
    if squeeze:
        out = out[:, :, 0]
    return out
