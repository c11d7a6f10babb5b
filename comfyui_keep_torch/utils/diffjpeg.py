"""JPEG compression as tensor arithmetic (reference wm_basicsr/utils/
diffjpeg.py), the port's copy of comfyui_keep_tpu/utils/diffjpeg.py.

The standard JPEG pipeline on (B, H, W, 3) RGB in [0, 1]: RGB -> YCbCr,
2 x 2 chroma averaging, 8 x 8 block DCT, quantisation by the standard luma /
chroma tables scaled by the quality factor, then the inverse chain. With
differentiable=True the rounding is round(x) + (x - round(x))^3, so
gradients pass. It runs on the tensor's device. The dataset's JPEG stand-in
for video compression (data/degradations.py:add_jpg_compression) calls it
with differentiable=False on CPU tensors.
"""
import itertools

import numpy as np
import torch

Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]],
    np.float32).T  # the reference stores the table transposed
C_TABLE = np.full((8, 8), 99, np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]], np.float32)

_RGB2YCBCR = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)
_YCBCR2RGB = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136],
                       [1.0, 1.772, 0.0]], np.float32)

# 8x8 type-II DCT basis [x, y, u, v] and JPEG's alpha(u) alpha(v) / 4
_DCT = np.zeros((8, 8, 8, 8), np.float32)
for _x, _y, _u, _v in itertools.product(range(8), repeat=4):
    _DCT[_x, _y, _u, _v] = np.cos((2 * _x + 1) * _u * np.pi / 16) * \
        np.cos((2 * _y + 1) * _v * np.pi / 16)
_ALPHA = np.array([1.0 / np.sqrt(2)] + [1.0] * 7, np.float32)
_SCALE = np.outer(_ALPHA, _ALPHA) * 0.25


def diff_round(x):
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality: float) -> float:
    if quality < 50:
        quality = 5000.0 / quality
    else:
        quality = 200.0 - quality * 2
    return quality / 100.0


def _blocks(x):
    """(B, H, W) -> (B, n, 8, 8)."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, -1, 8, 8)


def _unblocks(x, h, w):
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h, w)


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _dct8(blocks):
    out = torch.tensordot(blocks - 128.0, _const(_DCT, blocks),
                          dims=([-2, -1], [0, 1]))
    return out * _const(_SCALE, blocks)


def _idct8(coeffs):
    c = coeffs * _const(_SCALE * 4.0, coeffs)
    out = 0.25 * torch.tensordot(c, _const(_DCT, coeffs),
                                 dims=([-2, -1], [2, 3]))
    return out + 128.0


def diff_jpeg(x, quality, differentiable: bool = True):
    """x (B, H, W, 3) RGB in [0, 1] -> the JPEG round trip, same shape, in
    [0, 1]; quality a number in (0, 100] (or a factor tensor already
    mapped by quality_to_factor). H and W are padded to multiples of 16
    and cropped back."""
    rounding = diff_round if differentiable else torch.round
    factor = quality_to_factor(quality) if isinstance(quality, (int, float)) \
        else quality
    b, h, w, _ = x.shape
    hp, wp = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = torch.nn.functional.pad(x, (0, 0, 0, wp, 0, hp))
    hh, ww = h + hp, w + wp

    ycc = (x * 255.0) @ _const(_RGB2YCBCR.T, x) + _const([0.0, 128.0, 128.0],
                                                        x)
    y = ycc[..., 0]
    cb = ycc[..., 1].reshape(b, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4))
    cr = ycc[..., 2].reshape(b, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4))
    yt = _const(Y_TABLE, x) * factor
    ct = _const(C_TABLE, x) * factor

    def channel(c, table):
        return rounding(_dct8(_blocks(c)) / table) * table

    yq = _unblocks(_idct8(channel(y, yt)), hh, ww)
    cbq = _unblocks(_idct8(channel(cb, ct)), hh // 2, ww // 2)
    crq = _unblocks(_idct8(channel(cr, ct)), hh // 2, ww // 2)
    cbq = cbq.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    crq = crq.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    ycc = torch.stack([yq, cbq - 128.0, crq - 128.0], dim=-1)
    rgb = torch.clamp(ycc @ _const(_YCBCR2RGB.T, x), 0.0, 255.0) / 255.0
    return rgb[:, :h, :w]
