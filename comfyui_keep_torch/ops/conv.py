"""Convolution and linear primitives (NCHW, OIHW; linear weights (out, in)).

The port runs convolutions in PyTorch's native NCHW layout, on cuDNN on the
card, with the weights in the layout of the original torch state dicts. The
JAX package's asymmetric padding ([(top, bottom), (left, right)]) is kept
for the VQGAN Downsample's (0, 1, 0, 1) pad.
"""
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[int, Sequence[Tuple[int, int]]]


def conv2d(x, w, b=None, stride: int = 1, padding: Padding = 0,
           dilation: int = 1, groups: int = 1):
    """x: (N, Cin, H, W); w: (Cout, Cin / groups, kh, kw). padding is an
    int or [(top, bottom), (left, right)]."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
    return F.conv2d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv3d(x, w, b=None, stride=1, padding=0, dilation=1):
    """x: (N, Cin, D, H, W); w: (Cout, Cin, kd, kh, kw). stride, padding
    and dilation are ints or triples; padding may also be [(lo, hi)] * 3."""
    if not isinstance(padding, int) and not isinstance(padding[0], int):
        if all(lo == hi for lo, hi in padding):
            padding = tuple(lo for lo, _ in padding)
        else:
            x = F.pad(x, tuple(p for lo_hi in reversed(padding)
                               for p in lo_hi))
            padding = 0
    return F.conv3d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation)


def linear(x, w, b=None):
    """x: (..., in); w: (out, in)."""
    return F.linear(x, w, b)
