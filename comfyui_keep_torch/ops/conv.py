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


def conv2d(x, w, b=None, stride: int = 1, padding: Padding = 0):
    """x: (N, Cin, H, W); w: (Cout, Cin, kh, kw). padding is an int or
    [(top, bottom), (left, right)]."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def linear(x, w, b=None):
    """x: (..., in); w: (out, in)."""
    return F.linear(x, w, b)
