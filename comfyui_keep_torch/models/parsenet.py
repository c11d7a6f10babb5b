"""ParseNet face parser (reference wm_facelib/parsing/parsenet.py), ported
from comfyui_keep_tpu/models/parsenet.py: a reflection-padded conv encoder
(512 -> 32), a 10-block residual body, a nearest-upsampling decoder, and
19-class mask and RGB heads. BatchNorm in its inference form, LeakyReLU(0.2),
NCHW. Module names are the reference's (encoder.N.conv2d,
encoder.N.conv1.norm.norm, body.N.shortcut_func, ...), so
parsing_parsenet.pth loads as it is.
"""
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import (batch_norm, conv2d, leaky_relu,
                                    reflect_pad, upsample_nearest_2x)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


def _channels(in_size=512, out_size=512, min_feat_size=32, base_ch=64,
              ch_range=(32, 256)):
    lo, hi = ch_range

    def clip(c):
        return max(lo, min(c, hi))

    down = int(math.log2(in_size // min(in_size, min_feat_size)))
    up = int(math.log2(out_size // min(in_size, min_feat_size)))
    enc, head = [], base_ch
    for _ in range(down):
        enc.append((clip(head), clip(head * 2)))
        head *= 2
    body_ch = clip(head)
    dec = []
    for _ in range(up):
        dec.append((clip(head), clip(head // 2)))
        head //= 2
    return enc, body_ch, dec, clip(head)


class NormLayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(c)


class ConvLayer(nn.Module):
    """[x2 nearest up] -> reflect pad ceil((k-1)/2) -> conv[stride 2 down]
    -> [bn] -> [leaky 0.2]; the conv has a bias unless a norm follows."""

    def __init__(self, cin: int, cout: int, k: int = 3, scale: str = "none",
                 norm: bool = False, relu: bool = False):
        super().__init__()
        self.k, self.scale, self.relu = k, scale, relu
        self.conv2d = nn.Conv2d(cin, cout, k, 2 if scale == "down" else 1,
                                bias=not norm)
        self.norm = NormLayer(cout) if norm else None

    def forward(self, x):
        if self.scale == "up":
            x = upsample_nearest_2x(x)
        x = reflect_pad(x, -(-(self.k - 1) // 2))
        x = conv2d(x, self.conv2d.weight, self.conv2d.bias,
                   stride=2 if self.scale == "down" else 1)
        if self.norm is not None:
            x = batch_norm(x, self.norm.norm)
        return leaky_relu(x, 0.2) if self.relu else x


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, scale: str = "none"):
        super().__init__()
        first, second = {"down": ("none", "down"), "up": ("up", "none"),
                         "none": ("none", "none")}[scale]
        self.shortcut_func = None
        if not (scale == "none" and cin == cout):
            self.shortcut_func = ConvLayer(cin, cout, scale=scale)
        self.conv1 = ConvLayer(cin, cout, scale=first, norm=True, relu=True)
        self.conv2 = ConvLayer(cout, cout, scale=second, norm=True)

    def forward(self, x):
        identity = x if self.shortcut_func is None else self.shortcut_func(x)
        return identity + self.conv2(self.conv1(x))


@ARCH_REGISTRY.register()
class ParseNet(nn.Module):
    def __init__(self, in_size: int = 512, out_size: int = 512,
                 min_feat_size: int = 32, base_ch: int = 64,
                 parsing_ch: int = 19, res_depth: int = 10, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        enc, body_ch, dec, out_ch = _channels(in_size, out_size,
                                              min_feat_size, base_ch)
        self.encoder = nn.Sequential(
            ConvLayer(3, base_ch),
            *[ResidualBlock(ci, co, scale="down") for ci, co in enc])
        self.body = nn.Sequential(*[ResidualBlock(body_ch, body_ch)
                                    for _ in range(res_depth)])
        self.decoder = nn.Sequential(*[ResidualBlock(ci, co, scale="up")
                                       for ci, co in dec])
        self.out_img_conv = ConvLayer(out_ch, 3)
        self.out_mask_conv = ConvLayer(out_ch, parsing_ch)
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x):
        """x: (B, 3, H, W) RGB in [-1, 1] -> (mask logits (B, 19, H, W),
        RGB (B, 3, H, W))."""
        feat = self.encoder(x)
        h = self.decoder(feat + self.body(feat))
        return self.out_mask_conv(h), self.out_img_conv(h)


def make_parser_fn(model: ParseNet):
    """parser(face_rgb_pm1 (1, 512, 512, 3), numpy or a tensor) -> (1, 512,
    512, 19) logits, a tensor on the model's device: the FaceRestoreHelper
    plug-in. The module is parser.model."""

    def parser(x):
        p = next(model.parameters())
        x = (x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))).to(p.device, p.dtype)
        with torch.no_grad():
            mask, _ = model(x.permute(0, 3, 1, 2))
        return mask.permute(0, 2, 3, 1)

    parser.model = model
    return parser
