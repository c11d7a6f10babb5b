"""The single-image SR upscalers (reference archs rrdbnet_arch.py,
srvgg_arch.py, srresnet_arch.py, edsr_arch.py), ported from
comfyui_keep_tpu/models/sr_basic.py: RRDBNet (ESRGAN / Real-ESRGAN),
SRVGGNetCompact (realesr-general / animevideo), MSRResNet and EDSR, plus
pixel_shuffle / pixel_unshuffle. They serve as the pipeline's background
and face upscalers (pipeline/tiled.py, pipeline/realesrganer.py).

NCHW, images in [0, 1]. Module names are the reference's (conv_first,
body.{i}.rdb1.conv1, body.{i} of SRVGG's conv / PReLU list, upconv1,
upsample.{0, 2}, ...), so the released .pth files load as they are.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import (conv2d, leaky_relu, relu, resize_bilinear,
                                    resize_nearest, upsample_nearest_2x)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def pixel_shuffle(x, r: int):
    """nn.PixelShuffle: (B, C r^2, H, W) -> (B, C, H r, W r)."""
    return F.pixel_shuffle(x, r)


def pixel_unshuffle(x, r: int):
    """The inverse (arch_util.pixel_unshuffle): (B, C, H r, W r) ->
    (B, C r^2, H, W)."""
    return F.pixel_unshuffle(x, r)


def conv3x3(conv: nn.Conv2d, x):
    return conv2d(x, conv.weight, conv.bias, padding=1)


def prelu(x, weight):
    """where(x >= 0, x, x * w), w per channel (the JAX package's form)."""
    return torch.where(x >= 0, x, x * weight.view(1, -1, 1, 1))


def _build(module: nn.Module, device, dtype, generator):
    if generator is not None:
        default_init_(module, generator)
    return finish(module, device, dtype)


class ResidualBlockNoBN(nn.Module):
    def __init__(self, nf: int, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv2 = nn.Conv2d(nf, nf, 3, 1, 1)

    def forward(self, x):
        out = conv3x3(self.conv2, relu(conv3x3(self.conv1, x)))
        return x + out * self.res_scale


# -- RRDBNet (ESRGAN / Real-ESRGAN generator) ----------------------------------

class ResidualDenseBlock(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}", nn.Conv2d(
                nf + i * gc, gc if i < 4 else nf, 3, 1, 1))

    def forward(self, x):
        x1 = leaky_relu(conv3x3(self.conv1, x), 0.2)
        x2 = leaky_relu(conv3x3(self.conv2, torch.cat([x, x1], 1)), 0.2)
        x3 = leaky_relu(conv3x3(self.conv3, torch.cat([x, x1, x2], 1)), 0.2)
        x4 = leaky_relu(conv3x3(self.conv4, torch.cat([x, x1, x2, x3], 1)),
                        0.2)
        x5 = conv3x3(self.conv5, torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc)
        self.rdb2 = ResidualDenseBlock(nf, gc)
        self.rdb3 = ResidualDenseBlock(nf, gc)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """x4 by two nearest x2 upsamplings; scale 2 and 1 pixel_unshuffle the
    input by 2 and 4 first (rrdbnet_arch.py:107-122)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 scale: int = 4, num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = scale
        cin = num_in_ch * {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = nn.Conv2d(cin, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        _build(self, device, dtype, generator)

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = conv3x3(self.conv_first, x)
        feat = feat + conv3x3(self.conv_body, self.body(feat))
        feat = leaky_relu(conv3x3(self.conv_up1, upsample_nearest_2x(feat)),
                          0.2)
        feat = leaky_relu(conv3x3(self.conv_up2, upsample_nearest_2x(feat)),
                          0.2)
        return conv3x3(self.conv_last,
                       leaky_relu(conv3x3(self.conv_hr, feat), 0.2))


# -- SRVGGNetCompact -------------------------------------------------------------

@ARCH_REGISTRY.register()
class SRVGGNetCompact(nn.Module):
    """num_conv + 2 convolutions at the input's size, an activation after
    each but the last, pixel_shuffle by `upscale`, plus the nearest
    upsampling of the input."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_conv: int = 16, upscale: int = 4,
                 act_type: str = "prelu", device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act_type not in ("prelu", "relu", "lrelu"):
            raise ValueError(f"act_type {act_type!r}")
        self.upscale, self.act_type = upscale, act_type

        def act():
            return (nn.PReLU(num_feat, 0.25) if act_type == "prelu" else
                    nn.ReLU() if act_type == "relu" else nn.LeakyReLU(0.1))

        body = [nn.Conv2d(num_in_ch, num_feat, 3, 1, 1), act()]
        for _ in range(num_conv):
            body += [nn.Conv2d(num_feat, num_feat, 3, 1, 1), act()]
        body.append(nn.Conv2d(num_feat, num_out_ch * upscale ** 2, 3, 1, 1))
        self.body = nn.ModuleList(body)
        _build(self, device, dtype, generator)

    def forward(self, x):
        out = x
        for i in range(0, len(self.body), 2):
            out = conv3x3(self.body[i], out)
            if i + 1 < len(self.body):
                a = self.body[i + 1]
                out = (prelu(out, a.weight) if self.act_type == "prelu" else
                       relu(out) if self.act_type == "relu" else
                       leaky_relu(out, 0.1))
        out = pixel_shuffle(out, self.upscale)
        return out + resize_nearest(x, (x.shape[2] * self.upscale,
                                        x.shape[3] * self.upscale))


# -- MSRResNet -------------------------------------------------------------------

@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 16, upscale: int = 4,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upscale = upscale
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat)
                                    for _ in range(num_block)])
        if upscale == 4:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            self.upconv2 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
        else:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * upscale ** 2, 3, 1,
                                     1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        _build(self, device, dtype, generator)

    def forward(self, x):
        out = self.body(leaky_relu(conv3x3(self.conv_first, x), 0.1))
        if self.upscale == 4:
            out = leaky_relu(pixel_shuffle(conv3x3(self.upconv1, out), 2), 0.1)
            out = leaky_relu(pixel_shuffle(conv3x3(self.upconv2, out), 2), 0.1)
        else:
            out = leaky_relu(pixel_shuffle(conv3x3(self.upconv1, out),
                                           self.upscale), 0.1)
        out = conv3x3(self.conv_last,
                      leaky_relu(conv3x3(self.conv_hr, out), 0.1))
        base = resize_bilinear(x, (x.shape[2] * self.upscale,
                                   x.shape[3] * self.upscale))
        return out + base


# -- EDSR ------------------------------------------------------------------------

def upsample_layers(scale: int, nf: int) -> nn.Sequential:
    """arch_util.Upsample: (conv to 4 nf, PixelShuffle(2)) per factor of 2,
    or one (conv to 9 nf, PixelShuffle(3))."""
    layers = []
    if scale & (scale - 1) == 0:
        for _ in range(int(math.log2(scale))):
            layers += [nn.Conv2d(nf, 4 * nf, 3, 1, 1), nn.PixelShuffle(2)]
    elif scale == 3:
        layers += [nn.Conv2d(nf, 9 * nf, 3, 1, 1), nn.PixelShuffle(3)]
    else:
        raise ValueError(f"scale {scale}: a power of 2, or 3")
    return nn.Sequential(*layers)


def run_upsample(layers: nn.Sequential, x):
    for i in range(0, len(layers), 2):
        x = pixel_shuffle(conv3x3(layers[i], x), layers[i + 1].upscale_factor)
    return x


@ARCH_REGISTRY.register()
class EDSR(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 16, upscale: int = 4,
                 res_scale: float = 1.0, img_range: float = 255.0,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_range = img_range
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat, res_scale)
                                    for _ in range(num_block)])
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = upsample_layers(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        _build(self, device, dtype, generator)

    def forward(self, x):
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype,
                            device=x.device).view(1, 3, 1, 1)
        x = (x - mean) * self.img_range
        feat = conv3x3(self.conv_first, x)
        out = conv3x3(self.conv_after_body, self.body(feat)) + feat
        out = conv3x3(self.conv_last, run_upsample(self.upsample, out))
        return out / self.img_range + mean
