"""RCAN (reference rcan_arch.py), RIDNet (ridnet_arch.py) and ECBSR
(ecbsr_arch.py), ported from comfyui_keep_tpu/models/sr_extra.py. NCHW.

ECBSR's forward is the training form, the sum of each block's five
branches (3x3; 1x1 then 3x3; 1x1 then Sobel x / Sobel y / Laplacian,
scaled per channel); `rep_params` collapses each block into one 3x3
convolution and `apply_rep` runs the collapsed net, which equals the
training form up to rounding. Keys are the reference's (SeqConv3x3's raw
`k0` / `b0` / `k1` / `b1` / `scale` / `bias` tensors and fixed `mask`).
"""
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.models.sr_basic import (RGB_MEAN, ResidualBlockNoBN,
                                                pixel_shuffle, run_upsample,
                                                upsample_layers)
from comfyui_keep_torch.ops import conv2d, relu
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


def _build(module: nn.Module, device, dtype, generator):
    if generator is not None:
        default_init_(module, generator)
    return finish(module, device, dtype)


class ChannelAttention(nn.Module):
    """Squeeze-and-excitation: global mean, 1x1 down, ReLU, 1x1 up,
    sigmoid (`attention` at Sequential indices 1 and 3)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1), nn.ReLU(),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1), nn.Sigmoid())

    def forward(self, x):
        y = relu(self.attention[1](x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.attention[3](y))


# -- RCAN ------------------------------------------------------------------------

class RCAB(nn.Module):
    def __init__(self, num_feat: int, squeeze_factor: int, res_scale: float):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(
            nn.Conv2d(num_feat, num_feat, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(num_feat, num_feat, 3, 1, 1),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        h = self.rcab[2](relu(self.rcab[0](x)))
        return x + self.rcab[3](h) * self.res_scale


class ResidualGroup(nn.Module):
    def __init__(self, num_feat: int, num_block: int, squeeze_factor: int,
                 res_scale: float):
        super().__init__()
        self.residual_group = nn.Sequential(*[
            RCAB(num_feat, squeeze_factor, res_scale)
            for _ in range(num_block)])
        self.conv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return x + self.conv(self.residual_group(x))


@ARCH_REGISTRY.register()
class RCAN(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_group: int = 10, num_block: int = 16,
                 squeeze_factor: int = 16, upscale: int = 4,
                 res_scale: float = 1.0, img_range: float = 255.0,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_range = img_range
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[
            ResidualGroup(num_feat, num_block, squeeze_factor, res_scale)
            for _ in range(num_group)])
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = upsample_layers(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        _build(self, device, dtype, generator)

    def forward(self, x):
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype,
                            device=x.device).view(1, 3, 1, 1)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        h = self.conv_after_body(self.body(feat)) + feat
        out = self.conv_last(run_upsample(self.upsample, h))
        return out / self.img_range + mean


# -- RIDNet ----------------------------------------------------------------------

class MeanShift(nn.Module):
    """The reference's MeanShift, a 1x1 conv of identity weights over std
    and bias sign * img_range * mean / std (its weight and bias by the
    conv's names; not an nn.Conv2d, so the seeded init leaves them)."""

    def __init__(self, img_range: float, rgb_mean, rgb_std, sign: int = -1):
        super().__init__()
        std = torch.tensor(rgb_std)
        self.weight = nn.Parameter(torch.eye(3).view(3, 3, 1, 1)
                                   / std.view(3, 1, 1, 1))
        self.bias = nn.Parameter(sign * img_range * torch.tensor(rgb_mean)
                                 / std)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias)


class MergeRun(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dilation1 = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, 2, 2), nn.ReLU())
        self.dilation2 = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 3, 3), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, 4, 4), nn.ReLU())
        self.aggregation = nn.Sequential(nn.Conv2d(cout * 2, cout, 3, 1, 1),
                                         nn.ReLU())

    def forward(self, x):
        def pair(seq, z):
            return relu(seq[2](relu(seq[0](z))))

        d = torch.cat([pair(self.dilation1, x), pair(self.dilation2, x)], 1)
        return relu(self.aggregation[0](d)) + x


class EResidualBlockNoBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(cout, cout, 1, 1, 0))

    def forward(self, x):
        e = relu(self.body[0](x))
        e = self.body[4](relu(self.body[2](e)))
        return relu(e + x)


class EAM(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.merge = MergeRun(cin, mid)
        self.block1 = ResidualBlockNoBN(mid)
        self.block2 = EResidualBlockNoBN(mid, cout)
        self.ca = ChannelAttention(cout)

    def forward(self, x):
        return self.ca(self.block2(relu(self.block1(self.merge(x)))))


@ARCH_REGISTRY.register()
class RIDNet(nn.Module):
    """Real image denoising; images in [0, img_range]."""
    JAX_ABSENT = ("sub_mean.weight", "sub_mean.bias", "add_mean.weight",
                  "add_mean.bias")

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 out_channels: int = 3, num_block: int = 4,
                 img_range: float = 255.0, rgb_mean=RGB_MEAN,
                 rgb_std=(1.0, 1.0, 1.0), device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sub_mean = MeanShift(img_range, rgb_mean, rgb_std)
        self.add_mean = MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = nn.Conv2d(in_channels, mid_channels, 3, 1, 1)
        self.body = nn.Sequential(*[EAM(mid_channels, mid_channels,
                                        mid_channels)
                                    for _ in range(num_block)])
        self.tail = nn.Conv2d(mid_channels, out_channels, 3, 1, 1)
        _build(self, device, dtype, generator)

    def forward(self, x):
        res = self.sub_mean(x)
        res = self.body(relu(self.head(res)))
        return x + self.add_mean(self.tail(res))


# -- ECBSR -----------------------------------------------------------------------

_FIXED = {
    "conv1x1-sobelx": ((1, 0, -1), (2, 0, -2), (1, 0, -1)),
    "conv1x1-sobely": ((1, 2, 1), (0, 0, 0), (-1, -2, -1)),
    "conv1x1-laplacian": ((0, 1, 0), (1, -4, 1), (0, 1, 0)),
}


def _pad_with_bias(y, b):
    """Zero-pad by 1, then set the border ring to the bias (ecbsr_arch.py:
    the 1x1 conv's output continued by its bias)."""
    yp = torch.nn.functional.pad(y, (1, 1, 1, 1))
    ring = torch.ones_like(yp[:1, :1], dtype=torch.bool)
    ring[..., 1:-1, 1:-1] = False
    return torch.where(ring, b.view(1, -1, 1, 1).to(y.dtype), yp)


class SeqConv3x3(nn.Module):
    """A 1x1 conv followed by a 3x3 one: learned (conv1x1-conv3x3, mid
    channels out * depth_multiplier) or a fixed edge kernel scaled per
    channel (sobelx / sobely / laplacian, depthwise)."""
    JAX_ABSENT = ("mask",)

    def __init__(self, seq_type: str, cin: int, cout: int,
                 depth_multiplier: float = 1.0):
        super().__init__()
        self.seq_type, self.cout = seq_type, cout
        if seq_type == "conv1x1-conv3x3":
            mid = int(cout * depth_multiplier)
            self.k0 = nn.Parameter(torch.zeros(mid, cin, 1, 1))
            self.b0 = nn.Parameter(torch.zeros(mid))
            self.k1 = nn.Parameter(torch.zeros(cout, mid, 3, 3))
            self.b1 = nn.Parameter(torch.zeros(cout))
        elif seq_type in _FIXED:
            self.k0 = nn.Parameter(torch.zeros(cout, cin, 1, 1))
            self.b0 = nn.Parameter(torch.zeros(cout))
            self.scale = nn.Parameter(torch.zeros(cout, 1, 1, 1))
            self.bias = nn.Parameter(torch.zeros(cout))
            self.register_buffer("mask", torch.tensor(
                _FIXED[seq_type], dtype=torch.float32).expand(
                    cout, 1, 3, 3).clone())
        else:
            raise ValueError(f"seq_type {seq_type!r}")

    def reset_(self, generator: torch.Generator):
        """nn.Conv2d's default bounds for the convolutions' tensors; the
        scale and bias N(0, 1e-3^2), as the reference draws them."""
        with torch.no_grad():
            for w, b in ((self.k0, self.b0),) + (
                    ((self.k1, self.b1),) if hasattr(self, "k1") else ()):
                bound = 1.0 / math.sqrt(w[0].numel())
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                      generator=generator))
                b.copy_(torch.empty(b.shape).uniform_(-bound, bound,
                                                      generator=generator))
            if hasattr(self, "scale"):
                self.scale.copy_(torch.randn(self.scale.shape,
                                             generator=generator) * 1e-3)
                self.bias.copy_(torch.randn(self.bias.shape,
                                            generator=generator) * 1e-3)

    def forward(self, x):
        y0 = _pad_with_bias(conv2d(x, self.k0, self.b0), self.b0)
        if self.seq_type == "conv1x1-conv3x3":
            return conv2d(y0, self.k1, self.b1)
        return conv2d(y0, (self.scale * self.mask).to(y0.dtype), self.bias,
                      groups=self.cout)

    def rep_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The branch as one 3x3 convolution (weight, bias): the bias ring
        equals a constant field beyond the image, so a zero-padded 3x3
        conv with the folded bias is the same map."""
        k0 = self.k0[:, :, 0, 0]
        if self.seq_type == "conv1x1-conv3x3":
            rk = torch.einsum("omhw,mc->ochw", self.k1, k0)
            rb = torch.einsum("omhw,m->o", self.k1, self.b0) + self.b1
            return rk, rb
        k = self.scale * self.mask                       # (o, 1, 3, 3)
        rk = k * k0[:, :, None, None]
        rb = k.sum(dim=(1, 2, 3)) * self.b0 + self.bias
        return rk, rb


class ECB(nn.Module):
    """Edge-oriented convolution block: the five branches summed (plus the
    input with with_idt when the widths agree), then the activation."""

    def __init__(self, cin: int, cout: int, depth_multiplier: float = 2.0,
                 act_type: str = "prelu", with_idt: bool = False):
        super().__init__()
        self.act_type = act_type
        self.with_idt = with_idt and cin == cout
        self.conv3x3 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.conv1x1_3x3 = SeqConv3x3("conv1x1-conv3x3", cin, cout,
                                      depth_multiplier)
        self.conv1x1_sbx = SeqConv3x3("conv1x1-sobelx", cin, cout)
        self.conv1x1_sby = SeqConv3x3("conv1x1-sobely", cin, cout)
        self.conv1x1_lpl = SeqConv3x3("conv1x1-laplacian", cin, cout)
        if act_type == "prelu":
            self.act = nn.PReLU(num_parameters=cout)
        elif act_type == "relu":
            self.act = nn.ReLU()
        elif act_type != "linear":
            raise ValueError(f"act_type {act_type!r}: prelu, relu or linear")

    def branches(self):
        return (self.conv1x1_3x3, self.conv1x1_sbx, self.conv1x1_sby,
                self.conv1x1_lpl)

    def activate(self, y):
        if self.act_type == "prelu":
            return torch.where(y >= 0, y, y * self.act.weight.view(1, -1, 1,
                                                                   1))
        return relu(y) if self.act_type == "relu" else y

    def forward(self, x):
        y = self.conv3x3(x)
        for b in self.branches():
            y = y + b(x)
        if self.with_idt:
            y = y + x
        return self.activate(y)

    def rep_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        rk = self.conv3x3.weight.clone()
        rb = self.conv3x3.bias.clone()
        for b in self.branches():
            k, bb = b.rep_params()
            rk, rb = rk + k, rb + bb
        if self.with_idt:
            idx = torch.arange(rk.shape[0])
            rk[idx, idx, 1, 1] += 1.0
        return rk, rb


@ARCH_REGISTRY.register()
class ECBSR(nn.Module):
    def __init__(self, num_in_ch: int = 1, num_out_ch: int = 1,
                 num_block: int = 4, num_channel: int = 16,
                 with_idt: bool = False, act_type: str = "prelu",
                 scale: int = 4, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_in_ch, self.scale = num_in_ch, scale
        blocks = [ECB(num_in_ch, num_channel, act_type=act_type,
                      with_idt=with_idt)]
        blocks += [ECB(num_channel, num_channel, act_type=act_type,
                       with_idt=with_idt) for _ in range(num_block)]
        blocks.append(ECB(num_channel, num_out_ch * scale * scale,
                          act_type="linear", with_idt=with_idt))
        self.backbone = nn.Sequential(*blocks)
        if generator is not None:
            default_init_(self, generator)
            for m in self.modules():
                if isinstance(m, SeqConv3x3):
                    m.reset_(generator)
        finish(self, device, dtype)

    def _shortcut(self, x):
        if self.num_in_ch > 1:
            return torch.repeat_interleave(x, self.scale * self.scale, dim=1)
        return x

    def forward(self, x):
        """The training form: every ECB's branches summed."""
        return pixel_shuffle(self.backbone(x) + self._shortcut(x), self.scale)

    def rep_params(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each block collapsed to one 3x3 convolution (weight, bias)."""
        with torch.no_grad():
            return [blk.rep_params() for blk in self.backbone]

    def apply_rep(self, reps, x):
        """The net of rep_params' convolutions, each block's activation
        after it."""
        y = x
        for blk, (w, b) in zip(self.backbone, reps):
            y = blk.activate(conv2d(y, w, b, padding=1))
        return pixel_shuffle(y + self._shortcut(x), self.scale)
