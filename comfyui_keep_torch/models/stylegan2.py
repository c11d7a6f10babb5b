"""StyleGAN2 generator and discriminator (reference archs/stylegan2_arch.py),
ported from comfyui_keep_tpu/models/stylegan2.py. NCHW, with the
reference's module tree and state_dict names.

Every activation is the fused bias + leaky ReLU (ops/native.py, kernel K5 on
the card). The per-sample modulated convolution is one grouped convolution
with the batch in the groups (`conv_transpose2d` for the upsampling layers),
on cuDNN; the FIR resampling is `upfirdn2d`. The FIR kernels are
non-persistent buffers: they follow the module's device and stay out of the
state_dict, as in the reference.

Two departures of the JAX package from upstream are kept as it has them:
the generator draws its image from `styles[0]` only (style mixing changes
nothing), and its noise injection without a given noise adds nothing.
"""
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import finish
from comfyui_keep_torch.ops.native import (fused_leaky_relu,
                                           make_resample_kernel, upfirdn2d)
from comfyui_keep_torch.ops.resample import resize_bilinear

SQRT2 = math.sqrt(2.0)
RESAMPLE_KERNEL = (1, 3, 3, 1)


def channels_table(channel_multiplier=2, narrow=1):
    return {
        "4": int(512 * narrow), "8": int(512 * narrow), "16": int(512 * narrow),
        "32": int(512 * narrow), "64": int(256 * channel_multiplier * narrow),
        "128": int(128 * channel_multiplier * narrow),
        "256": int(64 * channel_multiplier * narrow),
        "512": int(32 * channel_multiplier * narrow),
        "1024": int(16 * channel_multiplier * narrow),
    }


# -- upfirdn wrappers (stylegan2_arch.py:43-131) ----------------------------

def upfirdn_upsample(x, kernel2d, factor=2):
    pad = kernel2d.shape[0] - factor
    return upfirdn2d(x, kernel2d * factor ** 2, up=factor, down=1,
                     pad=((pad + 1) // 2 + factor - 1, pad // 2))


def upfirdn_downsample(x, kernel2d, factor=2):
    pad = kernel2d.shape[0] - factor
    return upfirdn2d(x, kernel2d, up=1, down=factor,
                     pad=((pad + 1) // 2, pad // 2))


def upfirdn_smooth(x, kernel2d, upsample_factor=1, downsample_factor=1,
                   kernel_size=1):
    k = kernel2d
    if upsample_factor > 1:
        k = k * upsample_factor ** 2
        pad = (k.shape[0] - upsample_factor) - (kernel_size - 1)
        p = ((pad + 1) // 2 + upsample_factor - 1, pad // 2 + 1)
    elif downsample_factor > 1:
        pad = (k.shape[0] - downsample_factor) + (kernel_size - 1)
        p = ((pad + 1) // 2, pad // 2)
    else:
        raise NotImplementedError
    return upfirdn2d(x, k, up=1, down=1, pad=p)


class _FIR(nn.Module):
    """Holds a resampling FIR kernel as a non-persistent buffer."""

    def __init__(self, resample_kernel: Sequence[float]):
        super().__init__()
        self.register_buffer("kernel", make_resample_kernel(resample_kernel),
                             persistent=False)


class UpFirDnUpsample(_FIR):
    def forward(self, x):
        return upfirdn_upsample(x, self.kernel)


class UpFirDnSmooth(_FIR):
    def __init__(self, resample_kernel, upsample_factor=1, downsample_factor=1,
                 kernel_size=1):
        super().__init__(resample_kernel)
        self.up, self.down, self.ksize = (upsample_factor, downsample_factor,
                                          kernel_size)

    def forward(self, x):
        return upfirdn_smooth(x, self.kernel, self.up, self.down, self.ksize)


# -- equalized layers ---------------------------------------------------------

class EqualLinear(nn.Module):
    """weight (out, in) drawn N(0, 1) / lr_mul, scaled by lr_mul / sqrt(in)
    at run time, and a bias (bias_init_val); activation None or
    "fused_lrelu"."""

    def __init__(self, in_channels, out_channels, bias_init_val=0.0,
                 lr_mul=1.0, activation=None):
        super().__init__()
        self.lr_mul, self.bias_init_val = lr_mul, bias_init_val
        self.activation = activation
        self.scale = (1.0 / math.sqrt(in_channels)) * lr_mul
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    """weight (out, in, k, k) drawn N(0, 1), scaled by 1 / sqrt(in k^2); no
    bias (every StyleGAN2 conv takes its bias in the activation)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, stride=self.stride,
                        padding=self.padding)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


# -- modulated conv (stylegan2_arch.py:182-287) ------------------------------

class ModulatedConv2d(nn.Module):
    """Per-sample modulated (and demodulated) convolution. weight (1, out,
    in, k, k); modulation: style -> per-input-channel scale (bias init 1).
    sample_mode None, "upsample" (transposed conv, then the FIR smooth) or
    "downsample" (FIR smooth, then a stride-2 conv); `bilinear` resamples
    by bilinear interpolation before a plain conv instead."""

    def __init__(self, in_channels, out_channels, kernel_size, num_style_feat,
                 demodulate=True, sample_mode=None,
                 resample_kernel=RESAMPLE_KERNEL, bilinear=False, eps=1e-8):
        super().__init__()
        self.demodulate, self.sample_mode, self.eps = demodulate, sample_mode, eps
        self.bilinear = bilinear
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.modulation = EqualLinear(num_style_feat, in_channels,
                                      bias_init_val=1.0)
        self.weight = nn.Parameter(torch.empty(1, out_channels, in_channels,
                                               kernel_size, kernel_size))
        if sample_mode is not None and not bilinear:
            self.smooth = UpFirDnSmooth(
                resample_kernel, upsample_factor=2 if sample_mode == "upsample"
                else 1, downsample_factor=2 if sample_mode == "downsample"
                else 1, kernel_size=kernel_size)

    def forward(self, x, style):
        b, cin, h, w = x.shape
        _, cout, _, kh, kw = self.weight.shape
        s = self.modulation(style)                      # (b, cin)
        weight = self.scale * self.weight * s[:, None, :, None, None]
        if self.demodulate:
            demod = torch.rsqrt(weight.pow(2).sum(dim=(2, 3, 4)) + self.eps)
            weight = weight * demod[:, :, None, None, None]
        if self.bilinear and self.sample_mode is not None:
            f = 2 if self.sample_mode == "upsample" else 0.5
            x = resize_bilinear(x, (int(h * f), int(w * f)))
            b, cin, h, w = x.shape
        elif self.sample_mode == "upsample":
            wt = weight.transpose(1, 2).reshape(b * cin, cout, kh, kw)
            out = F.conv_transpose2d(x.reshape(1, b * cin, h, w), wt, stride=2,
                                     groups=b)
            out = out.reshape(b, cout, out.shape[-2], out.shape[-1])
            return self.smooth(out)
        elif self.sample_mode == "downsample":
            x = self.smooth(x)
            h, w = x.shape[-2:]
            out = F.conv2d(x.reshape(1, b * cin, h, w),
                           weight.reshape(b * cout, cin, kh, kw), stride=2,
                           groups=b)
            return out.reshape(b, cout, out.shape[-2], out.shape[-1])
        out = F.conv2d(x.reshape(1, b * cin, h, w),
                       weight.reshape(b * cout, cin, kh, kw),
                       padding=kh // 2, groups=b)
        return out.reshape(b, cout, h, w)


class StyleConv(nn.Module):
    """Modulated conv, noise injection (weight (1,)), fused bias + leaky
    ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size, num_style_feat,
                 demodulate=True, sample_mode=None,
                 resample_kernel=RESAMPLE_KERNEL, bilinear=False):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate=demodulate, sample_mode=sample_mode,
            resample_kernel=resample_kernel, bilinear=bilinear)
        self.weight = nn.Parameter(torch.empty(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise=None):
        out = self.modulated_conv(x, style)
        if noise is not None:
            out = out + self.weight * noise
        return self.activate(out)


class ToRGB(nn.Module):
    def __init__(self, in_channels, num_style_feat, upsample=True,
                 resample_kernel=RESAMPLE_KERNEL, bilinear=False):
        super().__init__()
        self.bilinear = bilinear
        if upsample and not bilinear:
            self.upsample = UpFirDnUpsample(resample_kernel)
        self.modulated_conv = ModulatedConv2d(
            in_channels, 3, 1, num_style_feat, demodulate=False,
            bilinear=bilinear)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.bilinear:
                h, w = skip.shape[-2:]
                skip = resize_bilinear(skip, (2 * h, 2 * w))
            else:
                skip = self.upsample(skip)
            out = out + skip
        return out


class NormStyleCode(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x ** 2, dim=1, keepdim=True) + 1e-8)


class ConstantInput(nn.Module):
    def __init__(self, channels, size=4):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, channels, size, size))

    def forward(self, batch):
        return self.weight.repeat(batch, 1, 1, 1)


def _init_(module: nn.Module, gen: torch.Generator):
    """The JAX package's init: normal weights (mapping layers / lr_mul),
    modulation bias 1, zero noise weights and biases, normal constant
    input and stored noises, drawn on the CPU in module order."""
    def normal(t, div=1.0):
        t.copy_(torch.randn(t.shape, generator=gen) / div)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, EqualLinear):
                normal(m.weight, m.lr_mul)
                m.bias.fill_(m.bias_init_val)
            elif isinstance(m, (EqualConv2d, ModulatedConv2d, ConstantInput)):
                normal(m.weight)
            elif isinstance(m, (StyleConv, FusedLeakyReLU, ToRGB)):
                for p in m._parameters.values():
                    p.zero_()
        for name, buf in module.named_buffers():
            if name.startswith("noises."):
                normal(buf)


def _stored_noises(num_layers):
    noises = nn.Module()
    for i in range(num_layers):
        r = 2 ** ((i + 5) // 2)
        noises.register_buffer(f"noise{i}", torch.empty(1, 1, r, r))
    return noises


class StyleGAN2Generator(nn.Module):
    """StyleGAN2 generator: the mapping MLP (style_mlp), a 4x4 constant
    input, two style convs per resolution up to out_size and a ToRGB skip
    path. Runs on "cuda" unless given device="cpu"; weights seeded from
    `generator` (seed 0 without one). `bilinear`: resample by bilinear
    interpolation instead of the FIR (models/stylegan2_bilinear.py)."""
    bilinear = False

    def __init__(self, out_size, num_style_feat=512, num_mlp=8,
                 channel_multiplier=2, narrow=1, lr_mlp=0.01,
                 resample_kernel=RESAMPLE_KERNEL, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ch = channels_table(channel_multiplier, narrow)
        self.out_size, self.num_style_feat = out_size, num_style_feat
        self.log_size = int(math.log2(out_size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        kw = dict(resample_kernel=resample_kernel, bilinear=self.bilinear)
        self.style_mlp = nn.Sequential(NormStyleCode(), *(
            EqualLinear(num_style_feat, num_style_feat, lr_mul=lr_mlp,
                        activation="fused_lrelu")
            for _ in range(num_mlp)))
        self.constant_input = ConstantInput(ch["4"])
        self.style_conv1 = StyleConv(ch["4"], ch["4"], 3, num_style_feat, **kw)
        self.to_rgb1 = ToRGB(ch["4"], num_style_feat, upsample=False, **kw)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        cin = ch["4"]
        for i in range(3, self.log_size + 1):
            cout = ch[str(2 ** i)]
            self.style_convs.append(StyleConv(cin, cout, 3, num_style_feat,
                                              sample_mode="upsample", **kw))
            self.style_convs.append(StyleConv(cout, cout, 3, num_style_feat,
                                              **kw))
            self.to_rgbs.append(ToRGB(cout, num_style_feat, **kw))
            cin = cout
        self.noises = _stored_noises(self.num_layers)
        _init_(self, generator or torch.Generator().manual_seed(0))
        finish(self, device, dtype)

    def make_noise(self, batch: int, generator: Optional[torch.Generator],
                   dtype=None, device=None) -> List[torch.Tensor]:
        """Fresh N(0, 1) noise for every layer: (batch, 1, r, r) at layer i's
        resolution r = 2 ** ((i + 5) // 2)."""
        dtype = dtype or self.constant_input.weight.dtype
        device = device or self.constant_input.weight.device
        return [torch.randn((batch, 1, 2 ** ((i + 5) // 2),
                             2 ** ((i + 5) // 2)), generator=generator,
                            dtype=dtype, device=device)
                for i in range(self.num_layers)]

    def forward(self, styles: List[torch.Tensor], input_is_latent=False,
                noise: Optional[List[torch.Tensor]] = None,
                randomize_noise=False,
                generator: Optional[torch.Generator] = None,
                truncation=1.0, truncation_latent=None, return_latents=False):
        """styles: list of (B, S) codes (or (B, num_latent, S) latents) ->
        (image (B, 3, out_size, out_size), latent or None). Noise: the given
        per-layer list, else fresh noise from `generator` when
        randomize_noise, else the stored buffers."""
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        s0 = styles[0]
        b = s0.shape[0]
        if noise is None:
            noise = (self.make_noise(b, generator, s0.dtype, s0.device)
                     if randomize_noise else
                     [getattr(self.noises, f"noise{i}")
                      for i in range(self.num_layers)])
        latent = (s0[:, None].repeat(1, self.num_latent, 1) if s0.dim() < 3
                  else s0)
        out = self.constant_input(b)
        out = self.style_conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for li, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * li](out, latent[:, i], noise[2 * li + 1])
            out = self.style_convs[2 * li + 1](out, latent[:, i + 1],
                                               noise[2 * li + 2])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip, (latent if return_latents else None)


# -- discriminator -------------------------------------------------------------

class ConvLayer(nn.Sequential):
    """[FIR smooth,] EqualConv2d (no bias) [, fused bias + leaky ReLU]
    (stylegan2_arch.py:654-703): the reference's Sequential indices."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 downsample=False, resample_kernel=RESAMPLE_KERNEL,
                 activate=True):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(resample_kernel, downsample_factor=2,
                                        kernel_size=kernel_size))
        layers.append(EqualConv2d(
            in_channels, out_channels, kernel_size,
            stride=2 if downsample else 1,
            padding=0 if downsample else kernel_size // 2))
        if activate:
            layers.append(FusedLeakyReLU(out_channels))
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(self, in_channels, out_channels,
                 resample_kernel=RESAMPLE_KERNEL):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               resample_kernel=resample_kernel)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              resample_kernel=resample_kernel, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / SQRT2


class StyleGAN2Discriminator(nn.Module):
    """StyleGAN2 discriminator: ResBlocks down to 4x4, the minibatch-stddev
    channel over groups of min(B, stddev_group), a 3x3 conv and two linear
    layers. Runs on "cuda" unless given device="cpu"."""

    def __init__(self, out_size, channel_multiplier=2, narrow=1,
                 resample_kernel=RESAMPLE_KERNEL, stddev_group=4,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ch = channels_table(channel_multiplier, narrow)
        log_size = int(math.log2(out_size))
        body = [ConvLayer(3, ch[str(out_size)], 1)]
        cin = ch[str(out_size)]
        for i in range(log_size, 2, -1):
            cout = ch[str(2 ** (i - 1))]
            body.append(ResBlock(cin, cout, resample_kernel))
            cin = cout
        self.conv_body = nn.Sequential(*body)
        self.final_conv = ConvLayer(cin + 1, ch["4"], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(ch["4"] * 16, ch["4"], activation="fused_lrelu"),
            EqualLinear(ch["4"], 1))
        self.stddev_group = stddev_group
        _init_(self, generator or torch.Generator().manual_seed(0))
        finish(self, device, dtype)

    def forward(self, x):
        out = self.conv_body(x)
        b, c, h, w = out.shape
        group = min(b, self.stddev_group)
        std = out.reshape(group, b // group, 1, c, h, w)
        std = torch.sqrt(std.var(dim=0, unbiased=False) + 1e-8)
        std = std.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        out = torch.cat([out, std.repeat(group, 1, h, w)], dim=1)
        out = self.final_conv(out)
        return self.final_linear(out.reshape(b, -1))
