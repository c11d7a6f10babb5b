"""Discriminators (reference archs/discriminator_arch.py), ported from
comfyui_keep_tpu/models/discriminators.py: the VGG-style one of SRGAN /
ESRGAN (128^2 or 256^2 input, BatchNorm on running statistics) and Real-
ESRGAN's U-Net under spectral norm. NCHW.

SpectralNormConv2d keeps torch's spectral_norm names (`weight_orig`,
`weight_u`, `weight_v`). In training its forward is torch's hook step: u
and v advance in place (ops/spectral.py layer_weight), and the
output equals the JAX package's apply from the same incoming u. In eval it
normalises weight_orig by one power iteration from weight_u and leaves the
buffers as they are, as the JAX package's apply does. HiFaceGAN and DFDNet
use it too.
"""
from typing import Optional

import torch
from torch import nn

from comfyui_keep_torch.models.init import (default_init_, finish,
                                            spectral_init_)
from comfyui_keep_torch.ops import (batch_norm, conv2d, leaky_relu, linear,
                                    resize_bilinear)
from comfyui_keep_torch.ops import spectral
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


class SpectralNormConv2d(nn.Module):
    """A Conv2d under torch's spectral_norm, by its state-dict names."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight_orig = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("weight_u", torch.ones(cout) / cout ** 0.5)
        n = cin * k * k
        self.register_buffer("weight_v", torch.ones(n) / n ** 0.5)

    def forward(self, x):
        return conv2d(x, spectral.layer_weight(self).to(x.dtype), self.bias,
                      self.stride, self.padding, self.dilation)


def build(module: nn.Module, device, dtype, generator):
    """Seeded init of convolutions, linears and spectral-norm layers, then
    device and dtype."""
    if generator is not None:
        default_init_(module, generator)
        spectral_init_(module, generator)
    return finish(module, device, dtype)


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator(nn.Module):
    """(B, C, S, S), S = input_size (128 or 256) -> (B, 1) logits."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 input_size: int = 128, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_size not in (128, 256):
            raise ValueError(f"input_size {input_size}: 128 or 256")
        nf = num_feat
        self.conv0_0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv0_1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = nn.BatchNorm2d(nf)
        self.names = ["0_1"]
        mults = [(1, 2), (2, 2), (2, 4), (4, 4), (4, 8), (8, 8), (8, 8),
                 (8, 8)] + ([(8, 8), (8, 8)] if input_size == 256 else [])
        for i, (mi, mo) in enumerate(mults):
            name = f"{i // 2 + 1}_{i % 2}"
            k, s = (3, 1) if i % 2 == 0 else (4, 2)
            setattr(self, f"conv{name}", nn.Conv2d(nf * mi, nf * mo, k, s, 1,
                                                   bias=False))
            setattr(self, f"bn{name}", nn.BatchNorm2d(nf * mo))
            self.names.append(name)
        self.linear1 = nn.Linear(nf * 8 * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)
        build(self, device, dtype, generator)

    def forward(self, x):
        x = leaky_relu(self.conv0_0(x), 0.2)
        for name in self.names:
            x = getattr(self, f"conv{name}")(x)
            x = leaky_relu(batch_norm(x, getattr(self, f"bn{name}")), 0.2)
        x = leaky_relu(linear(x.reshape(x.shape[0], -1), self.linear1.weight,
                              self.linear1.bias), 0.2)
        return linear(x, self.linear2.weight, self.linear2.bias)


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """(B, C, H, W), H and W multiples of 8 -> per-pixel logits (B, 1, H,
    W)."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_connection = skip_connection
        nf = num_feat
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        for i, (k, s, cin, cout) in enumerate(
                ((4, 2, 1, 2), (4, 2, 2, 4), (4, 2, 4, 8), (3, 1, 8, 4),
                 (3, 1, 4, 2), (3, 1, 2, 1), (3, 1, 1, 1), (3, 1, 1, 1)),
                start=1):
            setattr(self, f"conv{i}", SpectralNormConv2d(
                nf * cin, nf * cout, k, s, 1, bias=False))
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)
        build(self, device, dtype, generator)

    def forward(self, x):
        def up(z):
            return resize_bilinear(z, (z.shape[2] * 2, z.shape[3] * 2))

        x0 = leaky_relu(self.conv0(x), 0.2)
        x1 = leaky_relu(self.conv1(x0), 0.2)
        x2 = leaky_relu(self.conv2(x1), 0.2)
        x3 = leaky_relu(self.conv3(x2), 0.2)
        skips = (x2, x1, x0) if self.skip_connection else (0, 0, 0)
        h = x3
        for i, skip in zip((4, 5, 6), skips):
            h = leaky_relu(getattr(self, f"conv{i}")(up(h)), 0.2) + skip
        out = leaky_relu(self.conv7(h), 0.2)
        out = leaky_relu(self.conv8(out), 0.2)
        return self.conv9(out)
