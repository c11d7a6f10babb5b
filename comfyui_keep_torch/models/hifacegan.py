"""HiFaceGAN (reference archs/hifacegan_arch.py, hifacegan_util.py), ported
from comfyui_keep_tpu/models/hifacegan.py: a SPADE-modulated generator fed
by a local-importance-pooling (LIP) encoder, and the pix2pixHD multi-scale
PatchGAN discriminator under spectral-instance norm. NCHW.

The SPADE blocks normalise by instance norm (the reference's 'syncbatch'
falls back to it, as in the JAX package). LIP pools by a 3x3 stride-2
average with count_include_pad=True, weighted by exp of a logit gated to
sigmoid x 12. Keys are the reference's; the generator's `fc` convolution,
which the reference builds and its forward never uses, is kept so its
state dicts load.
"""
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.discriminators import (SpectralNormConv2d,
                                                      build)
from comfyui_keep_torch.ops import (instance_norm, leaky_relu, relu,
                                    resize_nearest, upsample_nearest_2x)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


def _in_affine(m: nn.InstanceNorm2d, x):
    return instance_norm(x) * m.weight.view(1, -1, 1, 1) + m.bias.view(
        1, -1, 1, 1)


class SPADE(nn.Module):
    """Instance norm, then a per-pixel scale and shift predicted from the
    guidance image resized (nearest) to the feature's size."""

    def __init__(self, norm_nc: int, label_nc: int, ks: int = 3):
        super().__init__()
        nhidden = 128 if norm_nc > 128 else norm_nc
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, nhidden, ks, padding=ks // 2), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=ks // 2,
                                   bias=False)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=ks // 2,
                                  bias=False)

    def forward(self, x, segmap):
        seg = resize_nearest(segmap, x.shape[2:])
        actv = relu(self.mlp_shared[0](seg))
        return (instance_norm(x) * self.mlp_gamma(actv)
                + self.mlp_beta(actv))


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, semantic_nc: int = 3):
        super().__init__()
        fmid = min(fin, fout)
        self.conv_0 = SpectralNormConv2d(fin, fmid, 3, padding=1)
        self.conv_1 = SpectralNormConv2d(fmid, fout, 3, padding=1)
        self.norm_0 = SPADE(fin, semantic_nc)
        self.norm_1 = SPADE(fmid, semantic_nc)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.conv_s = SpectralNormConv2d(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, semantic_nc)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(leaky_relu(self.norm_1(dx, seg), 0.2))
        return xs + dx


def _avg_pool3s2(x):
    """F.avg_pool2d(3, stride 2, padding 1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, 2, 1)


class SimplifiedLIP(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.logit = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1, bias=False),
            nn.InstanceNorm2d(channels, affine=True), nn.Sigmoid())

    def forward(self, x):
        lg = _in_affine(self.logit[1], self.logit[0](x))
        w = torch.exp(torch.sigmoid(lg) * 12.0)  # SoftGate, COEFF 12
        return _avg_pool3s2(x * w) / _avg_pool3s2(w)


class LIPEncoder(nn.Module):
    """conv + IN + ReLU, then n_2xdown (LIP, conv, IN[, ReLU]) stages, each
    halving the size; channels ngf * min(2^i, 16)."""

    def __init__(self, input_nc: int, ngf: int, n_2xdown: int):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ngf, 3, padding=1, bias=False),
                  nn.InstanceNorm2d(ngf), nn.ReLU()]
        cur = 1
        for i in range(n_2xdown):
            nxt = min(cur * 2, 16)
            layers += [SimplifiedLIP(ngf * cur),
                       nn.Conv2d(ngf * cur, ngf * nxt, 3, padding=1),
                       nn.InstanceNorm2d(ngf * nxt)]
            cur = nxt
            if i < n_2xdown - 1:
                layers.append(nn.ReLU())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        for m in self.model:
            if isinstance(m, nn.Conv2d):
                x = m(x)
            elif isinstance(m, nn.InstanceNorm2d):
                x = instance_norm(x)
            elif isinstance(m, nn.ReLU):
                x = relu(x)
            else:
                x = m(x)
        return x


@ARCH_REGISTRY.register()
class HiFaceGAN(nn.Module):
    SCALE_RATIO = 5
    JAX_ABSENT = ("fc.weight", "fc.bias")

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 phase: int = 4, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nf = num_feat
        self.phase = phase
        self.fc = nn.Conv2d(num_in_ch, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        widths = (16 * nf, 8 * nf, 4 * nf, 2 * nf, nf)
        self.ups = nn.ModuleList([SPADEResnetBlock(a, b, num_in_ch)
                                  for a, b in zip(widths, widths[1:])])
        self.to_rgbs = nn.ModuleList([nn.Conv2d(c, 3, 3, padding=1)
                                      for c in widths[1:]])
        self.lip_encoder = LIPEncoder(num_in_ch, nf, self.SCALE_RATIO)
        build(self, device, dtype, generator)

    def _generate(self, guides: List[torch.Tensor]):
        """guides: the guidance image of the encoder, then of each of the
        3 + phase SPADE stages."""
        h = self.lip_encoder(guides[0])
        h = self.head_0(h, guides[1])
        h = upsample_nearest_2x(h)
        h = self.g_middle_0(h, guides[2])
        h = self.g_middle_1(h, guides[3])
        for i in range(self.phase):
            h = self.ups[i](upsample_nearest_2x(h), guides[4 + i])
        rgb = self.to_rgbs[self.phase - 1]
        return torch.tanh(rgb(leaky_relu(h, 0.2)))

    def forward(self, x):
        """x: (B, 3, H, W), H and W multiples of 32 -> tanh (B, 3, H, W)."""
        return self._generate([x] * (4 + self.phase))

    def mixed_guidance_forward(self, input_x, seg=None, n: int = 0,
                               mode: str = "progressive"):
        """The subspace-visualisation forward (hifacegan_arch.py): of the
        4 + phase guided stages, 'progressive' guides the first n by
        input_x and the rest by seg; 'one_plug' all by seg but stage n by
        input_x; 'one_ablate' all by input_x but stage n by seg."""
        if seg is None:
            return self.forward(input_x)
        total = 4 + self.phase
        if mode == "progressive":
            n = max(min(n, total), 0)
            guides = [input_x] * n + [seg] * (total - n)
        elif mode == "one_plug":
            n = max(min(n, total - 1), 0)
            guides = [seg] * total
            guides[n] = input_x
        elif mode == "one_ablate":
            if n > total - 1:
                return self.forward(input_x)
            guides = [input_x] * total
            guides[n] = seg
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return self._generate(guides)


class NLayerDiscriminator(nn.Module):
    """4x4 convs with padding 2: the first stride 2 with leaky ReLU, then
    n_layers_d - 1 spectral-norm convs with instance norm (stride 2, the
    last 1), then a 1-channel conv; `model{n}` as the reference groups
    them, each group's output returned."""

    def __init__(self, input_nc: int, n_layers_d: int, num_feat: int):
        super().__init__()
        nf = num_feat
        self.model0 = nn.Sequential(nn.Conv2d(input_nc, nf, 4, 2, 2),
                                    nn.LeakyReLU(0.2))
        for n in range(1, n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_d - 1 else 2
            setattr(self, f"model{n}", nn.Sequential(nn.Sequential(
                SpectralNormConv2d(nf_prev, nf, 4, stride, 2, bias=False),
                nn.InstanceNorm2d(nf)), nn.LeakyReLU(0.2)))
        setattr(self, f"model{n_layers_d}",
                nn.Sequential(nn.Conv2d(nf, 1, 4, 1, 2)))
        self.n_groups = n_layers_d + 1

    def forward(self, x):
        results = []
        h = leaky_relu(self.model0[0](x), 0.2)
        results.append(h)
        for n in range(1, self.n_groups - 1):
            h = leaky_relu(instance_norm(getattr(self, f"model{n}")[0][0](h)),
                           0.2)
            results.append(h)
        last = getattr(self, f"model{self.n_groups - 1}")[0]
        results.append(last(h))
        return results


@ARCH_REGISTRY.register()
class HiFaceGANDiscriminator(nn.Module):
    """num_d NLayerDiscriminators, each on the input average-pooled (3x3,
    stride 2, count_include_pad=False) once more than the one before."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 conditional_d: bool = True, num_d: int = 2,
                 n_layers_d: int = 4, num_feat: int = 64,
                 keep_features: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_d, self.keep_features = num_d, keep_features
        input_nc = num_in_ch + (num_out_ch if conditional_d else 0)
        for i in range(num_d):
            setattr(self, f"discriminator_{i}", NLayerDiscriminator(
                input_nc, n_layers_d, num_feat))
        build(self, device, dtype, generator)

    def forward(self, x):
        """-> per scale, the list of every group's output (keep_features)
        or the last one."""
        out = []
        for i in range(self.num_d):
            res = getattr(self, f"discriminator_{i}")(x)
            out.append(res if self.keep_features else res[-1])
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return out
