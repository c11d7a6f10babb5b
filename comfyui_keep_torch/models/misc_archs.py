"""TOFlow (reference tof_arch.py), DUF (duf_arch.py) and the ResNetArcFace
identity network (arcface_arch.py), ported from
comfyui_keep_tpu/models/misc_archs.py. NCHW; clips (B, T, 3, H, W).
BatchNorm runs in inference form, on its running statistics. Keys are the
reference's.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.models.sr_basic import pixel_shuffle
from comfyui_keep_torch.ops import (avg_pool_2x, batch_norm, flow_warp,
                                    linear, max_pool, relu, resize_bilinear)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _build(module: nn.Module, device, dtype, generator):
    if generator is not None:
        default_init_(module, generator)
    return finish(module, device, dtype)


def _bn(m, x):
    return batch_norm(x, m, m.eps)


# -- TOFlow ----------------------------------------------------------------------

class TOFlowBasicModule(nn.Module):
    """Four 7x7 conv + BatchNorm + ReLU triples, then a 7x7 conv with bias
    (`basic_module` indices 0, 3, 6, 9 and 12)."""

    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in ((8, 32), (32, 64), (64, 32), (32, 16)):
            layers += [nn.Conv2d(cin, cout, 7, 1, 3, bias=False),
                       nn.BatchNorm2d(cout), nn.ReLU()]
        layers.append(nn.Conv2d(16, 2, 7, 1, 3))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        for i in range(0, 12, 3):
            x = relu(_bn(self.basic_module[i + 1],
                         self.basic_module[i](x)))
        return self.basic_module[12](x)


class SpyNetTOF(nn.Module):
    """TOFlow's four-level SpyNet on normalised frames whose sides are
    multiples of 16."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList([TOFlowBasicModule()
                                           for _ in range(4)])

    def forward(self, ref, supp):
        """ref / supp: (N, 3, H, W) -> flow (N, 2, H, W)."""
        refs, supps = [ref], [supp]
        for _ in range(3):
            refs.insert(0, avg_pool_2x(refs[0]))
            supps.insert(0, avg_pool_2x(supps[0]))
        flow = ref.new_zeros(ref.shape[0], 2, ref.shape[2] // 16,
                             ref.shape[3] // 16)
        for i in range(4):
            up = resize_bilinear(flow, (flow.shape[2] * 2, flow.shape[3] * 2),
                                 align_corners=True) * 2.0
            warped = flow_warp(supps[i], up.permute(0, 2, 3, 1))
            flow = up + self.basic_module[i](torch.cat([refs[i], warped, up],
                                                       1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(nn.Module):
    JAX_ABSENT = ("mean", "std")

    def __init__(self, adapt_official_weights: bool = False, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1))
        self.spynet = SpyNetTOF()
        self.conv_1 = nn.Conv2d(3 * 7, 64, 9, 1, 4)
        self.conv_2 = nn.Conv2d(64, 64, 9, 1, 4)
        self.conv_3 = nn.Conv2d(64, 64, 1)
        self.conv_4 = nn.Conv2d(64, 3, 1)
        _build(self, device, dtype, generator)

    def forward(self, lrs):
        """lrs: (B, 7, 3, H, W) in [0, 1], H and W multiples of 16 -> (B, 3,
        H, W). With adapt_official_weights frame 3 moves to the front and
        frame 0 is the reference (tof_arch.py)."""
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        b, t, c, h, w = lrs.shape
        mean, std = self.mean.to(lrs.dtype), self.std.to(lrs.dtype)
        lrs = (lrs - mean[:, None]) / std[:, None]
        lr_ref = lrs[:, self.ref_idx]
        others = [i for i in range(t) if i != self.ref_idx]
        supp = lrs[:, others].reshape(-1, c, h, w)
        ref = lr_ref[:, None].expand(b, len(others), c, h, w).reshape(
            -1, c, h, w)
        warped = flow_warp(supp, self.spynet(ref, supp).permute(0, 2, 3, 1))
        aligned = list(warped.reshape(b, len(others), c, h, w).unbind(1))
        aligned.insert(self.ref_idx, lr_ref)
        hr = relu(self.conv_1(torch.cat(aligned, 1)))
        hr = relu(self.conv_2(hr))
        hr = relu(self.conv_3(hr))
        hr = self.conv_4(hr) + lr_ref
        return hr * std + mean


# -- DUF -------------------------------------------------------------------------

def _bn_relu_conv3d(cin: int, cmid: int, cout: int, temporal_pad: int
                    ) -> nn.Sequential:
    """BN, ReLU, 1x1x1 conv, BN, ReLU, 3x3x3 conv (Sequential indices 0-5)."""
    return nn.Sequential(
        nn.BatchNorm3d(cin), nn.ReLU(), nn.Conv3d(cin, cmid, 1),
        nn.BatchNorm3d(cmid), nn.ReLU(),
        nn.Conv3d(cmid, cout, 3, 1, (temporal_pad, 1, 1)))


def _run_bn_relu_conv3d(seq: nn.Sequential, x):
    x = seq[2](relu(_bn(seq[0], x)))
    return seq[5](relu(_bn(seq[3], x)))


class DenseBlocks(nn.Module):
    def __init__(self, num_block: int, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.dense_blocks = nn.ModuleList([
            _bn_relu_conv3d(num_feat + i * num_grow_ch,
                            num_feat + i * num_grow_ch, num_grow_ch, 1)
            for i in range(num_block)])

    def forward(self, x):
        for seq in self.dense_blocks:
            x = torch.cat([x, _run_bn_relu_conv3d(seq, x)], 1)
        return x


class DenseBlocksTemporalReduce(nn.Module):
    """Three dense blocks without temporal padding: each drops a frame at
    both ends."""

    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        for i in range(3):
            c = num_feat + i * num_grow_ch
            setattr(self, f"temporal_reduce{i + 1}",
                    _bn_relu_conv3d(c, c, num_grow_ch, 0))

    def forward(self, x):
        for i in range(3):
            y = _run_bn_relu_conv3d(getattr(self, f"temporal_reduce{i + 1}"),
                                    x)
            x = torch.cat([x[:, :, 1:-1], y], 1)
        return x


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    """Dynamic upsampling filters: per pixel a softmax over 25 taps of the
    centre frame's 5x5 neighbourhood for each of the scale^2 sub-pixels,
    plus a residual. 7 frames in."""
    CFG = {16: (3, 32), 28: (9, 16), 52: (21, 16)}

    def __init__(self, scale: int = 4, num_layer: int = 52, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = scale
        num_block, gc = self.CFG[num_layer]
        self.conv3d1 = nn.Conv3d(3, 64, (1, 3, 3), 1, (0, 1, 1))
        self.dense_block1 = DenseBlocks(num_block, 64, gc)
        nf = 64 + num_block * gc
        self.dense_block2 = DenseBlocksTemporalReduce(nf, gc)
        ch = nf + 3 * gc
        self.bn3d2 = nn.BatchNorm3d(ch)
        self.conv3d2 = nn.Conv3d(ch, 256, (1, 3, 3), 1, (0, 1, 1))
        self.conv3d_r1 = nn.Conv3d(256, 256, 1)
        self.conv3d_r2 = nn.Conv3d(256, 3 * scale ** 2, 1)
        self.conv3d_f1 = nn.Conv3d(256, 512, 1)
        self.conv3d_f2 = nn.Conv3d(512, 25 * scale ** 2, 1)
        _build(self, device, dtype, generator)

    def forward(self, x):
        """x: (B, 7, 3, H, W) -> (B, 3, H * scale, W * scale)."""
        b, t, _, h, w = x.shape
        s2 = self.scale ** 2
        x = x.permute(0, 2, 1, 3, 4)  # (b, c, t, h, w) for conv3d
        x_center = x[:, :, t // 2]
        z = self.dense_block2(self.dense_block1(self.conv3d1(x)))
        z = relu(_bn(self.bn3d2, z))
        z = relu(self.conv3d2(z))
        res = self.conv3d_r2(relu(self.conv3d_r1(z)))
        filt = self.conv3d_f2(relu(self.conv3d_f1(z)))
        filt = torch.softmax(filt.reshape(b, 25, s2, h, w), dim=1)
        patches = F.unfold(x_center, 5, padding=2).reshape(b, 3, 25, h, w)
        out = torch.einsum("bckhw,bkuhw->bcuhw", patches, filt)
        out = out.reshape(b, 3 * s2, h, w) + res[:, :, 0]
        return pixel_shuffle(out, self.scale)


# -- ResNetArcFace ---------------------------------------------------------------

def _prelu(m: nn.PReLU, x):
    """PReLU with one slope (the JAX package's where form)."""
    return torch.where(x >= 0, x, x * m.weight)


class SEBlock(nn.Module):
    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channel, channel // reduction), nn.PReLU(),
            nn.Linear(channel // reduction, channel), nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = _prelu(self.fc[1], linear(y, self.fc[0].weight, self.fc[0].bias))
        y = torch.sigmoid(linear(y, self.fc[2].weight, self.fc[2].bias))
        return x * y[:, :, None, None]


class IRBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_se: bool = True):
        super().__init__()
        self.stride = stride
        self.bn0 = nn.BatchNorm2d(inplanes)
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(inplanes)
        self.prelu = nn.PReLU()
        self.conv2 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))
        self.se = SEBlock(planes) if use_se else None

    def forward(self, x):
        out = _bn(self.bn1, self.conv1(_bn(self.bn0, x)))
        out = _bn(self.bn2, self.conv2(_prelu(self.prelu, out)))
        if self.se is not None:
            out = self.se(out)
        res = x
        if self.downsample is not None:
            res = _bn(self.downsample[1], self.downsample[0](x))
        return _prelu(self.prelu, out + res)


@ARCH_REGISTRY.register()
class ResNetArcFace(nn.Module):
    """IR-SE ResNet of ArcFace (the reference's IRBlock form): (B, 1, 128,
    128) gray -> (B, 512)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 use_se: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.prelu = nn.PReLU()
        cin = 64
        for li, (n, planes, stride) in enumerate(
                zip(layers, (64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            blocks = []
            for bi in range(n):
                blocks.append(IRBlock(cin, planes, stride if bi == 0 else 1,
                                      use_se))
                cin = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.bn4 = nn.BatchNorm2d(512)
        self.fc5 = nn.Linear(512 * 8 * 8, 512)
        self.bn5 = nn.BatchNorm1d(512)
        _build(self, device, dtype, generator)

    def forward(self, x):
        h = _prelu(self.prelu, _bn(self.bn1, self.conv1(x)))
        h = max_pool(h, 2, 2)
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
        h = _bn(self.bn4, h).reshape(h.shape[0], -1)
        return _bn(self.bn5, linear(h, self.fc5.weight, self.fc5.bias))
