"""SpyNet optical flow (reference archs/spynet_arch.py), the flow network of
BasicVSR, IconVSR and BasicVSR++, ported from
comfyui_keep_tpu/models/spynet.py. A six-level coarse-to-fine pyramid:
each level upsamples the flow (x2, align_corners=True, an edge row or
column added where the level is odd), warps the support frame by it with
border padding and adds a 7x7 five-conv module's residual.

NCHW; flows (N, 2, H, W) with channel 0 the x displacement, as the
reference returns them. Keys are the reference's
(`basic_module.{level}.basic_module.{0,2,4,6,8}`, the `mean` / `std`
buffers).
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import (avg_pool_2x, conv2d, flow_warp, relu,
                                    resize_bilinear)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_DIMS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


class BasicModule(nn.Module):
    """Five 7x7 convolutions with ReLUs between, at Sequential indices 0, 2,
    4, 6, 8."""

    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in _DIMS:
            layers += [nn.Conv2d(cin, cout, 7, 1, 3), nn.ReLU()]
        self.basic_module = nn.Sequential(*layers[:-1])

    def forward(self, x):
        for i in range(0, 9, 2):
            m = self.basic_module[i]
            x = conv2d(x, m.weight, m.bias, padding=3)
            if i < 8:
                x = relu(x)
        return x


def upsample_flow(flow, hw):
    """x2 bilinear upsample (align_corners=True) of a (N, 2, h, w) flow,
    its displacements doubled, an edge row / column replicated where the
    level (hw) is odd."""
    up = resize_bilinear(flow, (flow.shape[2] * 2, flow.shape[3] * 2),
                         align_corners=True) * 2.0
    return F.pad(up, (0, hw[1] - up.shape[3], 0, hw[0] - up.shape[2]),
                 mode="replicate")


@ARCH_REGISTRY.register()
class SpyNet(nn.Module):
    JAX_ABSENT = ("mean", "std")

    def __init__(self, device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(6)])
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1))
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def process(self, ref, supp):
        mean, std = self.mean.to(ref.dtype), self.std.to(ref.dtype)
        refs, supps = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(5):
            refs.insert(0, avg_pool_2x(refs[0]))
            supps.insert(0, avg_pool_2x(supps[0]))
        flow = ref.new_zeros((ref.shape[0], 2, refs[0].shape[2] // 2,
                              refs[0].shape[3] // 2))
        for level in range(6):
            up = upsample_flow(flow, refs[level].shape[2:])
            warped = flow_warp(supps[level], up.permute(0, 2, 3, 1),
                               padding_mode="border")
            flow = self.basic_module[level](
                torch.cat([refs[level], warped, up], 1)) + up
        return flow

    def forward(self, ref, supp):
        """ref / supp: (N, 3, H, W) in [0, 1] -> flow (N, 2, H, W) from ref
        to supp. The frames are resized to multiples of 32 and the flow
        back, its displacements scaled by the ratio."""
        h, w = ref.shape[2], ref.shape[3]
        hf = math.floor(math.ceil(h / 32.0) * 32.0)
        wf = math.floor(math.ceil(w / 32.0) * 32.0)
        flow = resize_bilinear(self.process(resize_bilinear(ref, (hf, wf)),
                                            resize_bilinear(supp, (hf, wf))),
                               (h, w))
        scale = torch.tensor([w / wf, h / hf], dtype=flow.dtype,
                             device=flow.device)
        return flow * scale.view(1, 2, 1, 1)
