"""InceptionV3 feature extractor for FID (reference archs/inception.py, the
pytorch-fid port of the TF Inception), ported from
comfyui_keep_tpu/models/inception.py. FID's own pooling: the branch pools
of Mixed_5b-7b average over 3x3 with count_include_pad=False, Mixed_7c's
takes a 3x3 max. The input is resized to 299^2 bilinearly without
antialiasing and mapped to [-1, 1].

Keys are torchvision's (`Mixed_5b.branch1x1.conv.weight`), the names of
the pt_inception-2015-12-05 FID weights, as in the JAX package; BatchNorm
eps 1e-3, on running statistics. NCHW.
"""
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import (batch_norm, max_pool, relu,
                                    resize_bilinear)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


def _avg_pool3_nocount(x):
    """AvgPool2d(3, 1, 1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return relu(batch_norm(self.conv(x), self.bn,
                               self.bn.eps))


def _branches(module: nn.Module, specs):
    for name, cin, cout, k, s, p in specs:
        setattr(module, name, BasicConv2d(cin, cout, k, s, p))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        _branches(self, (
            ("branch1x1", cin, 64, 1, 1, 0),
            ("branch5x5_1", cin, 48, 1, 1, 0), ("branch5x5_2", 48, 64, 5, 1, 2),
            ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 1, 1),
            ("branch_pool", cin, pool_features, 1, 1, 0)))

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool3_nocount(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        _branches(self, (
            ("branch3x3", cin, 384, 3, 2, 0),
            ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 2, 0)))

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            max_pool(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        _branches(self, (
            ("branch1x1", cin, 192, 1, 1, 0),
            ("branch7x7_1", cin, c7, 1, 1, 0),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", cin, c7, 1, 1, 0),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", cin, 192, 1, 1, 0)))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool3_nocount(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        _branches(self, (
            ("branch3x3_1", cin, 192, 1, 1, 0),
            ("branch3x3_2", 192, 320, 3, 2, 0),
            ("branch7x7x3_1", cin, 192, 1, 1, 0),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, 192, 3, 2, 0)))

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          max_pool(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """FIDInceptionE_1 (pool "avg") or FIDInceptionE_2 (pool "max")."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        _branches(self, (
            ("branch1x1", cin, 320, 1, 1, 0),
            ("branch3x3_1", cin, 384, 1, 1, 0),
            ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch3x3dbl_1", cin, 448, 1, 1, 0),
            ("branch3x3dbl_2", 448, 384, 3, 1, 1),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch_pool", cin, 192, 1, 1, 0)))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_avg_pool3_nocount(x) if self.pool == "avg"
              else max_pool(x, 3, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


@ARCH_REGISTRY.register()
class InceptionV3(nn.Module):
    DEFAULT_BLOCK_INDEX = 3
    BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}

    def __init__(self, output_blocks: Sequence[int] = (DEFAULT_BLOCK_INDEX,),
                 resize_input: bool = True, normalize_input: bool = True,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x) -> List[torch.Tensor]:
        """x: (B, 3, H, W) in [0, 1] -> the requested blocks' outputs: 0
        (64 ch), 1 (192), 2 (768), 3 (2048, global mean, (B, 2048, 1,
        1))."""
        outputs = []
        if self.resize_input:
            x = resize_bilinear(x, (299, 299))
        if self.normalize_input:
            x = 2 * x - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x, 3, 2)
        if 0 in self.output_blocks:
            outputs.append(x)
        x = max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        if 1 in self.output_blocks:
            outputs.append(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        if 2 in self.output_blocks:
            outputs.append(x)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        if 3 in self.output_blocks:
            outputs.append(x.mean(dim=(2, 3), keepdim=True))
        return outputs


def make_fid_feature_fn(model: InceptionV3):
    """(B, 3, H, W) [0, 1] -> (B, 2048) pooled features, for
    metrics/fid.py."""
    if 3 not in model.output_blocks:
        raise ValueError("FID features are block 3's: output_blocks lacks 3")

    def fn(x):
        with torch.no_grad():
            out = model(x)[-1]   # block 3 comes last
        return out.reshape(out.shape[0], -1)
    return fn
