"""VQGAN block stacks (reference vqgan_arch.py), ported from
comfyui_keep_tpu/models/vqgan.py: the encoder and generator as flat block
plans whose indices match the reference's nn.ModuleList (KEEP taps features
by flat block index), on NCHW feature maps.

Only what KEEP's forward reaches is here: the plans, the blocks, tapped
execution and the codebook lookup.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from comfyui_keep_torch.ops import (conv2d, group_norm, softmax_attention,
                                    swish, upsample_nearest_2x)
from comfyui_keep_torch.ops.norm import GN_EPS


def encoder_plan(in_channels: int, nf: int, emb_dim: int,
                 ch_mult: Sequence[int], num_res_blocks: int, resolution: int,
                 attn_resolutions: Sequence[int]) -> List[Tuple]:
    """Flat block list of the reference Encoder."""
    blocks: List[Tuple] = [("conv", in_channels, nf)]
    curr_res = resolution
    in_ch_mult = (1,) + tuple(ch_mult)
    c = nf
    for i in range(len(ch_mult)):
        c = nf * in_ch_mult[i]
        c_out = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            blocks.append(("res", c, c_out))
            c = c_out
            if curr_res in attn_resolutions:
                blocks.append(("attn", c))
        if i != len(ch_mult) - 1:
            blocks.append(("down", c))
            curr_res //= 2
    blocks += [("res", c, c), ("attn", c), ("res", c, c),
               ("norm", c), ("conv", c, emb_dim)]
    return blocks


def generator_plan(nf: int, emb_dim: int, ch_mult: Sequence[int],
                   num_res_blocks: int, resolution: int,
                   attn_resolutions: Sequence[int],
                   out_channels: int = 3) -> List[Tuple]:
    """Flat block list of the reference Generator."""
    c = nf * ch_mult[-1]
    curr_res = resolution // 2 ** (len(ch_mult) - 1)
    blocks: List[Tuple] = [("conv", emb_dim, c),
                           ("res", c, c), ("attn", c), ("res", c, c)]
    for i in reversed(range(len(ch_mult))):
        c_out = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            blocks.append(("res", c, c_out))
            c = c_out
            if curr_res in attn_resolutions:
                blocks.append(("attn", c))
        if i != 0:
            blocks.append(("up", c))
            curr_res *= 2
    blocks += [("norm", c), ("conv", c, out_channels)]
    return blocks


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=GN_EPS)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.norm2 = _gn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.conv_out = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = swish(group_norm(x, self.norm1.weight, self.norm1.bias))
        h = conv2d(h, self.conv1.weight, self.conv1.bias, padding=1)
        h = swish(group_norm(h, self.norm2.weight, self.norm2.bias))
        h = conv2d(h, self.conv2.weight, self.conv2.bias, padding=1)
        if self.conv_out is not None:
            x = conv2d(x, self.conv_out.weight, self.conv_out.bias)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over H*W."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _gn(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = group_norm(x, self.norm.weight, self.norm.bias)

        def tokens(m):
            return conv2d(hn, m.weight, m.bias).flatten(2).transpose(1, 2)

        out = softmax_attention(tokens(self.q), tokens(self.k),
                                tokens(self.v), scale=c ** -0.5)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x + conv2d(out, self.proj_out.weight, self.proj_out.bias)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 2, 0)

    def forward(self, x):
        # asymmetric (0, 1, 0, 1) zero pad, then a stride-2 VALID conv
        return conv2d(x, self.conv.weight, self.conv.bias, stride=2,
                      padding=[(0, 1), (0, 1)])


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x):
        return conv2d(upsample_nearest_2x(x), self.conv.weight, self.conv.bias,
                      padding=1)


class _Conv(nn.Conv2d):
    def forward(self, x):
        return conv2d(x, self.weight, self.bias, padding=1)


class _Norm(nn.GroupNorm):
    def forward(self, x):
        return group_norm(x, self.weight, self.bias)


def make_block(spec) -> nn.Module:
    kind = spec[0]
    if kind == "conv":
        return _Conv(spec[1], spec[2], 3, 1, 1)
    if kind == "res":
        return ResBlock(spec[1], spec[2])
    if kind == "attn":
        return AttnBlock(spec[1])
    if kind == "down":
        return Downsample(spec[1])
    if kind == "up":
        return Upsample(spec[1])
    if kind == "norm":
        return _Norm(32, spec[1], eps=GN_EPS)
    raise ValueError(kind)


class BlockStack(nn.Module):
    """An encoder or generator: `blocks.{i}` aligned with its plan."""

    def __init__(self, plan):
        super().__init__()
        self.plan = list(plan)
        self.blocks = nn.ModuleList(make_block(s) for s in self.plan)

    def forward(self, x, tap_indices: Optional[Sequence[int]] = None):
        """Run every block; with tap_indices also return {i: features after
        block i}."""
        taps: Dict[int, torch.Tensor] = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if tap_indices is not None and i in tap_indices:
                taps[i] = x
        return (x, taps) if tap_indices is not None else x


class VectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int, emb_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(codebook_size, emb_dim)

    def lookup(self, indices):
        """get_codebook_feat: indices (...,) -> (..., C)."""
        return self.embedding.weight[indices]
