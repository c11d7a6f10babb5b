"""VQGAN block stacks (reference vqgan_arch.py), ported from
comfyui_keep_tpu/models/vqgan.py: the encoder and generator as flat block
plans whose indices match the reference's nn.ModuleList (KEEP taps features
by flat block index), on NCHW feature maps.

What KEEP and its stage-II training reach is here: the plans, the blocks,
tapped (and recomputed) execution, the nearest-code quantizer with its
lookup, and the VQHQEncoder that gives training its ground-truth codes.
The rest of the family follows: the Gumbel quantizer, the stage-I
VQAutoEncoder (nearest or Gumbel), the PatchGAN VQGANDiscriminator and the
spectral-norm video Discriminator3D of stage-III GAN training. Their
parameter names are the reference's, so a reference .pth loads.

Serving can run the top levels phase-packed (ops/phase_pack.py):
`phase512_prepare` packs a stack's weights into non-persistent buffers
(`block.p512`, and the Downsamples' `p512_p0` and the Upsamples'
`p512_p2p` for the deeper levels), after which `BlockStack.forward` runs
the encoder's packed prefix (one level or several) and
`packed_generator_tail` the generator's packed tail. A stack whose
`int8_acts` is set (serving only) stores the activations at its block
boundaries as int8 (`_quant_boundary`), as the JAX package's
KEEP_TPU_INT8_ACTS does.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from comfyui_keep_torch.models.init import (default_init_, finish,
                                            spectral_init_)
from comfyui_keep_torch.ops import (batch_norm, conv2d, conv3d, group_norm,
                                    leaky_relu, linear, softmax_attention,
                                    spectral_norm_weight, swish,
                                    upsample_nearest_2x)
from comfyui_keep_torch.ops import kernels as K
from comfyui_keep_torch.ops import phase_pack as pp
from comfyui_keep_torch.ops.norm import GN_EPS
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


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
        # int8 storage at block boundaries (serving; _quant_boundary)
        self.int8_acts = False

    def packed_prefix_end(self) -> Optional[int]:
        """Index of the Downsample closing the leading run of blocks that
        carry packed weights (an encoder's packed prefix), or None."""
        end = None
        for i, blk in enumerate(self.blocks):
            if getattr(blk, "p512", None) is None:
                break
            if self.plan[i][0] == "down":
                end = i
        return end

    def packed_tail_start(self) -> Optional[int]:
        """Index of the first Upsample carrying packed weights (the start of
        a generator's packed tail), or None."""
        return next((j for j, (s, blk) in enumerate(zip(self.plan,
                                                        self.blocks))
                     if s[0] == "up" and getattr(blk, "p512", None)
                     is not None), None)

    def forward(self, x, tap_indices: Optional[Sequence[int]] = None):
        """Run every block; with tap_indices also return {i: features after
        block i}. While gradients are recorded, each res/attn block is
        recomputed in the backward pass instead of keeping its activations
        (the JAX package's blocks_apply(remat=True)). A prepared encoder
        (phase512_prepare) runs its packed prefix first; its packed weights
        are not parameters, so it refuses to record gradients. With
        int8_acts, the input of every block after the first one run here
        (the packed prefix's, then the rest's), but a norm's, is stored as
        int8 (JAX's blocks_apply rule)."""
        taps: Dict[int, torch.Tensor] = {}
        remat = torch.is_grad_enabled()
        i0 = 0
        end = self.packed_prefix_end()
        if end is not None:
            if remat:
                raise RuntimeError("a phase-packed stack serves only: its "
                                   "packed weights get no gradients")
            x = _packed_encoder_prefix(self, x, end, taps, tap_indices)
            i0 = end + 1
        for i in range(i0, len(self.plan)):
            spec, blk = self.plan[i], self.blocks[i]
            if self.int8_acts and i > i0 and spec[0] != "norm":
                x = _quant_boundary(x)
            if remat and spec[0] in ("res", "attn"):
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
            if tap_indices is not None and i in tap_indices:
                taps[i] = x
        return (x, taps) if tap_indices is not None else x


# ---------------------------------------------------------------------------
# Phase-packed execution of the 512 level (serving; ops/phase_pack.py)
# ---------------------------------------------------------------------------

def phase_encoder_end(plan, max_levels: int = 1) -> Optional[int]:
    """Index of the Downsample that exits the max_levels-th encoder level,
    or of the last Downsample before a block that cannot run packed (only
    conv, res and down can), or None if there is none. The latent level
    past the last Downsample is never packed, so max_levels beyond the
    plan's levels gives the last Downsample."""
    end, seen = None, 0
    for i, s in enumerate(plan):
        if s[0] == "down":
            seen += 1
            end = i
            if seen == max_levels:
                return end
        elif s[0] not in ("conv", "res"):
            return end
    return end


def phase_generator_start(plan, fuse_indices=(),
                          max_levels: Optional[int] = None) -> Optional[int]:
    """Index of the earliest Upsample from which the generator's tail can
    run packed: every later block is up/res/norm/conv (attention needs the
    true layout) and no fusion tap lands at or after it. max_levels keeps
    the last max_levels such Upsamples (None: all of them; 1: the final
    Upsample alone)."""
    valid = [u for u, s in enumerate(plan) if s[0] == "up"
             and all(t[0] in ("up", "res", "norm", "conv")
                     for t in plan[u + 1:])
             and all(f < u for f in fuse_indices)]
    if max_levels is not None:
        valid = valid[-max_levels:]
    return valid[0] if valid else None


class PackedWeights(nn.Module):
    """One block's packed kernels as non-persistent buffers: `.to()` carries
    them, `state_dict()` leaves them out."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t, persistent=False)


def packed_weights(conv: nn.Conv2d, packer) -> PackedWeights:
    """Pack conv's (OIHW) weight and bias with a phase_pack packer on the
    host, in the module's own dtype (as the JAX package packs its params),
    onto the module's device."""
    w = conv.weight.detach().to("cpu").permute(2, 3, 1, 0)
    b = None if conv.bias is None else conv.bias.detach().to("cpu")
    pw, pb = packer(w, b)

    def dev(t):
        return None if t is None else t.contiguous().to(conv.weight.device)

    if isinstance(pw, dict):   # the packed -> packed Upsample's planes
        return PackedWeights(b=dev(pb), **{f"k_{p}": dev(k)
                                           for p, k in pw.items()})
    return PackedWeights(w=dev(pw), b=dev(pb))


def phase512_prepare(stack: BlockStack, blocks: range) -> BlockStack:
    """Pack (in place) the weights of `blocks` into non-persistent buffers:
    an encoder's packed prefix, range(phase_encoder_end + 1), or a
    generator's packed tail, range(phase_generator_start, len(plan)). As in
    the JAX package, every Downsample also gets its parity-0 kernel
    (`p512_p0`, for a level entered by space_to_depth) and every Upsample
    its packed -> packed planes (`p512_p2p`, for one between packed
    levels). Serving only: the trainers keep the unpacked path. Returns
    the stack."""
    for i in blocks:
        spec, blk = stack.plan[i], stack.blocks[i]
        if spec[0] == "conv":
            blk.p512 = packed_weights(blk, pp.pack_conv3x3)
        elif spec[0] == "res":
            c1 = packed_weights(blk.conv1, pp.pack_conv3x3)
            c2 = packed_weights(blk.conv2, pp.pack_conv3x3)
            blk.p512 = PackedWeights(conv1_w=c1.w, conv1_b=c1.b,
                                     conv2_w=c2.w, conv2_b=c2.b)
        elif spec[0] == "down":
            blk.p512 = packed_weights(blk.conv, pp.pack_downsample3x3)
            blk.p512_p0 = packed_weights(blk.conv, pp.pack_downsample3x3_p0)
        elif spec[0] == "up":
            blk.p512 = packed_weights(blk.conv, pp.pack_upconv3x3)
            blk.p512_p2p = packed_weights(blk.conv, pp.pack_upconv3x3_p2p)
        # "norm" uses its unpacked weight and bias
    return stack


def _packed_res_block(blk: ResBlock, x, parity: int, true_hw):
    p = blk.p512
    h = pp.packed_group_norm(x, blk.norm1.weight, blk.norm1.bias, true_hw,
                             eps=GN_EPS, parity=parity, swish_after=True)
    h = pp.packed_conv(h, p.conv1_w, p.conv1_b, parity)
    h = pp.packed_group_norm(h, blk.norm2.weight, blk.norm2.bias, true_hw,
                             eps=GN_EPS, parity=1 - parity, swish_after=True)
    h = pp.packed_conv(h, p.conv2_w, p.conv2_b, 1 - parity)
    if blk.conv_out is not None:
        x = pp.packed_conv1x1(x, blk.conv_out.weight, blk.conv_out.bias,
                              parity)
    return h.add_(x)


# boundaries stored as int8 since the last reset (serving runs read it)
INT8_BOUNDARIES = {"count": 0}


def _quant_boundary(x):
    """x stored as int8 and read back (the JAX package's _quant_boundary):
    one scale s = max(max|x| / 127, 1e-8) in f32 over the whole tensor, the
    batch included; q = clip(round_half_even(x / s), -127, 127) as int8;
    back in x's dtype as q * s, the product rounded in that dtype. Counted
    in INT8_BOUNDARIES. Serving only: it raises while gradients are
    recorded."""
    if torch.is_grad_enabled():
        raise RuntimeError("int8 activation storage serves only: call it "
                           "under torch.no_grad()")
    INT8_BOUNDARIES["count"] += 1
    s = torch.clamp_min(x.abs().max().float() / 127.0, 1e-8)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q.to(x.dtype) * s.to(x.dtype)


def _packed_encoder_prefix(stack: BlockStack, x, end: int, taps,
                           tap_indices):
    """Blocks [0, end] (conv, res*, down per level) phase-packed on the NCHW
    input x; returns the NCHW map after the Downsample at `end`. Each inner
    Downsample's unpacked output is packed again (space_to_depth) and its
    level runs at parity 0, its Downsample on the parity-0 kernel. Taps
    inside the packed region are unpacked at tap time. With int8_acts every
    block's input but the first's is stored as int8."""
    true_hw = tuple(x.shape[-2:])
    x = pp.space_to_depth(x)
    parity = 0
    for i in range(end + 1):
        spec, blk = stack.plan[i], stack.blocks[i]
        if stack.int8_acts and i > 0:
            x = _quant_boundary(x)
        if spec[0] == "conv":
            x = pp.packed_conv(x, blk.p512.w, blk.p512.b, parity)
            parity ^= 1
        elif spec[0] == "res":
            x = _packed_res_block(blk, x, parity, true_hw)
        else:  # down: an unpacked NHWC map at half the size
            if parity == 1:
                x = pp.packed_downsample(x, blk.p512.w, blk.p512.b)
            else:
                x = pp.packed_downsample_p0(x, blk.p512_p0.w, blk.p512_p0.b)
            x = x.permute(0, 3, 1, 2)
            if i < end:   # a deeper packed level follows
                true_hw = tuple(x.shape[-2:])
                x = pp.space_to_depth(x)
                parity = 0
            else:
                x = x.contiguous()
        if tap_indices is not None and i in tap_indices:
            taps[i] = x if i == end else pp.depth_to_space(x, parity)
    return x


def packed_generator_tail(stack: BlockStack, x, start: int):
    """Blocks [start, ...) (Upsample and res* per level, then norm, conv) of
    a prepared generator, phase-packed, from the NCHW map x; returns the
    NCHW full-resolution output. The first Upsample takes the unpacked map;
    one between packed levels goes packed -> packed (p512_p2p). With
    int8_acts every block's input but the first's and a norm's is stored as
    int8."""
    parity, true_hw = None, None   # parity None: x is the unpacked map
    for j in range(start, len(stack.plan)):
        spec, blk = stack.plan[j], stack.blocks[j]
        if stack.int8_acts and j > start and spec[0] != "norm":
            x = _quant_boundary(x)
        if spec[0] == "up":
            if parity is None:
                true_hw = (2 * x.shape[-2], 2 * x.shape[-1])
                x = pp.packed_upconv(x.permute(0, 2, 3, 1), blk.p512.w,
                                     blk.p512.b)
            else:   # a packed level ends on res blocks: parity 1
                true_hw = (2 * true_hw[0], 2 * true_hw[1])
                p = blk.p512_p2p
                x = pp.packed_upconv_p2p(
                    x, {q: getattr(p, f"k_{q}") for q in pp.P2P_PLANES}, p.b)
            parity = 1
        elif spec[0] == "res":
            x = _packed_res_block(blk, x, parity, true_hw)
        elif spec[0] == "norm":
            x = pp.packed_group_norm(x, blk.weight, blk.bias, true_hw,
                                     eps=GN_EPS, parity=parity)
        else:  # conv
            x = pp.packed_conv(x, blk.p512.w, blk.p512.b, parity)
            parity ^= 1
    return pp.depth_to_space(x, parity)


class VectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int, emb_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(codebook_size, emb_dim)

    def lookup(self, indices):
        """get_codebook_feat: indices (...,) -> (..., C)."""
        return self.embedding.weight[indices]

    def nearest(self, z):
        """z (..., C) -> (...) int32 index of the nearest code, through the
        nearest-codebook kernel (its plain version on CPU tensors)."""
        c = z.shape[-1]
        idx = K.vq_nearest_indices(z.reshape(-1, c).contiguous(),
                                   self.embedding.weight.contiguous())
        return idx.reshape(z.shape[:-1])


def vq_indices(codebook, z):
    """Nearest-codebook indices and the distances they come from (the JAX
    package's vq_indices): z (..., C), codebook (N, C) -> (idx (...),
    d (..., N)), d = |z|^2 + |e|^2 - 2 z.e with the products in at least
    f32. Materialises d; the training path uses `VectorQuantizer.nearest`."""
    ct = torch.promote_types(z.dtype, torch.float32)
    z2 = (z * z).sum(dim=-1, keepdim=True)
    e2 = (codebook * codebook).sum(dim=-1)
    ze = torch.matmul(z.to(ct), codebook.to(ct).t())
    d = (z2 + e2).to(ct) - 2.0 * ze
    return d.argmin(dim=-1), d


def vq_quantize(quantizer: VectorQuantizer, z, beta: float = 0.25):
    """z (..., C) -> (z_q straight-through, codebook loss, stats) as the
    JAX package's vq_quantize. The codes come from the nearest-codebook
    kernel; stats["mean_distance"], the mean of vq_indices' d, is taken in
    closed form, mean|z|^2 + mean|e|^2 - 2 mean(z).mean(e), without the
    (T, N) matrix."""
    e = quantizer.embedding.weight
    idx = quantizer.nearest(z.detach()).long()
    z_q = e[idx]
    loss = (torch.mean((z_q.detach() - z) ** 2)
            + beta * torch.mean((z_q - z.detach()) ** 2))
    z_q = z + (z_q - z).detach()
    counts = torch.bincount(idx.reshape(-1), minlength=e.shape[0])
    e_mean = counts.float() / idx.numel()
    perplexity = torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))
    zf = z.detach().float().reshape(-1, z.shape[-1])
    ef = e.detach().float()
    mean_d = ((zf * zf).sum(-1).mean() + (ef * ef).sum(-1).mean()
              - 2.0 * torch.dot(zf.mean(0), ef.mean(0)))
    stats = {"perplexity": perplexity, "min_encoding_indices": idx,
             "mean_distance": mean_d}
    return z_q, loss, stats


# the keys of a KEEP configuration that its VQHQEncoder takes
HQ_KEYS = ("img_size", "nf", "ch_mult", "res_blocks", "attn_resolutions",
           "codebook_size", "emb_dim")


@ARCH_REGISTRY.register()
class VQHQEncoder(nn.Module):
    """Encoder + nearest-code quantizer (reference vqgan_arch.py
    VQHQEncoder): the frozen net whose codes of the ground-truth frames
    KEEP's stage-II training predicts. Parameter names `encoder.blocks.*`
    and `quantize.embedding.weight`."""

    def __init__(self, img_size: int = 512, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 codebook_size: int = 1024, emb_dim: int = 256,
                 beta: float = 0.25, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.beta = beta
        self.encoder = BlockStack(encoder_plan(3, nf, emb_dim, ch_mult,
                                               res_blocks, img_size,
                                               attn_resolutions))
        self.quantize = VectorQuantizer(codebook_size, emb_dim)
        if generator is not None:
            default_init_(self, generator)
            with torch.no_grad():
                w = self.quantize.embedding.weight
                w.copy_(torch.empty(w.shape).uniform_(
                    -1.0 / codebook_size, 1.0 / codebook_size,
                    generator=generator))
        finish(self, device, dtype)

    def encode(self, x):
        """x (N, H, W, 3) in [-1, 1] -> latents (N, h, w, C)."""
        return self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def apply(self, x):
        """x (N, H, W, 3) -> (z, codebook loss, stats): like the JAX twin it
        returns the encoder's z, not the quantized z_q."""
        z = self.encode(x)
        _, loss, stats = vq_quantize(self.quantize, z, self.beta)
        return z, loss, stats

    def indices(self, x):
        """x (N, H, W, 3) -> (N, h*w) int32 nearest codes of the latents,
        one kernel launch for all N*h*w tokens."""
        z = self.encode(x)
        return self.quantize.nearest(z).reshape(z.shape[0], -1)


# ---------------------------------------------------------------------------
# The rest of the family: Gumbel quantizer, VQAutoEncoder, discriminators
# ---------------------------------------------------------------------------

class GumbelQuantizer(nn.Module):
    """The reference's GumbelQuantizer: a 1x1 projection to code logits
    (`proj`) and the code table (`embed`)."""

    def __init__(self, codebook_size: int, emb_dim: int, num_hiddens: int):
        super().__init__()
        self.proj = nn.Conv2d(num_hiddens, codebook_size, 1)
        self.embed = nn.Embedding(codebook_size, emb_dim)


def gumbel_quantize(quantizer: GumbelQuantizer, z,
                    generator: Optional[torch.Generator] = None,
                    uniform: Optional[torch.Tensor] = None, tau: float = 1.0,
                    kl_weight: float = 5e-4, hard: bool = True):
    """z (N, H, W, C) -> (z_q (N, H, W, D), KL term, {"min_encoding_indices":
    (N, H, W)}), the JAX package's gumbel_quantize. The Gumbel noise is
    -log(-log(u)) of a uniform draw u of the logits' shape: `uniform` given,
    or drawn from `generator`; with neither, no noise. hard=True takes the
    one-hot pick forward with the soft gradient (straight-through)."""
    w = quantizer.proj.weight
    logits = linear(z, w.reshape(w.shape[0], -1), quantizer.proj.bias)
    if uniform is None and generator is not None:
        uniform = torch.rand(logits.shape, generator=generator,
                             device=logits.device, dtype=logits.dtype)
    if uniform is not None:
        g = -torch.log(-torch.log(uniform.to(logits.dtype) + 1e-20) + 1e-20)
        y = torch.softmax((logits + g) / tau, dim=-1)
    else:
        y = torch.softmax(logits / tau, dim=-1)
    idx = y.argmax(dim=-1)
    if hard:
        y_hard = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(y.dtype)
        y = y + (y_hard - y).detach()
    z_q = torch.einsum("bhwn,nd->bhwd", y, quantizer.embed.weight)
    qy = torch.softmax(logits, dim=-1)
    diff = kl_weight * torch.mean(torch.sum(
        qy * torch.log(qy * logits.shape[-1] + 1e-10), dim=-1))
    return z_q, diff, {"min_encoding_indices": idx}


@ARCH_REGISTRY.register()
class VQAutoEncoder(nn.Module):
    """Stage-I VQGAN (reference vqgan_arch.py VQAutoEncoder): encoder,
    quantizer ("nearest", through the nearest-codebook kernel, or
    "gumbel"), generator. Parameter names `encoder.blocks.*`, `quantize.*`,
    `generator.blocks.*`."""

    def __init__(self, img_size: int = 512, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 8),
                 quantizer: str = "nearest", res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 codebook_size: int = 1024, emb_dim: int = 256,
                 beta: float = 0.25, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if quantizer not in ("nearest", "gumbel"):
            raise ValueError(f"quantizer must be nearest or gumbel, got "
                             f"{quantizer!r}")
        self.quantizer, self.beta = quantizer, beta
        self.encoder = BlockStack(encoder_plan(3, nf, emb_dim, ch_mult,
                                               res_blocks, img_size,
                                               attn_resolutions))
        if quantizer == "nearest":
            self.quantize = VectorQuantizer(codebook_size, emb_dim)
        else:
            self.quantize = GumbelQuantizer(codebook_size, emb_dim, emb_dim)
        self.generator = BlockStack(generator_plan(nf, emb_dim, ch_mult,
                                                   res_blocks, img_size,
                                                   attn_resolutions))
        if generator is not None:
            default_init_(self, generator)
            with torch.no_grad():
                if quantizer == "nearest":
                    w = self.quantize.embedding.weight
                    w.copy_(torch.empty(w.shape).uniform_(
                        -1.0 / codebook_size, 1.0 / codebook_size,
                        generator=generator))
                else:
                    w = self.quantize.embed.weight
                    w.copy_(torch.randn(w.shape, generator=generator) * 0.02)
        finish(self, device, dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None):
        """x (N, H, W, 3) in [-1, 1] -> (reconstruction (N, H, W, 3), the
        quantizer's loss, its stats). generator / uniform: the Gumbel
        quantizer's noise (gumbel_quantize)."""
        z = self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.quantizer == "nearest":
            z_q, loss, stats = vq_quantize(self.quantize, z, self.beta)
        else:
            z_q, loss, stats = gumbel_quantize(self.quantize, z, generator,
                                               uniform)
        out = self.generator(z_q.permute(0, 3, 1, 2).contiguous())
        return out.permute(0, 2, 3, 1), loss, stats


@ARCH_REGISTRY.register()
class VQGANDiscriminator(nn.Module):
    """PatchGAN discriminator (reference vqgan_arch.py VQGANDiscriminator):
    `main` holds 4x4 convs (stride 2, then 1), BatchNorm after each inner
    one and leaky ReLU 0.2 between. BatchNorm runs in inference form, on
    its running statistics, as in the JAX package."""

    def __init__(self, nc: int = 3, ndf: int = 64, n_layers: int = 4,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [nn.Conv2d(nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                                 2 if n < n_layers else 1, 1, bias=False),
                       nn.BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x):
        """x (N, H, W, nc) -> patch logits (N, H', W', 1)."""
        x = x.permute(0, 3, 1, 2)
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                x = conv2d(x, m.weight, m.bias, stride=m.stride[0], padding=1)
            elif isinstance(m, nn.BatchNorm2d):
                x = batch_norm(x, m)
            else:
                x = leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)


class SpectralNormConv3d(nn.Module):
    """A Conv3d under torch's spectral_norm, by its state-dict names:
    `weight_orig`, `bias` (if any) and the power-iteration buffers
    `weight_u` (O,) and `weight_v`. The forward normalises weight_orig by
    one power iteration from weight_u (ops/spectral.py) and leaves the
    buffers as they are, as the JAX package's apply does; weight_v is kept
    for loading and unused."""

    def __init__(self, cin: int, cout: int, kernel, stride, padding,
                 bias: bool):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("weight_u", torch.ones(cout) / cout ** 0.5)
        n = cin * kernel[0] * kernel[1] * kernel[2]
        self.register_buffer("weight_v", torch.ones(n) / n ** 0.5)

    def forward(self, x):
        w, _ = spectral_norm_weight(self.weight_orig, self.weight_u)
        return conv3d(x, w, self.bias, self.stride, self.padding)


@ARCH_REGISTRY.register()
class Discriminator3D(nn.Module):
    """Spectral-norm Conv3d video discriminator of stage-III GAN training
    (reference vqgan_arch.py Discriminator3D): five (3, 5, 5) convs of
    stride (1, 2, 2) under spectral norm with leaky ReLU 0.2, then one
    without, nf * (1, 2, 4, 4, 4, 4) channels, in `conv` at the
    reference's Sequential indices 0, 2, ..., 10."""

    CHANNELS = (("in", 1, (1, 1, 1)), (1, 2, (1, 2, 2)), (2, 4, (1, 2, 2)),
                (4, 4, (1, 2, 2)), (4, 4, (1, 2, 2)))

    def __init__(self, in_channels: int = 3, nf: int = 32,
                 use_sigmoid: bool = False, use_spectral_norm: bool = True,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        layers = []
        for cin_m, cout_m, pad in self.CHANNELS:
            cin = in_channels if cin_m == "in" else nf * cin_m
            if use_spectral_norm:
                layers.append(SpectralNormConv3d(cin, nf * cout_m, (3, 5, 5),
                                                 (1, 2, 2), pad, bias=False))
            else:
                layers.append(nn.Conv3d(cin, nf * cout_m, (3, 5, 5),
                                        (1, 2, 2), pad))
            layers.append(nn.LeakyReLU(0.2))
        layers.append(nn.Conv3d(nf * 4, nf * 4, (3, 5, 5), (1, 2, 2),
                                (1, 2, 2)))
        self.conv = nn.Sequential(*layers)
        if generator is not None:
            default_init_(self, generator)
            spectral_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x):
        """x (B, T, H, W, C) -> (B, T', H', W', nf * 4)."""
        x = x.permute(0, 4, 1, 2, 3)
        for m in self.conv:
            if isinstance(m, nn.Conv3d):
                x = conv3d(x, m.weight, m.bias, m.stride, m.padding)
            elif isinstance(m, SpectralNormConv3d):
                x = m(x)
            else:
                x = leaky_relu(x, 0.2)
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 4, 1)
