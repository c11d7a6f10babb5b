"""Phase-packed (space-to-depth) execution of 3x3-conv stacks, ported from
comfyui_keep_tpu/ops/phase_pack.py.

Packing the 2x2 pixel phases of a map into channels turns each 3x3 SAME
convolution with C channels at H x W into one 2x2 convolution at H/2 x W/2
with 4C channels, provided the output's packing grid is shifted one pixel
against the input's: a chain of convolutions alternates packing parity, and
no full-resolution map is materialised between them.

Geometry. A packed tensor is NHWC (B, Hc, Wc, 4C), phase-major (packed
channel (qy * 2 + qx) * C + c), the JAX package's layout. At parity o its
coarse cells cover original rows {2i - o, 2i - o + 1}: parity-0 tensors have
H/2 cells, parity-1 tensors H/2 + 1 cells whose first and last half-rows
are the SAME-padding rows -1 and H and are kept zero (`mask_parity1`). A
3x3 SAME convolution of a parity-0 input is the packed 2x2 one with one
coarse cell of zero pad on each side; of a parity-1 input it is the VALID
one. The Downsample's stride-2 (0, 1, 0, 1)-padded convolution consumes a
packed map and emits an ordinary half-resolution one; the Upsample's
nearest-2x + 3x3 convolution consumes an ordinary map and emits a parity-1
packed one, never materialising the upsampled map.

Every product equals the unpacked op's; only the order of summation
changes. The weights are packed once on the host, in the module's own dtype
and in the JAX package's order (its packers run in numpy in the params'
dtype): only `pack_upconv3x3` sums weights, tap by tap, so a bf16 module's
packed Upsample weight is rounded after each addition, as JAX's is. Every
2x2 convolution goes through the hand-written kernel
`ops/kernels.py:packed_conv2x2`, its bias and a parity-1 output's pad mask
fused into the kernel's epilogue (one launch, one rounding of the f32 sum).

Only the top (512) level is packed, as the JAX package packs it by default:
its multi-level packing (the parity-0 Downsample and packed-to-packed
Upsample kernels) and its packed GMFlow backbone are not ported.

space_to_depth / depth_to_space take and give the port's NCHW maps; the
unpacked maps that packed_upconv takes and packed_downsample gives are NHWC,
as in the JAX package.
"""
from typing import Tuple

import torch

from comfyui_keep_torch.ops import kernels as K

_SAME = ((1, 1), (1, 1))
_VALID = ((0, 0), (0, 0))


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

def space_to_depth(x):
    """NCHW (B, C, H, W) -> parity-0 packed NHWC (B, H/2, W/2, 4C)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x, parity: int = 0):
    """Packed (B, Hc, Wc, 4C) -> NCHW (B, C, H, W); a parity-1 tensor drops
    its -1 / H pad rows and columns."""
    b, hc, wc, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, hc, wc, 2, 2, c).permute(0, 5, 1, 3, 2, 4)
    x = x.reshape(b, c, 2 * hc, 2 * wc)
    if parity:
        x = x[:, :, 1:-1, 1:-1]
    return x


def mask_parity1(x, c: int):
    """A copy of the parity-1 packed tensor x with its pad half-cells
    zeroed. The packed ops zero their own fresh outputs in place."""
    return K.mask_parity1_(x.clone(), c)


# ---------------------------------------------------------------------------
# Host-side weight packing (once per prepare; HWIO weight tensors, summed in
# their own dtype)
# ---------------------------------------------------------------------------

def _tile4(b):
    return None if b is None else b.repeat(4)


def pack_conv3x3(w, b):
    """(3, 3, Cin, Cout) SAME conv -> (2, 2, 4Cin, 4Cout) packed kernel (and
    the bias tiled per output phase). The same kernel serves both parity
    directions; only the coarse padding differs (see `packed_conv`)."""
    cin, cout = w.shape[2], w.shape[3]
    pw = w.new_zeros((2, 2, 4 * cin, 4 * cout))
    for py in range(2):
        for px in range(2):
            for dy in range(3):
                for dx in range(3):
                    u, v = py + dy, px + dx
                    ty, tx = u // 2, v // 2
                    qy, qx = u % 2, v % 2
                    pw[ty, tx, (qy * 2 + qx) * cin:(qy * 2 + qx + 1) * cin,
                       (py * 2 + px) * cout:(py * 2 + px + 1) * cout] += w[dy, dx]
    return pw, _tile4(b)


def pack_upconv3x3(w, b):
    """nearest-2x-up + 3x3 SAME conv -> (2, 2, Cin, 4Cout) packed kernel
    over the un-upsampled input (emits a parity-1 packed tensor). Up to four
    taps are summed into each packed tap, in w's dtype, in the JAX package's
    order."""
    cin, cout = w.shape[2], w.shape[3]
    pw = w.new_zeros((2, 2, cin, 4 * cout))
    for py in range(2):
        for px in range(2):
            for dy in range(3):
                for dx in range(3):
                    ty, tx = (py + dy) // 2, (px + dx) // 2
                    pw[ty, tx, :, (py * 2 + px) * cout:(py * 2 + px + 1) * cout] \
                        += w[dy, dx]
    return pw, _tile4(b)


def pack_downsample3x3(w, b):
    """(0, 1, 0, 1)-pad stride-2 3x3 conv consuming a parity-1 packed input
    -> (2, 2, 4Cin, Cout) kernel emitting an ordinary half-res map."""
    cin = w.shape[2]
    pw = w.new_zeros((2, 2, 4 * cin) + tuple(w.shape[3:]))
    for dy in range(3):
        for dx in range(3):
            ty, tx = (dy + 1) // 2, (dx + 1) // 2
            qy, qx = (dy + 1) % 2, (dx + 1) % 2
            pw[ty, tx, (qy * 2 + qx) * cin:(qy * 2 + qx + 1) * cin] += w[dy, dx]
    return pw, b


# ---------------------------------------------------------------------------
# Packed ops (NHWC packed tensors; every 2x2 convolution is K6)
# ---------------------------------------------------------------------------

def _conv(x, pw, pb, pads, masked: bool = False):
    """One K6 launch: the bias, and for a parity-1 output the pad mask,
    fused into its epilogue."""
    return K.packed_conv2x2(x.contiguous(), pw, pads, bias=pb,
                            mask_c=pw.shape[-1] // 4 if masked else None)


def packed_conv(x, pw, pb, parity: int):
    """Packed 3x3-equivalent conv; parity is x's, the output's flips. A
    parity-1 output is masked after its bias."""
    if parity == 0:
        return _conv(x, pw, pb, _SAME, masked=True)
    return _conv(x, pw, pb, _VALID)


def packed_upconv(x, pw, pb):
    """Unpacked NHWC (B, H, W, C) -> parity-1 packed (B, H+1, W+1, 4Cout):
    nearest-2x upsample + 3x3 conv without the 2H x 2W map."""
    return _conv(x, pw, pb, _SAME, masked=True)


def packed_downsample(x, pw, pb):
    """Parity-1 packed (B, Hc, Wc, 4C) -> unpacked NHWC (B, Hc-1, Wc-1,
    Cout)."""
    return _conv(x, pw, pb, _VALID)


def packed_conv1x1(x, w, b, parity: int):
    """Per-phase 1x1 conv of a packed tensor (ResBlock skip projections), a
    plain matrix product. w: the unpacked (Cout, Cin, 1, 1) weight."""
    bsz, hc, wc, c4 = x.shape
    cout, cin = w.shape[:2]
    out = torch.matmul(x.reshape(bsz, hc, wc, 4, cin),
                       w.reshape(cout, cin).t()).reshape(bsz, hc, wc, 4 * cout)
    if b is not None:
        out.add_(b.repeat(4))
    if parity == 1:
        K.mask_parity1_(out, cout)
    return out


def _fold_phases(s, c: int):
    """(..., 4C) per-packed-channel sums -> (..., C) per-channel sums."""
    return s.reshape(s.shape[:-1] + (4, c)).sum(-2)


def packed_group_norm(x, weight, bias, true_hw: Tuple[int, int],
                      num_groups: int = 32, eps: float = 1e-6,
                      parity: int = 0, swish_after: bool = False):
    """GroupNorm over the original (H, W, C) geometry of a packed tensor.
    The statistics fold the 4 phase copies of each channel and divide by the
    true element count (a parity-1 tensor's pad half-cells are zeros, so
    they add nothing), as E[x^2] - mean^2 in promote_types(dtype, f32)."""
    c = x.shape[-1] // 4
    k = c // num_groups
    n = true_hw[0] * true_hw[1] * k
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    s1 = _fold_phases(xf.sum(dim=(1, 2)), c)
    s2 = _fold_phases(xf.square().sum(dim=(1, 2)), c)
    g1 = s1.reshape(-1, num_groups, k).sum(-1)
    g2 = s2.reshape(-1, num_groups, k).sum(-1)
    mean = g1 / n
    inv = torch.rsqrt(g2 / n - mean * mean + eps)
    scale = inv.repeat_interleave(k, dim=-1)
    shift = (-mean * inv).repeat_interleave(k, dim=-1)
    if weight is not None:
        gamma = weight.to(ct)
        scale = scale * gamma
        shift = shift * gamma + bias.to(ct)
    # per-channel (B, C) affine tiled over the 4 phases
    out = torch.addcmul(shift.repeat(1, 4)[:, None, None, :], xf,
                        scale.repeat(1, 4)[:, None, None, :])
    if swish_after:
        out = out * torch.sigmoid(out)
    out = out.to(x.dtype)
    if parity == 1:   # normalising maps the pad zeros to -mean/std
        K.mask_parity1_(out, c)
    return out
