"""The reference's native ops (wm_basicsr/ops: fused_act, upfirdn2d, dcn;
archs/correlation.py), ported from comfyui_keep_tpu/ops/native.py. NCHW.

`fused_leaky_relu` runs the fused bias + leaky ReLU kernel (K5,
ops/kernels.py) forward, and its backward in plain torch ops, as the JAX
package's custom VJP does (XLA there, no Pallas kernel). The backward is
itself differentiable, so R1 and the path-length penalty, which
differentiate a gradient, run through it.

`deform_conv2d` (DCNv1, and DCNv2 with a mask), `dcn_v2_pack` and
`correlation` are plain PyTorch, as they are plain XLA in the JAX package:
the deformable convolution samples its taps by a bilinear gather and
multiplies them by the weight, with no torchvision.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from comfyui_keep_torch.ops import kernels


class _FusedLeakyReLU(torch.autograd.Function):
    """leaky_relu(x + bias, slope) * scale. The backward keys on h >= 0 (h
    recomputed from the saved x and bias, as JAX's residual `h >= 0`), not
    on out > 0, and is linear in the incoming gradient: not
    once_differentiable."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.negative_slope, ctx.scale = negative_slope, scale
        return kernels.fused_bias_lrelu(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dt = torch.promote_types(x.dtype, torch.float32)  # as the forward
        pos = (x.to(dt) + bias.to(dt).reshape(
            (1, -1) + (1,) * (x.dim() - 2))) >= 0
        gx = torch.where(pos, g, g * ctx.negative_slope) * ctx.scale
        dims = [d for d in range(x.dim()) if d != 1]
        gb = gx.sum(dim=dims).to(bias.dtype)
        return gx, gb, None, None


def fused_leaky_relu(x, bias, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5):
    """x: (N, C, *spatial) or (N, C); bias: (C,)."""
    return _FusedLeakyReLU.apply(x, bias, negative_slope, scale)


def upfirdn2d(x, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)):
    """Upsample (zero insertion), FIR filter, downsample. x: (N, C, H, W);
    kernel: (kh, kw); pad = (pad0, pad1) on both spatial dims (the reference
    upfirdn2d API). The up-1 zeros that follow the last sample belong to the
    upsampled signal, as in the JAX package's pad1 + up - 1."""
    n, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (p0, p1, p0, p1))
    # depthwise correlation with the flipped kernel == convolution with it
    k = torch.flip(kernel, (0, 1)).to(x.dtype)
    k = k[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x, k, stride=down, groups=c)


def make_resample_kernel(k: Sequence[float]) -> torch.Tensor:
    """1D taps -> the separable, normalised 2D FIR kernel (f32)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


# ---------------------------------------------------------------------------
# Deformable convolution (ops/dcn: deform_conv, modulated_deform_conv)
# ---------------------------------------------------------------------------

def _dcn_sample(x, offset, mask, ksize: Tuple[int, int], stride: int,
                padding: int, dilation: int, deformable_groups: int):
    """The deformable im2col: x (N, C, H, W) sampled bilinearly (zero
    outside the image) at each output position's kernel taps moved by
    offset (N, dg * 2 * kh * kw, Ho, Wo), per deformable group and tap in
    (y, x) order as the reference's CUDA kernel reads it; times mask (N, dg
    * kh * kw, Ho, Wo) if given. Returns (N, C, kh * kw, Ho, Wo)."""
    n, c, h, w = x.shape
    kh, kw = ksize
    dg = deformable_groups
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev, dt = x.device, x.dtype

    def line(out, k):
        return (torch.arange(k, device=dev) * dilation)[:, None] + (
            torch.arange(out, device=dev) * stride - padding)[None, :]

    base_y = line(ho, kh).to(dt)[:, None, :, None]      # (kh, 1, ho, 1)
    base_x = line(wo, kw).to(dt)[None, :, None, :]      # (1, kw, 1, wo)
    off = offset.reshape(n, dg, kh, kw, 2, ho, wo)
    py = base_y + off[:, :, :, :, 0]                     # (n, dg, kh, kw, ho, wo)
    px = base_x + off[:, :, :, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0)[:, :, None], (px - x0)[:, :, None]
    cg = c // dg
    xg = x.reshape(n, dg, cg, h * w)

    def corner(yi, xi):
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(n, dg, 1, -1).expand(n, dg, cg, -1)
        v = torch.gather(xg, 3, idx).reshape(n, dg, cg, kh, kw, ho, wo)
        ok = (yi > -1) & (yi < h) & (xi > -1) & (xi < w)
        return v * ok[:, :, None].to(dt)

    val = (corner(y0, x0) * (1 - wy) * (1 - wx)
           + corner(y0, x0 + 1) * (1 - wy) * wx
           + corner(y0 + 1, x0) * wy * (1 - wx)
           + corner(y0 + 1, x0 + 1) * wy * wx)
    if mask is not None:
        val = val * mask.reshape(n, dg, 1, kh, kw, ho, wo)
    return val.reshape(n, c, kh * kw, ho, wo)


def deform_conv2d(x, offset, weight, bias=None, stride: int = 1,
                  padding: int = 0, dilation: int = 1, groups: int = 1,
                  deformable_groups: int = 1,
                  mask: Optional[torch.Tensor] = None):
    """DCNv1 (mask None) or DCNv2 (modulated). x: (N, Cin, H, W); offset:
    (N, dg * 2 * kh * kw, Ho, Wo) in (y, x) tap order; weight: (Cout,
    Cin / groups, kh, kw); mask: (N, dg * kh * kw, Ho, Wo). Returns (N,
    Cout, Ho, Wo)."""
    cout, cgi, kh, kw = weight.shape
    cols = _dcn_sample(x, offset, mask, (kh, kw), stride, padding, dilation,
                       deformable_groups)
    n, cin, k, ho, wo = cols.shape
    cols = cols.reshape(n, groups, cgi, k, ho, wo)
    wg = weight.reshape(groups, cout // groups, cgi, k)
    out = torch.einsum("ngckhw,gock->ngohw", cols, wg).reshape(n, cout, ho,
                                                                wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def dcn_v2_pack(x, feat, weight, bias, offset_weight, offset_bias,
                stride: int = 1, padding: int = 1, dilation: int = 1,
                deformable_groups: int = 1,
                max_residue_magnitude: Optional[float] = None):
    """DCNv2Pack (arch_util.py): offsets and mask predicted from a second
    map feat by the `conv_offset` convolution (offset_weight, offset_bias;
    its output channels are o1, o2, mask), the offsets optionally bounded
    by max_residue_magnitude * tanh, the mask a sigmoid; then the
    modulated deform_conv2d of x with weight and bias."""
    out = F.conv2d(feat, offset_weight, offset_bias, stride=stride,
                   padding=padding)
    o1, o2, m = torch.chunk(out, 3, dim=1)
    offset = torch.cat([o1, o2], dim=1)
    if max_residue_magnitude is not None:
        offset = max_residue_magnitude * torch.tanh(offset)
    return deform_conv2d(x, offset, weight, bias, stride=stride,
                         padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups,
                         mask=torch.sigmoid(m))


# ---------------------------------------------------------------------------
# Correlation cost volume (archs/correlation.py)
# ---------------------------------------------------------------------------

def correlation(f1, f2, max_displacement: int = 4):
    """f1, f2: (N, C, H, W) -> (N, (2d + 1)^2, H, W): channel dy * (2d + 1)
    + dx is the mean over C of f1 times f2 moved by (dy - d, dx - d), zero
    outside the image."""
    n, c, h, w = f1.shape
    d = max_displacement
    f2p = F.pad(f2, (d, d, d, d))
    return torch.stack([(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(1) / c
                        for dy in range(2 * d + 1)
                        for dx in range(2 * d + 1)], dim=1)
