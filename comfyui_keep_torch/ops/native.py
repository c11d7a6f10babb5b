"""StyleGAN2's native ops (reference wm_basicsr/ops: fused_act, upfirdn2d),
ported from comfyui_keep_tpu/ops/native.py. NCHW.

`fused_leaky_relu` runs the fused bias + leaky ReLU kernel (K5,
ops/kernels.py) forward, and its backward in plain torch ops, as the JAX
package's custom VJP does (XLA there, no Pallas kernel). The backward is
itself differentiable, so R1 and the path-length penalty, which
differentiate a gradient, run through it.
"""
from typing import Sequence, Tuple

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
