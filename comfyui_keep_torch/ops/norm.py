"""Normalisations matching the torch modules of the reference archs:
GroupNorm(32, eps=1e-6) in the VQGAN stacks, LayerNorm (eps 1e-5) in the
transformers, InstanceNorm2d (eps 1e-5, no affine) in GMFlow's backbone.

Feature maps are NCHW. GroupNorm and InstanceNorm take their statistics in
promote_types(dtype, f32) (f32 for bf16, f64 stays f64), as the JAX package
does, and return the input dtype.
"""
import torch
import torch.nn.functional as F

GN_EPS = 1e-6


def group_norm(x, weight=None, bias=None, num_groups: int = 32,
               eps: float = GN_EPS):
    """x: (N, C, H, W). A CPU input is made NCHW-contiguous first: torch's
    CPU GroupNorm backward faults on a channels-last input that needs no
    gradient while the affine parameters do (torch 2.13)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    w = None if weight is None else weight.to(ct)
    b = None if bias is None else bias.to(ct)
    xf = x.to(ct) if x.is_cuda else x.to(ct).contiguous()
    return F.group_norm(xf, num_groups, w, b, eps).to(x.dtype)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Normalise over the last dim."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def instance_norm(x, eps: float = 1e-5):
    """x: (N, C, H, W); per-(N, C) spatial statistics, no affine."""
    ct = torch.promote_types(x.dtype, torch.float32)
    return F.instance_norm(x.to(ct), eps=eps).to(x.dtype)
