"""Normalisations matching the torch modules of the reference archs:
GroupNorm(32, eps=1e-6) in the VQGAN stacks, LayerNorm (eps 1e-5) in the
transformers, InstanceNorm2d (eps 1e-5, no affine) in GMFlow's backbone.

Feature maps are NCHW. GroupNorm and InstanceNorm take their statistics in
f32 whatever the input dtype, as the JAX package does, and return the input
dtype.
"""
import torch
import torch.nn.functional as F

GN_EPS = 1e-6


def group_norm(x, weight=None, bias=None, num_groups: int = 32,
               eps: float = GN_EPS):
    """x: (N, C, H, W)."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.group_norm(x.float(), num_groups, w, b, eps).to(x.dtype)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Normalise over the last dim."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def instance_norm(x, eps: float = 1e-5):
    """x: (N, C, H, W); per-(N, C) spatial statistics, no affine."""
    return F.instance_norm(x.float(), eps=eps).to(x.dtype)
