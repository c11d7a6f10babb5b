"""Activations matching the torch versions the reference archs use."""
import torch
import torch.nn.functional as F


def swish(x):
    """x * sigmoid(x) (vqgan_arch.py swish)."""
    return x * torch.sigmoid(x)


def relu(x):
    return F.relu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def tanh_gelu(dtype: torch.dtype) -> bool:
    """The JAX package's rule (its ops/act.py): bf16 takes the tanh gelu,
    indistinguishable from erf at bf16 resolution; other dtypes the exact
    erf form of torch's F.gelu."""
    return dtype == torch.bfloat16


def gelu(x, approximate=None):
    """gelu; `approximate=None` follows tanh_gelu(x.dtype)."""
    if approximate is None:
        approximate = tanh_gelu(x.dtype)
    return F.gelu(x, approximate="tanh" if approximate else "none")
