"""Seeded random initialisation of the port's modules.

torch's own module initialisers draw from the global generator; the port
draws every weight from an explicit `torch.Generator` instead, with torch's
default bounds (Conv2d/Linear: kaiming_uniform(a=sqrt(5)) weights and
uniform(+-1/sqrt(fan_in)) biases). Weights are drawn on the CPU, so one seed
gives the same model on every device.
"""
import copy
import math

import torch
from torch import nn

from comfyui_keep_torch.ops.spectral import power_iteration_v


def default_init_(module: nn.Module, generator: torch.Generator):
    """Re-draw every Conv2d/Conv3d/Linear weight and bias of `module` in
    place, in module order, from `generator`."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                continue
            w = m.weight
            fan_in = w[0].numel()
            bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                  generator=generator))
            if m.bias is not None:
                bb = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(
                    -bb, bb, generator=generator))


def spectral_init_(module: nn.Module, generator: torch.Generator):
    """Re-draw every spectral-norm layer of `module` (a module holding
    `weight_orig` and the power-iteration vectors `weight_u`, `weight_v`)
    in place, in module order: the weight and bias with torch's default
    bounds, u a unit Gaussian draw, v the power iteration's first step
    from u."""
    with torch.no_grad():
        for m in module.modules():
            if not hasattr(m, "weight_orig"):
                continue
            w = m.weight_orig
            bound = 1.0 / math.sqrt(w[0].numel())  # kaiming_uniform(a=sqrt 5)
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                  generator=generator))
            if m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(
                    -bound, bound, generator=generator))
            u = torch.randn(m.weight_u.shape, generator=generator)
            m.weight_u.copy_(u / u.norm())
            m.weight_v.copy_(power_iteration_v(w, m.weight_u))


def zero_(module: nn.Module):
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()


def shared_copy(module: nn.Module) -> nn.Module:
    """A copy of `module`'s tree of modules that shares every parameter and
    buffer tensor with it: buffers or submodules added to the copy leave
    `module` as it is, and no weight is duplicated."""
    memo = {id(t): t for t in list(module.parameters())
            + list(module.buffers())}
    return copy.deepcopy(module, memo)


def finish(module: nn.Module, device, dtype=None):
    """Move a freshly built module to its device (and dtype), in eval mode."""
    module = module.to(device=device)
    if dtype is not None:
        module = module.to(dtype=dtype)
    return module.eval().requires_grad_(False)
