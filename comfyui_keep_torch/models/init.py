"""Seeded random initialisation of the port's modules.

torch's own module initialisers draw from the global generator; the port
draws every weight from an explicit `torch.Generator` instead, with torch's
default bounds (Conv2d/Linear: kaiming_uniform(a=sqrt(5)) weights and
uniform(+-1/sqrt(fan_in)) biases). Weights are drawn on the CPU, so one seed
gives the same model on every device.
"""
import math

import torch
from torch import nn


def default_init_(module: nn.Module, generator: torch.Generator):
    """Re-draw every Conv2d/Linear weight and bias of `module` in place, in
    module order, from `generator`."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
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


def zero_(module: nn.Module):
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()


def finish(module: nn.Module, device, dtype=None):
    """Move a freshly built module to its device (and dtype), in eval mode."""
    module = module.to(device=device)
    if dtype is not None:
        module = module.to(dtype=dtype)
    return module.eval().requires_grad_(False)
