"""Training state: f32 master weights, optimizer, EMA and the iteration
count (reference base_model.py), ported from
comfyui_keep_tpu/training/state.py without its disk IO (save and resume
are ROADMAP Queue 1: the rest of training).

`fix_modules` freezes top-level submodules: a frozen parameter gets no
gradient and no update (optax's `set_to_zero` branch in the JAX package),
while gradients still flow through it into the layers that train. The EMA
covers every parameter, frozen ones included, as the JAX package's does.
"""
import contextlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module                   # f32 master weights
    optimizer: torch.optim.Optimizer   # over the trainable parameters only
    ema: Optional[Dict[str, torch.Tensor]] = None  # name -> every parameter
    iter: int = 0                      # micro-steps taken


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float):
    """ema = ema * decay + p * (1 - decay), in place, rounded in that order
    (the JAX package's ema_update)."""
    params = dict(model.named_parameters())
    es = list(ema.values())
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, torch._foreach_mul(
        [params[n].detach() for n in ema], 1.0 - decay))


def freeze(model: nn.Module, frozen_prefixes: Sequence[str]
           ) -> List[nn.Parameter]:
    """Set requires_grad from fix_modules: a parameter whose top-level
    module name is in frozen_prefixes is frozen. Returns the trainable
    parameters."""
    trainable = []
    for name, p in model.named_parameters():
        train = name.split(".")[0] not in frozen_prefixes
        p.requires_grad_(train)
        if train:
            trainable.append(p)
    return trainable


def build_optimizer(opt: Dict, params: Iterable[nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """Adam or AdamW from an options dict {"type", "lr", "betas",
    "weight_decay"}. Adam's weight_decay adds wd * p to the gradient (optax
    add_decayed_weights before adam); AdamW's is decoupled. The LR is set
    per update by the trainer (base * schedule)."""
    opt = dict(opt)
    t = opt.pop("type", "Adam")
    lr = opt.pop("lr", 1e-4)
    betas = tuple(opt.pop("betas", (0.9, 0.999)))
    wd = opt.pop("weight_decay", 0.0)
    if t == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=wd)
    if t == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=wd)
    raise NotImplementedError(
        f"optimizer {t} is not ported yet (ROADMAP Queue 1: the rest of "
        "training)")


@contextlib.contextmanager
def cast_parameters(model: nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter of `model` is replaced by
    its cast to `dtype`. The casts are differentiable, so gradients reach
    the masters; keep the block open through backward, so that recomputed
    checkpoints see the same weights."""
    swapped = []
    try:
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None and p.is_floating_point():
                    mod._parameters[name] = p.to(dtype)
                    swapped.append((mod, name, p))
        yield model
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p
