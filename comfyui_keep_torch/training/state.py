"""Training state: f32 master weights, optimizer, EMA, the iteration and
epoch counts, and their save / resume (reference base_model.py:75-82,
207-365), ported from comfyui_keep_tpu/training/state.py.

`fix_modules` freezes top-level submodules: a frozen parameter gets no
gradient and no update (optax's `set_to_zero` branch in the JAX package),
while gradients still flow through it into the layers that train. The EMA
covers every parameter, frozen ones included, as the JAX package's does.

On disk, as the reference's .pth convention: `net_g_<iter>.pth` holds
`params` (the model's state dict) and `params_ema` (the same with the EMA
in place of each parameter); `<iter>.state` the optimizer's state dict,
`epoch`, `iter` and the trainer's `extra` (a GAN trainer's discriminator
and its optimizer). Both through torch.save, read back with
torch.load(weights_only=True).
"""
import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from comfyui_keep_torch.utils.logger import get_root_logger


@dataclass
class TrainState:
    model: nn.Module                   # f32 master weights
    optimizer: torch.optim.Optimizer   # over the trainable parameters only
    ema: Optional[Dict[str, torch.Tensor]] = None  # name -> every parameter
    iter: int = 0                      # micro-steps taken
    epoch: int = 0
    resume_extra: Any = None           # the trainer's extra, set by resume()

    def save(self, net_dir: str, state_dir: str, current_iter: int,
             retry: int = 3, extra=None) -> Tuple[str, str]:
        """Write net_g_<iter>.pth and <iter>.state, retrying an IO error
        up to `retry` times a second apart (base_model.py:237-252).
        Returns the two paths."""
        os.makedirs(net_dir, exist_ok=True)
        os.makedirs(state_dir, exist_ok=True)
        net = {"params": self.model.state_dict()}
        if self.ema is not None:
            net["params_ema"] = {**net["params"], **self.ema}
        net_path = os.path.join(net_dir, f"net_g_{current_iter}.pth")
        state_path = os.path.join(state_dir, f"{current_iter}.state")
        state = {"optimizer": self.optimizer.state_dict(),
                 "epoch": self.epoch, "iter": current_iter}
        if extra is not None:
            state["extra"] = extra
        for attempt in range(retry):
            try:
                torch.save(net, net_path)
                torch.save(state, state_path)
                return net_path, state_path
            except OSError:
                if attempt == retry - 1:
                    raise
                time.sleep(1)

    @staticmethod
    def latest_state(state_dir: str) -> Optional[str]:
        """The <iter>.state file of the highest iter in state_dir, or None
        (the auto_resume scan, train.py:68-88)."""
        if not os.path.isdir(state_dir):
            return None
        iters = [int(f.split(".")[0]) for f in os.listdir(state_dir)
                 if f.endswith(".state") and f.split(".")[0].isdigit()]
        if not iters:
            return None
        return os.path.join(state_dir, f"{max(iters)}.state")

    def resume(self, state_path: str):
        """Read a .state file: epoch and iter set, the trainer's extra kept
        in resume_extra; returns the optimizer's saved state dict."""
        data = torch.load(state_path, map_location="cpu", weights_only=True)
        self.epoch = int(data["epoch"])
        self.iter = int(data["iter"])
        self.resume_extra = data.get("extra")
        return data.get("optimizer")

    def resume_optimizer(self, opt_state: Optional[Dict]):
        """Put the saved optimizer state (moments, step counts) back on the
        live optimizer; without it a resumed Adam restarts from zero
        moments."""
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)

    def load_networks(self, net_path: str, strict: bool = False
                      ) -> Dict[str, int]:
        """The weights and the EMA from a net_g_<iter>.pth, merged into the
        live ones (merge_network_params). Returns {"loaded": tensors
        restored, "kept": tensors that kept their live value}."""
        net = torch.load(net_path, map_location="cpu", weights_only=True)
        stats: Dict[str, int] = {}
        merged = merge_network_params(self.model.state_dict(),
                                      net["params"], strict, stats)
        self.model.load_state_dict(merged)
        if self.ema is not None and "params_ema" in net:
            ema_saved = {k: v for k, v in net["params_ema"].items()
                         if k in self.ema}
            merged = merge_network_params(self.ema, ema_saved, strict, stats)
            with torch.no_grad():
                for k, v in merged.items():
                    self.ema[k].copy_(v)
        return stats


def load_network(path: str, prefer_ema: bool = True) -> Dict[str, Any]:
    """The state dict of a net_g_<iter>.pth: its EMA form when present and
    preferred, else its weights."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if prefer_ema and "params_ema" in data:
        return data["params_ema"]
    return data.get("params", data)


def merge_network_params(current: Dict[str, torch.Tensor],
                         loaded: Dict[str, torch.Tensor], strict: bool = True,
                         stats: Optional[Dict[str, int]] = None
                         ) -> Dict[str, torch.Tensor]:
    """`current` with each entry replaced by the loaded one of its name
    (base_model.py:254-287). A missing name or a shape mismatch raises with
    strict; without it, the entry keeps its current value and a warning
    says so. Names only in `loaded` raise with strict, else are ignored
    with a warning. `stats` counts {"loaded", "kept"} tensors."""
    logger = get_root_logger()
    stats = {} if stats is None else stats
    merged = {}
    for key, cur in current.items():
        new = loaded.get(key)
        if new is None:
            if strict:
                raise KeyError(f"missing key in checkpoint: {key}")
            logger.warning(f"missing key in checkpoint (kept init): {key}")
        elif tuple(new.shape) != tuple(cur.shape):
            if strict:
                raise ValueError(f"size mismatch for {key}: "
                                 f"{tuple(new.shape)} vs {tuple(cur.shape)}")
            logger.warning(f"size mismatch for {key} ({tuple(new.shape)} vs "
                           f"{tuple(cur.shape)}); kept init")
            new = None
        if new is None:
            merged[key] = cur
            stats["kept"] = stats.get("kept", 0) + 1
        else:
            merged[key] = new
            stats["loaded"] = stats.get("loaded", 0) + 1
    extra = sorted(set(loaded) - set(current))
    if extra:
        if strict:
            raise KeyError(f"unexpected keys in checkpoint: {extra[:5]}")
        logger.warning(f"{len(extra)} unexpected checkpoint keys ignored")
    return merged


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


class RMSpropOptax(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay=0.9, eps=1e-8, momentum): nu = decay nu +
    (1 - decay) g^2 from nu = 0; u = g / sqrt(nu + eps) (eps inside the
    root, where torch.optim.RMSprop adds it outside); then the momentum
    trace on the LR-scaled update, t = lr u + momentum t, p -= t."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8, momentum=0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                nu = st["nu"]
                nu.mul_(group["decay"]).add_(p.grad * p.grad,
                                             alpha=1 - group["decay"])
                upd = p.grad * torch.rsqrt(nu + group["eps"]) * group["lr"]
                st["trace"].mul_(group["momentum"]).add_(upd)
                p.sub_(st["trace"])


class RpropOptax(torch.optim.Optimizer):
    """optax.rprop(lr) (etas 0.5 / 1.2, step sizes 1e-6 to 50) as optax
    computes it: with s = g * prev (prev: the last step's sign(g) * step
    size), the step size grows where s > 0 and shrinks where s < 0 (clipped
    to its range); prev becomes step size * sign(g), 0 where s < 0; and the
    parameter moves by the *previous* prev, 0 where s < 0. So each update
    lags its gradient by one step (the first moves nothing), unlike
    torch.optim.Rprop (ROADMAP Queue 3)."""

    def __init__(self, params, lr=1e-2, etas=(0.5, 1.2),
                 step_sizes=(1e-6, 50.0)):
        super().__init__(params, dict(lr=lr, etas=etas,
                                      step_sizes=step_sizes))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            minus, plus = group["etas"]
            lo, hi = group["step_sizes"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step_size"] = torch.full_like(p, group["lr"])
                    st["prev"] = torch.zeros_like(p)
                g, prev = p.grad, st["prev"]
                s = g * prev
                grown = (st["step_size"] * torch.where(s > 0, plus, minus)
                         ).clamp(lo, hi)
                st["step_size"] = torch.where(s == 0, st["step_size"], grown)
                zero = torch.zeros_like(p)
                p.sub_(torch.where(s < 0, zero, prev))
                st["prev"] = torch.where(s < 0, zero,
                                         st["step_size"] * torch.sign(g))


def build_optimizer(opt: Dict, params: Iterable[nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The optimizer of an options dict {"type", "lr", ...}, as the JAX
    package maps each type onto optax (base_model.py:103-120): Adam (its
    weight_decay adds wd * p to the gradient), AdamW (decoupled decay),
    Adamax, SGD (momentum), ASGD as plain SGD, RMSprop (optax's form,
    RMSpropOptax) and Rprop (optax's form, RpropOptax). The trainer sets
    the LR of each update (base * schedule); Rprop keeps its own step
    sizes, as optax.rprop takes the base LR only."""
    opt = dict(opt)
    t = opt.pop("type", "Adam")
    lr = opt.pop("lr", 1e-4)
    betas = tuple(opt.pop("betas", (0.9, 0.999)))
    wd = opt.pop("weight_decay", 0.0)
    params = list(params)
    if t == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=wd)
    if t == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=wd)
    if t == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=betas)
    if t == "SGD":
        return torch.optim.SGD(params, lr=lr,
                               momentum=opt.pop("momentum", 0.0))
    if t == "ASGD":
        return torch.optim.SGD(params, lr=lr)
    if t == "RMSprop":
        return RMSpropOptax(params, lr=lr, momentum=opt.pop("momentum", 0.0))
    if t == "Rprop":
        return RpropOptax(params, lr=lr)
    raise NotImplementedError(f"optimizer {t}")


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
