"""LR schedules (reference models/lr_scheduler.py, base_model.py warmup) as
plain Python multipliers of the base LR, iteration -> float, ported from
comfyui_keep_tpu/training/schedulers.py. The trainer sets
lr = base * multiplier(step) on the optimizer's param groups before each
update, where step counts optimizer updates."""
import math
from bisect import bisect_right
from typing import Sequence


def multi_step_restart_lr(milestones: Sequence[int], gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1,)):
    """MultiStepRestartLR: gamma per milestone passed since the most recent
    restart, times that restart's weight."""
    milestones = sorted(milestones)
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and restart_weights differ in length")
    pairs = sorted(zip(restarts, restart_weights))

    def multiplier(step):
        step = int(step)
        last_restart, weight = 0, 1.0
        for r, w in pairs:
            if step >= r:
                last_restart, weight = r, float(w)
        n = (bisect_right(milestones, step)
             - bisect_right(milestones, last_restart))
        return weight * gamma ** n

    return multiplier


def cosine_annealing_restart_lr(periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0.0, base_lr: float = 1.0):
    """CosineAnnealingRestartLR as a multiplier of base_lr; the boundary
    step belongs to the period that ends there."""
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights differ in length")
    cum = [sum(periods[:i + 1]) for i in range(len(periods))]
    floor = eta_min / base_lr

    def multiplier(step):
        step = int(step)
        idx = next((i for i, c in enumerate(cum) if step <= c), len(cum) - 1)
        nearest_restart = 0 if idx == 0 else cum[idx - 1]
        return floor + restart_weights[idx] * 0.5 * (1 - floor) * (
            1 + math.cos(math.pi * ((step - nearest_restart) / periods[idx])))

    return multiplier


def cosine_onecycle(transition_steps: int, peak_value: float,
                    pct_start: float = 0.3, div_factor: float = 25.0,
                    final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule as a function of the update count: the
    LR itself, not a multiplier. From peak / div_factor it rises to
    peak_value at int(pct_start * transition_steps), then falls to peak /
    (div_factor^2 final_div_factor) at transition_steps and stays there;
    each phase is a cosine between its end values, end + (start - end) / 2
    (cos(pi pct) + 1). Its warm-up phase ends at that int(), one step later
    than torch's OneCycleLR. A zero-length warm-up (pct_start *
    transition_steps < 1) raises: optax returns NaN at every step there."""
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    if not bounds[0] < bounds[1] < bounds[2]:
        raise ValueError(f"cosine_onecycle: phase bounds {bounds} (optax's "
                         "schedule is NaN with an empty phase)")
    init = peak_value / div_factor
    values = (init, peak_value, peak_value / (div_factor * final_div_factor))

    def lr(step):
        step = int(step)
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * pct) + 1)
        return values[-1]

    return lr


def with_warmup(multiplier, warmup_iter: int = -1):
    """Linear warmup over the first warmup_iter steps."""
    if warmup_iter <= 0:
        return multiplier

    def sched(step):
        if step < warmup_iter:
            return multiplier(step) * (step + 1) / warmup_iter
        return multiplier(step)

    return sched


def build_scheduler(opt: dict):
    opt = dict(opt)
    t = opt.pop("type")
    if t in ("MultiStepLR", "MultiStepRestartLR"):
        return multi_step_restart_lr(**opt)
    if t == "CosineAnnealingRestartLR":
        return cosine_annealing_restart_lr(**opt)
    raise NotImplementedError(f"scheduler {t}")
