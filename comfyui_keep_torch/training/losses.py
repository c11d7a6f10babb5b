"""Pixel losses (reference wm_basicsr/losses/basic_loss.py), ported from
comfyui_keep_tpu/training/losses.py. Layout-free: they reduce elementwise
differences. The perceptual and GAN losses wait for VGG and the
discriminators (ROADMAP Queue 1 item 10)."""
from typing import Dict

import torch

_REDUCES = {"none": lambda x: x, "mean": torch.mean, "sum": torch.sum}


def _weighted(raw, weight, reduction):
    if weight is not None:
        raw = raw * weight
    return _REDUCES[reduction](raw)


def l1_loss(pred, target, weight=None, reduction="mean"):
    return _weighted((pred - target).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, reduction="mean"):
    return _weighted((pred - target) ** 2, weight, reduction)


def charbonnier_loss(pred, target, weight=None, reduction="mean", eps=1e-12):
    return _weighted(torch.sqrt((pred - target) ** 2 + eps), weight,
                     reduction)


class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * l1_loss(pred, target, weight,
                                          self.reduction)


class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * mse_loss(pred, target, weight,
                                           self.reduction)


class CharbonnierLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * charbonnier_loss(pred, target, weight,
                                                   self.reduction, self.eps)


LOSSES = {"L1Loss": L1Loss, "MSELoss": MSELoss,
          "CharbonnierLoss": CharbonnierLoss}


def build_loss(opt: Dict):
    """Config dict {"type": ..., **kwargs} -> loss object."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type not in LOSSES:
        raise NotImplementedError(
            f"loss {loss_type} is not ported yet (ROADMAP Queue 1 item 10)")
    return LOSSES[loss_type](**opt)
