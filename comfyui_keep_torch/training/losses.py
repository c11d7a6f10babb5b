"""Pixel and GAN losses (reference wm_basicsr/losses/basic_loss.py,
gan_loss.py), ported from comfyui_keep_tpu/training/losses.py: the pixel
losses, GANLoss (five types), the R1 penalty and StyleGAN2's path-length
regularisation. Layout-free: they reduce elementwise differences. The
other losses, PerceptualLoss among them (on models/vgg.py), are ROADMAP
Queue 1, item 6.2: the rest of training."""
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

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


class GANLoss:
    """vanilla | lsgan | wgan | wgan_softplus | hinge (gan_loss.py:11-113).
    loss_weight applies to the generator's loss only."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        if gan_type not in ("vanilla", "lsgan", "wgan", "wgan_softplus",
                            "hinge"):
            raise NotImplementedError(f"GAN type {gan_type}")
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def _target(self, x, target_is_real):
        return torch.full_like(
            x, self.real_label_val if target_is_real else self.fake_label_val)

    def __call__(self, x, target_is_real, is_disc=False):
        if self.gan_type == "vanilla":  # BCE with logits, the stable form
            t = self._target(x, target_is_real)
            loss = torch.mean(torch.clamp(x, min=0) - x * t
                              + torch.log1p(torch.exp(-x.abs())))
        elif self.gan_type == "lsgan":
            loss = torch.mean((x - self._target(x, target_is_real)) ** 2)
        elif self.gan_type == "wgan":
            loss = -torch.mean(x) if target_is_real else torch.mean(x)
        elif self.gan_type == "wgan_softplus":
            loss = (torch.mean(F.softplus(-x)) if target_is_real
                    else torch.mean(F.softplus(x)))
        elif is_disc:  # hinge
            x = -x if target_is_real else x
            loss = torch.mean(torch.clamp(1 + x, min=0))
        else:
            loss = -torch.mean(x)
        return loss if is_disc else loss * self.loss_weight


def r1_penalty(disc_fn: Callable, real):
    """R1 gradient penalty (gan_loss.py:143-160): the batch mean of
    |d sum(D(real)) / d real|^2, with the graph kept so that it trains D."""
    real = real.detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(real).sum(), real, create_graph=True)
    return grads.pow(2).reshape(grads.shape[0], -1).sum(dim=1).mean()


def g_path_regularize(fake_fn: Callable, latents, mean_path_length,
                      decay=0.01, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """StyleGAN2 path-length regularisation (gan_loss.py:163-180) as the JAX
    package has it: the gradient is taken with respect to the latents given
    to fake_fn (z codes through the mapping MLP) and the path length is one
    scalar over the batch. noise: N(0, 1) of the image's shape (drawn from
    `generator` when not given), divided by sqrt(H W) here. Returns
    (penalty, new mean path length (detached), path length)."""
    latents = latents.detach().requires_grad_(True)
    fake = fake_fn(latents)
    if noise is None:
        noise = torch.randn(fake.shape, generator=generator,
                            dtype=fake.dtype, device=fake.device)
    noise = noise / math.sqrt(fake.shape[2] * fake.shape[3])
    grads, = torch.autograd.grad((fake * noise).sum(), latents,
                                 create_graph=True)
    path_lengths = torch.sqrt(grads.pow(2).sum(dim=1).mean(dim=-1) + 1e-12)
    path_mean = mean_path_length + decay * (path_lengths.mean()
                                            - mean_path_length)
    penalty = torch.mean((path_lengths - path_mean) ** 2)
    return penalty, path_mean.detach(), path_lengths


LOSSES = {"L1Loss": L1Loss, "MSELoss": MSELoss,
          "CharbonnierLoss": CharbonnierLoss, "GANLoss": GANLoss}


def build_loss(opt: Dict):
    """Config dict {"type": ..., **kwargs} -> loss object."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type not in LOSSES:
        raise NotImplementedError(
            f"loss {loss_type} is not ported yet (ROADMAP Queue 1, item "
            "6: the rest of training; the losses are 6.2)")
    return LOSSES[loss_type](**opt)
