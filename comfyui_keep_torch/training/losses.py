"""The loss library (reference wm_basicsr/losses/basic_loss.py,
gan_loss.py, loss_util.py), ported from comfyui_keep_tpu/training/
losses.py: the pixel losses, WeightedTVLoss, PerceptualLoss and LPIPSLoss
on a feature function (models/vgg.py's VGGFeatureExtractor), GANLoss (five
types) and MultiScaleGANLoss, the R1 and WGAN-GP penalties, StyleGAN2's
path-length regularisation, and LDL's artifact map. Each loss class is in
LOSS_REGISTRY under the JAX package's name; `build_loss` builds one from
the options. Images are NCHW, as the port's image models take them (the
pixel and GAN losses reduce elementwise and take any layout).
"""
import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from comfyui_keep_torch.utils.registry import LOSS_REGISTRY

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


@LOSS_REGISTRY.register()
class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * l1_loss(pred, target, weight,
                                          self.reduction)


@LOSS_REGISTRY.register()
class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * mse_loss(pred, target, weight,
                                           self.reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * charbonnier_loss(pred, target, weight,
                                                   self.reduction, self.eps)


@LOSS_REGISTRY.register()
class WeightedTVLoss:
    """L1 total variation, optionally weighted per pixel (basic_loss.py
    WeightedTVLoss): the vertical and the horizontal neighbour differences
    of an NCHW image, each weighted by `weight` cut to its shape."""

    def __init__(self, loss_weight=1.0, reduction="mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"unsupported reduction {reduction}")
        self.l1 = L1Loss(loss_weight, reduction)

    def __call__(self, pred, weight=None):
        yw = None if weight is None else weight[:, :, :-1, :]
        xw = None if weight is None else weight[:, :, :, :-1]
        ydiff = self.l1(pred[:, :, :-1], pred[:, :, 1:], weight=yw)
        xdiff = self.l1(pred[:, :, :, :-1], pred[:, :, :, 1:], weight=xw)
        return ydiff + xdiff


@LOSS_REGISTRY.register()
class PerceptualLoss:
    """Feature and style loss (basic_loss.py:146-253) on feature_fn(x,
    layers) -> {layer: NCHW activation}, e.g. a VGGFeatureExtractor (which
    applies its input normalisation). Returns (perceptual, style), each
    None when its weight is 0: the criterion's distance between the
    features (their Gram matrices for style), weighted per layer."""

    def __init__(self, layer_weights: Dict[str, float], feature_fn: Callable,
                 perceptual_weight=1.0, style_weight=0.0, criterion="l1"):
        if criterion not in ("l1", "l2", "mse", "fro"):
            raise ValueError(f"criterion {criterion}")
        self.layer_weights = layer_weights
        self.feature_fn = feature_fn
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion

    def _crit(self, a, b):
        if self.criterion == "l1":
            return torch.mean((a - b).abs())
        if self.criterion == "fro":
            return torch.linalg.vector_norm(a - b)
        return torch.mean((a - b) ** 2)

    @staticmethod
    def _gram(x):
        n, c, h, w = x.shape
        f = x.reshape(n, c, h * w)
        return f @ f.transpose(1, 2) / (c * h * w)

    def __call__(self, x, gt):
        layers = list(self.layer_weights)
        fx = self.feature_fn(x, layers)
        fgt = self.feature_fn(gt.detach(), layers)
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self._crit(fx[k], fgt[k]) * self.layer_weights[k]
                         for k in layers) * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._crit(self._gram(fx[k]), self._gram(fgt[k]))
                        * self.layer_weights[k]
                        for k in layers) * self.style_weight
        return percep, style


@LOSS_REGISTRY.register()
class LPIPSLoss:
    """LPIPS-style distance (the JAX package's form): feature_fn's
    activations unit-normalised over channels, squared differences summed
    over channels (times a layer's linear_weights (1, C, 1, 1) where
    given), averaged over batch and space, summed over layers."""

    def __init__(self, feature_fn: Callable,
                 layers: Sequence[str] = ("relu1_2", "relu2_2", "relu3_4",
                                          "relu4_4", "relu5_4"),
                 loss_weight=1.0, linear_weights: Optional[Dict] = None):
        self.feature_fn = feature_fn
        self.layers = list(layers)
        self.loss_weight = loss_weight
        self.linear_weights = linear_weights

    def __call__(self, x, gt):
        fx = self.feature_fn(x, self.layers)
        fgt = self.feature_fn(gt.detach(), self.layers)
        total = 0.0
        for k in self.layers:
            a = fx[k] / (torch.linalg.vector_norm(fx[k], dim=1,
                                                  keepdim=True) + 1e-10)
            b = fgt[k] / (torch.linalg.vector_norm(fgt[k], dim=1,
                                                   keepdim=True) + 1e-10)
            d = (a - b) ** 2
            if self.linear_weights is not None and k in self.linear_weights:
                d = d * self.linear_weights[k]
            total = total + torch.mean(torch.sum(d, dim=1))
        return self.loss_weight * total


@LOSS_REGISTRY.register()
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


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a multi-scale discriminator's outputs: a list
    of predictions, each a tensor or a list whose last entry is taken."""

    def __call__(self, x, target_is_real, is_disc=False):
        if isinstance(x, (list, tuple)):
            total = 0.0
            for xi in x:
                if isinstance(xi, (list, tuple)):
                    xi = xi[-1]
                total = total + super().__call__(xi, target_is_real, is_disc)
            return total / len(x)
        return super().__call__(x, target_is_real, is_disc)


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


def gradient_penalty_loss(disc_fn: Callable, real, fake, weight=None,
                          alpha: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """WGAN-GP penalty (gan_loss.py:183-207): mean over the batch of
    (|d sum(D(x)) / d x| - 1)^2 at x = alpha real + (1 - alpha) fake, with
    alpha (B, 1, ...) given or drawn uniform from `generator`; the
    gradient times `weight` and the loss over mean(weight) when a weight is
    given. The graph is kept, so that it trains D."""
    if alpha is None:
        alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1),
                           generator=generator, dtype=real.dtype,
                           device=real.device)
    interp = (alpha * real.detach() + (1 - alpha) * fake.detach()
              ).requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(interp).sum(), interp,
                                 create_graph=True)
    if weight is not None:
        grads = grads * weight
    norm = grads.reshape(grads.shape[0], -1).norm(dim=1)
    loss = torch.mean((norm - 1) ** 2)
    if weight is not None:
        loss = loss / torch.mean(weight)
    return loss


def get_local_weights(residual, ksize: int):
    """LDL's pixel-level weights (loss_util.py:99-119): the unbiased
    variance of the residual (B, 1, H, W) over each ksize x ksize window,
    reflect-padded."""
    pad = (ksize - 1) // 2
    h, w = residual.shape[2:]
    rp = F.pad(residual, (pad, pad, pad, pad), mode="reflect")
    patches = torch.stack([rp[:, :, dy:dy + h, dx:dx + w]
                           for dy in range(ksize) for dx in range(ksize)],
                          dim=-1)
    return torch.var(patches, dim=-1, unbiased=True)


def get_refined_artifact_map(img_gt, img_output, img_ema, ksize: int):
    """LDL's artifact map (CVPR 2022; loss_util.py:121-147) of NCHW images
    -> (B, 1, H, W) weights, zero where the EMA model's output is already
    closer to the ground truth than img_output."""
    residual_ema = torch.sum((img_gt - img_ema).abs(), dim=1, keepdim=True)
    residual_sr = torch.sum((img_gt - img_output).abs(), dim=1, keepdim=True)
    patch_level = torch.var(residual_sr, dim=(1, 2, 3), unbiased=True,
                            keepdim=True) ** (1 / 5)
    overall = patch_level * get_local_weights(residual_sr, ksize)
    return torch.where(residual_sr < residual_ema,
                       torch.zeros_like(overall), overall)


def build_loss(opt: Dict, **extra):
    """Options {"type": ..., **kwargs} -> the loss LOSS_REGISTRY names
    (reference losses/__init__.py:19-31); `extra` (a feature_fn) is passed
    through to it."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    return LOSS_REGISTRY.get(loss_type)(**opt, **extra)
