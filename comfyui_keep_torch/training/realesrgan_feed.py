"""Real-ESRGAN's training-pair synthesis on the card (reference
models/realesrgan_model.py:69-186 feed_data), ported from
comfyui_keep_tpu/training/realesrgan_feed.py.

Two-order degradation of a batch of GT patches: unsharp-masked GT -> blur
(each sample's kernel, from the dataset) -> random resize -> Gaussian or
Poisson noise -> JPEG -> a second blur / resize / noise -> [resize back +
sinc filter] and JPEG in random order -> clamp and round to 8 bits ->
a paired random crop -> the training-pair pool. Batches are NHWC in [0, 1],
as the datasets give them; the convolutions and resizes run NCHW.

The draws: the choices and scales from a random.Random and a
np.random.RandomState (the JAX package's global Python and numpy streams,
drawn in its order), the noise from a torch.Generator on the batch's device
(the JAX package's jax.random keys: the two cannot agree, so parity holds
with the noise off or injected). JPEG quality is one draw a batch, as in
the JAX package. Runs eagerly: the random resizes change the shapes on
every call.
"""
import random
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from comfyui_keep_torch.utils.diffjpeg import diff_jpeg
from comfyui_keep_torch.utils.img_process import usm_sharp_pt


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) correlated with each sample's kernel (B, k, k) (or
    one (k, k) for all) over a reflect pad of k // 2 (img_process_util.py
    filter2D)."""
    b, h, w, c = img.shape
    if kernel.dim() == 2:
        kernel = kernel.expand(b, -1, -1)
    k = kernel.shape[-1]
    x = F.pad(img.permute(0, 3, 1, 2), (k // 2,) * 4, mode="reflect")
    wt = kernel.to(img.dtype)[:, None].repeat_interleave(c, dim=0)
    out = F.conv2d(x.reshape(1, b * c, h + k - 1, w + k - 1), wt,
                   groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def resize_torch(x: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    """F.interpolate of an NHWC batch: "bilinear" and "bicubic"
    (align_corners=False, no antialias) or "area"."""
    if mode not in ("bilinear", "bicubic", "area"):
        raise ValueError(mode)
    kw = {} if mode == "area" else {"align_corners": False}
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode=mode,
                         **kw).permute(0, 2, 3, 1)


def random_add_gaussian_noise_pt(img: torch.Tensor, generator,
                                 sigma_range=(0, 10), gray_prob=0.0):
    """Per-sample Gaussian noise: sigma ~ U(sigma_range) / 255, one gray
    (channel-shared) draw with probability gray_prob; clamped to [0, 1].
    Draws sigma, the colour noise, the gray noise, then the gray picks."""
    b = img.shape[0]
    dev, dt = img.device, img.dtype
    lo, hi = sigma_range

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    sigma = (lo + (hi - lo) * rand(b, 1, 1, 1)) / 255.0
    noise = torch.randn(img.shape, generator=generator, device=dev) * sigma
    gray = torch.randn(img.shape[:-1] + (1,), generator=generator,
                       device=dev) * sigma
    is_gray = rand(b, 1, 1, 1) < gray_prob
    noise = torch.where(is_gray, gray, noise)
    return torch.clamp(img + noise.to(dt), 0, 1)


def random_add_poisson_noise_pt(img: torch.Tensor, generator,
                                scale_range=(0, 1.0), gray_prob=0.0):
    """Per-sample Poisson noise: each sample's 8-bit levels, rounded up to
    a power of two, as the photon count; the noise scaled by U(scale_range)
    and added; clamped to [0, 1]."""
    b = img.shape[0]
    dev, dt = img.device, img.dtype
    lo, hi = scale_range
    scale = lo + (hi - lo) * torch.rand((b, 1, 1, 1), generator=generator,
                                        device=dev)
    is_gray = torch.rand((b, 1, 1, 1), generator=generator, device=dev) \
        < gray_prob
    base = torch.where(is_gray, img.mean(dim=-1, keepdim=True).expand_as(img),
                       img)
    rounded = torch.round(torch.clamp(base, 0, 1) * 255.0) / 255.0
    u8 = torch.round(rounded * 255).to(torch.uint8).cpu().numpy()
    levels = torch.as_tensor(
        [2.0 ** np.ceil(np.log2(max(len(np.unique(u8[i])), 2)))
         for i in range(b)], dtype=dt, device=dev).reshape(b, 1, 1, 1)
    noisy = torch.poisson(rounded * levels, generator=generator) / levels
    return torch.clamp(img + (noisy - rounded).to(dt) * scale.to(dt), 0, 1)


class TrainingPairPool:
    """FIFO pool of (lq, gt) pairs that decorrelates the batches'
    degradations (realesrgan_model.py:32-67 _dequeue_and_enqueue): until it
    holds queue_size pairs a batch goes in and comes out as it is; then the
    pool is shuffled (np_rng.permutation), its first B pairs come out and
    the batch takes their place."""

    def __init__(self, queue_size: int = 180, np_rng=None):
        self.queue_size = queue_size
        self.np_rng = np.random if np_rng is None else np_rng
        self.lq = self.gt = None
        self.ptr = 0

    def exchange(self, lq: torch.Tensor, gt: torch.Tensor):
        b = lq.shape[0]
        if self.lq is None:
            if self.queue_size % b:
                raise ValueError("queue size should be divisible by batch "
                                 "size")
            self.lq = lq.new_zeros((self.queue_size,) + lq.shape[1:])
            self.gt = gt.new_zeros((self.queue_size,) + gt.shape[1:])
        if self.ptr == self.queue_size:
            idx = torch.as_tensor(self.np_rng.permutation(self.queue_size),
                                  device=lq.device)
            self.lq, self.gt = self.lq[idx], self.gt[idx]
            out_lq, out_gt = self.lq[:b].clone(), self.gt[:b].clone()
            self.lq[:b], self.gt[:b] = lq, gt
            return out_lq, out_gt
        self.lq[self.ptr:self.ptr + b] = lq
        self.gt[self.ptr:self.ptr + b] = gt
        self.ptr += b
        return lq, gt


def realesrgan_synthesize(batch: Dict, opt: Dict, generator,
                          pool: Optional[TrainingPairPool] = None,
                          py_rng=None, np_rng=None) -> Dict:
    """The two-order synthesis. batch: {"gt" (B, H, W, 3) in [0, 1],
    "kernel1", "kernel2", "sinc_kernel" (B, k, k)} as tensors on one
    device; opt: the yml's top-level degradation options. Returns {"lq",
    "gt", "gt_usm"} cropped to opt["gt_size"] (lq to gt_size / scale)."""
    py = random if py_rng is None else py_rng
    nr = np.random if np_rng is None else np_rng
    gt = batch["gt"]
    gt_usm = usm_sharp_pt(gt)
    k1, k2, sinc = batch["kernel1"], batch["kernel2"], batch["sinc_kernel"]
    ori_h, ori_w = gt.shape[1:3]
    scale_f = opt.get("scale", 4)
    modes = ["area", "bilinear", "bicubic"]

    def rand_resize(out, prob_key, range_key, size=None):
        kind = py.choices(["up", "down", "keep"], opt[prob_key])[0]
        if kind == "up":
            s = nr.uniform(1, opt[range_key][1])
        elif kind == "down":
            s = nr.uniform(opt[range_key][0], 1)
        else:
            s = 1
        mode = py.choice(modes)
        h, w = size if size is not None else (out.shape[1], out.shape[2])
        return resize_torch(out, (int(h * s), int(w * s)), mode)

    def noise(out, prob, rng_key, scale_key, gray_key):
        if nr.uniform() < opt[prob]:
            return random_add_gaussian_noise_pt(out, generator, opt[rng_key],
                                                opt[gray_key])
        return random_add_poisson_noise_pt(out, generator, opt[scale_key],
                                           opt[gray_key])

    def jpeg(out, range_key):
        return diff_jpeg(torch.clamp(out, 0, 1), nr.uniform(*opt[range_key]),
                         differentiable=False)

    # first order
    out = filter2d(gt_usm, k1)
    out = rand_resize(out, "resize_prob", "resize_range")
    out = noise(out, "gaussian_noise_prob", "noise_range",
                "poisson_scale_range", "gray_noise_prob")
    out = jpeg(out, "jpeg_range")
    # second order
    if nr.uniform() < opt["second_blur_prob"]:
        out = filter2d(out, k2)
    out = rand_resize(out, "resize_prob2", "resize_range2",
                      size=(ori_h / scale_f, ori_w / scale_f))
    out = noise(out, "gaussian_noise_prob2", "noise_range2",
                "poisson_scale_range2", "gray_noise_prob2")
    final_hw = (ori_h // scale_f, ori_w // scale_f)
    if nr.uniform() < 0.5:
        out = filter2d(resize_torch(out, final_hw, py.choice(modes)), sinc)
        out = jpeg(out, "jpeg_range2")
    else:
        out = jpeg(out, "jpeg_range2")
        out = filter2d(resize_torch(out, final_hw, py.choice(modes)), sinc)
    lq = torch.clamp(torch.round(out * 255.0), 0, 255) / 255.0

    # one crop window for the whole batch, as the batched reference
    gt_size = opt["gt_size"]
    lq_size = gt_size // scale_f
    top = nr.randint(0, lq.shape[1] - lq_size + 1)
    left = nr.randint(0, lq.shape[2] - lq_size + 1)
    lq = lq[:, top:top + lq_size, left:left + lq_size]
    gt_c = gt[:, top * scale_f:top * scale_f + gt_size,
              left * scale_f:left * scale_f + gt_size]
    if pool is not None:
        lq, gt_c = pool.exchange(lq, gt_c)
    return {"lq": lq.contiguous(), "gt": gt_c.contiguous(),
            "gt_usm": usm_sharp_pt(gt_c)}
