"""Unsharp masking (reference wm_basicsr/utils/img_process_util.py), ported
from comfyui_keep_tpu/utils/img_process.py without OpenCV: `usm_sharp` on
one float32 image as cv2.GaussianBlur gives it (utils/cvops.py), and
`usm_sharp_pt`, the batched twin (the reference's USMSharp module) that
the Real-ESRGAN feed runs on the card."""
import numpy as np
import torch
import torch.nn.functional as F

from comfyui_keep_torch.utils import cvops


def usm_sharp(img, weight: float = 0.5, radius: int = 50,
              threshold: int = 10):
    """img: (H, W, C) float32 in [0, 1], numpy or a tensor (the result is
    of the same kind): the blur residual added with `weight` where it
    exceeds threshold / 255, the mask softened by the same blur."""
    if radius % 2 == 0:
        radius += 1
    t = torch.as_tensor(np.ascontiguousarray(img)) if isinstance(
        img, np.ndarray) else img
    blur = cvops.gaussian_blur(t, radius, 0)
    residual = t - blur
    mask = (torch.abs(residual) * 255 > threshold).float()
    soft_mask = cvops.gaussian_blur(mask, radius, 0)
    sharp = torch.clamp(t + weight * residual, 0, 1)
    out = soft_mask * sharp + (1 - soft_mask) * t
    return out.numpy() if isinstance(img, np.ndarray) else out


def usm_sharp_pt(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
                 threshold: int = 10) -> torch.Tensor:
    """img: (B, H, W, C) in [0, 1] on any device: the JAX package's
    usm_sharp_jax, the blur the outer product of cv2.getGaussianKernel's
    taps as one 2-D depthwise correlation over a reflect pad."""
    if radius % 2 == 0:
        radius += 1
    k1d = torch.as_tensor(cvops.gaussian_kernel(radius, 0).astype(np.float64))
    c = img.shape[-1]
    w = torch.outer(k1d, k1d).to(img.dtype).to(img.device)
    w = w.expand(c, 1, radius, radius)
    pad = radius // 2

    def blur(x):
        x = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
        return F.conv2d(x, w, groups=c).permute(0, 2, 3, 1)

    residual = img - blur(img)
    mask = (torch.abs(residual) * 255 > threshold).to(img.dtype)
    soft_mask = blur(mask)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img
