"""PSNR / SSIM (reference wm_basicsr/metrics/psnr_ssim.py), ported from
comfyui_keep_tpu/metrics/psnr_ssim.py without OpenCV: numpy forms on HWC
images in [0, 255] (float64 inside), and batched tensor twins on (N, C, H,
W) images in [0, 1].

SSIM is MATLAB's: an 11x11 Gaussian window of sigma 1.5 (cv2's
getGaussianKernel(11, 1.5) in float64), the valid part of the filtered
maps (the reference's filter2D then [5:-5] crop: its border never reaches
a kept value), C1 / C2 from k1 = 0.01 / k2 = 0.03 at L = 255.
"""
import numpy as np
import torch
import torch.nn.functional as F

from comfyui_keep_torch.utils.color import rgb2ycbcr_pt, to_y_channel
from comfyui_keep_torch.utils.registry import METRIC_REGISTRY

C1 = (0.01 * 255) ** 2
C2 = (0.03 * 255) ** 2


def gaussian_kernel(n: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(n, sigma) (n odd, sigma > 0) as OpenCV builds
    it in float64: exp(-(x / 2)^2 / (2 sigma^2)) over x = 1 - n, 3 - n,
    ..., the sum's reciprocal times each value, mirrored."""
    scale2x = -0.125 / (sigma * sigma)
    half = [np.exp(float(x * x) * scale2x) for x in range(1 - n, 0, 2)]
    mul = 1.0 / (2.0 * sum(half) + 1.0)
    side = [v * mul for v in half]
    return np.array(side + [mul] + side[::-1], np.float64)


def reorder_image(img, input_order="HWC"):
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = img[..., None]
    return img


def _prep(img, img2, crop_border, input_order, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f"shapes differ: {img.shape} vs {img2.shape}")
    img = reorder_image(img, input_order)
    img2 = reorder_image(img2, input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order="HWC",
                   test_y_channel=False, **kwargs):
    """Images in [0, 255]."""
    img, img2 = _prep(img, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def _filter_valid(img, k):
    """The valid part of img (H, W) correlated with outer(k, k)."""
    n = len(k)
    h, w = img.shape
    rows = sum(k[i] * img[i:h - n + 1 + i] for i in range(n))
    return sum(k[j] * rows[:, j:w - n + 1 + j] for j in range(n))


def _ssim_channel(img, img2):
    k = gaussian_kernel()
    mu1, mu2 = _filter_valid(img, k), _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img ** 2, k) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, k) - mu2_sq
    sigma12 = _filter_valid(img * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order="HWC",
                   test_y_channel=False, **kwargs):
    """Images in [0, 255]; per-channel SSIM averaged."""
    img, img2 = _prep(img, img2, crop_border, input_order, test_y_channel)
    return float(np.mean([_ssim_channel(img[..., i], img2[..., i])
                          for i in range(img.shape[2])]))


# -- batched tensor twins (reference calculate_psnr_pt / calculate_ssim_pt):
# (N, C, H, W) RGB in [0, 1], computed in the input's dtype promoted to at
# least float32 (a float64 input gives the reference's float64 form) ----------

def _prep_pt(img, img2, crop_border, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f"shapes differ: {img.shape} vs {img2.shape}")
    dt = torch.promote_types(img.dtype, torch.float32)
    img, img2 = img.to(dt), img2.to(dt)
    if crop_border != 0:
        img = img[..., crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[..., crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img = rgb2ycbcr_pt(img, y_only=True)
        img2 = rgb2ycbcr_pt(img2, y_only=True)
    return img, img2


def calculate_psnr_pt(img, img2, crop_border, test_y_channel=False):
    """-> (N,) PSNR in dB, 10 log10(1 / (mse + 1e-8))."""
    img, img2 = _prep_pt(img, img2, crop_border, test_y_channel)
    mse = torch.mean((img - img2) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


def calculate_ssim_pt(img, img2, crop_border, test_y_channel=False):
    """-> (N,) SSIM: the Gaussian window as a depthwise VALID convolution."""
    img, img2 = _prep_pt(img, img2, crop_border, test_y_channel)
    img, img2 = img * 255.0, img2 * 255.0
    c = img.shape[1]
    k = torch.as_tensor(gaussian_kernel(), dtype=img.dtype, device=img.device)
    window = torch.outer(k, k).expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, window, groups=c)

    mu1, mu2 = filt(img), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img ** 2) - mu1_sq
    s2 = filt(img2 ** 2) - mu2_sq
    s12 = filt(img * img2) - mu1_mu2
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    ssim_map = ((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs
    return ssim_map.mean(dim=(1, 2, 3))
