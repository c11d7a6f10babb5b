"""NIQE, the Natural Image Quality Evaluator (reference
wm_basicsr/metrics/niqe.py; Mittal et al., "Making a 'Completely Blind'
Image Quality Analyzer"), ported from comfyui_keep_tpu/metrics/niqe.py
without OpenCV (numpy and scipy).

The pristine-model statistics (mu / cov) are data: the port's own copy of
BasicSR's `niqe_pris_params.npz` ships in `metrics/assets/`; another file
can be named by `params_path`. The 7x7 Gaussian smoothing window is
fspecial('gaussian', 7, 7/6). convert_to="gray" is OpenCV's float32
BGR2GRAY (utils/cvops.py bgr_to_gray).
"""
import math
import os
from typing import Optional

import numpy as np
from scipy.ndimage import convolve as _nd_convolve
from scipy.special import gamma as _gamma

from comfyui_keep_torch.utils.color import to_y_channel
from comfyui_keep_torch.utils.cvops import bgr_to_gray
from comfyui_keep_torch.utils.matlab import imresize
from comfyui_keep_torch.utils.registry import METRIC_REGISTRY

PRIS_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "assets", "niqe_pris_params.npz")


def gaussian_window_7() -> np.ndarray:
    """fspecial('gaussian', 7, 7/6), normalized."""
    sigma = 7.0 / 6.0
    ax = np.arange(-3, 4, dtype=np.float64)
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def load_pris_params(path: Optional[str] = None):
    with np.load(path or PRIS_PARAMS) as data:
        return data["mu_pris_param"], data["cov_pris_param"]


def estimate_aggd_param(block: np.ndarray):
    """Asymmetric generalized-Gaussian fit via the moment-matching table
    (Eq. 7 of the paper)."""
    block = block.flatten()
    gam = np.arange(0.2, 10.001, 0.001)
    rg = np.reciprocal(gam)
    r_gam = np.square(_gamma(rg * 2)) / (_gamma(rg) * _gamma(rg * 3))

    left_std = np.sqrt(np.mean(block[block < 0] ** 2))
    right_std = np.sqrt(np.mean(block[block > 0] ** 2))
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    pos = np.argmin((r_gam - rhatnorm) ** 2)
    alpha = gam[pos]
    beta_l = left_std * np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
    beta_r = right_std * np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
    return alpha, beta_l, beta_r


def compute_feature(block: np.ndarray):
    """18-dim feature of one block: AGGD of MSCN + 4 pairwise products."""
    feat = []
    alpha, bl, br = estimate_aggd_param(block)
    feat.extend([alpha, (bl + br) / 2])
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = estimate_aggd_param(block * shifted)
        mean = (br - bl) * (_gamma(2 / alpha) / _gamma(1 / alpha))
        feat.extend([alpha, mean, bl, br])
    return feat


def niqe_core(img: np.ndarray, mu_pris, cov_pris, block_h=96, block_w=96):
    """img: gray/Y (h, w) float [0, 255]."""
    assert img.ndim == 2
    window = gaussian_window_7()
    h, w = img.shape
    nbh, nbw = math.floor(h / block_h), math.floor(w / block_w)
    img = img[:nbh * block_h, :nbw * block_w]

    distparam = []
    for scale in (1, 2):
        mu = _nd_convolve(img, window, mode="nearest")
        sigma = np.sqrt(np.abs(
            _nd_convolve(np.square(img), window, mode="nearest") - np.square(mu)))
        norm = (img - mu) / (sigma + 1)
        feats = []
        for iw in range(nbw):
            for ih in range(nbh):
                block = norm[ih * block_h // scale:(ih + 1) * block_h // scale,
                             iw * block_w // scale:(iw + 1) * block_w // scale]
                feats.append(compute_feature(block))
        distparam.append(np.array(feats))
        if scale == 1:
            img = imresize(img / 255.0, scale=0.5, antialiasing=True) * 255.0

    distparam = np.concatenate(distparam, axis=1)
    mu_dist = np.nanmean(distparam, axis=0)
    good = distparam[~np.isnan(distparam).any(axis=1)]
    cov_dist = np.cov(good, rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = np.atleast_2d(mu_pris - mu_dist)  # npz stores mu as (1, 36)
    return float(np.sqrt(np.squeeze(d @ invcov @ d.T)))


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border, input_order="HWC", convert_to="y",
                   params_path: Optional[str] = None, **kwargs):
    """img: BGR [0, 255]."""
    mu_pris, cov_pris = load_pris_params(params_path)
    img = img.astype(np.float32)
    if input_order != "HW":
        if input_order == "CHW":
            img = img.transpose(1, 2, 0)
        if convert_to == "y":
            img = to_y_channel(img)
        elif convert_to == "gray":
            img = bgr_to_gray(img / 255.0) * 255.0
        img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = img.round()
    return niqe_core(img, mu_pris, cov_pris)
