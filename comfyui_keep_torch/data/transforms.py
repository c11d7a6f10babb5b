"""Spatial transforms of the training data (reference wm_basicsr/data/
transforms.py), the port's copy of comfyui_keep_tpu/data/transforms.py.
Host-side numpy; the random draws take `rng` (a random.Random, the
datasets pass theirs; Python's global stream without one, as in the JAX
package). img_rotate warps through utils/cvops.py instead of OpenCV.
"""
import math
import random

import numpy as np
import torch

from comfyui_keep_torch.utils.cvops import warp_affine


def mod_crop(img, scale):
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale, gt_path=None,
                       rng=None):
    """Random crop of matching GT/LQ patches (transforms.py:26-93)."""
    rng = rng or random
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[:2]
    h_gt, w_gt = img_gts[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"scale mismatch: GT ({h_gt},{w_gt}) vs LQ*{scale}")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq},{w_lq}) smaller than patch {lq_patch_size}")
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt:top_gt + gt_patch_size, left_gt:left_gt + gt_patch_size, ...]
               for v in img_gts]
    if single_gt:
        img_gts = img_gts[0]
    if single_lq:
        img_lqs = img_lqs[0]
    return img_gts, img_lqs


def augment(imgs, hflip=True, rotation=True, flows=None, return_status=False,
            rng=None):
    """hflip / vflip / 90-rotate augmentation, flow-aware
    (transforms.py:94-160)."""
    rng = rng or random
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...].copy()
        if vflip:
            img = img[::-1, :, ...].copy()
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return img

    def _augment_flow(flow):
        if hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return flow

    single = not isinstance(imgs, list)
    if single:
        imgs = [imgs]
    imgs = [_augment(img) for img in imgs]
    if single:
        imgs = imgs[0]

    if flows is not None:
        single_f = not isinstance(flows, list)
        if single_f:
            flows = [flows]
        flows = [_augment_flow(f) for f in flows]
        if single_f:
            flows = flows[0]
        if return_status:
            return imgs, flows, (hflip, vflip, rot90)
        return imgs, flows
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs


def rotation_matrix_2d(center, angle: float, scale: float = 1.0
                       ) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): angle in degrees,
    counter-clockwise, about center (x, y)."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def img_rotate(img, angle, center=None, scale=1.0):
    """cv2.warpAffine(img, getRotationMatrix2D(center, angle, scale), (w,
    h)) of a uint8 or float32 (H, W[, C]) numpy image: bilinear, constant
    zero border."""
    h, w = img.shape[:2]
    if center is None:
        center = (w // 2, h // 2)
    m = rotation_matrix_2d(center, angle, scale)
    return warp_affine(torch.from_numpy(np.ascontiguousarray(img)), m,
                       (w, h)).numpy()
