"""Host image conversions (reference img2tensor / tensor2img semantics,
modules/utils.py's ComfyUI conversions, facelib misc.py), ported from
comfyui_keep_tpu/utils/image.py.

Host images are HWC uint8 BGR (OpenCV order); the network takes RGB float
in [-1, 1]; ComfyUI IMAGEs are (B, H, W, C) float32 RGB in [0, 1].
"""
import numpy as np


def bgr_u8_to_rgb_pm1(img: np.ndarray) -> np.ndarray:
    """uint8 BGR HWC -> float32 RGB [-1, 1]."""
    x = img.astype(np.float32)[..., ::-1] / 255.0
    return (x - 0.5) / 0.5


def rgb_pm1_to_bgr_u8(x: np.ndarray) -> np.ndarray:
    """float RGB [-1, 1] -> uint8 BGR: clamp, rescale to [0, 1], * 255,
    round."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    x = (x + 1.0) / 2.0
    return (x[..., ::-1] * 255.0).round().astype(np.uint8)


def is_gray(img: np.ndarray, threshold: int = 10) -> bool:
    """Channel-difference heuristic (facelib utils/misc.py)."""
    img = img.astype(np.float32)
    if img.ndim == 2 or img.shape[-1] == 1:
        return True
    diff1 = np.abs(img[..., 0] - img[..., 1]).mean()
    diff2 = np.abs(img[..., 1] - img[..., 2]).mean()
    return diff1 <= threshold and diff2 <= threshold


def bgr2gray(img: np.ndarray, out_channel: int = 3) -> np.ndarray:
    """ITU-R 601 luma, repeated to 3 channels (or 1)."""
    gray = 0.299 * img[..., 2] + 0.587 * img[..., 1] + 0.114 * img[..., 0]
    if out_channel == 3:
        return np.stack([gray] * 3, axis=-1).astype(img.dtype)
    return gray.astype(img.dtype)


def comfy_to_cv2(img: np.ndarray) -> np.ndarray:
    """A ComfyUI image ((B,) H, W, C float32 RGB in [0, 1]; the first of a
    batch) -> HWC uint8 BGR."""
    if img.ndim == 4:
        img = img[0]
    x = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    return x[..., ::-1].copy()


def cv2_to_comfy(img: np.ndarray) -> np.ndarray:
    """HWC uint8 BGR -> (1, H, W, C) float32 RGB in [0, 1]."""
    x = img[..., ::-1].astype(np.float32) / 255.0
    return x[None]


def adain_npy(content_feat: np.ndarray, style_feat: np.ndarray) -> np.ndarray:
    """AdaIN colour transfer per channel (the helper's grayscale path)."""
    size = content_feat.shape
    style_mean = style_feat.reshape(-1, size[-1]).mean(0)
    style_std = style_feat.reshape(-1, size[-1]).std(0) + 1e-5
    content_mean = content_feat.reshape(-1, size[-1]).mean(0)
    content_std = content_feat.reshape(-1, size[-1]).std(0) + 1e-5
    normalized = (content_feat - content_mean) / content_std
    return normalized * style_std + style_mean
