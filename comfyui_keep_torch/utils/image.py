"""Host image conversions (reference img2tensor / tensor2img semantics).

Host images are HWC uint8 BGR (OpenCV order); the network takes RGB float
in [-1, 1].
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


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, repeated to 3 channels."""
    gray = 0.299 * img[..., 2] + 0.587 * img[..., 1] + 0.114 * img[..., 0]
    return np.stack([gray] * 3, axis=-1).astype(img.dtype)
