"""Face restoration pipeline for aligned faces (reference
modules/keep_processor.py), ported from comfyui_keep_tpu/pipeline/processor.py.

A stream of aligned 512x512 faces is cut into `max_clip_length` chunks; the
recurrent state resets at each chunk and a 1-frame chunk is duplicated and
its first output kept (keep_processor.py:256-275). Each chunk runs GMFlow
over its frame pairs, then KEEP. Face detection, tracking and paste-back are
not ported yet, so the unaligned paths raise.
"""
import copy
from typing import List, Optional

import numpy as np
import torch

from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.utils.image import (bgr2gray, bgr_u8_to_rgb_pm1,
                                            is_gray, rgb_pm1_to_bgr_u8)


def _cast(module: Optional[torch.nn.Module], dtype):
    """`module` in `dtype`: itself when it already is, else a cast copy (the
    caller's module keeps its dtype)."""
    if module is None or dtype is None:
        return module
    if next(module.parameters()).dtype == dtype:
        return module
    return copy.deepcopy(module).to(dtype)


def _on(module: Optional[torch.nn.Module], device: torch.device) -> bool:
    if module is None:
        return True
    d = next(module.parameters()).device
    return d.type == device.type and device.index in (None, d.index)


class KEEPFaceProcessor:
    """KEEP (and optionally GMFlow) on one device, in one dtype. Without
    GMFlow the flows are zero (the single-image path).

    The models must already sit on `device` ("cuda" unless the caller asks
    for the CPU); `KEEPModelPack.processor` moves them there."""

    def __init__(self, keep: KEEP, gmflow: Optional[GMFlow] = None, dtype=None,
                 device="cuda"):
        device = torch.device(device)
        if not (_on(keep, device) and _on(gmflow, device)):
            raise ValueError(f"the models are not on {device}: move them "
                             f"there first (KEEPModelPack.load_device)")
        self.keep = _cast(keep, dtype)
        self.gmflow = _cast(gmflow, dtype)
        p = next(self.keep.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.face_size = int(self.keep.cfg.get("img_size", 512))

    def restore_clip(self, clip: np.ndarray) -> np.ndarray:
        """One chunk: (T, H, W, 3) RGB in [-1, 1] -> (T, H, W, 3) float32."""
        x = torch.as_tensor(clip[None]).to(self.device, self.dtype)
        flows = flow_from_clip(self.gmflow, x) if self.gmflow is not None \
            else None
        out = self.keep.apply(x, flows=flows)
        return out[0].float().cpu().numpy()

    def restore_face_stream(self, faces_bgr_u8: List[np.ndarray],
                            max_clip_length: int = 20) -> List[np.ndarray]:
        """Restore a flat stream of aligned faces (uint8 BGR), chunked with
        the state reset per chunk."""
        if not faces_bgr_u8:
            return []
        x_all = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces_bgr_u8])
        outs: List[np.ndarray] = []
        for start in range(0, len(x_all), max_clip_length):
            clip = x_all[start:start + max_clip_length]
            dup = clip.shape[0] == 1
            if dup:  # 1-frame duplication (keep_processor.py:266-268)
                clip = np.concatenate([clip, clip], axis=0)
            out = self.restore_clip(clip)
            if dup:
                out = out[:1]
            outs.extend(rgb_pm1_to_bgr_u8(o) for o in out)
        return outs

    # -- host orchestration (aligned faces only) -------------------------------

    @staticmethod
    def _resize_bg(img_bgr: np.ndarray, factor: float) -> np.ndarray:
        import cv2
        h, w = img_bgr.shape[:2]
        th, tw = int(h * factor), int(w * factor)
        if (h, w) == (th, tw):
            return img_bgr
        return cv2.resize(img_bgr, (tw, th), interpolation=cv2.INTER_LANCZOS4)

    def process_image(self, img_bgr: np.ndarray,
                      final_upscale_factor: float = 1.0,
                      has_aligned: bool = False) -> np.ndarray:
        """Single-image restore of an aligned face (keep_processor.py)."""
        if not has_aligned:
            raise NotImplementedError("unaligned images need face detection, "
                                      "which the port does not have yet")
        import cv2
        face = cv2.resize(img_bgr, (self.face_size, self.face_size),
                          interpolation=cv2.INTER_LINEAR)
        restored = self.restore_face_stream([face], max_clip_length=2)[0]
        if is_gray(face, threshold=10):
            restored = bgr2gray(restored)
        th = int(self.face_size * final_upscale_factor)
        if restored.shape[0] != th:
            restored = cv2.resize(restored, (th, th),
                                  interpolation=cv2.INTER_LANCZOS4)
        return restored

    def process_image_sequence(self, frames_bgr: List[np.ndarray],
                               final_upscale_factor: float = 1.0,
                               has_aligned_frames: bool = False,
                               max_clip_length: int = 20) -> List[np.ndarray]:
        """Sequence restore of aligned frames. As in the JAX package and the
        reference, aligned frames return the (upscaled) input frames: the
        restored faces are computed but pasted nowhere."""
        if not has_aligned_frames:
            raise NotImplementedError("unaligned frames need face detection, "
                                      "which the port does not have yet")
        import cv2
        faces = [cv2.resize(f, (self.face_size, self.face_size),
                            interpolation=cv2.INTER_LINEAR)
                 for f in frames_bgr]
        self.restore_face_stream(faces, max_clip_length)
        return [self._resize_bg(f, final_upscale_factor) for f in frames_bgr]
