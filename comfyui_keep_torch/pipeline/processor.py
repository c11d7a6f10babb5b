"""Face restoration pipeline for aligned faces (reference
modules/keep_processor.py), ported from comfyui_keep_tpu/pipeline/processor.py.

A stream of aligned 512x512 faces is cut into `max_clip_length` chunks; the
recurrent state resets at each chunk and a 1-frame chunk is duplicated and
its first output kept (keep_processor.py:256-275). Each chunk runs GMFlow
over its frame pairs, then KEEP. With carry_chunks=True (the JAX package's
extension) the state streams across chunks instead. KEEP's 512-level
convolutions run phase-packed (the JAX package's default) only when asked,
phase512=True: on the H100 the packed chunk is the slower one (PERF.md).
Face detection, tracking and paste-back are not ported yet, so the
unaligned paths raise. The resizes of the aligned paths are cv2.resize's,
computed without OpenCV (utils/resize.py), and skipped where the size
already matches.
"""
import copy
from typing import List, Optional

import numpy as np
import torch

from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.utils.image import (bgr2gray, bgr_u8_to_rgb_pm1,
                                            is_gray, rgb_pm1_to_bgr_u8)
from comfyui_keep_torch.utils.resize import resize


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
    for the CPU); `KEEPModelPack.processor` moves them there. With
    phase512=True (the JAX processor's default, not this one's: on the H100
    the packed chunk is slower, PERF.md), KEEP is prepared for phase-packed
    512-level convolutions on a copy, so the caller's KEEP stays unpacked.
    As in the JAX processor, the weights are packed in their own dtype and
    then cast to `dtype`, so both round a packed bf16 weight alike."""

    def __init__(self, keep: KEEP, gmflow: Optional[GMFlow] = None, dtype=None,
                 device="cuda", phase512: bool = False):
        device = torch.device(device)
        if not (_on(keep, device) and _on(gmflow, device)):
            raise ValueError(f"the models are not on {device}: move them "
                             f"there first (KEEPModelPack.load_device)")
        self.keep = _cast(keep.prepare_phase512() if phase512 else keep,
                          dtype)
        self.gmflow = _cast(gmflow, dtype)
        p = next(self.keep.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.face_size = int(self.keep.cfg.get("img_size", 512))

    def restore_clip(self, clip: np.ndarray, carry=None,
                     prev_frame: Optional[np.ndarray] = None,
                     return_carry: bool = False):
        """One chunk: (T, H, W, 3) RGB in [-1, 1] -> (T, H, W, 3) float32.
        With `carry` (a return_carry=True call's, on the chunk whose last
        input frame was prev_frame) the state streams in, and the boundary
        flow maps this chunk's frame 0 to prev_frame. return_carry=True
        returns (out, carry)."""
        frames = clip if carry is None else np.concatenate(
            [prev_frame[None], clip])
        x = torch.as_tensor(frames[None]).to(self.device, self.dtype)
        flows = (flow_from_clip(self.gmflow, x)
                 if self.gmflow is not None and x.shape[1] > 1 else None)
        if carry is not None:
            x = x[:, 1:]
        out = self.keep.apply(x, flows=flows, carry=carry,
                              return_carry=return_carry)
        if return_carry:
            out, carry = out
        out = out[0].float().cpu().numpy()
        return (out, carry) if return_carry else out

    def restore_face_stream(self, faces_bgr_u8: List[np.ndarray],
                            max_clip_length: int = 20,
                            carry_chunks: bool = False) -> List[np.ndarray]:
        """Restore a flat stream of aligned faces (uint8 BGR), chunked.
        carry_chunks=False resets the state per chunk (the reference);
        carry_chunks=True streams the Kalman state and the CFA features
        across chunk boundaries, with no 1-frame duplication."""
        if not faces_bgr_u8:
            return []
        x_all = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces_bgr_u8])
        outs: List[np.ndarray] = []
        carry = None
        for start in range(0, len(x_all), max_clip_length):
            clip = x_all[start:start + max_clip_length]
            if carry_chunks:
                out, carry = self.restore_clip(
                    clip, carry, x_all[start - 1] if start else None,
                    return_carry=True)
            elif clip.shape[0] == 1:
                # 1-frame duplication (keep_processor.py:266-268)
                out = self.restore_clip(np.concatenate([clip, clip]))[:1]
            else:
                out = self.restore_clip(clip)
            outs.extend(rgb_pm1_to_bgr_u8(o) for o in out)
        return outs

    # -- host orchestration (aligned faces only) -------------------------------

    @staticmethod
    def _resize_bg(img_bgr: np.ndarray, factor: float) -> np.ndarray:
        h, w = img_bgr.shape[:2]
        th, tw = int(h * factor), int(w * factor)
        if (h, w) == (th, tw):
            return img_bgr
        return resize(img_bgr, (tw, th), "lanczos4")

    def _face(self, img_bgr: np.ndarray) -> np.ndarray:
        """The aligned face at the face size (cv2's INTER_LINEAR)."""
        n = self.face_size
        if img_bgr.shape[:2] == (n, n):
            return img_bgr
        return resize(img_bgr, (n, n), "linear")

    def process_image(self, img_bgr: np.ndarray,
                      final_upscale_factor: float = 1.0,
                      has_aligned: bool = False) -> np.ndarray:
        """Single-image restore of an aligned face (keep_processor.py)."""
        if not has_aligned:
            raise NotImplementedError("unaligned images need face detection, "
                                      "which the port does not have yet")
        face = self._face(img_bgr)
        restored = self.restore_face_stream([face], max_clip_length=2)[0]
        if is_gray(face, threshold=10):
            restored = bgr2gray(restored)
        th = int(self.face_size * final_upscale_factor)
        if restored.shape[0] != th:
            restored = resize(restored, (th, th), "lanczos4")
        return restored

    def process_image_sequence(self, frames_bgr: List[np.ndarray],
                               final_upscale_factor: float = 1.0,
                               has_aligned_frames: bool = False,
                               max_clip_length: int = 20,
                               carry_chunks: bool = False) -> List[np.ndarray]:
        """Sequence restore of aligned frames. As in the JAX package and the
        reference, aligned frames return the (upscaled) input frames: the
        restored faces are computed but pasted nowhere."""
        if not has_aligned_frames:
            raise NotImplementedError("unaligned frames need face detection, "
                                      "which the port does not have yet")
        faces = [self._face(f) for f in frames_bgr]
        self.restore_face_stream(faces, max_clip_length,
                                 carry_chunks=carry_chunks)
        return [self._resize_bg(f, final_upscale_factor) for f in frames_bgr]
