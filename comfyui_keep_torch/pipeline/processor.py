"""Face restoration pipeline (reference modules/keep_processor.py), ported
from comfyui_keep_tpu/pipeline/processor.py.

A stream of aligned 512x512 faces is cut into `max_clip_length` chunks; the
recurrent state resets at each chunk and a 1-frame chunk is duplicated and
its first output kept (keep_processor.py:256-275). Each chunk runs GMFlow
over its frame pairs, then KEEP. With carry_chunks=True (the JAX package's
extension) the state streams across chunks instead. A stream of at least
two chunks sends its full chunks in groups of up to `chunks_per_dispatch`
(JAX's grouped dispatch), each group in one of three forms
(`chunk_batching`): "map", chunk after chunk (the default, the same output
as one call per chunk), "batch", one GMFlow and one KEEP call on the group's
stack, or "stage", one GMFlow call and KEEP.apply_chunks. KEEP's 512-level
convolutions run phase-packed (the JAX package's default) only when asked,
phase512=True: on the H100 the packed chunk is the slower one (PERF.md).

Whole frames (has_aligned=False) go through a FaceRestoreHelper with a
detector and a parser attached: detect (the clip as one batch when its
frames share a shape), track and smooth the landmarks across frames, crop
and align each face, restore the face stream, paste each face back into
the upscaled frame. Optional upscalers (bgr_u8 -> bgr_u8 plug-ins,
pipeline/tiled.py's make_upscaler_fn) upscale the background before its
LANCZOS4 resize to the final size, and each restored face before it is
resized back and pasted (BASELINE config 5). No step needs OpenCV: the
resizes are utils/resize.py's and the helper's pixel work utils/cvops.py's.
"""
import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from comfyui_keep_torch.facelib.helper import FaceRestoreHelper
from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.pipeline.tracking import (interpolate_sequence,
                                                  smooth_landmark_tracks,
                                                  track_faces)
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


def plugin_models(*plugins) -> List[torch.nn.Module]:
    """The modules of plug-ins (a detector, a parser, an upscaler): each
    one's `.model`, where it has one."""
    return [m for m in (getattr(p, "model", None) for p in plugins)
            if isinstance(m, torch.nn.Module)]


def helper_models(helper: Optional[FaceRestoreHelper]
                  ) -> List[torch.nn.Module]:
    """The modules of a helper's detector and parser plug-ins (`.model`)."""
    if helper is None:
        return []
    return plugin_models(helper.detector, helper.parser)


CHUNK_BATCHING = ("map", "batch", "stage")


def _on(module: Optional[torch.nn.Module], device: torch.device) -> bool:
    if module is None:
        return True
    d = next(module.parameters()).device
    return d.type == device.type and device.index in (None, d.index)


class KEEPFaceProcessor:
    """KEEP (and optionally GMFlow) on one device, in one dtype. Without
    GMFlow the flows are zero (the single-image path). face_helper, a
    FaceRestoreHelper with a detector and a parser, serves whole frames; it
    works on the processor's device, and its models keep their dtype, as
    do the upscalers' (bg_upscaler, face_upscaler: bgr_u8 -> bgr_u8).

    The models must already sit on `device` ("cuda" unless the caller asks
    for the CPU); `KEEPModelPack.processor` moves them there. With
    phase512=True (the JAX processor's default, not this one's: on the H100
    the packed chunk is slower, PERF.md), KEEP is prepared for phase-packed
    512-level convolutions on a copy, so the caller's KEEP stays unpacked.
    As in the JAX processor, the weights are packed in their own dtype and
    then cast to `dtype`, so both round a packed bf16 weight alike.

    chunk_batching and chunks_per_dispatch choose how restore_face_stream
    runs a group of full chunks (the JAX processor's KEEP_TPU_BATCH_CHUNKS,
    KEEP_TPU_STAGE_BATCH and KEEP_TPU_CHUNKS_PER_DISPATCH): "map" restores
    them one by one; "batch" runs GMFlow and KEEP.apply once on the group
    (B = group), "stage" GMFlow once and KEEP.apply_chunks. The batched
    forms equal "map" up to summation order, so a code pick can flip."""

    def __init__(self, keep: KEEP, gmflow: Optional[GMFlow] = None, dtype=None,
                 device="cuda", phase512: bool = False,
                 face_helper: Optional[FaceRestoreHelper] = None,
                 bg_upscaler: Optional[Callable] = None,
                 face_upscaler: Optional[Callable] = None,
                 chunk_batching: str = "map", chunks_per_dispatch: int = 8):
        if chunk_batching not in CHUNK_BATCHING:
            raise ValueError(f"chunk_batching must be one of {CHUNK_BATCHING},"
                             f" got {chunk_batching!r}")
        self.chunk_batching = chunk_batching
        self.chunks_per_dispatch = int(chunks_per_dispatch)
        device = torch.device(device)
        if not all(_on(m, device) for m in [keep, gmflow]
                   + helper_models(face_helper)
                   + plugin_models(bg_upscaler, face_upscaler)):
            raise ValueError(f"the models are not on {device}: move them "
                             f"there first (KEEPModelPack.load_device)")
        self.face_helper = face_helper
        self.bg_upscaler, self.face_upscaler = bg_upscaler, face_upscaler
        if face_helper is not None:
            face_helper.device = device
        self.keep = _cast(keep.prepare_phase512() if phase512 else keep,
                          dtype)
        self.gmflow = _cast(gmflow, dtype)
        p = next(self.keep.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.face_size = int(self.keep.cfg.get("img_size", 512))

    def _restore(self, clips: np.ndarray, carry=None,
                 return_carry: bool = False, stage: bool = False):
        """clips (G, T, H, W, 3) RGB in [-1, 1] -> (G, T', H, W, 3) float32:
        GMFlow on the stack's frame pairs, then KEEP.apply (apply_chunks
        with stage=True). With a carry, frame 0 is the previous chunk's last
        input frame and only the flow uses it."""
        x = torch.as_tensor(clips).to(self.device, self.dtype)
        flows = (flow_from_clip(self.gmflow, x)
                 if self.gmflow is not None and x.shape[1] > 1 else None)
        if carry is not None:
            x = x[:, 1:]
        if stage:
            out = self.keep.apply_chunks(x, flows=flows)
        else:
            out = self.keep.apply(x, flows=flows, carry=carry,
                                  return_carry=return_carry)
        if return_carry:
            out, carry = out
        out = out.float().cpu().numpy()
        return (out, carry) if return_carry else out

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
        if return_carry:
            out, carry = self._restore(frames[None], carry, True)
            return out[0], carry
        return self._restore(frames[None])[0]

    def restore_group(self, clips: np.ndarray) -> np.ndarray:
        """G full chunks (G, T, H, W, 3), each from a reset state, in the
        processor's chunk_batching form -> (G, T, H, W, 3) float32."""
        if self.chunk_batching == "map":
            return np.stack([self.restore_clip(c) for c in clips])
        return self._restore(clips, stage=self.chunk_batching == "stage")

    def restore_face_stream(self, faces_bgr_u8: List[np.ndarray],
                            max_clip_length: int = 20,
                            carry_chunks: bool = False) -> List[np.ndarray]:
        """Restore a flat stream of aligned faces (uint8 BGR), chunked.
        carry_chunks=False resets the state per chunk (the reference);
        carry_chunks=True streams the Kalman state and the CFA features
        across chunk boundaries, with no 1-frame duplication.

        Without a carry, a stream of n >= 2 * max_clip_length faces sends
        its full chunks in n_full // group groups of group = min(max(2,
        chunks_per_dispatch), n_full) chunks (the JAX processor's grouped
        dispatch), each group in the chunk_batching form; the full chunks
        left over and the ragged tail go chunk by chunk."""
        if not faces_bgr_u8:
            return []
        x_all = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces_bgr_u8])
        outs: List[np.ndarray] = []
        n = len(x_all)
        if not carry_chunks and n >= 2 * max_clip_length:
            n_full = n // max_clip_length
            group = min(max(2, self.chunks_per_dispatch), n_full)
            head = (n_full // group) * group * max_clip_length
            for start in range(0, head, group * max_clip_length):
                out = self.restore_group(
                    x_all[start:start + group * max_clip_length].reshape(
                        (group, max_clip_length) + x_all.shape[1:]))
                outs.extend(rgb_pm1_to_bgr_u8(o)
                            for o in out.reshape((-1,) + out.shape[2:]))
            x_all = x_all[head:]
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

    # -- host orchestration ---------------------------------------------------

    def _run_bg(self, img_bgr: np.ndarray, factor: float) -> np.ndarray:
        """The background at the final size: the bg upscaler's output (or
        the frame), resized by LANCZOS4 on the processor's device where its
        size differs (processor.py:274-279)."""
        up = (self.bg_upscaler(img_bgr) if self.bg_upscaler is not None
              else img_bgr)
        h, w = img_bgr.shape[:2]
        th, tw = int(h * factor), int(w * factor)
        if up.shape[:2] == (th, tw):
            return up
        t = torch.from_numpy(np.ascontiguousarray(up)).to(self.device)
        return resize(t, (tw, th), "lanczos4").cpu().numpy()

    def _face(self, img_bgr: np.ndarray) -> np.ndarray:
        """The aligned face at the face size (cv2's INTER_LINEAR)."""
        n = self.face_size
        if img_bgr.shape[:2] == (n, n):
            return img_bgr
        return resize(img_bgr, (n, n), "linear")

    def _helper(self) -> FaceRestoreHelper:
        if self.face_helper is None:
            raise RuntimeError("whole frames need a face_helper with a "
                               "detector (api.load_models(detector=...))")
        return self.face_helper

    def process_image(self, img_bgr: np.ndarray,
                      final_upscale_factor: float = 1.0,
                      has_aligned: bool = False,
                      only_center_face: bool = False,
                      draw_box: bool = False) -> np.ndarray:
        """Single-image restore (keep_processor.py:134-194): an aligned face
        (the face upscaler on the restored face, then LANCZOS4 to the final
        size), or a whole frame (detect, align, restore, paste back)."""
        if has_aligned:
            face = self._face(img_bgr)
            restored = self.restore_face_stream([face], max_clip_length=2)[0]
            if is_gray(face, threshold=10):
                restored = bgr2gray(restored)
            if self.face_upscaler is not None:
                restored = self.face_upscaler(restored)
            th = int(self.face_size * final_upscale_factor)
            if restored.shape[0] != th:
                restored = resize(restored, (th, th), "lanczos4")
            return restored

        helper = self._helper()
        bg_final = self._run_bg(img_bgr, final_upscale_factor)
        helper.upscale_factor = final_upscale_factor
        helper.clean_all()
        helper.read_image(img_bgr)
        n = helper.get_face_landmarks_5(only_center_face=only_center_face,
                                        resize=640, eye_dist_threshold=5)
        if n == 0:
            return bg_final
        helper.align_warp_face()
        restored = self.restore_face_stream(list(helper.cropped_faces),
                                            max_clip_length=2)
        helper.restored_faces = restored
        helper.get_inverse_affine()
        return helper.paste_faces_to_input_image(
            upsample_img=bg_final, draw_box=draw_box,
            face_upsampler=self.face_upscaler)

    def _detect_all(self, frames_bgr: List[np.ndarray], only_center_face: bool,
                    progress: Optional[Callable]) -> List[List[np.ndarray]]:
        """Detection over all frames: a clip whose frames share a shape, with
        a detector that has detect_batch, as ONE batch (the reference's
        batched_detect_faces); otherwise frame by frame
        (keep_processor.py:206-214). The same read_image preprocessing,
        resize cap and selection either way."""
        helper = self.face_helper
        det_batch = getattr(helper.detector, "detect_batch", None)
        raw: List[List[np.ndarray]] = []
        if (det_batch is not None and len(frames_bgr) > 1
                and len({f.shape for f in frames_bgr}) == 1):
            prepped = []
            for f in frames_bgr:
                helper.clean_all()
                helper.read_image(f)
                prepped.append(helper.input_img)
            if len({p.shape for p in prepped}) == 1:
                smalls = [helper.resize_for_detection(p, 640) for p in prepped]
                scale_back = smalls[0][1]
                rows_per_frame = det_batch(torch.stack([s for s, _ in smalls]),
                                           conf_threshold=0.97)
                for p, rows in zip(prepped, rows_per_frame):
                    if rows is None or len(rows) == 0:
                        raw.append([])
                    else:
                        lms, _ = helper.select_landmarks_5(
                            np.asarray(rows) * scale_back, p.shape[:2],
                            only_center_face=only_center_face,
                            eye_dist_threshold=5)
                        raw.append(lms)
                    if progress:
                        progress(1)
                return raw
        for f in frames_bgr:
            helper.clean_all()
            helper.read_image(f)
            helper.get_face_landmarks_5(only_center_face=only_center_face,
                                        resize=640, eye_dist_threshold=5)
            raw.append(list(helper.all_landmarks_5))
            if progress:
                progress(1)
        return raw

    def process_image_sequence(self, frames_bgr: List[np.ndarray],
                               final_upscale_factor: float = 1.0,
                               has_aligned_frames: bool = False,
                               only_center_face: bool = False,
                               draw_box: bool = False,
                               max_clip_length: int = 20,
                               carry_chunks: bool = False,
                               progress: Optional[Callable] = None
                               ) -> List[np.ndarray]:
        """The 4-stage sequence restore (keep_processor.py:196-307): detect
        all frames, track and smooth the landmarks, restore the face stream
        in chunks, paste back frame by frame. As in the JAX package and the
        reference, aligned frames come back as the (upscaled) input frames:
        their restored faces are pasted nowhere. `progress(k)` is called as
        work advances (1 a frame detected, 1 cropped, 2 pasted)."""
        n_frames = len(frames_bgr)
        if n_frames == 0:
            return []
        if has_aligned_frames:
            faces = []
            for f in frames_bgr:
                faces.append(self._face(f))
                if progress:
                    progress(1)
            self.restore_face_stream(faces, max_clip_length,
                                     carry_chunks=carry_chunks)
            out = []
            for f in frames_bgr:
                out.append(self._run_bg(f, final_upscale_factor))
                if progress:
                    progress(2)
            return out

        helper = self._helper()
        raw = self._detect_all(frames_bgr, only_center_face, progress)
        smoothed: Dict[int, np.ndarray] = {}
        if only_center_face:
            seq = [lms[0] if lms else np.full((5, 2), np.nan) for lms in raw]
            arr = np.array([lm.reshape(10) for lm in seq])
            for j in range(10):
                arr[:, j] = interpolate_sequence(arr[:, j])
            arr = gaussian_filter1d(arr, sigma=2, axis=0)
            smoothed[0] = arr.reshape(n_frames, 5, 2)
        elif any(raw):
            smoothed = smooth_landmark_tracks(track_faces(raw), n_frames,
                                              sigma=2.0)

        # crop and align every frame's tracked faces
        all_faces: List[np.ndarray] = []
        all_affines: List[np.ndarray] = []
        counts: List[int] = []
        for i in range(n_frames):
            active = [seq[i] for seq in smoothed.values()
                      if not np.isnan(seq[i]).any()]
            if active:
                helper.clean_all()
                helper.read_image(frames_bgr[i])
                helper.all_landmarks_5 = active
                helper.align_warp_face()
                all_faces.extend(helper.cropped_faces)
                all_affines.extend(helper.affine_matrices)
            counts.append(len(active))
            if progress:
                progress(1)

        restored = (self.restore_face_stream(all_faces, max_clip_length,
                                             carry_chunks=carry_chunks)
                    if all_faces else [])

        # paste back, frame by frame, on the frame the affines were solved
        # against (read_image again: its min-side-512 upscale)
        out_frames: List[np.ndarray] = []
        fidx = 0
        for i in range(n_frames):
            bg_final = self._run_bg(frames_bgr[i], final_upscale_factor)
            c = counts[i]
            if c:
                helper.clean_all()
                helper.read_image(frames_bgr[i])
                helper.restored_faces = restored[fidx:fidx + c]
                helper.affine_matrices = all_affines[fidx:fidx + c]
                helper.upscale_factor = final_upscale_factor
                helper.get_inverse_affine()
                bg_final = helper.paste_faces_to_input_image(
                    upsample_img=bg_final, draw_box=draw_box,
                    face_upsampler=self.face_upscaler)
            out_frames.append(bg_final)
            fidx += c
            if progress:
                progress(2)
        return out_frames
