"""User-facing API of the port (reference model loader and nodes), ported
from comfyui_keep_tpu/api.py.

    pack = load_models(seed=0, detector=init_detection_model(
        "retinaface_resnet50", require_weights=False),
        parser=init_parsing_model("parsenet", require_weights=False))
    out = restore_image(pack, frame_bgr, final_upscale_factor=2)
    frames = restore_sequence(pack, frames_bgr, dtype=torch.bfloat16)

`load_models` builds KEEP and GMFlow on the host (random weights from a
seed, or a reference .pth) and, given a detector or a parser (facelib/
factory.py), a FaceRestoreHelper for whole frames; the optional
bg_upscaler and face_upscaler (bgr_u8 -> bgr_u8, e.g. pipeline/tiled.py's
make_upscaler_fn over models/sr_basic.py or models/swinir.py) ride in the
pack to the processor and the paste-back. `load_device` moves the models
to the card (the CPU only when asked), the detector's, parser's and
upscalers' in their own dtype, and `offload` back to the host. The JAX
package's keyed model cache is not kept: each call builds its pack. `processor` runs on the
card unless the caller asks for the CPU, and moves the pack there if
needed; its KEEP runs the 512 level phase-packed only when asked
`phase512=True`, and sends a long stream's full chunks in the form
`chunk_batching` asks for ("map", "batch" or "stage").
"""
from typing import Callable, Optional

import torch

from comfyui_keep_torch.facelib.helper import FaceRestoreHelper
from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.pipeline.processor import (KEEPFaceProcessor,
                                                   helper_models,
                                                   plugin_models)
from comfyui_keep_torch.utils.convert import read_pth, split_keep_checkpoint


class KEEPModelPack:
    def __init__(self, keep: KEEP, gmflow: Optional[GMFlow] = None,
                 face_helper: Optional[FaceRestoreHelper] = None,
                 bg_upscaler: Optional[Callable] = None,
                 face_upscaler: Optional[Callable] = None,
                 model_type: str = "KEEP"):
        self.keep = keep
        self.gmflow = gmflow
        self.face_helper = face_helper
        self.bg_upscaler = bg_upscaler
        self.face_upscaler = face_upscaler
        self.model_type = model_type

    def _models(self):
        return [m for m in (self.keep, self.gmflow) if m is not None]

    def _plugin_models(self):
        return helper_models(self.face_helper) + plugin_models(
            self.bg_upscaler, self.face_upscaler)

    def models(self):
        """Every module of the pack: KEEP, GMFlow, the detector's, the
        parser's, the upscalers'."""
        return self._models() + self._plugin_models()

    def load_device(self, dtype: Optional[torch.dtype] = None,
                    device="cuda") -> "KEEPModelPack":
        """Move the models (in place) to `device`; KEEP and GMFlow cast to
        `dtype` if given, the detector, parser and upscalers in their own
        dtype."""
        for m in self._models():
            m.to(device=device, dtype=dtype)
        for m in self._plugin_models():
            m.to(device=device)
        if self.face_helper is not None:
            self.face_helper.device = torch.device(device)
        return self

    def offload(self) -> "KEEPModelPack":
        return self.load_device(device="cpu")

    def processor(self, dtype: Optional[torch.dtype] = None,
                  device="cuda", phase512: bool = False,
                  chunk_batching: str = "map",
                  chunks_per_dispatch: int = 8) -> KEEPFaceProcessor:
        """A processor on `device` in `dtype`; moves the pack to `device`
        first (in place, as load_device) when a model sits elsewhere.
        phase512, chunk_batching and chunks_per_dispatch as for
        KEEPFaceProcessor: the pack's own KEEP stays unpacked."""
        device = torch.device(device)
        if any(next(m.parameters()).device.type != device.type
               for m in self.models()):
            self.load_device(device=device)
        return KEEPFaceProcessor(self.keep, self.gmflow, dtype=dtype,
                                 device=device, phase512=phase512,
                                 face_helper=self.face_helper,
                                 bg_upscaler=self.bg_upscaler,
                                 face_upscaler=self.face_upscaler,
                                 chunk_batching=chunk_batching,
                                 chunks_per_dispatch=chunks_per_dispatch)


def load_models(model_type: str = "KEEP", keep_ckpt: Optional[str] = None,
                detector: Optional[Callable] = None,
                parser: Optional[Callable] = None,
                bg_upscaler: Optional[Callable] = None,
                face_upscaler: Optional[Callable] = None, seed: int = 0,
                cfg_overrides: Optional[dict] = None) -> KEEPModelPack:
    """Build a model pack on the host. With keep_ckpt: load the reference
    .pth (the flow net's weights ride in the same file). Without: random
    weights from `seed` (GMFlow from seed + 1). A detector or parser (left
    on its device until the pack moves) gives the pack a FaceRestoreHelper
    at KEEP's face size, with the parse mask on when there is a parser.
    bg_upscaler upscales each frame's background, face_upscaler each
    restored face before its paste-back (JAX api.py:28-35, 66-82)."""
    overrides = cfg_overrides or {}
    if keep_ckpt is not None:
        keep_sd, flow_sd = split_keep_checkpoint(read_pth(keep_ckpt))
        keep = KEEP(model_type, device="cpu", **overrides)
        keep.load_state_dict(keep_sd)
        gmflow = None
        if flow_sd:
            gmflow = GMFlow(device="cpu")
            gmflow.load_state_dict(flow_sd)
    else:
        keep = KEEP(model_type, device="cpu",
                    generator=torch.Generator().manual_seed(seed), **overrides)
        gmflow = GMFlow(device="cpu",
                        generator=torch.Generator().manual_seed(seed + 1))
    face_helper = None
    if detector is not None or parser is not None:
        face_helper = FaceRestoreHelper(
            upscale_factor=1, face_size=keep.cfg["img_size"],
            detector=detector, parser=parser, use_parse=parser is not None,
            device="cpu")
    return KEEPModelPack(keep, gmflow, face_helper, bg_upscaler,
                         face_upscaler, model_type)


def restore_image(pack: KEEPModelPack, img_bgr, final_upscale_factor=1.0,
                  has_aligned: bool = False, only_center_face: bool = False,
                  draw_box: bool = False, dtype=None, device="cuda"):
    """KEEP Single Image node: an aligned face, or a whole frame."""
    return pack.processor(dtype, device).process_image(
        img_bgr, final_upscale_factor, has_aligned, only_center_face,
        draw_box)


def restore_sequence(pack: KEEPModelPack, frames_bgr,
                     final_upscale_factor: float = 1.0,
                     has_aligned_frames: bool = False,
                     only_center_face: bool = False, draw_box: bool = False,
                     max_clip_length: int = 20, carry_chunks: bool = False,
                     dtype=None, device="cuda"):
    """KEEP Image Sequence node (aligned frames, or whole ones).
    carry_chunks=True streams the recurrent state across max_clip_length
    chunks (the JAX package's extension) instead of the reference's
    per-chunk reset."""
    return pack.processor(dtype, device).process_image_sequence(
        frames_bgr, final_upscale_factor, has_aligned_frames,
        only_center_face, draw_box, max_clip_length,
        carry_chunks=carry_chunks)
