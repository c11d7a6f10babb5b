"""User-facing API of the port (reference model loader and nodes), ported
from comfyui_keep_tpu/api.py for aligned faces.

    pack = load_models(seed=0).load_device(torch.bfloat16)
    faces = pack.processor(torch.bfloat16).restore_face_stream(faces_bgr)

`load_models` builds the models on the host (random weights from a seed,
or a reference .pth); `load_device` moves them to the card (the CPU only
when asked) and `offload` back to the host. `processor` runs on the card
unless the caller asks for the CPU, and moves the pack there if needed.
"""
from typing import Optional

import torch

from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
from comfyui_keep_torch.utils.convert import read_pth, split_keep_checkpoint


class KEEPModelPack:
    def __init__(self, keep: KEEP, gmflow: Optional[GMFlow] = None):
        self.keep = keep
        self.gmflow = gmflow

    def _models(self):
        return [m for m in (self.keep, self.gmflow) if m is not None]

    def load_device(self, dtype: Optional[torch.dtype] = None,
                    device="cuda") -> "KEEPModelPack":
        """Move the models (in place) to `device`, cast to `dtype` if given."""
        for m in self._models():
            m.to(device=device, dtype=dtype)
        return self

    def offload(self) -> "KEEPModelPack":
        for m in self._models():
            m.to("cpu")
        return self

    def processor(self, dtype: Optional[torch.dtype] = None,
                  device="cuda") -> KEEPFaceProcessor:
        """A processor on `device` in `dtype`; moves the pack to `device`
        first (in place, as load_device) when it sits elsewhere."""
        device = torch.device(device)
        if next(self.keep.parameters()).device.type != device.type:
            self.load_device(device=device)
        return KEEPFaceProcessor(self.keep, self.gmflow, dtype=dtype,
                                 device=device)


def load_models(model_type: str = "KEEP", keep_ckpt: Optional[str] = None,
                seed: int = 0, cfg_overrides: Optional[dict] = None
                ) -> KEEPModelPack:
    """Build a model pack on the host. With keep_ckpt: load the reference
    .pth (the flow net's weights ride in the same file). Without: random
    weights from `seed` (GMFlow from seed + 1)."""
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
    return KEEPModelPack(keep, gmflow)


def restore_image(pack: KEEPModelPack, img_bgr, final_upscale_factor=1.0,
                  has_aligned: bool = False, dtype=None, device="cuda"):
    """KEEP Single Image node (aligned faces)."""
    return pack.processor(dtype, device).process_image(
        img_bgr, final_upscale_factor, has_aligned)


def restore_sequence(pack: KEEPModelPack, frames_bgr,
                     final_upscale_factor: float = 1.0,
                     has_aligned_frames: bool = False,
                     max_clip_length: int = 20, dtype=None, device="cuda"):
    """KEEP Image Sequence node (aligned frames)."""
    return pack.processor(dtype, device).process_image_sequence(
        frames_bgr, final_upscale_factor, has_aligned_frames, max_clip_length)
