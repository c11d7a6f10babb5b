"""ComfyUI nodes of the port (reference nodes.py:17-149), ported from
comfyui_keep_tpu/nodes.py: KEEP_ModelLoader, KEEP_FaceUpscaleImage and
KEEP_ProcessImageSequence, with the same keys, display names and input
schemas (widget names, defaults, ranges), so saved workflows load
unchanged. Standalone, the node classes work on numpy images (a ComfyUI
IMAGE is (B, H, W, C) float32 RGB in [0, 1]). The execution nodes run on
the card; their `device` keyword (not a widget) asks for another.

As in the JAX package and the reference, the execution nodes trap every
error, print the traceback, return (None,) and always offload the pack;
the loader passes the two optional upscale models through to the pack
(bgr_u8 -> bgr_u8 upscalers) and records the detection model's name.
Given `model_rootpath` (a keyword, not a widget: a directory holding the
reference-named .pth files, facelib/factory.py's MODEL_NAMES), the loader
also builds the named detector and the reference's ParseNet on the host,
as the reference's loader does, so whole frames go through the nodes;
nothing is downloaded. Without it the pack has no detector (as the JAX
node's), and a whole frame fails inside the trap with a message naming
`model_rootpath` and the files it must hold.
"""
import traceback
from typing import Optional

import numpy as np

from comfyui_keep_torch import api
from comfyui_keep_torch.facelib import factory
from comfyui_keep_torch.utils.image import comfy_to_cv2, cv2_to_comfy

# the KEEP variants of the reference's KEEP_MODEL_CONFIGS (modules/utils.py)
KEEP_MODEL_TYPES = ["KEEP", "Asian"]


class KEEP_ModelLoaderNode:
    _MODEL_TYPES = list(KEEP_MODEL_TYPES)

    @classmethod
    def INPUT_TYPES(cls):
        # reference nodes.py:19-31 (same widget names and option lists)
        detection_models = ["retinaface_resnet50", "retinaface_mobile0.25",
                            "YOLOv5l", "YOLOv5n"]
        return {"required": {
            "model": (cls._MODEL_TYPES,
                      {"default": cls._MODEL_TYPES[0] if cls._MODEL_TYPES
                       else "KEEP"}),
            "detection_model": (detection_models,
                                {"default": "retinaface_resnet50"}),
        }, "optional": {
            "bg_upscale_model": ("UPSCALE_MODEL",),
            "face_upscale_model": ("UPSCALE_MODEL",),
        }}

    RETURN_TYPES = ("KEEP_MODEL_PACK",)
    RETURN_NAMES = ("keep_model_pack",)
    FUNCTION = "load_model_pack"
    CATEGORY = "ComfyUI-KEEP"

    def load_model_pack(self, model, detection_model,
                        bg_upscale_model=None, face_upscale_model=None,
                        keep_ckpt: Optional[str] = None,
                        model_rootpath: Optional[str] = None):
        helpers = {}
        if model_rootpath is not None:
            # the reference's loader: the named detector and ParseNet, on
            # the host until the pack moves (a missing file raises
            # FileNotFoundError naming it)
            helpers = {
                "detector": factory.init_detection_model(
                    detection_model, model_rootpath=model_rootpath,
                    device="cpu"),
                "parser": factory.init_parsing_model(
                    "parsenet", model_rootpath=model_rootpath, device="cpu")}
        pack = api.load_models(
            model_type=model, keep_ckpt=keep_ckpt,
            bg_upscaler=bg_upscale_model, face_upscaler=face_upscale_model,
            **helpers)
        pack.detection_model = detection_model
        return (pack,)


def _check_whole_frames(pack, aligned: bool):
    """A whole frame needs the pack's face helper: without one, raise an
    error that says how the loader builds it."""
    if aligned or pack.face_helper is not None:
        return
    det = factory.MODEL_NAMES.get(getattr(pack, "detection_model", None),
                                  factory.MODEL_NAMES["retinaface_resnet50"])
    raise RuntimeError(
        "a whole frame needs a face detector and parser, which this pack "
        "lacks: load it with model_rootpath, a directory holding "
        f"{det} and {factory.MODEL_NAMES['parsenet']} (nothing is "
        "downloaded)")


_UPSCALE_WIDGET = ("FLOAT", {
    "default": 1.0, "min": 0.5, "max": 4.0, "step": 0.1,
    "tooltip": "The final upscaling factor for the output image. The image "
               "will be resized to this scale after processing."})


class KEEP_FaceUpscaleImageNode:
    @classmethod
    def INPUT_TYPES(cls):
        # reference nodes.py:48-58
        return {"required": {
            "image": ("IMAGE",),
            "keep_model": ("KEEP_MODEL_PACK",),
            "final_upscale_factor": _UPSCALE_WIDGET,
            "has_aligned_face": ("BOOLEAN", {
                "default": False, "tooltip": "Check if the input image is an "
                "already aligned 512x512 face."}),
            "only_center_face": ("BOOLEAN", {
                "default": True, "tooltip": "If the image has multiple faces, "
                "only process the one closest to the center."}),
            "draw_bounding_box": ("BOOLEAN", {
                "default": False, "tooltip": "Draw a bounding box around the "
                "detected face on the output image."}),
        }}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "upscale_face_image"
    CATEGORY = "ComfyUI-KEEP"

    def upscale_face_image(self, image, keep_model, final_upscale_factor,
                           has_aligned_face, only_center_face,
                           draw_bounding_box, device="cuda"):
        if not hasattr(keep_model, "load_device"):  # nodes.py:66-68 guard
            print(f"[comfyui_keep_torch] Invalid KEEP model pack: "
                  f"{type(keep_model)}")
            return (None,)
        try:
            _check_whole_frames(keep_model, has_aligned_face)
            keep_model.load_device(device=device)
            # comfy_to_cv2 takes the first image of the batch (nodes.py:72)
            img_bgr = comfy_to_cv2(np.asarray(image))
            out = api.restore_image(
                keep_model, img_bgr, final_upscale_factor,
                has_aligned=has_aligned_face,
                only_center_face=only_center_face, draw_box=draw_bounding_box,
                device=device)
            return (cv2_to_comfy(out),)
        except Exception as e:  # reference nodes.py:84-87
            print(f"[comfyui_keep_torch] Error processing single image: {e}")
            traceback.print_exc()
            return (None,)
        finally:
            keep_model.offload()  # nodes.py:88 lifecycle


class KEEP_ProcessImageSequenceNode:
    @classmethod
    def INPUT_TYPES(cls):
        # reference nodes.py:92-106
        return {"required": {
            "images": ("IMAGE",),
            "keep_model": ("KEEP_MODEL_PACK",),
            "final_upscale_factor": ("FLOAT", {
                "default": 1.0, "min": 0.5, "max": 4.0, "step": 0.1,
                "tooltip": "The final upscaling factor for the output frames. "
                "They will be resized to this scale after processing."}),
            "has_aligned_frames": ("BOOLEAN", {
                "default": False, "tooltip": "Check if the input frames are "
                "already aligned 512x512 faces."}),
            "only_center_face": ("BOOLEAN", {
                "default": True, "tooltip": "If frames have multiple faces, "
                "only process the one closest to the center."}),
            "draw_bounding_box": ("BOOLEAN", {
                "default": False, "tooltip": "Draw a bounding box around the "
                "detected face on the output frames."}),
            "max_clip_length": ("INT", {
                "default": 20, "min": 1, "max": 100, "step": 1,
                "tooltip": "Maximum number of frames to process in a single "
                "batch to manage VRAM."}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("processed_images",)
    FUNCTION = "process_sequence"
    CATEGORY = "ComfyUI-KEEP"

    def process_sequence(self, images, keep_model, final_upscale_factor,
                         has_aligned_frames, only_center_face,
                         draw_bounding_box, max_clip_length, device="cuda"):
        if not hasattr(keep_model, "load_device"):  # nodes.py:117-119 guard
            print(f"[comfyui_keep_torch] Invalid KEEP model pack: "
                  f"{type(keep_model)}")
            return (None,)
        try:
            _check_whole_frames(keep_model, has_aligned_frames)
            keep_model.load_device(device=device)
            frames = [comfy_to_cv2(f) for f in np.asarray(images)]
            outs = api.restore_sequence(
                keep_model, frames, final_upscale_factor,
                has_aligned_frames=has_aligned_frames,
                only_center_face=only_center_face, draw_box=draw_bounding_box,
                max_clip_length=max_clip_length, device=device)
            return (np.concatenate([cv2_to_comfy(f) for f in outs], axis=0),)
        except Exception as e:  # reference nodes.py:131-134
            print(f"[comfyui_keep_torch] Error during image sequence "
                  f"processing: {e}")
            traceback.print_exc()
            return (None,)
        finally:
            keep_model.offload()


NODE_CLASS_MAPPINGS = {
    "KEEP_ModelLoader": KEEP_ModelLoaderNode,
    "KEEP_FaceUpscaleImage": KEEP_FaceUpscaleImageNode,
    "KEEP_ProcessImageSequence": KEEP_ProcessImageSequenceNode,
}
NODE_DISPLAY_NAME_MAPPINGS = {
    "KEEP_ModelLoader": "Load KEEP Models",
    "KEEP_FaceUpscaleImage": "KEEP Single Image",
    "KEEP_ProcessImageSequence": "KEEP Image Sequence",
}
