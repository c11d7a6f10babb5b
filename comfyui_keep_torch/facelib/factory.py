"""Detection / parsing model factories (reference wm_facelib/detection and
parsing __init__.py), ported from comfyui_keep_tpu/facelib/factory.py.

    detector = init_detection_model("retinaface_resnet50",
                                    model_rootpath="/models/facedetection")
    parser = init_parsing_model("parsenet", require_weights=False, seed=0)

The detectors are RetinaFace (ResNet50, MobileNet-0.25) and YOLOv5-face
(YOLOv5l, YOLOv5n), the parsers ParseNet and BiSeNet (which the JAX package
wires too). Each returns the FaceRestoreHelper plug-in
(models/retinaface.py's make_detector_fn, facelib/yolov5face.py's
make_yolo_detector_fn, models/parsenet.py's and models/bisenet.py's
make_parser_fn), whose module is `.model`, built on `device` ("cuda" unless
the caller asks for the CPU). With `model_rootpath` the reference's .pth
is read from there (the port never downloads); without one,
`require_weights=False` gives random weights from `seed`. `half=True`
casts to bfloat16, as the JAX package does.
"""
import os
from typing import Callable, Optional

import torch

from comfyui_keep_torch.utils.convert import read_pth

# cli-name -> checkpoint filename (detection/__init__.py:25-30)
MODEL_NAMES = {
    "retinaface_resnet50": "detection_Resnet50_Final.pth",
    "retinaface_mobile0.25": "detection_mobilenet0.25_Final.pth",
    "YOLOv5n": "yolov5n-face.pth",
    "YOLOv5l": "yolov5l-face.pth",
    "parsenet": "parsing_parsenet.pth",
    "bisenet": "parsing_bisenet.pth",
}
# reference buffers the port computes instead of storing: YOLO's anchors,
# SwinIR's window tables
DROPPED = ("anchors", "anchor_grid", "relative_position_index", "attn_mask")


def _checkpoint(model_name: str, model_rootpath: Optional[str],
                require_weights: bool) -> Optional[str]:
    if model_name not in MODEL_NAMES:
        raise NotImplementedError(f"{model_name} is not implemented.")
    if model_rootpath is not None:
        path = os.path.join(model_rootpath, MODEL_NAMES[model_name])
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return path
    if require_weights:
        raise ValueError(
            f"{model_name!r}: no model_rootpath given; pass "
            "require_weights=False for random weights")
    return None


def load_reference(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference .pth into a port module: a detector's, a parser's or
    an upscaler's (a `state_dict`, `params_ema` or `params` wrapper
    unwrapped, `module.` stripped, the buffers named in DROPPED left out);
    a BatchNorm's num_batches_tracked may be absent."""
    sd = read_pth(path, prefer=("state_dict", "params_ema", "params"))
    sd = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] not in DROPPED}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{path}: missing {missing[:8]}, unexpected "
                         f"{unexpected[:8]}")
    return model


def _build(model: torch.nn.Module, ckpt: Optional[str], half: bool):
    if ckpt is not None:
        load_reference(model, ckpt)
    return model.to(torch.bfloat16) if half else model


def init_detection_model(model_name: str, half: bool = False,
                         model_rootpath: Optional[str] = None,
                         require_weights: bool = True, seed: int = 0,
                         device="cuda") -> Callable:
    """A face detector by name (detection/__init__.py:32-89)."""
    from comfyui_keep_torch.facelib.yolov5face import (YoloFace,
                                                       make_yolo_detector_fn)
    from comfyui_keep_torch.models.retinaface import (RetinaFace,
                                                      make_detector_fn)
    ckpt = _checkpoint(model_name, model_rootpath, require_weights)
    gen = None if ckpt else torch.Generator().manual_seed(seed)
    if model_name.startswith("retinaface_"):
        model = RetinaFace(model_name.split("_", 1)[1], device=device,
                           generator=gen)
        return make_detector_fn(_build(model, ckpt, half))
    if model_name in ("YOLOv5l", "YOLOv5n"):
        model = YoloFace(model_name.lower(), device=device, generator=gen)
        return make_yolo_detector_fn(_build(model, ckpt, half))
    raise NotImplementedError(f"{model_name} is not a detector.")


def init_parsing_model(model_name: str = "parsenet", half: bool = False,
                       model_rootpath: Optional[str] = None,
                       require_weights: bool = True, seed: int = 0,
                       device="cuda") -> Callable:
    """A face parser by name (parsing/__init__.py:22-51, and BiSeNet, which
    the JAX package wires too)."""
    from comfyui_keep_torch.models import bisenet, parsenet
    ckpt = _checkpoint(model_name, model_rootpath, require_weights)
    gen = None if ckpt else torch.Generator().manual_seed(seed)
    if model_name == "parsenet":
        model = parsenet.ParseNet(device=device, generator=gen)
        return parsenet.make_parser_fn(_build(model, ckpt, half))
    if model_name == "bisenet":
        model = bisenet.BiSeNet(device=device, generator=gen)
        return bisenet.make_parser_fn(_build(model, ckpt, half))
    raise NotImplementedError(f"{model_name} is not a parser.")
