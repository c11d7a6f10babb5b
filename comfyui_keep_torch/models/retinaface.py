"""RetinaFace face detector (reference wm_facelib/detection/retinaface),
ported from comfyui_keep_tpu/models/retinaface.py: a ResNet50 or
MobileNetV1-0.25 body -> FPN -> SSH -> class / box / landmark heads ->
SSD prior decode -> score filter + NMS.

The network and the prior decode run on the module's device (the priors
cached there per input shape); the score filter, the sort and the NMS run
on the host in numpy over the decoded rows, as in the JAX package. A
detector returns (N, 15) float32 rows [x1, y1, x2, y2, score, 10 landmark
coordinates]. Module names are the reference's (body.*, fpn.output1.0,
ssh1.conv3X3.0, ClassHead.0.conv1x1, ...), so detection_Resnet50_Final.pth
and detection_mobilenet0.25_Final.pth load as they are.
"""
import math
from itertools import product
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.models.resnet import ResNet50Body
from comfyui_keep_torch.ops import (batch_norm, conv2d, leaky_relu, relu,
                                    resize_nearest)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

CFG = {
    "resnet50": dict(min_sizes=[[16, 32], [64, 128], [256, 512]],
                     steps=[8, 16, 32], variance=[0.1, 0.2],
                     in_channel=256, out_channel=256),
    "mobile0.25": dict(min_sizes=[[16, 32], [64, 128], [256, 512]],
                       steps=[8, 16, 32], variance=[0.1, 0.2],
                       in_channel=32, out_channel=64),
}
MEAN_BGR = (104.0, 117.0, 123.0)


# ---------------------------------------------------------------------------
# blocks (retinaface_net.py)
# ---------------------------------------------------------------------------

class ConvBN(nn.Sequential):
    """[conv (no bias), bn(, leaky relu)]: conv_bn / conv_bn1X1 /
    conv_bn_no_relu of the reference; `leaky` None means no activation."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 leaky: Optional[float] = 0.0):
        layers = [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False),
                  nn.BatchNorm2d(cout)]
        if leaky is not None:
            layers.append(nn.LeakyReLU(leaky))
        super().__init__(*layers)
        self.k, self.stride, self.leaky = k, stride, leaky

    def forward(self, x):
        x = batch_norm(conv2d(x, self[0].weight, stride=self.stride,
                              padding=(self.k - 1) // 2), self[1])
        return x if self.leaky is None else leaky_relu(x, self.leaky)


class ConvDW(nn.Sequential):
    """conv_dw: depthwise 3x3, bn, leaky 0.1, pointwise 1x1, bn, leaky 0.1."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(
            nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
            nn.BatchNorm2d(cin), nn.LeakyReLU(0.1),
            nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout),
            nn.LeakyReLU(0.1))
        self.stride = stride

    def forward(self, x):
        x = F.conv2d(x, self[0].weight, stride=self.stride, padding=1,
                     groups=x.shape[1])
        x = leaky_relu(batch_norm(x, self[1]), 0.1)
        x = conv2d(x, self[3].weight)
        return leaky_relu(batch_norm(x, self[4]), 0.1)


class MobileNetV1Body(nn.Module):
    """MobileNetV1 x0.25 up to stage3 (the body IntermediateLayerGetter
    keeps); returns the three stages' outputs."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            ConvBN(3, 8, stride=2, leaky=0.1), ConvDW(8, 16, 1),
            ConvDW(16, 32, 2), ConvDW(32, 32, 1), ConvDW(32, 64, 2),
            ConvDW(64, 64, 1))
        self.stage2 = nn.Sequential(ConvDW(64, 128, 2),
                                    *[ConvDW(128, 128, 1) for _ in range(5)])
        self.stage3 = nn.Sequential(ConvDW(128, 256, 2), ConvDW(256, 256, 1))

    def forward(self, x) -> Tuple:
        outs = []
        for stage in (self.stage1, self.stage2, self.stage3):
            x = stage(x)
            outs.append(x)
        return tuple(outs)


class SSH(nn.Module):
    def __init__(self, cin: int, cout: int, leaky: float):
        super().__init__()
        self.conv3X3 = ConvBN(cin, cout // 2, leaky=None)
        self.conv5X5_1 = ConvBN(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = ConvBN(cout // 4, cout // 4, leaky=None)
        self.conv7X7_2 = ConvBN(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = ConvBN(cout // 4, cout // 4, leaky=None)

    def forward(self, x):
        c3 = self.conv3X3(x)
        c51 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c51)
        c7 = self.conv7x7_3(self.conv7X7_2(c51))
        return relu(torch.cat([c3, c5, c7], dim=1))


class FPN(nn.Module):
    def __init__(self, cins: List[int], cout: int, leaky: float):
        super().__init__()
        self.output1 = ConvBN(cins[0], cout, k=1, leaky=leaky)
        self.output2 = ConvBN(cins[1], cout, k=1, leaky=leaky)
        self.output3 = ConvBN(cins[2], cout, k=1, leaky=leaky)
        self.merge1 = ConvBN(cout, cout, leaky=leaky)
        self.merge2 = ConvBN(cout, cout, leaky=leaky)

    def forward(self, feats):
        o1 = self.output1(feats[0])
        o2 = self.output2(feats[1])
        o3 = self.output3(feats[2])
        o2 = self.merge2(o2 + resize_nearest(o3, o2.shape[-2:]))
        o1 = self.merge1(o1 + resize_nearest(o2, o1.shape[-2:]))
        return o1, o2, o3


class Head(nn.Module):
    """ClassHead / BboxHead / LandmarkHead: a 1x1 conv, (B, H*W*2, n)."""

    def __init__(self, cin: int, n_out: int, num_anchors: int = 2):
        super().__init__()
        self.n_out = n_out
        self.conv1x1 = nn.Conv2d(cin, num_anchors * n_out, 1)

    def forward(self, x):
        out = conv2d(x, self.conv1x1.weight, self.conv1x1.bias)
        return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1, self.n_out)


@ARCH_REGISTRY.register()
class RetinaFace(nn.Module):
    def __init__(self, network: str = "resnet50", device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = CFG[network]
        self.network, self.cfg = network, cfg
        leaky = 0.1 if cfg["out_channel"] <= 64 else 0.0
        cins = [cfg["in_channel"] * m for m in (2, 4, 8)]
        cout = cfg["out_channel"]
        self.body = (ResNet50Body() if network == "resnet50"
                     else MobileNetV1Body())
        self.fpn = FPN(cins, cout, leaky)
        self.ssh1 = SSH(cout, cout, leaky)
        self.ssh2 = SSH(cout, cout, leaky)
        self.ssh3 = SSH(cout, cout, leaky)
        self.ClassHead = nn.ModuleList([Head(cout, 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([Head(cout, 4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([Head(cout, 10) for _ in range(3)])
        self._priors: Dict[Tuple, torch.Tensor] = {}
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x):
        """x: (B, 3, H, W) BGR minus MEAN_BGR. Returns (box offsets, softmax
        class scores, landmark offsets) over all priors."""
        f1, f2, f3 = self.fpn(self.body(x))
        feats = (self.ssh1(f1), self.ssh2(f2), self.ssh3(f3))
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], 1)
        conf = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], 1)
        landms = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], 1)
        return loc, F.softmax(conf, dim=-1), landms

    def priors(self, h: int, w: int) -> torch.Tensor:
        """prior_box for an (h, w) input, cached on the module's device."""
        dev = next(self.parameters()).device
        key = (h, w, str(dev))
        if key not in self._priors:
            self._priors[key] = torch.as_tensor(prior_box(self.cfg, (h, w)),
                                                device=dev)
        return self._priors[key]

    def prepare(self, frames_bgr_u8) -> torch.Tensor:
        """(n, h, w, 3) uint8 BGR frames (numpy or a tensor) -> the network's
        input on the module's device: (n, 3, h, w), minus MEAN_BGR, in the
        module's dtype."""
        p = next(self.parameters())
        x = frames_bgr_u8
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(p.device)
        mean = torch.tensor(MEAN_BGR, dtype=torch.float32, device=p.device)
        return (x.to(torch.float32) - mean).permute(0, 3, 1, 2).to(p.dtype)

    def decoded(self, frames_bgr_u8) -> Tuple[torch.Tensor, ...]:
        """(n, h, w, 3) uint8 BGR frames (numpy or a tensor) -> boxes
        (n, P, 4), face scores (n, P) and landmarks (n, P, 10), decoded on
        the module's device, in [0, 1] units of the frame, float32."""
        x = self.prepare(frames_bgr_u8)
        loc, conf, landms = self(x)
        priors = self.priors(x.shape[2], x.shape[3])
        var = self.cfg["variance"]
        return (decode_boxes(loc.float(), priors, var), conf[..., 1].float(),
                decode_landms(landms.float(), priors, var))


# ---------------------------------------------------------------------------
# priors, decode and NMS (retinaface_utils.py)
# ---------------------------------------------------------------------------

def prior_box(cfg: Dict, image_size: Tuple[int, int]) -> np.ndarray:
    anchors = []
    feature_maps = [(math.ceil(image_size[0] / s),
                     math.ceil(image_size[1] / s)) for s in cfg["steps"]]
    for k, f in enumerate(feature_maps):
        for i, j in product(range(f[0]), range(f[1])):
            for min_size in cfg["min_sizes"][k]:
                s_kx = min_size / image_size[1]
                s_ky = min_size / image_size[0]
                cx = (j + 0.5) * cfg["steps"][k] / image_size[1]
                cy = (i + 0.5) * cfg["steps"][k] / image_size[0]
                anchors.append([cx, cy, s_kx, s_ky])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc, priors, variances):
    """(..., P, 4) offsets -> [x1, y1, x2, y2] in units of the frame."""
    centers = priors[:, :2] + loc[..., :2] * variances[0] * priors[:, 2:]
    sizes = priors[:, 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = centers - sizes / 2
    return torch.cat([mins, mins + sizes], dim=-1)


def decode_landms(pre, priors, variances):
    """(..., P, 10) offsets -> 5 landmark points in units of the frame."""
    parts = [priors[:, :2] + pre[..., 2 * i:2 * i + 2] * variances[0]
             * priors[:, 2:] for i in range(5)]
    return torch.cat(parts, dim=-1)


def score_order(scores: np.ndarray) -> np.ndarray:
    """Indices of `scores` from the highest down, equal scores in index
    order: a stable sort keyed on (-score, index), so equal inputs order
    alike whatever the sort's algorithm (numpy's argsort is unstable)."""
    return np.lexsort((np.arange(len(scores)), -scores))


def nms_numpy(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy IoU NMS (torchvision.ops.nms semantics) on the host, the
    boxes taken in score_order."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1) * (y2 - y1)
    order = score_order(scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep


def filter_sort_nms(boxes, scores, landms, conf_threshold, nms_threshold):
    """Score filter -> sort (score_order) -> NMS -> (n, 15) float32 rows."""
    inds = scores > conf_threshold
    boxes, landms, scores = boxes[inds], landms[inds], scores[inds]
    order = score_order(scores)
    boxes, landms, scores = boxes[order], landms[order], scores[order]
    dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    keep = nms_numpy(dets, nms_threshold)
    return np.concatenate([dets[keep], landms[keep]],
                          axis=1).astype(np.float32)


def make_detector_fn(model: RetinaFace, nms_threshold: float = 0.4):
    """detector(img_bgr_u8 (h, w, 3), conf_threshold=0.8) -> (N, 15) numpy,
    the FaceRestoreHelper plug-in, running `model` on its device; the
    whole-clip form detector.detect_batch(frames (n, h, w, 3),
    conf_threshold) -> [(N_i, 15)] runs the clip as one batch. The module
    is detector.model (KEEPModelPack moves it with the pack)."""

    def rows(frames, conf_threshold):
        """frames: (n, h, w, 3) uint8, numpy or a tensor."""
        h, w = frames.shape[1:3]
        with torch.no_grad():
            boxes, scores, landms = model.decoded(frames)
        scale = np.array([w, h, w, h], np.float32)
        scale1 = np.array([w, h] * 5, np.float32)
        boxes = boxes.cpu().numpy() * scale
        landms = landms.cpu().numpy() * scale1
        scores = scores.cpu().numpy()
        return [filter_sort_nms(b, s, l, conf_threshold, nms_threshold)
                for b, s, l in zip(boxes, scores, landms)]

    def detector(img_bgr_u8, conf_threshold: float = 0.8) -> np.ndarray:
        return rows(img_bgr_u8[None], conf_threshold)[0]

    def detect_batch(frames_bgr_u8, conf_threshold: float = 0.8):
        return rows(frames_bgr_u8, conf_threshold)

    detector.detect_batch = detect_batch
    detector.model = model
    return detector


def align_multi(detector, img_bgr_u8: np.ndarray, conf_threshold: float = 0.8,
                limit: Optional[int] = None, device="cuda"):
    """Detect, then warp each face to the 112 x 112 ArcFace template
    (retinaface.py:254-279: detect_faces, then warp_and_crop_face on each
    with the default_square reference points) on `device`. Returns ((n, 15)
    rows, the faces as numpy)."""
    from comfyui_keep_torch.facelib.align_trans import (
        get_reference_facial_points, warp_and_crop_face)
    rows = detector(img_bgr_u8, conf_threshold)
    if rows is None or len(rows) == 0:
        return np.zeros((0, 15), np.float32), []
    rows = np.asarray(rows)
    if limit:
        rows = rows[:limit]
    reference = get_reference_facial_points(default_square=True)
    faces = [warp_and_crop_face(np.array(img_bgr_u8), row[5:].reshape(5, 2),
                                reference, crop_size=(112, 112),
                                device=device) for row in rows]
    return rows, faces
