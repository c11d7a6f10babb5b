"""YOLOv5-face detector (reference wm_facelib/detection/yolov5face), ported
from comfyui_keep_tpu/facelib/yolov5face.py: the YOLOv5n (StemBlock,
ShuffleV2 blocks) and YOLOv5l (C3, SPP) backbones and heads built from the
same specs, a Detect head with 16 outputs an anchor (box 4, objectness 1,
10 landmark coordinates, class 1) at strides 8 / 16 / 32, the letterbox
without OpenCV, and the face NMS.

NCHW. The network and the decode run on the module's device; the NMS on
the host in numpy, as in the JAX package. Module names are the
reference's (model.{i}.conv.weight, model.{i}.{j}.branch2.0.weight for a
repeated block, model.{i}.m.{j} for the Detect convolutions), so
yolov5{n,l}-face.pth loads once its `anchors` / `anchor_grid` buffers are
dropped. A detector returns (N, 15) float32 rows [x1, y1, x2, y2, score,
10 landmark coordinates] in the frame's pixels.
"""
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.models.retinaface import nms_numpy
from comfyui_keep_torch.ops import (batch_norm, conv2d, max_pool, swish,
                                    upsample_nearest_2x)
from comfyui_keep_torch.utils import cvops
from comfyui_keep_torch.utils.resize import resize
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

ANCHORS = [[4, 5, 8, 10, 13, 16], [23, 29, 43, 55, 73, 105],
           [146, 217, 231, 300, 335, 433]]

# [from, number, module, args]: models/yolov5n.yaml and yolov5l.yaml
YOLOV5N_SPEC = {
    "nc": 1, "anchors": ANCHORS,
    "layers": [
        (-1, 1, "StemBlock", [32, 3, 2]),
        (-1, 1, "ShuffleV2Block", [128, 2]),
        (-1, 3, "ShuffleV2Block", [128, 1]),
        (-1, 1, "ShuffleV2Block", [256, 2]),
        (-1, 7, "ShuffleV2Block", [256, 1]),
        (-1, 1, "ShuffleV2Block", [512, 2]),
        (-1, 3, "ShuffleV2Block", [512, 1]),
        (-1, 1, "Conv", [128, 1, 1]),
        (-1, 1, "Upsample", [2]),
        ([-1, 4], 1, "Concat", []),
        (-1, 1, "C3", [128, False]),
        (-1, 1, "Conv", [128, 1, 1]),
        (-1, 1, "Upsample", [2]),
        ([-1, 2], 1, "Concat", []),
        (-1, 1, "C3", [128, False]),
        (-1, 1, "Conv", [128, 3, 2]),
        ([-1, 11], 1, "Concat", []),
        (-1, 1, "C3", [128, False]),
        (-1, 1, "Conv", [128, 3, 2]),
        ([-1, 7], 1, "Concat", []),
        (-1, 1, "C3", [128, False]),
        ([14, 17, 20], 1, "Detect", []),
    ],
}

YOLOV5L_SPEC = {
    "nc": 1, "anchors": ANCHORS,
    "layers": [
        (-1, 1, "StemBlock", [64, 3, 2]),
        (-1, 3, "C3", [128]),
        (-1, 1, "Conv", [256, 3, 2]),
        (-1, 9, "C3", [256]),
        (-1, 1, "Conv", [512, 3, 2]),
        (-1, 9, "C3", [512]),
        (-1, 1, "Conv", [1024, 3, 2]),
        (-1, 1, "SPP", [1024, [3, 5, 7]]),
        (-1, 3, "C3", [1024, False]),
        (-1, 1, "Conv", [512, 1, 1]),
        (-1, 1, "Upsample", [2]),
        ([-1, 5], 1, "Concat", []),
        (-1, 3, "C3", [512, False]),
        (-1, 1, "Conv", [256, 1, 1]),
        (-1, 1, "Upsample", [2]),
        ([-1, 3], 1, "Concat", []),
        (-1, 3, "C3", [256, False]),
        (-1, 1, "Conv", [256, 3, 2]),
        ([-1, 13], 1, "Concat", []),
        (-1, 3, "C3", [512, False]),
        (-1, 1, "Conv", [512, 3, 2]),
        ([-1, 9], 1, "Concat", []),
        (-1, 3, "C3", [1024, False]),
        ([16, 19, 22], 1, "Detect", []),
    ],
}
SPECS = {"yolov5n": YOLOV5N_SPEC, "yolov5l": YOLOV5L_SPEC}
STRIDES = (8, 16, 32)


# -- blocks -------------------------------------------------------------------

class Conv(nn.Module):
    """conv (no bias) -> bn -> SiLU, padding k // 2."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.k, self.s = k, s
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2)

    def forward(self, x):
        x = conv2d(x, self.conv.weight, stride=self.s, padding=self.k // 2)
        return swish(batch_norm(x, self.bn))


class StemBlock(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.stem_1 = Conv(c1, c2, k, s)
        self.stem_2a = Conv(c2, c2 // 2, 1, 1)
        self.stem_2b = Conv(c2 // 2, c2, 3, 2)
        self.stem_3 = Conv(c2 * 2, c2, 1, 1)

    def forward(self, x):
        s1 = self.stem_1(x)
        s2 = self.stem_2b(self.stem_2a(s1))
        # MaxPool2d(2, 2, ceil_mode=True): an odd edge pools alone
        sp = F.max_pool2d(s1, 2, 2, ceil_mode=True)
        return self.stem_3(torch.cat([s2, sp], 1))


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1)
        self.cv2 = Conv(c2, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        out = self.cv2(self.cv1(x))
        return x + out if self.add else out


class C3(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut)
                                 for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    def __init__(self, c1: int, c2: int, k=(3, 5, 7)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1)

    def forward(self, x):
        x = self.cv1(x)
        pools = [x] + [max_pool(x, k, 1, k // 2) for k in self.k]
        return self.cv2(torch.cat(pools, 1))


def channel_shuffle(x, groups: int = 2):
    """(B, C, H, W): channel j of group i goes to j * groups + i."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


class ShuffleV2Block(nn.Module):
    def __init__(self, c1: int, c2: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = c2 // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2d(c1, c1, 3, stride, 1, groups=c1, bias=False),
                nn.BatchNorm2d(c1), nn.Conv2d(c1, bf, 1, bias=False),
                nn.BatchNorm2d(bf), nn.SiLU())
        cin = c1 if stride > 1 else bf
        self.branch2 = nn.Sequential(
            nn.Conv2d(cin, bf, 1, bias=False), nn.BatchNorm2d(bf), nn.SiLU(),
            nn.Conv2d(bf, bf, 3, stride, 1, groups=bf, bias=False),
            nn.BatchNorm2d(bf), nn.Conv2d(bf, bf, 1, bias=False),
            nn.BatchNorm2d(bf), nn.SiLU())

    def _branch2(self, z):
        b = self.branch2
        z = swish(batch_norm(conv2d(z, b[0].weight), b[1]))
        z = F.conv2d(z, b[3].weight, stride=self.stride, padding=1,
                     groups=z.shape[1])
        z = batch_norm(z, b[4])
        return swish(batch_norm(conv2d(z, b[5].weight), b[6]))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = torch.cat([x[:, :c], self._branch2(x[:, c:])], 1)
        else:
            b = self.branch1
            b1 = F.conv2d(x, b[0].weight, stride=self.stride, padding=1,
                          groups=x.shape[1])
            b1 = batch_norm(b1, b[1])
            b1 = swish(batch_norm(conv2d(b1, b[2].weight), b[3]))
            out = torch.cat([b1, self._branch2(x)], 1)
        return channel_shuffle(out, 2)


class NoParams(nn.Module):
    """Upsample / Concat: a place in model.{i} with no weights."""


class Detect(nn.Module):
    def __init__(self, chs: List[int], no: int, na: int):
        super().__init__()
        self.no, self.na = no, na
        self.m = nn.ModuleList([nn.Conv2d(c, no * na, 1) for c in chs])

    def forward(self, feats):
        """Decoded predictions (B, sum of na * ny * nx, no): xy and wh in
        the input's pixels, objectness, 10 landmark coordinates (no
        sigmoid), class; anchors in pixels."""
        outs = []
        for li, (feat, conv) in enumerate(zip(feats, self.m)):
            out = conv2d(feat, conv.weight, conv.bias)
            b, _, ny, nx = out.shape
            out = out.view(b, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2)
            gy, gx = torch.meshgrid(
                torch.arange(ny, dtype=out.dtype, device=out.device),
                torch.arange(nx, dtype=out.dtype, device=out.device),
                indexing="ij")
            grid = torch.stack([gx, gy], -1)                 # (ny, nx, 2)
            stride = STRIDES[li]
            anc = torch.tensor(ANCHORS[li], dtype=out.dtype,
                               device=out.device).view(1, self.na, 1, 1, 2)
            sig = torch.sigmoid(out[..., :5])
            xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * stride
            wh = (sig[..., 2:4] * 2) ** 2 * anc
            obj = sig[..., 4:5]
            lmk = out[..., 5:15].reshape(b, self.na, ny, nx, 5, 2)
            lmk = lmk * anc[:, :, :, :, None] + grid[None, None, :, :, None] \
                * stride
            lmk = lmk.reshape(b, self.na, ny, nx, 10)
            cls = torch.sigmoid(out[..., 15:])
            dec = torch.cat([xy, wh, obj, lmk, cls], -1)
            outs.append(dec.reshape(b, -1, self.no))
        return torch.cat(outs, 1)


@ARCH_REGISTRY.register()
class YoloFace(nn.Module):
    def __init__(self, config: str = "yolov5n", device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec = SPECS[config]
        self.config, self.spec = config, spec
        no = spec["nc"] + 5 + 10
        na = len(spec["anchors"][0]) // 2
        layers, ch = [], [3]
        for frm, n, mod, args in spec["layers"]:
            cin = ch[frm if isinstance(frm, int) else frm[0]]
            cout = args[0] if args else cin
            if mod == "StemBlock":
                layer = StemBlock(cin, args[0], args[1], args[2])
            elif mod == "ShuffleV2Block":
                blocks = [ShuffleV2Block(cin if j == 0 else args[0], args[0],
                                         args[1]) for j in range(n)]
                layer = blocks[0] if n == 1 else nn.Sequential(*blocks)
            elif mod == "Conv":
                layer = Conv(cin, args[0], args[1], args[2])
            elif mod == "C3":
                layer = C3(cin, args[0], n,
                           shortcut=len(args) < 2 or args[1])
            elif mod == "SPP":
                layer = SPP(cin, args[0], args[1])
            elif mod in ("Upsample", "Concat"):
                layer = NoParams()
                cout = (cin if mod == "Upsample" else
                        sum(ch[f if f == -1 else f + 1] for f in frm))
            elif mod == "Detect":
                layer = Detect([ch[f + 1] for f in frm], no, na)
                cout = 0
            else:
                raise ValueError(f"unknown module {mod}")
            layers.append(layer)
            ch.append(cout)
        self.model = nn.ModuleList(layers)
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x):
        """x: (B, 3, H, W) RGB in [0, 1], H and W multiples of 32 -> (B,
        anchors, 16) decoded predictions (xywh, obj, 10 landmarks, cls)."""
        y, h = [], x
        for (frm, _, mod, _), layer in zip(self.spec["layers"], self.model):
            inp = h if frm == -1 else (
                [y[f] if f != -1 else h for f in frm]
                if isinstance(frm, list) else y[frm])
            if mod == "Upsample":
                h = upsample_nearest_2x(inp)
            elif mod == "Concat":
                h = torch.cat(inp, 1)
            elif mod == "Detect":
                return layer(inp)
            else:
                h = layer(inp)
            y.append(h)
        raise RuntimeError("spec has no Detect layer")


# -- host pre / post (utils/datasets.letterbox, utils/general NMS) ------------

def letterbox(img, new_shape=640, color=(114, 114, 114)):
    """Resize an (H, W, 3) uint8 image (numpy, or a tensor on any device) by
    r = min(new / old) with cv2's INTER_LINEAR, then pad with `color` to
    new_shape (BORDER_CONSTANT), int(round(dh -+ 0.1)) rows above / below
    and likewise columns. Returns (the image, of the input's kind, r,
    (dw, dh))."""
    is_tensor = torch.is_tensor(img)
    h, w = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    t = img if is_tensor else torch.from_numpy(np.ascontiguousarray(img))
    if (w, h) != new_unpad:
        t = resize(t, new_unpad, "linear")
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    t = cvops.copy_make_border(t, top, bottom, left, right, color)
    return (t if is_tensor else t.numpy()), r, (dw, dh)


def non_max_suppression_face(pred: np.ndarray, conf_thres: float = 0.5,
                             iou_thres: float = 0.45) -> np.ndarray:
    """pred: (N, 16) decoded -> kept rows (M, 16) [x1, y1, x2, y2, conf,
    10 landmarks, cls], conf = obj * cls, by score (utils/general.py:
    89-165)."""
    conf = pred[:, 4] * pred[:, 15]
    keep = conf > conf_thres
    pred, conf = pred[keep], conf[keep]
    if pred.shape[0] == 0:
        return np.zeros((0, 16), np.float32)
    xy, wh = pred[:, :2], pred[:, 2:4]
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=1)
    dets = np.concatenate([boxes, conf[:, None]], axis=1).astype(np.float32)
    idx = nms_numpy(dets, iou_thres)
    out = np.concatenate([boxes, conf[:, None], pred[:, 5:15],
                          pred[:, 15:16]], axis=1)
    return out[idx]


def make_yolo_detector_fn(model: YoloFace, iou_thres: float = 0.5,
                          target_size: int = 640):
    """detector(img_bgr_u8 (h, w, 3), numpy or a tensor, conf_threshold=0.7)
    -> (N, 15) numpy rows in the image's pixels: the FaceRestoreHelper
    plug-in. The letterbox and the network run on the model's device, one
    frame a call (the JAX detector has no batched form either). The module
    is detector.model."""

    def predictions(img_bgr_u8):
        """(the letterboxed frame's decoded predictions, (anchors, 16) on
        the model's device, float32; r; (dw, dh))."""
        p = next(model.parameters())
        img = img_bgr_u8 if torch.is_tensor(img_bgr_u8) else \
            torch.from_numpy(np.ascontiguousarray(img_bgr_u8))
        padded, r, pad = letterbox(img.to(p.device).flip(-1),
                                   new_shape=target_size)
        x = (padded.to(torch.float32) / 255.0).permute(2, 0, 1)[None]
        with torch.no_grad():
            return model(x.to(p.dtype))[0].float(), r, pad

    def detector(img_bgr_u8, conf_threshold: float = 0.7) -> np.ndarray:
        pred, r, (dw, dh) = predictions(img_bgr_u8)
        det = non_max_suppression_face(pred.cpu().numpy(), conf_threshold,
                                       iou_thres)
        if det.shape[0] == 0:
            return np.zeros((0, 15), np.float32)
        # undo the letterbox
        det[:, [0, 2]] = (det[:, [0, 2]] - dw) / r
        det[:, [1, 3]] = (det[:, [1, 3]] - dh) / r
        det[:, 5:15:2] = (det[:, 5:15:2] - dw) / r
        det[:, 6:15:2] = (det[:, 6:15:2] - dh) / r
        return det[:, :15]

    detector.model = model
    detector.predictions = predictions
    return detector
