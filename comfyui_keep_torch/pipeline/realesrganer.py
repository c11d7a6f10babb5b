"""RealESRGANer (reference wm_basicsr/utils/realesrgan_utils.py), ported
from comfyui_keep_tpu/pipeline/realesrganer.py without OpenCV: the reflect
pre-pad and the pad to a multiple of the model's unshuffle, inference whole
or in independent tiles whose interiors are copied back (tile_process), the
alpha channel (through the model, or by INTER_LINEAR), 16-bit and gray
images, and the final `outscale` resize.

The image work runs on the model's device up to the uint8 / uint16
conversion. OpenCV's pieces are the port's: GRAY2BGR on float (a copy per
channel), BGR2GRAY on uint8 / uint16 (`cvops.bgr_to_gray`, OpenCV's fixed
point), INTER_LINEAR on the float32 alpha (`cvops.resize_linear_f32`) and
INTER_LANCZOS4 on uint8 and uint16 (`utils/resize.py`). The reference's
PrefetchReader and IOConsumer (the command-line tools' file threads) read
and write PNG through `utils/png.py`, where the JAX forms use cv2.imread /
imwrite.
"""
import copy
import math
import queue
import threading
from typing import Optional

import numpy as np
import torch

from comfyui_keep_torch.utils import cvops, png
from comfyui_keep_torch.utils.resize import resize


def reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """np.pad(x, bottom pad_h, right pad_w, mode="reflect") of (B, H, W, C):
    the edge not repeated, the reflection periodic past the size."""
    for axis, p in ((1, pad_h), (2, pad_w)):
        if p:
            n = x.shape[axis]
            idx = cvops.border_index(torch.arange(n + p, device=x.device), n,
                                     "reflect101")
            x = x.index_select(axis, idx)
    return x


class RealESRGANer:
    """An SR module (NCHW, [0, 1]) of upscale `scale`; tile > 0 runs tiles
    of that size with tile_pad pixels of context; pre_pad reflect-pads the
    bottom and right first. half=True runs the model on a bf16 copy (the
    JAX package's half type)."""

    def __init__(self, scale: int, model: torch.nn.Module, tile: int = 0,
                 tile_pad: int = 10, pre_pad: int = 10, half: bool = False):
        self.scale = scale
        self.tile_size, self.tile_pad, self.pre_pad = tile, tile_pad, pre_pad
        self.mod_scale = {1: 4, 2: 2}.get(scale)
        self.model = (copy.deepcopy(model).to(torch.bfloat16) if half
                      else model)
        self.mod_pad_h = self.mod_pad_w = 0

    def _model(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, C) float32 -> (B, h s, w s, C) float32."""
        p = next(self.model.parameters())
        with torch.no_grad():
            out = self.model(x.permute(0, 3, 1, 2).to(p.dtype))
        return out.permute(0, 2, 3, 1).to(torch.float32)

    def pre_process(self, img_rgb01: torch.Tensor) -> torch.Tensor:
        """(H, W, C) -> (1, H', W', C): the pre-pad, then the pad to a
        multiple of mod_scale, both reflected (realesrgan_utils.py:61-80)."""
        img = img_rgb01[None]
        if self.pre_pad:
            img = reflect_pad(img, self.pre_pad, self.pre_pad)
        self.mod_pad_h = self.mod_pad_w = 0
        if self.mod_scale is not None:
            h, w = img.shape[1:3]
            self.mod_pad_h = (-h) % self.mod_scale
            self.mod_pad_w = (-w) % self.mod_scale
            img = reflect_pad(img, self.mod_pad_h, self.mod_pad_w)
        return img

    def tile_process(self, img: torch.Tensor) -> torch.Tensor:
        """Independent tiles with tile_pad of context; each tile's interior
        is copied into the output (realesrgan_utils.py:118-176)."""
        b, h, w, c = img.shape
        s = self.scale
        out = torch.zeros((b, h * s, w * s, c), dtype=torch.float32,
                          device=img.device)
        for ty in range(math.ceil(h / self.tile_size)):
            for tx in range(math.ceil(w / self.tile_size)):
                x0, y0 = tx * self.tile_size, ty * self.tile_size
                x1 = min(x0 + self.tile_size, w)
                y1 = min(y0 + self.tile_size, h)
                px0, py0 = max(x0 - self.tile_pad, 0), max(y0 - self.tile_pad,
                                                           0)
                px1, py1 = min(x1 + self.tile_pad, w), min(y1 + self.tile_pad,
                                                           h)
                out_tile = self._model(img[:, py0:py1, px0:px1])
                out[:, y0 * s:y1 * s, x0 * s:x1 * s] = out_tile[
                    :, (y0 - py0) * s:(y1 - py0) * s,
                    (x0 - px0) * s:(x1 - px0) * s]
        return out

    def post_process(self, out: torch.Tensor) -> torch.Tensor:
        s = self.scale
        h, w = out.shape[1:3]
        out = out[:, :h - self.mod_pad_h * s, :w - self.mod_pad_w * s]
        h, w = out.shape[1:3]
        return out[:, :h - self.pre_pad * s, :w - self.pre_pad * s]

    def _upscale(self, img01: torch.Tensor) -> torch.Tensor:
        x = self.pre_process(img01)
        up = self.tile_process(x) if self.tile_size > 0 else self._model(x)
        return self.post_process(up)[0]

    def enhance(self, img: np.ndarray, outscale: Optional[float] = None,
                alpha_upsampler: str = "realesrgan"):
        """img: (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, uint8 or
        uint16 (16-bit when its largest value exceeds 256) -> (the upscaled
        image of the same layout, the mode "L", "RGB" or "RGBA")."""
        h_input, w_input = img.shape[:2]
        x = torch.from_numpy(np.asarray(img).astype(np.float32)).to(
            next(self.model.parameters()).device)
        max_range = 65535 if float(x.max()) > 256 else 255
        x = x / max_range
        alpha = None
        if x.dim() == 2:
            img_mode = "L"
            x = x[:, :, None].expand(-1, -1, 3)
        elif x.shape[2] == 4:
            img_mode = "RGBA"
            alpha = x[:, :, 3]
            x = x[:, :, :3]
        else:
            img_mode = "RGB"
        output = self._upscale(x.flip(-1).contiguous()).flip(-1)
        if alpha is not None:
            if alpha_upsampler == "realesrgan":
                alpha_up = self._upscale(alpha[:, :, None].expand(
                    -1, -1, 3).contiguous())[:, :, 0]
            else:
                alpha_up = cvops.resize_linear_f32(
                    alpha.contiguous(), (output.shape[1], output.shape[0]))
            output = torch.cat([output, alpha_up[:, :, None]], 2)
        out = torch.round(output.clamp(0, 1) * float(max_range)).to(
            torch.int32)
        if img_mode == "L":
            out = cvops.bgr_to_gray(out)
        size = None
        if outscale is not None and outscale != float(self.scale):
            size = (int(w_input * outscale), int(h_input * outscale))
        if max_range == 255:
            out = out.to(torch.uint8)
            if size is not None:
                out = resize(out, size, "lanczos4")
            return out.cpu().numpy(), img_mode
        out = out.cpu().numpy().astype(np.uint16)
        if size is not None:
            out = resize(out, size, "lanczos4")
        return out, img_mode


class PrefetchReader(threading.Thread):
    """Background image reader feeding a bounded queue
    (realesrgan_utils.py:258-283): each path's PNG as
    cv2.imread(path, IMREAD_UNCHANGED) gives it (png.imread_unchanged),
    then None; iterate it after start(). A file that does not read ends
    the queue, and the iteration raises its error there (cv2.imread would
    have queued a None)."""

    def __init__(self, img_list, num_prefetch_queue):
        super().__init__()
        self.que = queue.Queue(num_prefetch_queue)
        self.img_list = img_list
        self.error: Optional[BaseException] = None

    def run(self):
        try:
            for img_path in self.img_list:
                self.que.put(png.imread_unchanged(img_path))
        except Exception as e:     # handed to the reading thread
            self.error = e
        finally:
            self.que.put(None)

    def __next__(self):
        item = self.que.get()
        if item is None:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def __iter__(self):
        return self


class IOConsumer(threading.Thread):
    """Background image writer draining a queue until "quit"
    (realesrgan_utils.py:286-304): each {"output", "save_path"} message
    written as PNG (png.imwrite_bgr)."""

    def __init__(self, opt, que, qid):
        super().__init__()
        self._queue = que
        self.qid = qid
        self.opt = opt

    def run(self):
        while True:
            msg = self._queue.get()
            if isinstance(msg, str) and msg == "quit":
                break
            png.imwrite_bgr(msg["save_path"], msg["output"])
