"""Tiled upscaler inference with feathered overlaps, ported from
comfyui_keep_tpu/pipeline/tiled.py: ComfyUI's tiled_scale (comfy/utils.py
tiled_scale_multidim) as the reference applies its upscale models
(keep_processor.py:126-132: tile 512, overlap 64).

ComfyUI's semantics, kept:
- tile origins `range(0, size, tile - overlap)` per axis, each clamped to
  `max(0, min(size - overlap, origin))`; an edge tile is ragged, of length
  `min(tile, size - origin)`, and the model runs on the ragged crop;
- feather = round(overlap * scale) in output pixels: the first and last
  `feather` rows and columns of every tile's mask are multiplied by
  (t + 1) / feather (the image's own edges too);
- out += model(tile) * mask and div += mask; the result is out / div.
The tiles, `out` and `div` stay on the image's device. As in the JAX
package, tiles of one shape run as batches of up to `batch_tiles`, the
shapes in the order the row-major scan first meets them, and accumulate
in that order.
"""
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def feather_mask(th: int, tw: int, feather: int) -> np.ndarray:
    """ComfyUI's mask (th, tw, 1) float32: ones, each edge of each axis
    multiplied by (t + 1) / feather for t < feather (compounding where the
    tile is shorter than 2 feather)."""
    mask = np.ones((th, tw, 1), np.float32)
    for t in range(feather):
        w = (t + 1) / feather
        if t < th:
            mask[t, :, 0] *= w
        if th - 1 - t >= 0:
            mask[th - 1 - t, :, 0] *= w
        if t < tw:
            mask[:, t, 0] *= w
        if tw - 1 - t >= 0:
            mask[:, tw - 1 - t, 0] *= w
    return mask


def tile_origins(size: int, tile: int, overlap: int) -> List[int]:
    """ComfyUI's clamped origins; duplicates kept (comfy accumulates a
    repeated tile again)."""
    return [max(0, min(size - overlap, it))
            for it in range(0, size, tile - overlap)]


def tiled_scale(img01: torch.Tensor, model_fn: Callable, scale: int,
                tile: int = 512, overlap: int = 64,
                batch_tiles: int = 4) -> torch.Tensor:
    """img01: (H, W, C) float32 in [0, 1], a tensor on any device;
    model_fn: (N, th, tw, C) -> (N, th scale, tw scale, C') on that
    device. Returns (round(H scale), round(W scale), C') float32, not
    clamped."""
    h, w, _ = img01.shape
    if tile - overlap <= 0:
        raise ValueError(f"tile ({tile}) must exceed overlap ({overlap})")
    dev = img01.device
    ys, xs = tile_origins(h, tile, overlap), tile_origins(w, tile, overlap)
    feather = round(overlap * scale)
    out_h, out_w = round(h * scale), round(w * scale)
    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for y in ys:
        for x in xs:
            groups.setdefault((min(tile, h - y), min(tile, w - x)),
                              []).append((y, x))
    acc = div = None
    masks: Dict[Tuple[int, int], torch.Tensor] = {}
    for (lh, lw), coords in groups.items():
        for i in range(0, len(coords), batch_tiles):
            batch = coords[i:i + batch_tiles]
            tiles = torch.stack([img01[y:y + lh, x:x + lw] for y, x in batch])
            outs = model_fn(tiles).to(torch.float32)
            if acc is None:
                acc = torch.zeros((out_h, out_w, outs.shape[-1]),
                                  dtype=torch.float32, device=dev)
                div = torch.zeros((out_h, out_w, 1), dtype=torch.float32,
                                  device=dev)
            th, tw = outs.shape[1], outs.shape[2]
            if (th, tw) not in masks:
                masks[(th, tw)] = torch.from_numpy(
                    feather_mask(th, tw, feather)).to(dev)
            mask = masks[(th, tw)]
            for (y, x), o in zip(batch, outs):
                oy, ox = round(y * scale), round(x * scale)
                acc[oy:oy + th, ox:ox + tw] += o * mask
                div[oy:oy + th, ox:ox + tw] += mask
    return acc / div


def make_upscaler_fn(model: torch.nn.Module, scale: int, tile: int = 512,
                     overlap: int = 64) -> Callable:
    """The pipeline's upscaler plug-in for an SR module (NCHW, [0, 1]):
    upscaler(img_bgr_u8 (H, W, 3)) -> (H scale, W scale, 3) uint8 BGR, tiled
    on the module's device in its dtype (KEEPFaceProcessor._run_upscaler,
    keep_processor.py:126-132). A numpy image comes back as numpy, a tensor
    as a tensor on the module's device. As in the JAX package the output is
    clamped to [0, 1], scaled by 255 and truncated to uint8. The module is
    upscaler.model; upscaler.calls counts the images it upscaled."""

    def net(tiles):
        p = next(model.parameters())
        with torch.no_grad():
            out = model(tiles.permute(0, 3, 1, 2).to(p.dtype))
        return out.permute(0, 2, 3, 1)

    def upscaler(img_bgr_u8):
        upscaler.calls += 1
        is_tensor = torch.is_tensor(img_bgr_u8)
        dev = next(model.parameters()).device
        t = img_bgr_u8 if is_tensor else torch.from_numpy(
            np.ascontiguousarray(img_bgr_u8))
        x = t.to(dev).flip(-1).to(torch.float32) / 255.0
        out = tiled_scale(x, net, scale, tile, overlap).clamp(0.0, 1.0)
        out = (out.flip(-1) * 255.0).to(torch.uint8)
        return out if is_tensor else out.cpu().numpy()

    upscaler.model = model
    upscaler.calls = 0
    return upscaler
