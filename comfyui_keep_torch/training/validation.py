"""Validation loops (reference models/sr_model.py:184-265;
video_base_model.py, video_recurrent_model.py:66-174), ported from
comfyui_keep_tpu/training/validation.py: each image, or each clip folder's
frames, through the model, then the metrics of metrics/ on the 8-bit BGR
forms, averaged; work split across processes by striding, the sums
reduced over torch.distributed when it is initialised."""
import os
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _numpy(x):
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_u8_255(img01):
    """[0, 1] -> clipped, times 255, rounded: the metrics' 0-255 floats."""
    return (np.clip(np.asarray(img01, np.float32), 0, 1) * 255.0).round()


def _img_name(batch, b, i):
    paths = batch.get("lq_path") or batch.get("gt_path")
    if paths:
        p = paths[b] if isinstance(paths, (list, tuple)) else paths
        return os.path.splitext(os.path.basename(str(p)))[0]
    return f"img_{i}_{b}"


def validate_images(forward_fn: Callable, loader, metrics_opt: Dict[str, Dict],
                    rank: int = 0, world: int = 1,
                    save_fn: Optional[Callable] = None) -> Dict[str, float]:
    """forward_fn(lq (B, H, W, C) in [0, 1]) -> sr (B, H', W', C) for each
    batch of this rank's share; each output against its gt by every metric
    of metrics_opt ({"psnr": {"type": "calculate_psnr", "crop_border": 4},
    ...}) on the 8-bit BGR forms. save_fn(img_bgr_u8, img_name) receives
    each output (sr_model.py save_img). Returns {metric: mean}."""
    from comfyui_keep_torch.metrics import calculate_metric
    totals = defaultdict(float)
    count = 0
    for i, batch in enumerate(loader):
        if i % world != rank:
            continue
        sr = _numpy(forward_fn(batch["lq"]))
        gt = batch.get("gt")
        for b in range(sr.shape[0]):
            sr_bgr = _to_u8_255(sr[b][..., ::-1])
            if save_fn is not None:
                save_fn(sr_bgr.astype(np.uint8), _img_name(batch, b, i))
            if gt is None:
                continue
            data = {"img": sr_bgr,
                    "img2": _to_u8_255(_numpy(gt)[b][..., ::-1])}
            for name, opt in metrics_opt.items():
                totals[name] += calculate_metric(data, opt)
            count += 1
    return _reduce(dict(totals), count)


def validate_videos(forward_fn: Callable, loader, metrics_opt: Dict[str, Dict],
                    rank: int = 0, world: int = 1,
                    save_fn: Optional[Callable] = None):
    """Per clip folder (video_recurrent_model.py:66-174): each rank takes
    every world-th item; forward_fn(lq (1, T, H, W, C)) -> (1, T, H', W',
    C); each frame's metrics averaged over its folder. save_fn receives
    each frame as "<folder>/<frame:08d>". Returns ({folder: {metric:
    value}}, {metric: mean over the folders})."""
    from comfyui_keep_torch.metrics import calculate_metric
    items = list(loader)
    num = len(items)
    per_folder: Dict[str, Dict[str, float]] = {}
    for i in range(rank, num, world):
        item = items[i]
        folder = item.get("folder", [f"clip{i}"])
        folder = folder[0] if isinstance(folder, list) else folder
        gt = item.get("gt")
        if gt is None:
            continue
        sr = _numpy(forward_fn(item["lq"]))
        gt = _numpy(gt)
        acc = defaultdict(float)
        t = sr.shape[1]
        for f in range(t):
            sr_bgr = _to_u8_255(sr[0, f][..., ::-1])
            if save_fn is not None:
                save_fn(sr_bgr.astype(np.uint8), f"{folder}/{f:08d}")
            data = {"img": sr_bgr, "img2": _to_u8_255(gt[0, f][..., ::-1])}
            for name, opt in metrics_opt.items():
                acc[name] += calculate_metric(data, opt)
        per_folder[folder] = {k: v / t for k, v in acc.items()}
    avg = defaultdict(float)
    for v in per_folder.values():
        for k, m in v.items():
            avg[k] += m
    n = max(len(per_folder), 1)
    return per_folder, {k: v / n for k, v in avg.items()}


def _reduce(totals: Dict[str, float], count: int) -> Dict[str, float]:
    """{metric: total / count}, the totals and the count summed over the
    processes of an initialised torch.distributed group first."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        keys = sorted(totals)
        vec = torch.tensor([totals[k] for k in keys] + [float(count)],
                           dtype=torch.float64)
        dist.all_reduce(vec)
        count = int(vec[-1].item())
        totals = {k: float(v) for k, v in zip(keys, vec[:-1])}
    return {k: v / max(count, 1) for k, v in totals.items()}


def flip_seq_self_ensemble(forward_fn: Callable, lq):
    """(forward(lq) + forward(lq reversed in time) reversed back) / 2, lq
    (B, T, ...) a tensor or numpy (video_recurrent_model.py:176-197)."""
    if torch.is_tensor(lq):
        return 0.5 * (forward_fn(lq) + forward_fn(lq.flip(1)).flip(1))
    back = forward_fn(np.ascontiguousarray(np.flip(lq, 1)))
    return 0.5 * (forward_fn(lq) + np.flip(back, 1))
