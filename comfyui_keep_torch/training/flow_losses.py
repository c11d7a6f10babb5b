"""GMFlow's training loss and error metrics (reference archs/gmflow/loss.py,
evaluate.py), ported from comfyui_keep_tpu/training/flow_losses.py. Flows
are (B, H, W, 2) tensors, as the JAX package lays them out."""
from typing import Dict, Optional, Sequence, Tuple

import torch


def flow_loss_func(flow_preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                   valid: Optional[torch.Tensor] = None, gamma: float = 0.9,
                   max_flow: float = 400.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence-weighted L1 over the predictions (the i-th of n weighted
    gamma^(n-1-i)), each the mean over the valid pixels of |pred - gt|
    summed over x and y; a pixel is valid where valid >= 0.5 (every pixel
    without `valid`) and |gt| < max_flow. Metrics of the last prediction
    over the valid pixels: its end-point error "epe" and the shares above
    1, 3 and 5 px. valid: (B, H, W)."""
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    if valid is None:
        valid = torch.ones_like(mag)
    valid = ((valid >= 0.5) & (mag < max_flow)).to(flow_gt.dtype)
    denom = torch.clamp(valid.sum(), min=1.0)
    n = len(flow_preds)
    total = 0.0
    for i, pred in enumerate(flow_preds):
        err = torch.abs(pred - flow_gt).sum(dim=-1)
        total = total + gamma ** (n - 1 - i) * torch.sum(valid * err) / denom
    epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
    metrics = {"epe": torch.sum(epe * valid) / denom}
    for px in (1, 3, 5):
        metrics[f"{px}px"] = torch.sum(valid * (epe > px)) / denom
    return total, metrics


def end_point_error(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean end-point error, over the pixels where valid >= 0.5 if given."""
    epe = torch.sqrt(torch.sum((flow_pred - flow_gt) ** 2, dim=-1))
    if valid is None:
        return epe.mean()
    v = (valid >= 0.5).to(epe.dtype)
    return torch.sum(epe * v) / torch.clamp(v.sum(), min=1.0)
