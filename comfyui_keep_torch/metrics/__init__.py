"""Quality metrics (reference wm_basicsr/metrics), ported from
comfyui_keep_tpu/metrics without OpenCV: PSNR / SSIM (numpy, and batched
tensor twins), NIQE, FID. `calculate_metric` dispatches a config dict as
the reference's metrics/__init__.py does."""
from copy import deepcopy

from comfyui_keep_torch.metrics.fid import calculate_fid
from comfyui_keep_torch.metrics.niqe import calculate_niqe
from comfyui_keep_torch.metrics.psnr_ssim import (calculate_psnr,
                                                  calculate_psnr_pt,
                                                  calculate_ssim,
                                                  calculate_ssim_pt)
from comfyui_keep_torch.utils.registry import METRIC_REGISTRY

__all__ = ["calculate_metric", "calculate_fid", "calculate_niqe",
           "calculate_psnr", "calculate_psnr_pt", "calculate_ssim",
           "calculate_ssim_pt"]


def calculate_metric(data, opt):
    """opt: {"type": a registered metric's name, **its keywords}; data:
    the metric's image arguments."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
