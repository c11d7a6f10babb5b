"""Tensor primitives of the port (NCHW feature maps, torch weight layouts)
and the hand-written CUDA kernels (ops/kernels.py)."""
from comfyui_keep_torch.ops.act import gelu, leaky_relu, relu, swish
from comfyui_keep_torch.ops.attention import (multi_head_attention,
                                              softmax_attention)
from comfyui_keep_torch.ops.conv import conv2d, linear
from comfyui_keep_torch.ops.norm import group_norm, instance_norm, layer_norm
from comfyui_keep_torch.ops.resample import resize_bilinear, upsample_nearest_2x
from comfyui_keep_torch.ops.warp import (flow_warp, flow_warp_xy, grid_sample,
                                         resize_flow)
