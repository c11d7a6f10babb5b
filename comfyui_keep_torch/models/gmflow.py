"""GMFlow optical flow (reference archs/gmflow), ported from
comfyui_keep_tpu/models/gmflow.py.

CNN backbone (stride 8, InstanceNorm) -> sine position embedding -> 6
single-head transformer blocks with split-window attention (shifted on odd
layers), both images as one 2B batch -> global correlation softmax -> global
flow-propagation attention -> convex x8 upsampling. The refinement model
(`GMFlow(num_scales=2)`, `apply_refine`, the reference's gmflow_with_refine)
adds a shared-weight trident conv that gives the backbone a 1/4-resolution
scale, local correlation within a radius, local propagation, and a residual
flow per scale; `forward_backward_consistency_check` gives occlusion masks
from a bidirectional pair.

The module tree and parameter names are the reference's, so its state dict
(the `flownet.model.*` subtree of a KEEP checkpoint) loads as it is. The
backbone and upsampler convolutions run NCHW; the transformer works on
(B, L, C) tokens, as the JAX package does. Window attention, the global
flow attention, the FFN tail and the global correlation go through the
hand-written kernels of ops/kernels.py (their plain versions on the CPU).
"""
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import kernels as K
from comfyui_keep_torch.ops import (conv2d, flow_warp, grid_sample,
                                    instance_norm, layer_norm, linear, relu,
                                    resize_bilinear)
from comfyui_keep_torch.ops.act import tanh_gelu

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Backbone (backbone.py CNNEncoder)
# ---------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride))
        else:
            self.downsample = None

    def forward(self, x, stride: Optional[int] = None):
        """stride overrides the one the block was built with (the JAX
        package runs a refinement backbone's layer3 at either)."""
        stride = self.stride if stride is None else stride
        y = relu(instance_norm(conv2d(x, self.conv1.weight, stride=stride,
                                      padding=1)))
        y = relu(instance_norm(conv2d(y, self.conv2.weight, padding=1)))
        if self.downsample is not None:
            d = self.downsample[0]
            x = instance_norm(conv2d(x, d.weight, d.bias, stride=stride))
        return relu(x + y)


class MultiScaleTridentConv(nn.Conv2d):
    """The trident conv (trident_conv.py): one 3x3 weight, padding 1, no
    bias, applied at each stride of `strides`."""

    def __init__(self, c: int, strides):
        super().__init__(c, c, 3, padding=1, bias=False)
        self.strides = tuple(strides)

    def forward(self, x):
        return [conv2d(x, self.weight, stride=s, padding=1)
                for s in self.strides]


TRIDENT_STRIDES = {2: (1, 2), 3: (1, 2, 4), 4: (1, 2, 4, 8)}


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, num_output_scales: int = 1):
        super().__init__()
        dims = (64, 96, 128)
        # with more than one scale layer3 keeps stride 1 (1/4 resolution)
        s3 = 2 if num_output_scales == 1 else 1
        self.conv1 = nn.Conv2d(3, dims[0], 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(dims[0], dims[0], 1),
                                    ResidualBlock(dims[0], dims[0], 1))
        self.layer2 = nn.Sequential(ResidualBlock(dims[0], dims[1], 2),
                                    ResidualBlock(dims[1], dims[1], 1))
        self.layer3 = nn.Sequential(ResidualBlock(dims[1], dims[2], s3),
                                    ResidualBlock(dims[2], dims[2], 1))
        self.conv2 = nn.Conv2d(dims[2], output_dim, 1)
        if num_output_scales > 1:
            self.trident_conv = MultiScaleTridentConv(
                output_dim, TRIDENT_STRIDES[num_output_scales])

    def forward(self, x, num_output_scales: int = 1):
        """(N, 3, H, W) normalised -> (N, C, H/8, W/8); with more scales
        (the model's own number, a trident conv) the list of maps from high
        resolution (1/4) to low. As in the JAX package's backbone_apply, one
        scale runs layer3 at stride 2 and skips the trident conv whatever
        the model was built with."""
        x = relu(instance_norm(conv2d(x, self.conv1.weight, stride=2,
                                      padding=3)))
        x = self.layer2(self.layer1(x))
        x = self.layer3[1](self.layer3[0](
            x, 2 if num_output_scales == 1 else 1))
        x = conv2d(x, self.conv2.weight, self.conv2.bias)
        if num_output_scales == 1:
            return x
        return self.trident_conv(x)


# ---------------------------------------------------------------------------
# Windows and position embedding (utils.py, position.py)
# ---------------------------------------------------------------------------

def split_windows(x, k: int):
    """(B, H, W, C) -> (B*k*k, H/k, W/k, C), row-major windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x, k: int):
    bk, hk, wk, c = x.shape
    x = x.reshape(bk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bk // (k * k), k * hk, k * wk, c)


def sine_pos_embed(h: int, w: int, num_pos_feats: int) -> np.ndarray:
    """DETR sine embedding, normalize=True: (h, w, 2*num_pos_feats) ordered
    [y-part, x-part]."""
    scale, eps = 2 * math.pi, 1e-6
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w),
                                                                 np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1),
                                                                 np.float32)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = 10000.0 ** (2 * np.floor(dim_t / 2) / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


def add_position(f0, f1, attn_splits: int, channels: int):
    """feature_add_position: the embedding is computed per split window."""
    b, h, w, c = f0.shape
    k = attn_splits
    pos = torch.as_tensor(sine_pos_embed(h // k, w // k, channels // 2),
                          device=f0.device).to(f0.dtype)
    if k > 1:
        return (merge_windows(split_windows(f0, k) + pos, k),
                merge_windows(split_windows(f1, k) + pos, k))
    return f0 + pos, f1 + pos


def shifted_window_mask(h: int, w: int, k: int) -> np.ndarray:
    """Swin shifted-window mask: (k*k, win, win) additive {0, -100} f32."""
    wsh, wsw = h // k, w // k
    ssh, ssw = wsh // 2, wsw // 2
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, h - wsh), slice(h - wsh, h - ssh), slice(h - ssh, None)):
        for ws in (slice(0, w - wsw), slice(w - wsw, w - ssw),
                   slice(w - ssw, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(k, wsh, k, wsw).transpose(0, 2, 1, 3).reshape(
        k * k, wsh * wsw)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Feature transformer (transformer.py)
# ---------------------------------------------------------------------------

class TransformerLayer(nn.Module):
    def __init__(self, d: int = 128, ffn: bool = True, expansion: int = 4):
        super().__init__()
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d)
        if ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * d, 2 * d * expansion, bias=False), nn.GELU(),
                nn.Linear(2 * d * expansion, d, bias=False))
            self.norm2 = nn.LayerNorm(d)
        else:
            self.mlp = None

    def forward(self, sw, tw, bias):
        """One sublayer in window layout: sw (source) and tw (target) are
        (B*k*k, win, C) tokens; bias the shifted-window mask or None."""
        c = sw.shape[-1]
        q = linear(sw, self.q_proj.weight)
        k = linear(tw, self.k_proj.weight)
        v = linear(tw, self.v_proj.weight)
        out = K.attention(q, k, v, 1.0 / math.sqrt(c), bias=bias)
        msg = layer_norm(linear(out, self.merge.weight), self.norm1.weight,
                         self.norm1.bias)
        if self.mlp is None:
            return sw + msg
        # concat([src, msg]) @ W1^T, gelu, W2, LayerNorm and the residual
        # in one kernel, on the weights as nn.Linear holds them
        return K.mlp_fused(sw, msg, self.mlp[0].weight, self.mlp[2].weight,
                           self.norm2.weight, self.norm2.bias,
                           approximate=tanh_gelu(sw.dtype))


class TransformerBlock(nn.Module):
    def __init__(self, d: int = 128):
        super().__init__()
        self.self_attn = TransformerLayer(d, ffn=False)
        self.cross_attn_ffn = TransformerLayer(d, ffn=True)


class FeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 128):
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(d_model)
                                    for _ in range(num_layers))


def _prep_tokens(x, b, h, w, c, k, shift):
    """(B, H*W, C) tokens -> (B*k*k, win, C) window layout."""
    t = x.reshape(b, h, w, c)
    if shift:
        t = torch.roll(t, (-(h // k // 2), -(w // k // 2)), dims=(1, 2))
    return split_windows(t, k).reshape(b * k * k, (h // k) * (w // k), c)


def _unprep_tokens(x, b, h, w, c, k, shift):
    t = merge_windows(x.reshape(b * k * k, h // k, w // k, c), k)
    if shift:
        t = torch.roll(t, (h // k // 2, w // k // 2), dims=(1, 2))
    return t.reshape(b, h * w, c)


# ---------------------------------------------------------------------------
# Matching, propagation, upsampling (matching.py, transformer.py, gmflow.py)
# ---------------------------------------------------------------------------

def coords_grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) [x, y] pixel coordinates, f32."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def global_correlation_softmax(f0, f1):
    """(B, H, W, C) x2 -> flow (B, H, W, 2) in the feature dtype: the
    softmax-weighted expectation of the pixel grid over the full (H*W)^2
    correlation, taken in f32 by the fused kernel."""
    b, h, w, c = f0.shape
    grid = coords_grid(h, w, f0.device).reshape(h * w, 2)
    corresp = K.global_correlation_expectation(
        f0.reshape(b, h * w, c), f1.reshape(b, h * w, c), grid)
    return (corresp - grid).to(f0.dtype).reshape(b, h, w, 2)


def local_correlation_softmax(f0, f1, radius: int):
    """(B, H, W, C) x2 -> flow (B, H, W, 2) in the feature dtype: the
    softmax-weighted expectation of the (2r+1)^2 window of positions around
    each pixel, f1 sampled there bilinearly with zero padding and the
    positions outside the image at -1e9 (matching.py local_correlation).
    Correlation and softmax run in f32."""
    b, h, w, c = f0.shape
    k = 2 * radius + 1
    dev = f0.device
    coords = coords_grid(h, w, dev)                      # (h, w, 2)
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    window = torch.stack([ox, oy], dim=-1).reshape(k * k, 2)
    sample = coords[:, :, None] + window                 # (h, w, k*k, 2)
    valid = ((sample[..., 0] >= 0) & (sample[..., 0] < w)
             & (sample[..., 1] >= 0) & (sample[..., 1] < h))
    norm = torch.stack([2 * sample[..., 0] / max(w - 1, 1) - 1,
                        2 * sample[..., 1] / max(h - 1, 1) - 1], dim=-1)
    grid = norm.reshape(1, h * w, k * k, 2).expand(b, -1, -1, -1)
    feat = grid_sample(f1.permute(0, 3, 1, 2), grid)     # (b, c, hw, k*k)
    corr = torch.einsum("bcl,bclk->blk", f0.reshape(b, h * w, c).permute(
        0, 2, 1).float(), feat.float()) / math.sqrt(c)
    corr = corr.masked_fill(~valid.reshape(1, h * w, k * k), -1e9)
    prob = torch.softmax(corr, dim=-1)
    corresp = torch.einsum("blk,lkc->blc", prob,
                           sample.reshape(h * w, k * k, 2))
    return (corresp.reshape(b, h, w, 2) - coords).to(f0.dtype)


def _unfold_nhwc(x, ksize: int, pad: int):
    """(B, H, W, C) -> (B, H, W, ksize^2, C): each pixel's zero-padded
    ksize x ksize neighbourhood, row-major (F.unfold's order)."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return torch.stack([xp[:, i:i + h, j:j + w] for i in range(ksize)
                        for j in range(ksize)], dim=3)


class FeatureFlowAttention(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)

    def forward(self, feature0, flow, local_window_radius: int = -1):
        """Propagation of flow (B, H, W, 2) guided by feature0 (B, H, W, C).
        Global (radius -1): softmax(q k^T / sqrt(c)) @ flow, the reference's
        quirk kept, key = k_proj(q_proj(x)). Local (radius r > 0): each
        pixel attends to its zero-padded (2r+1)^2 neighbourhood, the key
        projected from feature0 itself, as the reference's local branch
        does."""
        b, h, w, c = feature0.shape
        x = feature0.reshape(b, h * w, c)
        q = linear(x, self.q_proj.weight, self.q_proj.bias)
        if local_window_radius > 0:
            r = local_window_radius
            k = linear(x, self.k_proj.weight, self.k_proj.bias)
            kp = _unfold_nhwc(k.reshape(b, h, w, c), 2 * r + 1, r)
            vp = _unfold_nhwc(flow, 2 * r + 1, r)
            scores = torch.einsum("bhwc,bhwkc->bhwk", q.reshape(b, h, w, c),
                                  kp) / math.sqrt(c)
            return torch.einsum("bhwk,bhwkc->bhwc",
                                torch.softmax(scores, dim=-1), vp)
        k = linear(q, self.k_proj.weight, self.k_proj.bias)
        v = flow.reshape(b, h * w, 2).contiguous()
        return K.attention(q, k, v, 1.0 / math.sqrt(c)).reshape(b, h, w, 2)


def upsample_flow_convex(upsampler: nn.Sequential, flow, feature,
                         factor: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convex x`factor` upsampling. flow (B, H, W, 2), feature (B, H, W, C)
    -> (fx, fy) planes, each (B, H*f, W*f)."""
    b, h, w, _ = flow.shape
    x = torch.cat([flow, feature], dim=-1).permute(0, 3, 1, 2)
    c0, c2 = upsampler[0], upsampler[2]
    mask = relu(conv2d(x, c0.weight, c0.bias, padding=1))
    mask = conv2d(mask, c2.weight, c2.bias)              # (b, 9*f*f, h, w)
    mask = torch.softmax(mask.reshape(b, 9, factor * factor, h, w), dim=1)
    fl = (flow * factor).permute(0, 3, 1, 2)             # (b, 2, h, w)
    patches = F.unfold(fl, 3, padding=1).reshape(b, 2, 9, 1, h, w)
    up = (mask[:, None] * patches).sum(dim=2)            # (b, 2, f*f, h, w)
    up = F.pixel_shuffle(up.reshape(b, 2 * factor * factor, h, w), factor)
    return up[:, 0], up[:, 1]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class GMFlow(nn.Module):
    FEATURE_CHANNELS = 128
    UPSAMPLE_FACTOR = 8

    def __init__(self, feature_channels: int = 128, num_layers: int = 6,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 num_scales: int = 1):
        super().__init__()
        c = feature_channels
        self.backbone = CNNEncoder(c, num_scales)
        self.transformer = FeatureTransformer(num_layers, c)
        self.feature_flow_attn = FeatureFlowAttention(c)
        f = self.UPSAMPLE_FACTOR
        self.upsampler = nn.Sequential(nn.Conv2d(2 + c, 256, 3, 1, 1),
                                       nn.ReLU(inplace=True),
                                       nn.Conv2d(256, f * f * 9, 1))
        self._masks: Dict[Tuple, torch.Tensor] = {}
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def extract_features(self, imgs):
        """(N, H, W, 3) in [0, 255] -> single-scale backbone features
        (N, H/8, W/8, C)."""
        mean = torch.tensor(IMAGENET_MEAN, dtype=imgs.dtype, device=imgs.device)
        std = torch.tensor(IMAGENET_STD, dtype=imgs.dtype, device=imgs.device)
        x = ((imgs / 255.0 - mean) / std).permute(0, 3, 1, 2)
        return self.backbone(x).permute(0, 2, 3, 1)

    def _mask(self, h, w, k, device):
        key = (h, w, k, str(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(shifted_window_mask(h, w, k),
                                               device=device)
        return self._masks[key]

    def transformer_apply(self, f0, f1, attn_splits: int):
        """f0/f1: (B, H, W, C). Both images run as one 2B batch, swapped
        each layer; tokens stay in window layout through each layer's self
        attention, cross attention and FFN."""
        b, h, w, c = f0.shape
        k = attn_splits
        c0 = torch.cat([f0, f1], dim=0).reshape(2 * b, h * w, c)
        half = b * k * k  # the f0 half of the window batch
        for i, layer in enumerate(self.transformer.layers):
            shift = k > 1 and i % 2 == 1
            bias = self._mask(h, w, k, f0.device) if shift else None
            sw = _prep_tokens(c0, 2 * b, h, w, c, k, shift)
            tw = torch.cat([sw[half:], sw[:half]], dim=0)
            sw = layer.self_attn(sw, sw, bias)
            sw = layer.cross_attn_ffn(sw, tw, bias)
            c0 = _unprep_tokens(sw, 2 * b, h, w, c, k, shift)
        return (c0[:b].reshape(b, h, w, c), c0[b:].reshape(b, h, w, c))

    def match(self, f0, f1, attn_splits: int, corr_radius: int,
              prop_radius: int, flow=None):
        """One scale on features (B, H, W, C): position embedding, the
        transformer, correlation softmax (global, or local within
        corr_radius), added to `flow` if given, then propagation (global,
        or local within prop_radius). Returns (flow (B, H, W, 2), f0 after
        the transformer)."""
        f0, f1 = add_position(f0, f1, attn_splits, self.FEATURE_CHANNELS)
        f0, f1 = self.transformer_apply(f0, f1, attn_splits)
        if corr_radius == -1:
            pred = global_correlation_softmax(f0, f1)
        else:
            pred = local_correlation_softmax(f0, f1, corr_radius)
        flow = pred if flow is None else flow + pred
        return self.feature_flow_attn(f0, flow.detach(), prop_radius), f0

    def flow_from_features(self, f0, f1, attn_splits: int = 2,
                           corr_radius: int = -1, prop_radius: int = -1):
        """Pair stages on backbone features (B, H, W, C) -> (fx, fy)."""
        flow, f0 = self.match(f0, f1, attn_splits, corr_radius, prop_radius)
        return upsample_flow_convex(self.upsampler, flow, f0,
                                    self.UPSAMPLE_FACTOR)

    @torch.no_grad()
    def apply(self, img0, img1, attn_splits: int = 2, corr_radius: int = -1,
              prop_radius: int = -1):
        """img0, img1: (B, H, W, 3) in [0, 255] -> flow (B, H, W, 2), img0
        -> img1 displacement, through the single-scale backbone."""
        b = img0.shape[0]
        feats = self.extract_features(torch.cat([img0, img1], dim=0))
        fx, fy = self.flow_from_features(feats[:b], feats[b:], attn_splits,
                                         corr_radius, prop_radius)
        return torch.stack([fx, fy], dim=-1)

    @torch.no_grad()
    def apply_refine(self, img0, img1, attn_splits_list=(2, 8),
                     corr_radius_list=(-1, 4), prop_radius_list=(-1, 1),
                     num_scales: int = 2, pred_bidir_flow: bool = False):
        """The multi-scale refinement forward (the reference's
        gmflow_with_refine), on a model built with num_scales scales:
        img0, img1 (B, H, W, 3) in [0, 255] -> flow (B, H', W', 2). Each
        scale, coarse to fine, warps f1 by the flow so far (resized x2 with
        align_corners=True and doubled) and adds its residual flow. With
        pred_bidir_flow the forward and backward pairs run as one doubled
        batch: the output's first B entries are img0 -> img1, the rest img1
        -> img0. As in the JAX package the convex upsampler is x8 at every
        scale count, so two scales (1/4-resolution features) return twice
        the input size."""
        b = img0.shape[0]
        mean = torch.tensor(IMAGENET_MEAN, dtype=img0.dtype, device=img0.device)
        std = torch.tensor(IMAGENET_STD, dtype=img0.dtype, device=img0.device)
        imgs = ((torch.cat([img0, img1], dim=0) / 255.0 - mean) / std)
        feats = self.backbone(imgs.permute(0, 3, 1, 2), num_scales)[::-1]
        flow = f0 = None
        for si in range(num_scales):
            f = feats[si].permute(0, 2, 3, 1)
            f0, f1 = f[:b], f[b:]
            if pred_bidir_flow:
                f0, f1 = torch.cat([f0, f1], dim=0), torch.cat([f1, f0], dim=0)
            if flow is not None:
                flow = resize_bilinear(
                    flow.permute(0, 3, 1, 2),
                    (2 * flow.shape[1], 2 * flow.shape[2]),
                    align_corners=True).permute(0, 2, 3, 1) * 2
                f1 = flow_warp(f1.permute(0, 3, 1, 2), flow).permute(0, 2, 3, 1)
            flow, f0 = self.match(f0, f1, attn_splits_list[si],
                                  corr_radius_list[si], prop_radius_list[si],
                                  flow)
        fx, fy = upsample_flow_convex(self.upsampler, flow, f0,
                                      self.UPSAMPLE_FACTOR)
        return torch.stack([fx, fy], dim=-1)


@torch.no_grad()
def flow_from_clip(gm: GMFlow, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, H, W, 3) in [-1, 1] -> (fx, fy), each (B, T-1, H, W), where
    flow i = GMFlow(frame i+1 -> frame i) (keep_arch.py get_flow). The
    backbone runs once per frame."""
    b, t, h, w, _ = x.shape
    x255 = (x + 1.0) * 0.5 * 255.0
    feats = gm.extract_features(x255.reshape(b * t, h, w, 3))
    feats = feats.reshape((b, t) + feats.shape[1:])
    f0 = feats[:, 1:].reshape((b * (t - 1),) + feats.shape[2:])
    f1 = feats[:, :-1].reshape((b * (t - 1),) + feats.shape[2:])
    fx, fy = gm.flow_from_features(f0, f1)
    return fx.reshape(b, t - 1, h, w), fy.reshape(b, t - 1, h, w)


def forward_backward_consistency_check(fwd_flow, bwd_flow,
                                       alpha: float = 0.01,
                                       beta: float = 0.5):
    """Occlusion masks of a bidirectional pair (geometry.py, UnFlow's
    thresholds): fwd_flow, bwd_flow (B, H, W, 2) -> (fwd_occ, bwd_occ),
    each (B, H, W) in {0, 1}, 1 where a flow and the other one warped back
    along it differ by more than alpha * (|fwd| + |bwd|) + beta."""
    mag = fwd_flow.norm(dim=-1) + bwd_flow.norm(dim=-1)
    warped_bwd = flow_warp(bwd_flow.permute(0, 3, 1, 2), fwd_flow)
    warped_fwd = flow_warp(fwd_flow.permute(0, 3, 1, 2), bwd_flow)
    diff_fwd = (fwd_flow + warped_bwd.permute(0, 2, 3, 1)).norm(dim=-1)
    diff_bwd = (bwd_flow + warped_fwd.permute(0, 2, 3, 1)).norm(dim=-1)
    thr = alpha * mag + beta
    return ((diff_fwd > thr).to(fwd_flow.dtype),
            (diff_bwd > thr).to(bwd_flow.dtype))
