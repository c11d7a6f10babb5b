"""GMFlow optical flow (reference archs/gmflow), ported from
comfyui_keep_tpu/models/gmflow.py.

CNN backbone (stride 8, InstanceNorm) -> sine position embedding -> 6
single-head transformer blocks with split-window attention (shifted on odd
layers), both images as one 2B batch -> global correlation softmax -> global
flow-propagation attention -> convex x8 upsampling.

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
from comfyui_keep_torch.ops import (conv2d, instance_norm, layer_norm, linear,
                                    relu)
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

    def forward(self, x):
        y = relu(instance_norm(conv2d(x, self.conv1.weight,
                                      stride=self.stride, padding=1)))
        y = relu(instance_norm(conv2d(y, self.conv2.weight, padding=1)))
        if self.downsample is not None:
            d = self.downsample[0]
            x = instance_norm(conv2d(x, d.weight, d.bias, stride=self.stride))
        return relu(x + y)


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128):
        super().__init__()
        dims = (64, 96, 128)
        self.conv1 = nn.Conv2d(3, dims[0], 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(dims[0], dims[0], 1),
                                    ResidualBlock(dims[0], dims[0], 1))
        self.layer2 = nn.Sequential(ResidualBlock(dims[0], dims[1], 2),
                                    ResidualBlock(dims[1], dims[1], 1))
        self.layer3 = nn.Sequential(ResidualBlock(dims[1], dims[2], 2),
                                    ResidualBlock(dims[2], dims[2], 1))
        self.conv2 = nn.Conv2d(dims[2], output_dim, 1)

    def forward(self, x):
        """(N, 3, H, W) normalised -> (N, C, H/8, W/8)."""
        x = relu(instance_norm(conv2d(x, self.conv1.weight, stride=2,
                                      padding=3)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return conv2d(x, self.conv2.weight, self.conv2.bias)


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
        # concat([src, msg]) @ W1 = src @ W1[:c] + msg @ W1[c:], fused with
        # gelu, W2, LayerNorm and the residual in one kernel
        w1 = self.mlp[0].weight  # (H, 2C)
        return K.mlp_fused(sw, msg, w1[:, :c].t().contiguous(),
                           w1[:, c:].t().contiguous(),
                           self.mlp[2].weight.t().contiguous(),
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


class FeatureFlowAttention(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)

    def forward(self, feature0, flow):
        """Global propagation: softmax(q k^T / sqrt(c)) @ flow. The
        reference's quirk is kept: key = k_proj(q_proj(x))."""
        b, h, w, c = feature0.shape
        q = linear(feature0.reshape(b, h * w, c), self.q_proj.weight,
                   self.q_proj.bias)
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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = feature_channels
        self.backbone = CNNEncoder(c)
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
        """(N, H, W, 3) in [0, 255] -> backbone features (N, H/8, W/8, C)."""
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

    def flow_from_features(self, f0, f1, attn_splits: int = 2):
        """Pair stages on backbone features (B, H, W, C) -> (fx, fy)."""
        f0, f1 = add_position(f0, f1, attn_splits, self.FEATURE_CHANNELS)
        f0, f1 = self.transformer_apply(f0, f1, attn_splits)
        flow = global_correlation_softmax(f0, f1)
        flow = self.feature_flow_attn(f0, flow)
        return upsample_flow_convex(self.upsampler, flow, f0,
                                    self.UPSAMPLE_FACTOR)


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
