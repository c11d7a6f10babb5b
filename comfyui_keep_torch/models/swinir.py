"""SwinIR (reference archs/swinir_arch.py), ported from comfyui_keep_tpu/
models/swinir.py: a shallow convolution, residual Swin transformer blocks
(window attention with a relative-position bias, every second block on
windows shifted by half a window under the shifted-window mask), and the
reconstruction: "pixelshuffle", "pixelshuffledirect", "nearest+conv" or
"" (denoising / JPEG: the input plus a residual).

NCHW at the convolutions, (B, L, C) tokens in the transformer. The window
attention is plain PyTorch, as the JAX package computes it outside any
Pallas kernel: scores, the bias, the mask, a softmax and the product.
Any H and W: as the reference's check_image_size does, the input is
reflect-padded at the bottom and right to window multiples, and the output
cropped to H s x W s (the JAX package takes window multiples only, where
the two agree). Module names are the reference's
(layers.{i}.residual_group.blocks.{j}.attn.qkv, ...); the reference's
computed buffers (relative_position_index, attn_mask) are not state here,
so its .pth loads once they are dropped (facelib/factory.py's
load_reference drops them).
"""
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.models.sr_basic import (RGB_MEAN, conv3x3,
                                                pixel_shuffle, run_upsample,
                                                upsample_layers)
from comfyui_keep_torch.ops import gelu, layer_norm, leaky_relu, linear
from comfyui_keep_torch.ops.resample import resize_nearest
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

NUM_FEAT = 64


def rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(N, N) index into the (2 wh - 1)(2 ww - 1) bias table."""
    ch, cw = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    coords = np.stack([ch.reshape(-1), cw.reshape(-1)])
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def attn_mask(h: int, w: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """(nW, N, N) float32: -100 between tokens of a shifted window that come
    from different regions of the rolled image, else 0."""
    if shift == 0:
        return None
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B nW, ws^2, C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_merge(x, ws: int, h: int, w: int):
    """The inverse of window_partition: (B nW, ws^2, C) -> (B, H, W, C)."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x, rel_index, mask=None):
        """x: (nW B, N, C) windows; rel_index (N, N); mask (nW, N, N)."""
        nb, n, c = x.shape
        nh = self.num_heads
        qkv = linear(x, self.qkv.weight, self.qkv.bias).reshape(
            nb, n, 3, nh, c // nh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scale = (c // nh) ** -0.5
        ct = torch.promote_types(x.dtype, torch.float32)
        attn = torch.matmul((q * scale).to(ct), k.to(ct).transpose(-2, -1))
        bias = self.relative_position_bias_table[rel_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1)[None].to(ct)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(nb // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(nb, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nb, n, c)
        return linear(out, self.proj.weight, self.proj.bias)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(gelu(linear(x, self.fc1.weight, self.fc1.bias)),
                      self.fc2.weight, self.fc2.bias)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: float):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size: Tuple[int, int], cache: Dict):
        h, w = x_size
        b, l, c = x.shape
        ws = min(self.window_size, min(h, w))
        sh = 0 if min(h, w) <= self.window_size else self.shift
        if h % ws or w % ws:     # SwinIR.forward pads to window multiples
            raise ValueError(f"SwinIR: H and W ({h}, {w}) must be multiples "
                             f"of the window ({ws})")
        rel, mask = window_tables(cache, h, w, ws, sh, x.device)
        xn = layer_norm(x, self.norm1.weight, self.norm1.bias).reshape(
            b, h, w, c)
        if sh > 0:
            xn = torch.roll(xn, (-sh, -sh), dims=(1, 2))
        attn = self.attn(window_partition(xn, ws), rel, mask)
        xn = window_merge(attn, ws, h, w)
        if sh > 0:
            xn = torch.roll(xn, (sh, sh), dims=(1, 2))
        x = x + xn.reshape(b, l, c)
        return x + self.mlp(layer_norm(x, self.norm2.weight, self.norm2.bias))


def window_tables(cache: Dict, h: int, w: int, ws: int, shift: int, device):
    """The relative-position index and the shifted-window mask for an
    (h, w) map, made once per shape and device."""
    key = (h, w, ws, shift, str(device))
    if key not in cache:
        mask = attn_mask(h, w, ws, shift)
        cache[key] = (torch.as_tensor(rel_pos_index(ws, ws), device=device),
                      None if mask is None else torch.as_tensor(
                          mask, device=device))
    return cache[key]


class RSTB(nn.Module):
    """A residual group of Swin blocks (shift 0, ws // 2, 0, ...) and a 3x3
    convolution ("1conv")."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if j % 2 == 0 else window_size // 2,
                                 mlp_ratio) for j in range(depth)])
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, tokens, x_size, cache):
        t = tokens
        for blk in self.residual_group.blocks:
            t = blk(t, x_size, cache)
        b, (h, w), c = t.shape[0], x_size, t.shape[2]
        img = t.transpose(1, 2).reshape(b, c, h, w)
        img = conv3x3(self.conv, img)
        return img.flatten(2).transpose(1, 2) + tokens


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """x (B, C, H, W) in [0, 1] -> (B, C, H s, W s), any H and W (padded
    to window_size multiples and cropped back). The input is centred on
    RGB_MEAN (3 channels) and scaled by img_range, and the output brought
    back."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "", resi_connection: str = "1conv",
                 patch_norm: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if resi_connection != "1conv":
            raise ValueError("resi_connection: only '1conv' (as the JAX "
                             "package)")
        if upsampler not in ("pixelshuffle", "pixelshuffledirect",
                             "nearest+conv", ""):
            raise ValueError(f"upsampler {upsampler!r}")
        self.in_chans, self.upscale = in_chans, upscale
        self.window_size = window_size
        self.img_range, self.upsampler = img_range, upsampler
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        if patch_norm:
            self.patch_embed = nn.Module()
            self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, d, h, window_size, mlp_ratio)
            for d, h in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, NUM_FEAT, 3, 1, 1), nn.LeakyReLU())
            self.upsample = upsample_layers(upscale, NUM_FEAT)
            self.conv_last = nn.Conv2d(NUM_FEAT, in_chans, 3, 1, 1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                nn.Conv2d(embed_dim, in_chans * upscale ** 2, 3, 1, 1),
                nn.PixelShuffle(upscale))
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, NUM_FEAT, 3, 1, 1), nn.LeakyReLU())
            self.conv_up1 = nn.Conv2d(NUM_FEAT, NUM_FEAT, 3, 1, 1)
            self.conv_up2 = nn.Conv2d(NUM_FEAT, NUM_FEAT, 3, 1, 1)
            self.conv_hr = nn.Conv2d(NUM_FEAT, NUM_FEAT, 3, 1, 1)
            self.conv_last = nn.Conv2d(NUM_FEAT, in_chans, 3, 1, 1)
        else:
            self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)
        self._tables: Dict = {}
        if generator is not None:
            default_init_(self, generator)
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, WindowAttention):
                        m.relative_position_bias_table.copy_(torch.randn(
                            m.relative_position_bias_table.shape,
                            generator=generator) * 0.02)
        finish(self, device, dtype)

    def forward_features(self, x):
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        if hasattr(self, "patch_embed"):
            n = self.patch_embed.norm
            tokens = layer_norm(tokens, n.weight, n.bias)
        for layer in self.layers:
            tokens = layer(tokens, (h, w), self._tables)
        tokens = layer_norm(tokens, self.norm.weight, self.norm.bias)
        return tokens.transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x):
        h, w = x.shape[2:]
        ws = self.window_size
        pad_h, pad_w = -h % ws, -w % ws
        if pad_h or pad_w:       # the reference's check_image_size
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        mean = (torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).view(
            1, 3, 1, 1) if self.in_chans == 3 else 0.0)
        x = (x - mean) * self.img_range
        feat = conv3x3(self.conv_first, x)
        feat = conv3x3(self.conv_after_body,
                       self.forward_features(feat)) + feat
        if self.upsampler == "pixelshuffle":
            feat = leaky_relu(conv3x3(self.conv_before_upsample[0], feat),
                              0.01)
            out = conv3x3(self.conv_last, run_upsample(self.upsample, feat))
        elif self.upsampler == "pixelshuffledirect":
            out = pixel_shuffle(conv3x3(self.upsample[0], feat),
                                self.upscale)
        elif self.upsampler == "nearest+conv":
            feat = leaky_relu(conv3x3(self.conv_before_upsample[0], feat),
                              0.01)
            for conv in (self.conv_up1, self.conv_up2):
                feat = leaky_relu(conv3x3(conv, resize_nearest(
                    feat, (feat.shape[2] * 2, feat.shape[3] * 2))), 0.2)
            out = conv3x3(self.conv_last,
                          leaky_relu(conv3x3(self.conv_hr, feat), 0.2))
        else:
            out = x + conv3x3(self.conv_last, feat)
        out = out / self.img_range + mean
        if pad_h or pad_w:
            s = out.shape[2] // x.shape[2]
            out = out[:, :, :h * s, :w * s]
        return out
