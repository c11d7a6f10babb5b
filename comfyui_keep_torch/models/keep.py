"""KEEP: Kalman-inspired feature propagation for video face restoration
(reference keep_arch.py), ported from comfyui_keep_tpu/models/keep.py.

The public forward keeps the JAX package's layouts: `KEEP.apply` takes
(B, T, H, W, 3) in [-1, 1] and flows as (fx, fy) planes (B, T-1, H, W), and
returns (B, T, H, W, 3). Inside, feature maps are NCHW and the frame
recurrence (flow-warp of the previous output -> HQ encoder -> Kalman update
-> token transformer -> code pick -> generator with CFT/CFA fusion) is a
Python loop. The conv, GroupNorm and attention stacks are plain PyTorch.
"""
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from comfyui_keep_torch.models import layers as L
from comfyui_keep_torch.models.init import default_init_, finish, zero_
from comfyui_keep_torch.models.vqgan import (BlockStack, ResBlock,
                                             VectorQuantizer, encoder_plan,
                                             generator_plan)
from comfyui_keep_torch.ops import conv2d, flow_warp_xy, layer_norm, linear


def arch_tables(cfg):
    """(channels, fuse_encoder_block, fuse_generator_block) derived from the
    VQGAN config by walking the block plans. Encoder taps: after the last
    ResBlock of each level. Generator taps: after the first ResBlock of each
    upsampled level and after the last ResBlock of the latent level."""
    nf, ch_mult, nrb = cfg["nf"], cfg["ch_mult"], cfg["res_blocks"]
    img, attn_res = cfg["img_size"], cfg["attn_resolutions"]
    channels, enc_tap, gen_tap = {}, {}, {}
    idx, curr = 0, img
    for i in range(len(ch_mult)):
        for _ in range(nrb):
            idx += 1
            enc_tap[str(curr)] = idx
            channels[str(curr)] = nf * ch_mult[i]
            if curr in attn_res:
                idx += 1
        if i != len(ch_mult) - 1:
            idx += 1
            curr //= 2
    idx, curr = 3, img // 2 ** (len(ch_mult) - 1)
    for i in reversed(range(len(ch_mult))):
        first_level = i == len(ch_mult) - 1
        for b in range(nrb):
            idx += 1
            if (first_level and b == nrb - 1) or (not first_level and b == 0):
                gen_tap[str(curr)] = idx
            if curr in attn_res:
                idx += 1
        if i != 0:
            idx += 1
            curr *= 2
    return channels, enc_tap, gen_tap


DEFAULT_CFG = dict(
    img_size=512, nf=64, ch_mult=(1, 2, 2, 4, 4, 8), res_blocks=2,
    attn_resolutions=(16,), codebook_size=1024, emb_dim=256, beta=0.25,
    dim_embd=512, n_head=8, n_layers=9, latent_size=256,
    cft_list=("16", "32", "64"), cfa_list=("16", "32"), cfa_nhead=4,
    cfa_dim=256, kalman_attn_head_dim=48, num_uncertainty_layers=3,
    cond=1, cross_residual=True, temp_reg_list=("32",), mask_ratio=0.0,
)

VARIANTS = {
    "KEEP": dict(DEFAULT_CFG),
    "Asian": dict(DEFAULT_CFG, cft_list=("32", "64", "128", "256"),
                  temp_reg_list=()),
}


def config(variant: str = "KEEP", **overrides):
    cfg = dict(VARIANTS[variant])
    cfg.update(overrides)
    return cfg


class KalmanFilter(nn.Module):
    def __init__(self, emb_dim: int, n_head: int, head_dim: int,
                 n_layers: int):
        super().__init__()
        self.uncertainty_estimator = nn.ModuleList(
            L.BasicTransformerBlock(emb_dim, n_head, head_dim)
            for _ in range(n_layers))
        self.kalman_gain_calculator = nn.Sequential(
            ResBlock(emb_dim, emb_dim), ResBlock(emb_dim, emb_dim),
            ResBlock(emb_dim, emb_dim), nn.Conv2d(emb_dim, 1, 1))

    def calc_gain(self, z_codes):
        """z_codes: (B, T, C, h, w) -> gains (B, T, 1, h, w) in [0, 1]."""
        b, t, c, h, w = z_codes.shape
        x = z_codes.reshape(b * t, c, h * w).transpose(1, 2)
        for blk in self.uncertainty_estimator:
            x = blk(x, video_length=t)
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        g = self.kalman_gain_calculator
        x = g[2](g[1](g[0](x)))
        x = torch.sigmoid(conv2d(x, g[3].weight, g[3].bias))
        return x.reshape(b, t, 1, h, w)


def kalman_calc_gain(kf: KalmanFilter, z_codes):
    """JAX-layout form: z_codes (B, T, h, w, C) -> (B, T, h, w, 1)."""
    g = kf.calc_gain(z_codes.permute(0, 1, 4, 2, 3))
    return g.permute(0, 1, 3, 4, 2)


class KEEP(nn.Module):
    """The KEEP network. Parameter names are the reference's (with the
    current `cfa` / `cft` module names), without the flow net."""

    def __init__(self, variant: str = "KEEP", device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, **overrides):
        super().__init__()
        cfg = config(variant, **overrides)
        self.cfg = cfg
        self.enc_plan = encoder_plan(3, cfg["nf"], cfg["emb_dim"],
                                     cfg["ch_mult"], cfg["res_blocks"],
                                     cfg["img_size"], cfg["attn_resolutions"])
        self.gen_plan = generator_plan(cfg["nf"], cfg["emb_dim"],
                                       cfg["ch_mult"], cfg["res_blocks"],
                                       cfg["img_size"],
                                       cfg["attn_resolutions"])
        channels, self.enc_tap, self.gen_tap = arch_tables(cfg)
        e, d = cfg["emb_dim"], cfg["dim_embd"]
        self.encoder = BlockStack(self.enc_plan)
        self.hq_encoder = BlockStack(self.enc_plan)
        self.generator = BlockStack(self.gen_plan)
        self.quantize = VectorQuantizer(cfg["codebook_size"], e)
        self.kalman_filter = KalmanFilter(e, cfg["n_head"],
                                          cfg["kalman_attn_head_dim"],
                                          cfg["num_uncertainty_layers"])
        self.position_emb = nn.Parameter(torch.zeros(cfg["latent_size"], d))
        self.feat_emb = nn.Linear(e, d)
        self.ft_layers = nn.ModuleList(L.TransformerSALayer(d, 2 * d)
                                       for _ in range(cfg["n_layers"]))
        self.idx_pred_layer = nn.Sequential(
            nn.LayerNorm(d), nn.Linear(d, cfg["codebook_size"], bias=False))
        self.cfa = nn.ModuleDict({f: L.CFALayer(channels[f], cfg["cfa_nhead"],
                                                cfg["cfa_dim"])
                                  for f in cfg["cfa_list"]})
        self.cft = nn.ModuleDict({f: L.CFTBlock(channels[f], channels[f])
                                  for f in cfg["cft_list"]})
        if generator is not None:
            self._random_init(generator)
        finish(self, device, dtype)

    def _random_init(self, gen: torch.Generator):
        """Seeded random weights with the reference's structure: default
        conv/linear bounds, xavier in-projections, zero-initialised CFT and
        CFA transforms and temporal attention outputs."""
        default_init_(self, gen)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, L.MultiheadAttention):
                    e = m.in_proj_weight.shape[1]
                    bound = math.sqrt(6.0 / (2 * e))
                    m.in_proj_weight.copy_(torch.empty(3 * e, e).uniform_(
                        -bound, bound, generator=gen))
                    m.in_proj_bias.zero_()
                    m.out_proj.bias.zero_()
            n = self.cfg["codebook_size"]
            self.quantize.embedding.weight.copy_(torch.empty(
                self.quantize.embedding.weight.shape).uniform_(
                    -1.0 / n, 1.0 / n, generator=gen))
            w = self.idx_pred_layer[1].weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
            for blk in self.kalman_filter.uncertainty_estimator:
                blk.attn_temp.to_out[0].weight.zero_()
        for f in self.cft.values():
            zero_(f)
        for f in self.cfa.values():
            zero_(f.attn)
            zero_(f.ff)

    # -- forward pieces -------------------------------------------------------

    def tokens_to_code(self, z_hat, force_idx=None):
        """Latent (B, C, h, w) -> (quant (B, C, h, w), logits (B, L, N)).
        force_idx (B, L) replaces the argmax pick (teacher forcing)."""
        b, c, h, w = z_hat.shape
        q = linear(z_hat.flatten(2).transpose(1, 2), self.feat_emb.weight,
                   self.feat_emb.bias)
        for lp in self.ft_layers:
            q = lp(q, query_pos=self.position_emb, num_heads=self.cfg["n_head"])
        ln = self.idx_pred_layer[0]
        logits = linear(layer_norm(q, ln.weight, ln.bias),
                        self.idx_pred_layer[1].weight)
        idx = logits.argmax(dim=-1) if force_idx is None else force_idx
        quant = self.quantize.lookup(idx).reshape(b, h, w, -1)
        return quant.permute(0, 3, 1, 2), logits

    def decode_frame(self, quant, enc_feats_t: Dict[str, torch.Tensor],
                     prev_cfa: Dict[str, torch.Tensor], first: bool):
        """Generator pass for one frame with CFT skip fusion and CFA
        cross-frame fusion. Returns (frame, new cfa features)."""
        cfg = self.cfg
        cft_idx = {self.gen_tap[f]: f for f in cfg["cft_list"]}
        cfa_idx = {self.gen_tap[f]: f for f in cfg["cfa_list"]}
        x, new_cfa = quant, {}
        for j, blk in enumerate(self.generator.blocks):
            x = blk(x)
            if j in cft_idx:
                f = cft_idx[j]
                x = self.cft[f](enc_feats_t[f], x, cfg["cond"])
            if j in cfa_idx:
                f = cfa_idx[j]
                if not first:
                    x = self.cfa[f](x, prev_cfa[f],
                                    residual=cfg["cross_residual"])
                new_cfa[f] = x
        return x, new_cfa

    @torch.no_grad()
    def apply(self, x, flows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              *, return_aux: bool = False, force_indices=None):
        """x: (B, T, H, W, 3) in [-1, 1] -> (B, T, H, W, 3).

        flows: (fx, fy) planes, each (B, T-1, H, W) (flow_from_clip), or None
        for zero flow. force_indices: optional (B, T, L) code indices that
        replace the argmax picks. return_aux also returns
        {"logits": (B*T, L, N)}."""
        cfg = self.cfg
        b, t, h, w = x.shape[:4]
        if flows is None:
            fxs = fys = torch.zeros((b, t - 1, h, w), dtype=x.dtype,
                                    device=x.device)
        else:
            fxs, fys = flows

        tap = {self.enc_tap[f]: f for f in cfg["cft_list"]}
        xf = x.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
        z, taps = self.encoder(xf, tap_indices=list(tap))
        enc_feats = {tap[i]: v.reshape((b, t) + v.shape[1:])
                     for i, v in taps.items()}
        z_codes = z.reshape((b, t) + z.shape[1:])
        gains = self.kalman_filter.calc_gain(z_codes)

        def forced(i):
            return None if force_indices is None else force_indices[:, i]

        quant, logits0 = self.tokens_to_code(z_codes[:, 0], forced(0))
        out, cfa = self.decode_frame(
            quant, {f: enc_feats[f][:, 0] for f in cfg["cft_list"]}, {},
            first=True)
        outs, logits = [out], [logits0]
        for i in range(1, t):
            warped = flow_warp_xy(out, fxs[:, i - 1], fys[:, i - 1])
            z_prime = self.hq_encoder(warped)
            g = gains[:, i]
            z_hat = (1.0 - g) * z_codes[:, i] + g * z_prime
            quant, logit = self.tokens_to_code(z_hat, forced(i))
            out, cfa = self.decode_frame(
                quant, {f: enc_feats[f][:, i] for f in cfg["cft_list"]}, cfa,
                first=False)
            outs.append(out)
            logits.append(logit)
        res = torch.stack(outs, dim=1).permute(0, 1, 3, 4, 2)
        if not return_aux:
            return res
        logits = torch.stack(logits, dim=1)
        return res, {"logits": logits.reshape((b * t,) + logits.shape[2:])}
