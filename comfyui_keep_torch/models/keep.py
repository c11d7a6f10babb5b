"""KEEP: Kalman-inspired feature propagation for video face restoration
(reference keep_arch.py), ported from comfyui_keep_tpu/models/keep.py.

The public forwards keep the JAX package's layouts: `KEEP.apply`
(inference) and `KEEP.forward` (training, with gradients and the auxiliary
outputs of the losses) take (B, T, H, W, 3) in [-1, 1] and flows as
(fx, fy) planes (B, T-1, H, W), and return (B, T, H, W, 3). Inside,
feature maps are NCHW and the frame recurrence (flow-warp of the previous
output -> HQ encoder -> Kalman update -> token transformer -> code pick ->
generator with CFT/CFA fusion) is a Python loop. The conv, GroupNorm and
attention stacks are plain PyTorch.
"""
import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from comfyui_keep_torch.models import layers as L
from comfyui_keep_torch.models.init import (default_init_, finish,
                                            shared_copy, zero_)
from comfyui_keep_torch.models.vqgan import (BlockStack, ResBlock,
                                             VectorQuantizer, encoder_plan,
                                             generator_plan,
                                             packed_generator_tail,
                                             phase512_prepare,
                                             phase_encoder_end,
                                             phase_generator_start)
from comfyui_keep_torch.ops import (conv2d, flow_warp_xy, layer_norm, linear,
                                    resize_bilinear)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


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


@ARCH_REGISTRY.register()
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

    def prepare_phase512(self, levels: int = 1,
                         enc_levels: int = 1) -> "KEEP":
        """Serving-time weight preparation (the JAX package's
        prepare_phase512; its KEEP_TPU_PHASE_LEVELS and
        KEEP_TPU_PHASE_ENC_LEVELS are the keywords here): a copy of this
        network, sharing its parameters, whose encoders run their top
        `enc_levels` levels phase-packed (capped at the last Downsample)
        and whose generator runs its last `levels` Upsample levels packed,
        of those with no CFT/CFA/temporal tap at or after them
        (ops/phase_pack.py). The packed weights are non-persistent buffers
        of the copy, so state_dict() keys do not change and this network
        stays unpacked. Off img_size 512 this network itself is returned.
        Do not train the copy: gradients would not reach the parameters."""
        if levels < 1 or enc_levels < 1:
            raise ValueError(f"packing levels start at 1, got levels="
                             f"{levels}, enc_levels={enc_levels}")
        cfg = self.cfg
        if cfg["img_size"] != 512:
            return self
        net = shared_copy(self)
        # a tap inside the packed prefix is unpacked at tap time, so no
        # fusion constraint applies to the encoders
        end = phase_encoder_end(self.enc_plan, max_levels=enc_levels)
        if end is not None:
            phase512_prepare(net.encoder, range(end + 1))
            phase512_prepare(net.hq_encoder, range(end + 1))
        fuse = {self.gen_tap[f] for f in (tuple(cfg["cft_list"])
                                          + tuple(cfg["cfa_list"])
                                          + tuple(cfg["temp_reg_list"]))}
        start = phase_generator_start(self.gen_plan, fuse, max_levels=levels)
        if start is not None:
            phase512_prepare(net.generator, range(start, len(self.gen_plan)))
        return net

    def int8_acts_copy(self) -> "KEEP":
        """A copy of this network, sharing its parameters (and any packed
        buffers), whose encoder, HQ encoder and generator store their
        activations as int8 at block boundaries (the JAX package's
        KEEP_TPU_INT8_ACTS; vqgan._quant_boundary): the encoders' stacks
        and the generator's packed tail, not decode_frame's unpacked loop,
        as in JAX. Serving only: it raises while gradients are
        recorded."""
        net = shared_copy(self)
        for stack in (net.encoder, net.hq_encoder, net.generator):
            stack.int8_acts = True
        return net

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
        cross-frame fusion. Returns (frame, new cfa features, the
        temp_reg_list taps {f: (B, c, s, s)} taken after the fusions). A
        prepared generator switches to its packed tail at its first packed
        Upsample (no fusion tap lands there: prepare_phase512 checks)."""
        cfg = self.cfg
        cft_idx = {self.gen_tap[f]: f for f in cfg["cft_list"]}
        cfa_idx = {self.gen_tap[f]: f for f in cfg["cfa_list"]}
        temp_idx = {self.gen_tap[f]: f for f in cfg["temp_reg_list"]}
        tail = self.generator.packed_tail_start()
        x, new_cfa, gen_feats = quant, {}, {}
        for j, blk in enumerate(self.generator.blocks):
            if j == tail:
                x = packed_generator_tail(self.generator, x, j)
                break
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
            if j in temp_idx:
                gen_feats[temp_idx[j]] = x
        return x, new_cfa, gen_feats

    def code_and_decode(self, z_hat, enc_t, prev_cfa, force_t=None,
                        first: bool = False):
        """Pick the codes of a latent (B, C, h, w) and decode them: returns
        decode_frame's (frame, new cfa features, taps) and the logits. The
        picked codes carry no gradient."""
        quant, logit = self.tokens_to_code(z_hat, force_t)
        return self.decode_frame(quant.detach(), enc_t, prev_cfa,
                                 first) + (logit,)

    def step(self, prev_out, prev_cfa, z_t, gain_t, fx_t, fy_t, enc_t,
             force_t=None):
        """One frame of the recurrence, shared by forward() and
        apply_chunks(): warp the previous output (B, 3, H, W) by the flow
        planes (B, H, W), re-encode it with the HQ encoder, blend it into the
        LQ latent z_t by the Kalman gain, then code_and_decode."""
        warped = flow_warp_xy(prev_out.detach(), fx_t, fy_t)
        z_prime = self.hq_encoder(warped)
        return self.code_and_decode((1.0 - gain_t) * z_t + gain_t * z_prime,
                                    enc_t, prev_cfa, force_t)

    def encode_clip(self, x):
        """The batched, non-recurrent stages of a clip stack x (B, T, H, W,
        3): the LQ encoder over all B*T frames with its CFT taps, and the
        Kalman gains. Returns z (B*T, C, h, w), the taps {f: (B, T, c, s,
        s)} (detached), z_codes (B, T, C, h, w) and the gains (B, T, 1, h,
        w)."""
        b, t, h, w = x.shape[:4]
        tap = {self.enc_tap[f]: f for f in self.cfg["cft_list"]}
        xf = x.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
        z, taps = self.encoder(xf, tap_indices=list(tap))
        enc_feats = {tap[i]: v.detach().reshape((b, t) + v.shape[1:])
                     for i, v in taps.items()}
        z_codes = z.reshape((b, t) + z.shape[1:])
        return z, enc_feats, z_codes, self.kalman_filter.calc_gain(z_codes)

    def forward(self, x, flows=None, *, force_indices=None, carry=None,
                return_carry: bool = False, need_upscale: bool = False):
        """The grad-enabled forward of training (the JAX package's
        KEEP.apply with detach_16=True and return_aux=True).

        x: (B, T, H, W, 3) in [-1, 1]. flows: (fx, fy) planes, each
        (B, T-1, H, W) (flow_from_clip), or None for zero flow.
        force_indices: optional (B, T, L) code indices that replace the
        argmax picks. Returns (outs (B, T, H, W, 3), {"logits": (B*T, L, N),
        "lq_feat": (B*T, h, w, C), "gen_feat_dict": {f: (B, T, s, s, c)}}).
        need_upscale=True first resizes x by 4 (bilinear, align_corners
        False; keep_arch.py's need_upscale), and the flows are then those of
        the upscaled frames.

        carry / return_carry (the JAX package's streaming extension):
        carry = (prev_out (B, H, W, 3), {f: (B, s, s, c)} CFA features), as
        a return_carry=True call returns it after its last frame. With a
        carry every frame, frame 0 included, propagates from the carried
        state, so flows then hold T planes, flow 0 mapping frame 0 back to
        the carried frame. return_carry=True returns ((outs, aux), carry).

        Gradients stop where the JAX package stops them: at the flows, the
        CFT encoder taps, the warped previous output and the picked codes;
        lq_feat and the Kalman gains keep theirs. While gradients are
        recorded, what the JAX package rematerialises is recomputed in the
        backward pass with torch.utils.checkpoint: each res/attn block of the
        encoders and each frame step after the first."""
        cfg = self.cfg
        if need_upscale:
            b, t, h, w = x.shape[:4]
            x = resize_bilinear(x.reshape(b * t, h, w, 3).permute(0, 3, 1, 2),
                                (4 * h, 4 * w))
            x = x.permute(0, 2, 3, 1).reshape(b, t, 4 * h, 4 * w, 3)
        b, t, h, w = x.shape[:4]
        # frame i's flow is plane i - off: T planes with a carry, T-1 without
        off = 0 if carry is not None else 1
        if flows is None:
            fxs = fys = torch.zeros((b, t - off, h, w), dtype=x.dtype,
                                    device=x.device)
        else:
            fxs, fys = flows
        fxs, fys = fxs.detach(), fys.detach()
        z, enc_feats, z_codes, gains = self.encode_clip(x)

        def frame(i):
            """Frame i's inputs after the previous output and features."""
            return (z_codes[:, i], gains[:, i], fxs[:, i - off],
                    fys[:, i - off],
                    {f: enc_feats[f][:, i] for f in cfg["cft_list"]},
                    None if force_indices is None else force_indices[:, i])

        if carry is None:
            out, cfa, gen_feats, logit = self.code_and_decode(
                z_codes[:, 0], {f: enc_feats[f][:, 0] for f in cfg["cft_list"]},
                {}, None if force_indices is None else force_indices[:, 0],
                first=True)
            outs, logits, feats = [out], [logit], [gen_feats]
        else:
            out = carry[0].permute(0, 3, 1, 2)
            cfa = {f: v.permute(0, 3, 1, 2) for f, v in carry[1].items()}
            outs, logits, feats = [], [], []
        for i in range(off, t):
            if torch.is_grad_enabled():
                out, cfa, gen_feats, logit = checkpoint(
                    self.step, out, cfa, *frame(i), use_reentrant=False)
            else:
                out, cfa, gen_feats, logit = self.step(out, cfa, *frame(i))
            outs.append(out)
            logits.append(logit)
            feats.append(gen_feats)
        res = torch.stack(outs, dim=1).permute(0, 1, 3, 4, 2)
        logits = torch.stack(logits, dim=1)
        aux = {"logits": logits.reshape((b * t,) + logits.shape[2:]),
               "lq_feat": z.permute(0, 2, 3, 1),
               "gen_feat_dict": {
                   f: torch.stack([g[f] for g in feats], dim=1).permute(
                       0, 1, 3, 4, 2) for f in feats[0]}}
        if not return_carry:
            return res, aux
        return (res, aux), (out.permute(0, 2, 3, 1),
                            {f: v.permute(0, 2, 3, 1) for f, v in cfa.items()})

    @torch.no_grad()
    def apply(self, x, flows=None, *, return_aux: bool = False,
              force_indices=None, carry=None, return_carry: bool = False,
              need_upscale: bool = False):
        """Inference forward: x (B, T, H, W, 3) in [-1, 1] ->
        (B, T, H, W, 3) (4H x 4W with need_upscale), and with return_aux
        also forward()'s aux dict; with return_carry (res, carry). flows,
        force_indices, the carry and need_upscale as for forward()."""
        (res, aux), new_carry = self.forward(
            x, flows, force_indices=force_indices, carry=carry,
            return_carry=True, need_upscale=need_upscale)
        res = (res, aux) if return_aux else res
        return (res, new_carry) if return_carry else res

    @torch.no_grad()
    def apply_chunks(self, x, flows=None, *, force_indices=None):
        """Serving form for G independent chunks, x (G, T, H, W, 3) in
        [-1, 1] -> (G, T, H, W, 3): equal to G calls of apply(x[i:i+1]) (each
        chunk starts from a reset state) up to the summation order of the
        batched stages. The LQ encoder with its CFT taps, the Kalman gains
        and frame 0's pick and decode run batched over the G*T frames; the
        recurrence over frames 1..T-1 runs one chunk at a time (B = 1).
        flows: (fx, fy) planes, each (G, T-1, H, W) (flow_from_clip on the
        stack), or None for zero flow; force_indices: optional (G, T, L)
        picks, as for apply()."""
        cfg = self.cfg
        g, t, h, w = x.shape[:4]
        if flows is None:
            fxs = fys = torch.zeros((g, t - 1, h, w), dtype=x.dtype,
                                    device=x.device)
        else:
            fxs, fys = flows
        _, enc_feats, z_codes, gains = self.encode_clip(x)

        out0, cfa0, _, _ = self.code_and_decode(
            z_codes[:, 0], {f: enc_feats[f][:, 0] for f in cfg["cft_list"]},
            {}, None if force_indices is None else force_indices[:, 0],
            first=True)
        chunks = []
        for c in range(g):
            out = out0[c:c + 1]
            cfa = {f: v[c:c + 1] for f, v in cfa0.items()}
            outs = [out]
            for i in range(1, t):
                out, cfa, _, _ = self.step(
                    out, cfa, z_codes[c:c + 1, i], gains[c:c + 1, i],
                    fxs[c:c + 1, i - 1], fys[c:c + 1, i - 1],
                    {f: enc_feats[f][c:c + 1, i] for f in cfg["cft_list"]},
                    None if force_indices is None
                    else force_indices[c:c + 1, i])
                outs.append(out)
            chunks.append(torch.cat(outs, dim=0))
        return torch.stack(chunks).permute(0, 1, 3, 4, 2)


def mask_by_ratio(z_codes, mask_ratio: float = 0.0,
                  generator: Optional[torch.Generator] = None):
    """Training-time random token masking (keep_arch.py:988-1006):
    z_codes (B, T, h, w, C); in each frame the int(h*w*(1-mask_ratio))
    tokens of highest uniform score are kept, the rest zeroed."""
    if mask_ratio == 0:
        return z_codes
    b, t, h, w, _ = z_codes.shape
    d = h * w
    keep = int(d * (1 - mask_ratio))
    scores = torch.rand((b, t, d), generator=generator,
                        device=z_codes.device)
    thresh = scores.sort(dim=-1, descending=True).values[..., keep - 1:keep]
    mask = (scores >= thresh).to(z_codes.dtype).reshape(b, t, h, w, 1)
    return z_codes * mask


def count_parameters(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
