#!/usr/bin/env python3
"""Drive the PyTorch port (comfyui_keep_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (the last two lines are the kernel table and
the verdict):
  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds csrc/*.cu into build/kernels/ (seconds)
  3. kernel   every GMFlow kernel against its plain PyTorch version on the
              card at the main path's shapes, in bf16 and f32: max|d| and
              its tolerance, kernel ms, plain ms, one PyTorch library call's
              ms as a yardstick (the port never calls it), and the bound;
              for the MLP tail, which no one call computes, the ms of its
              unfused PyTorch calls instead (unfused_ms, reported); the f32
              MLP tail also at the f32 training step's 114,688 rows
              (mlp_fused[step])
  4. kernel   (packed_conv2x2, K6) the phase-packed convolution at every
              shape of the packed 512-level path and at its own shape over
              the LQ encoder's 20-frame batch, bf16 and f32: max|d| and
              tolerance, kernel / plain / library ms (cuDNN's conv2d on the
              same packed tensor, channels-last), the ms of the unpacked
              3x3 convolution at 512^2 it replaces, and the bound; at each
              shape whose output the path masks (pad 1), a second row with
              the fused bias and parity-1 mask against plain + bias + mask,
              beside the bias add and mask launches it replaces (unfused_ms)
  5. gmflow   flow_from_clip on a 2-frame 512x512 clip, f32: card (kernels)
              against CPU (plain versions), max|d| in pixels
  6. keep     KEEP.apply on the same clip and flows, f32: card against CPU
              (unpacked), code picks teacher-forced from the CPU run, first
              unpacked, then phase-packed (prepare_phase512, 24 K6
              launches: the f32 kernel's launches in the kernel table);
              outputs and logits
  7. main     api.load_models(seed=0) -> load_device(bf16) ->
              processor(bf16, phase512=True).restore_face_stream(21 faces,
              20 per chunk), the 512 level phase-packed: faces/s, ms per
              20-frame chunk and the kernel launch counts (K6: 12 per
              frame, 264); main_unpacked: the same with phase512=False, K6
              = 0, and the packed-against-unpacked uint8 difference
              (reported). Before them, `default`: both chunks timed in turns
              over 10 pairs, their medians and ratio, and whether ROADMAP's
              condition for packing by default holds in this run (K6 at its
              own shape within 1.5x of cuDNN's 2x2, packed median no slower)
              beside the processor's default
  8. stream   restore_face_stream(21 faces, carry_chunks=True): the state
              carried into a 1-frame second chunk; finite outputs and the
              launches the path implies (K6 240 + 18)
     api      the node entry points without OpenCV: api.restore_image on
              an aligned 512^2 face at factor 1 and a 400^2 face at 1.5,
              api.restore_sequence on 3 aligned 512^2 frames at factor 2:
              shapes, uint8, the image within 1 level of restore_face_stream
              on the same resized face, the frames equal to the resized
              inputs, each call's launches, cv2 never imported
  9. kernel   (vq) the nearest-codebook kernel against its plain version at
              the training step's shape, T = 4096 tokens against N = 1024
              codes of C = 256, in f32 and bf16, on tokens drawn near codes
              of varied norms: picks, kernel/plain/addmm+argmin ms, the
              kernel's and addmm+argmin's device ms (profiler), bound
 10. train_parity  one KEEP stage-II step of a tiny config (GMFlow 128
              channels, 2 layers, a 64x64 clip of 3 frames), card (kernels)
              against CPU (plain versions): in f32 the loss terms and
              per-leaf gradients, the code-pick margins asserted first;
              in bf16 mixed precision the same at bf16's resolution
 11. train    options/train_keep_stage2.yml's step at full width (KEEP
              512x512, VQHQEncoder, GMFlow; B=2 x 8 frames, random weights
              and clips), f32 as configured, then mixed precision: ms/step,
              frames/s, peak GiB, losses, launches per step; frozen leaves
              unchanged, trainable ones moved, the EMA rule held
 12. kernel   (fused_bias_lrelu) the fused bias + leaky ReLU kernel against
              its plain version at StyleGAN2's largest activation, (4, 32,
              1024, 1024), and at the mapping MLP's (4, 512), in bf16 and
              f32: max|d| in units of the last place (at most 1), kernel
              and plain ms, the bound; then fused_leaky_relu's value, x- and
              bias-gradients and a second-order term, card against CPU
 13. stylegan2_parity  a narrow StyleGAN2 (64x64, channel multiplier 1,
              narrow 0.25, 64 style features, 2 mapping layers), f32, card
              (kernels) against CPU (plain versions): the image and the D
              logits, then one GAN alternation at iteration 16 (R1 and the
              path penalty both fire) from one warm state (the CPU's after
              alternation 15) and the same draws: losses, mean path length,
              Adam moments and updated leaves
 14. stylegan2_sample  StyleGAN2Generator config-f at 1024x1024 (512 style
              features, 8 mapping layers, channel multiplier 2), B=4 codes,
              bf16 then f32: ms per batch, images/s, peak GiB, a finite
              image, K5 launches per forward from its counter (25)
 15. stylegan2_train  StyleGAN2Model at 256x256 (channel multiplier 2, G and
              D), B=4 random real images, f32, 16 alternations after a
              warm-up (R1 once, the path penalty four times): ms of a plain,
              a path and the R1 + path alternation, peak GiB, losses, K5
              launches per alternation; the EMA rule, D and G leaves moved
Every phase that counts launches counts K6 too: the training and StyleGAN2
phases expect none. The script exits non-zero, printing no verdict, if
there is no CUDA device, if a kernel does not build or disagrees, or if any
phase fails. TF32 is off for matmuls and convolutions, so f32 means f32.
"""
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
HBM = 3.35e12        # H100 SXM device memory bytes/s
# relative tolerance of a kernel against its plain version, scaled by the
# plain output's spread, max|plain - mean(plain)|: bf16 outputs round to 8
# bits (4 ulps allowed for the different rounding points of the online
# softmax); f32 differs only in the order of summation and exp2 against exp
KERNEL_RTOL = {"bfloat16": 1.6e-2, "float32": 1e-4}
FLOW_TOL_PX = 5e-2           # GMFlow card against CPU, pixels
KEEP_ATOL, KEEP_RTOL = 5e-3, 1e-2   # KEEP forward tolerance of the golden tests
FRAMES, WINDOWS, FEAT, CH, HID = 20, 4, 64, 128, 1024
STEP_PAIRS = 14      # the f32 training step's GMFlow: B=2 clips x 7 pairs
KERNEL_ITERS = 20    # timed launches per kernel (a quarter for plain versions)
MAIN_PAIRS = 10      # packed / unpacked chunk pairs timed in turns
VQ_T, VQ_N, VQ_C = 4096, 1024, 256   # B=2 x 8 frames x 16x16 latents
# both dtypes accumulate the products in f32 (bf16 products are exact), so
# kernel and plain distances differ by summation order only
VQ_RTOL = 1e-5
TRAIN_STEPS = 3      # timed steps per training run, after one warm-up step
# loss terms and per-leaf gradients, card against CPU (and port against JAX
# in tests/test_torch_training.py)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-3, 1e-7
# least top-1/top-2 gap, relative to the largest value, of the code logits
# and of the ground-truth code distances: ~100x their f32 error
LOGIT_MARGIN_RTOL, DIST_MARGIN_RTOL = 1e-4, 1e-5
# bf16 mixed precision, card against CPU (and port against JAX in the
# tests): each loss term, and each leaf's gradient in L2, within 3x the
# CPU's own bf16-to-f32 distance for it, plus 2 % of the term or the f32
# gradient tolerance (bf16 rounding moves a weak leaf's gradient as far as
# its own size, and a small loss term such as the temporal one by 3 %)
MP_LOSS_RTOL, MP_GRAD_RATIO = 2e-2, 3.0
# StyleGAN2 (K5 and its paths)
K5_SHAPES = ((4, 32, 1024, 1024), (4, 512))   # largest conv act, mapping MLP
SG2_TOL = dict(atol=2e-3, rtol=1e-2)   # tests/test_stylegan2_golden.py:78
# the alternation, card against CPU, f32, from one warm state. l_d comes
# before any update and is held to LOSS_RTOL. R1 and the path penalty are
# gradient norms through leaky ReLUs: one activation that rounding moves
# across zero moves them by ~1e-3 of themselves (measured on the CPU at
# 32x32), and G's gradient reaches it through D's activations. So the losses
# taken after an update are held to SG2_POST_RTOL; the Adam moments (the
# last sub-steps' gradients, the running squares) of G and of D, each as one
# vector over all its leaves, in L2 to SG2_MOMENT_RTOL (a single leaf, such
# as a noise weight's one-element gradient, a sum of many terms of either
# sign, moved by 2.7-7 % in card runs); and at least SG2_LEAF_SHARE of all
# updated elements to GRAD_RTOL * max|update of the leaf| + GRAD_ATOL (0.3
# to 0.6 % of G's elements fell outside in card runs: Adam divides each
# element's gradient by its own running size, so a small gradient's error
# comes through whole). A wrong weight, sign or beta moves every element.
SG2_POST_RTOL, SG2_MOMENT_RTOL, SG2_LEAF_SHARE = 5e-2, 2e-2, 0.95
SG2_PARITY = dict(out_size=64, num_style_feat=64, num_mlp=2,
                  channel_multiplier=1, narrow=0.25)
SG2_SAMPLE = dict(out_size=1024, num_style_feat=512, num_mlp=8,
                  channel_multiplier=2)   # config-f
SG2_BATCH, SG2_TRAIN_SIZE, SG2_ALTERNATIONS = 4, 256, 16
# K6 at the packed path's shapes, per frame (the LQ encoder batches a chunk's
# 20 frames): (label, B, Hi = Wi, Cin, Cout, pads, the unpacked 3x3 conv at
# 512^2 it replaces as (kind, Cin, Cout)). kh = kw = 2 throughout.
K6_SAME, K6_VALID = ((1, 1), (1, 1)), ((0, 0), (0, 0))
K6_CASES = (
    ("encoder conv 0, parity 0->1", 1, 256, 12, 256, K6_SAME, ("conv", 3, 64)),
    ("res conv2, parity 0->1", 1, 256, 256, 256, K6_SAME, ("conv", 64, 64)),
    ("res conv1, parity 1->0 (K6's own)", 1, 257, 256, 256, K6_VALID,
     ("conv", 64, 64)),
    ("generator res 128->64 conv1", 1, 257, 512, 256, K6_VALID,
     ("conv", 128, 64)),
    ("generator final conv", 1, 257, 256, 12, K6_VALID, ("conv", 64, 3)),
    ("downsample", 1, 257, 256, 64, K6_VALID, ("down", 64, 64)),
    ("upsample conv", 1, 256, 128, 512, K6_SAME, ("up", 128, 128)),
    ("res conv1, LQ encoder batch of 20", FRAMES, 257, 256, 256, K6_VALID,
     ("conv", 64, 64)),
)
K6_OWN = K6_CASES[2][0]

# options/train_keep_stage2.yml as a dict: the card machine is not specified
# to have pyyaml. tests/test_torch_training.py checks that the two agree.
TRAIN_OPT = {
    "model_type": "KEEPModel",
    "manual_seed": 0,
    "network_g": {
        "type": "KEEP", "img_size": 512, "nf": 64, "ch_mult": [1, 2, 2, 4, 4, 8],
        "dim_embd": 512, "n_head": 8, "n_layers": 9, "codebook_size": 1024,
        "cft_list": ["16", "32", "64"], "cfa_list": ["16", "32"],
        "fix_modules": ["quantize", "generator"], "temp_reg_list": ["32"]},
    "datasets": {"train": {"num_frame": 8, "batch_size_per_gpu": 2}},
    "train": {
        "use_hq_feat_loss": True, "feat_loss_weight": 1.0,
        "cross_entropy_loss": True, "entropy_loss_weight": 0.5,
        "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
        "temporal_opt": {"type": "L1Loss", "loss_weight": 0.1},
        "temporal_warp_type": "GT",
        "optim_g": {"type": "Adam", "lr": 1e-4},
        "scheduler": {"type": "MultiStepLR", "milestones": [400000],
                      "gamma": 0.5},
        "total_iter": 500000, "warmup_iter": -1, "ema_decay": 0.995},
}
# the tiny configuration of train_parity (the tests' TINY KEEP)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=("32",))
HQ_KEYS = ("img_size", "nf", "ch_mult", "res_blocks", "attn_resolutions",
           "codebook_size", "emb_dim")


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters):
    """Device time per call of fn from torch.profiler: the device time of
    every kernel over iters calls, divided by iters (host gaps between
    launches excluded, unlike time_ms). Only the kernels' own entries count:
    an ATen op's entry repeats its kernels' time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def kernel_names(torch, fn):
    """The device kernels one call of fn launches, by the profiler's name
    (cut to 160 characters): which kernel a library call picks, e.g.
    whether SDPA's f32 form runs on the tensor cores."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key[:160] for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def matched_keys(torch, q, strength, g):
    """Keys for queries q (B, L, C): key perm[i] is strength * q[i] plus unit
    noise, so each query's softmax puts roughly half its mass on one match
    (GMFlow's correlations are peaked), and a wrong score scale or a dropped
    bias moves the output far."""
    perm = torch.randperm(q.shape[1], generator=g, device=q.device)
    k = torch.empty_like(q)
    k[:, perm] = (strength * q.float() + torch.randn(
        q.shape, generator=g, device=q.device)).to(q.dtype)
    return k


def kernel_cases(torch, dtype):
    """(counter, wrapper, args, library call, [(flops, peak rate)], bytes,
    rtol, unfused PyTorch calls or None) at the shapes one 20-frame 512x512
    chunk gives each kernel."""
    import torch.nn.functional as F
    from comfyui_keep_torch.models.gmflow import shifted_window_mask
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    isz = torch.finfo(dtype).bits // 8
    dname = str(dtype).split(".")[-1]
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    pairs = FRAMES - 1
    bw, lw = 2 * pairs * WINDOWS, (FEAT // 2) ** 2   # 152 windows of 1024
    bg, lg = pairs, FEAT * FEAT                     # 19 maps of 4096
    scale = 1.0 / math.sqrt(CH)
    q, v = rnd(bw, lw, CH), rnd(bw, lw, CH)
    k = matched_keys(torch, q, 0.7, g)
    mask = torch.as_tensor(shifted_window_mask(FEAT, FEAT, 2), device=dev)
    mask_full = mask.repeat(bw // WINDOWS, 1, 1)[:, None].to(dtype)
    qg = rnd(bg, lg, CH)
    kg = matched_keys(torch, qg, 0.8, g)
    vg = rnd(bg, lg, 2, scale=8.0)
    ys, xs = torch.meshgrid(torch.arange(FEAT, device=dev, dtype=torch.float32),
                            torch.arange(FEAT, device=dev, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(lg, 2).contiguous()
    grid_b = grid.to(dtype).expand(bg, lg, 2)
    src, msg = rnd(bw, lw, CH), rnd(bw, lw, CH)
    w1 = rnd(HID, 2 * CH, scale=0.05)    # nn.Linear's (H, 2C) and (C, H)
    w2 = rnd(CH, HID, scale=0.05)
    gamma, beta = rnd(CH), rnd(CH)
    tanh = dtype == torch.bfloat16

    def sdpa(a, b_, c, m=None):
        return lambda: F.scaled_dot_product_attention(
            a[:, None], b_[:, None], c[:, None], attn_mask=m, scale=scale)

    # f32 only: the f32 step's row count (2 x 14 pairs x 4096 tokens)
    ssrc, smsg = ((None, None) if tanh else
                  (rnd(2 * STEP_PAIRS, lg, CH), rnd(2 * STEP_PAIRS, lg, CH)))

    def mlp_unfused_at(s, m):
        """The MLP tail as unfused PyTorch calls in the working dtype (a
        yardstick the port never calls)."""
        h = F.gelu(torch.matmul(s, w1[:, :CH].t())
                   + torch.matmul(m, w1[:, CH:].t()),
                   approximate="tanh" if tanh else "none")
        return s + F.layer_norm(torch.matmul(h, w2.t()), (CH,), gamma,
                                beta, eps=1e-5)

    att_fl = 2 * bw * lw * lw * CH
    glb_fl = 2 * bg * lg * lg * CH
    rows = bw * lw
    rtol = KERNEL_RTOL[dname]
    step = [] if tanh else [
        ("mlp_fused[step]", "mlp_fused",
         (ssrc, smsg, w1, w2, gamma, beta, tanh),
         None, [(6 * ssrc.numel() * HID, peak)],
         3 * ssrc.numel() * isz + 3 * CH * HID * isz, rtol,
         lambda: mlp_unfused_at(ssrc, smsg))]
    return [
        ("attention[dv128]", "attention", (q, k, v, scale),
         sdpa(q, k, v), [(2 * att_fl, peak)], 4 * q.numel() * isz, rtol,
         None),
        ("attention[dv128+bias]", "attention", (q, k, v, scale, mask),
         sdpa(q, k, v, mask_full), [(2 * att_fl, peak)],
         4 * q.numel() * isz + mask.numel() * 4, rtol, None),
        ("attention[dv2]", "attention", (qg, kg, vg, scale),
         sdpa(qg, kg, vg), [(glb_fl + 2 * bg * lg * lg * 2, peak)],
         (2 * qg.numel() + 2 * vg.numel()) * isz, rtol, None),
        # softmax and expectation stay f32 in both dtypes: f32 tolerance
        ("global_correlation_expectation", "global_correlation_expectation",
         (qg, kg, grid),
         lambda: F.scaled_dot_product_attention(qg, kg, grid_b, scale=scale),
         [(glb_fl, peak), (2 * bg * lg * lg * 2, PEAK_F32)],
         2 * qg.numel() * isz + grid.numel() * 4 + bg * lg * 2 * 4,
         KERNEL_RTOL["float32"], None),
        ("mlp_fused", "mlp_fused",
         (src, msg, w1, w2, gamma, beta, tanh),
         None, [(6 * rows * CH * HID, peak)],
         3 * src.numel() * isz + 3 * CH * HID * isz, rtol,
         lambda: mlp_unfused_at(src, msg)),
    ] + step


def phase_kernels(torch, iters=KERNEL_ITERS):
    from comfyui_keep_torch.ops import kernels as K
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, fn_name, args, lib, flops, nbytes, rtol, unfused in \
                kernel_cases(torch, dtype):
            fn, plain = getattr(K, fn_name), K.PLAIN[fn_name]
            got = fn(*args)
            torch.cuda.synchronize()
            ref = plain(*args).float()
            err = (got.float() - ref).abs().max().item()
            spread = (ref - ref.mean()).abs().max().item()
            tol = rtol * spread
            ms = time_ms(torch, lambda: fn(*args), iters)
            plain_ms = time_ms(torch, lambda: plain(*args), max(1, iters // 4))
            lib_ms = None if lib is None else time_ms(torch, lib, iters)
            op_s = sum(f / p for f, p in flops)
            byte_s = nbytes / HBM
            row = {"name": name, "dtype": dname, "max_abs_err": err,
                   "tol": tol, "ref_spread": spread, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": 1e3 * max(op_s, byte_s),
                   "bound_by": "operations" if op_s >= byte_s else "bytes",
                   "ok": bool(err <= tol)}
            if unfused is not None:   # reported, not gated
                row["unfused_ms"] = time_ms(torch, unfused, iters)
            if lib is not None and dtype == torch.float32:
                row["library_kernels"] = kernel_names(torch, lib)
            say("kernel", **row)
            rows[(name, dname)] = row
            del got, ref
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return rows


def phase_k6(torch, iters=KERNEL_ITERS):
    """K6 at every shape of the packed path, bf16 and f32: max|d| against
    its plain version within KERNEL_RTOL x the plain output's spread; kernel,
    plain and library ms (F.conv2d on the same packed tensor, channels-last,
    through cuDNN: a yardstick the port never calls); the ms of the
    unpacked cuDNN 3x3 convolution at 512^2 that the packed one replaces
    (NCHW, as the port's unpacked path runs it); the bound."""
    import torch.nn.functional as F
    from comfyui_keep_torch.ops import conv2d, upsample_nearest_2x
    from comfyui_keep_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(14)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        for label, b, hi, cin, cout, pads, (kind, uci, uco) in K6_CASES:
            x = torch.randn(b, hi, hi, cin, generator=g,
                            device="cuda").to(dtype)
            w = (torch.randn(2, 2, cin, cout, generator=g, device="cuda")
                 / math.sqrt(4 * cin)).to(dtype)
            got = K.packed_conv2x2(x, w, pads)
            torch.cuda.synchronize()
            ref = K.packed_conv2x2_plain(x, w, pads).float()
            err = (got.float() - ref).abs().max().item()
            spread = (ref - ref.mean()).abs().max().item()
            tol = KERNEL_RTOL[dname] * spread
            ms = time_ms(torch, lambda: K.packed_conv2x2(x, w, pads), iters)
            plain_ms = time_ms(torch, lambda: K.packed_conv2x2_plain(
                x, w, pads), max(1, iters // 4))
            xl = x.permute(0, 3, 1, 2)           # NCHW view, channels-last
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_ms = time_ms(torch, lambda: F.conv2d(xl, wl,
                                                     padding=pads[0][0]),
                             iters)
            ux = torch.randn(b, uci, 256 if kind == "up" else 512,
                             256 if kind == "up" else 512, generator=g,
                             device="cuda").to(dtype)
            uw = (torch.randn(uco, uci, 3, 3, generator=g, device="cuda")
                  / math.sqrt(9 * uci)).to(dtype)
            if kind == "conv":
                unpacked = lambda: conv2d(ux, uw, padding=1)
            elif kind == "down":
                unpacked = lambda: conv2d(ux, uw, stride=2,
                                          padding=[(0, 1), (0, 1)])
            else:
                unpacked = lambda: conv2d(upsample_nearest_2x(ux), uw,
                                          padding=1)
            unpacked_ms = time_ms(torch, unpacked, iters)
            op_s = 2 * got.numel() * 4 * cin / peak
            byte_s = (x.numel() + w.numel() + got.numel()) * \
                x.element_size() / HBM
            row = {"name": "packed_conv2x2", "case": label, "dtype": dname,
                   "x": [b, hi, hi, cin], "w": [2, 2, cin, cout],
                   "pads": pads, "max_abs_err": err, "tol": tol,
                   "ref_spread": spread, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "unpacked_3x3_ms": unpacked_ms,
                   "unpacked_3x3": [kind, b, uci, uco],
                   "bound_ms": 1e3 * max(op_s, byte_s),
                   "bound_by": "operations" if op_s >= byte_s else "bytes",
                   "ok": bool(err <= tol)}
            say("kernel", **row)
            rows[(label, dname)] = row
            if pads == K6_SAME:
                # the path masks these outputs: the fused bias + parity-1
                # mask against plain + bias + mask, and against the launches
                # it replaces (the bias add and the six slice zeroings)
                bias = torch.randn(cout, generator=g, device="cuda").to(dtype)
                mc = cout // 4
                fused = K.packed_conv2x2(x, w, pads, bias, mc)
                torch.cuda.synchronize()
                fref = K.packed_conv2x2_plain(x, w, pads, bias, mc).float()
                ferr = (fused.float() - fref).abs().max().item()
                fspread = (fref - fref.mean()).abs().max().item()
                ftol = KERNEL_RTOL[dname] * fspread

                def unfused():
                    K.mask_parity1_(K.packed_conv2x2(x, w, pads).add_(bias),
                                    mc)
                frow = dict(row, case=label + ", + bias + mask",
                            max_abs_err=ferr, tol=ftol, ref_spread=fspread,
                            ms=time_ms(torch, lambda: K.packed_conv2x2(
                                x, w, pads, bias, mc), iters),
                            plain_ms=time_ms(
                                torch, lambda: K.packed_conv2x2_plain(
                                    x, w, pads, bias, mc), max(1, iters // 4)),
                            unfused_ms=time_ms(torch, unfused, iters),
                            library_ms=time_ms(torch, lambda: F.conv2d(
                                xl, wl, bias, padding=1), iters),
                            library="cuDNN conv2d + bias (no mask)",
                            ok=bool(ferr <= ftol))
                say("kernel", **frow)
                rows[(frow["case"], dname)] = frow
                del fused, fref
            del x, w, got, ref, ux, uw, xl, wl
    torch.cuda.empty_cache()
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"the packed conv kernel disagrees with its plain version: {bad}")
    return rows


def phase_gmflow(torch):
    from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
    gen = torch.Generator().manual_seed(1)
    gm = GMFlow(device="cpu", generator=gen)
    gm_cuda = copy.deepcopy(gm).cuda()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((1, 2, 512, 512, 3), dtype=np.float32)
                        * 2 - 1)
    with torch.no_grad():
        cpu = flow_from_clip(gm, x)
        gpu = flow_from_clip(gm_cuda, x.cuda())
    err = max((g.cpu() - c).abs().max().item() for g, c in zip(gpu, cpu))
    ok = bool(np.isfinite(err) and err <= FLOW_TOL_PX)
    say("gmflow", max_abs_err_px=err, tol_px=FLOW_TOL_PX,
        flow_abs_max_px=max(c.abs().max().item() for c in cpu), ok=ok)
    if not ok:
        fail(f"GMFlow card vs CPU max|d| {err} px > {FLOW_TOL_PX}")
    return x, cpu


def phase_keep(torch, x, flows):
    """KEEP on the 2-frame clip, f32, card against CPU (unpacked), picks
    forced from the CPU: the card's unpacked forward, then its packed one,
    which must launch K6 12 times per frame. Returns that count: the f32
    kernel's launches in the kernel table (the serving runs count the bf16
    kernel's)."""
    from comfyui_keep_torch.models.keep import KEEP
    from comfyui_keep_torch.ops import kernels as K
    gen = torch.Generator().manual_seed(2)
    net = KEEP(device="cpu", generator=gen)
    net_cuda = copy.deepcopy(net).cuda()
    with torch.no_grad():
        out_c, aux_c = net.apply(x, flows=flows, return_aux=True)
        picks = aux_c["logits"].argmax(-1).reshape(1, x.shape[1], -1)
        out_g, aux_g = net_cuda.apply(
            x.cuda(), flows=tuple(f.cuda() for f in flows), return_aux=True,
            force_indices=picks.cuda())
        # the serving form: 512-level convolutions phase-packed (K6)
        packed = net_cuda.prepare_phase512()
        K.reset_launch_counts()
        out_p, aux_p = packed.apply(
            x.cuda(), flows=tuple(f.cuda() for f in flows), return_aux=True,
            force_indices=picks.cuda())
        torch.cuda.synchronize()
        k6 = K.LAUNCHES["packed_conv2x2"]
    lim = KEEP_ATOL + KEEP_RTOL * out_c.abs()
    llim = KEEP_ATOL + KEEP_RTOL * aux_c["logits"].abs()
    d, dp = (out_g.cpu() - out_c).abs(), (out_p.cpu() - out_c).abs()
    dl = (aux_g["logits"].cpu() - aux_c["logits"]).abs()
    dlp = (aux_p["logits"].cpu() - aux_c["logits"]).abs()
    # LQ encoder once over both frames, HQ encoder on frame 1, generator
    # tail on both: 6 packed convolutions each
    want_k6 = 12 * x.shape[1]
    ok = bool((d <= lim).all() and (dl <= llim).all() and (dp <= lim).all()
              and (dlp <= llim).all() and k6 == want_k6)
    say("keep", max_abs_err=d.max().item(), logits_max_abs_err=dl.max().item(),
        packed_max_abs_err=dp.max().item(),
        packed_logits_max_abs_err=dlp.max().item(), atol=KEEP_ATOL,
        rtol=KEEP_RTOL, packed_k6_launches=k6, expected_k6_launches=want_k6,
        ok=ok)
    if not ok:
        fail(f"KEEP card (unpacked and packed) vs CPU outside atol/rtol, or "
             f"K6 launches {k6} != {want_k6}")
    return k6


def serving_launches(k6_per_frame_chunks):
    """Launch counts of one restore_face_stream run with two GMFlow calls
    (a 20-frame chunk and a 2-frame one): K1 13 per call (6 windows, 6
    shifted windows with the mask, 1 global flow attention), K2 6, K3 1;
    serving picks codes by argmax, so no nearest-codebook search; K6 12 per
    frame of each chunk when KEEP is packed (the LQ encoder 6 once, the HQ
    encoder 6 per propagated frame, the generator tail 6 per frame)."""
    return {"attention[dv128]": 12, "attention[dv128+bias]": 12,
            "attention[dv2]": 2, "mlp_fused": 12,
            "global_correlation_expectation": 2, "vq_nearest_indices": 0,
            "fused_bias_lrelu": 0, "packed_conv2x2": k6_per_frame_chunks}


def phase_main(torch, k6_own):
    """The packed processor (phase512=True) and a phase512=False one on the
    same pack: chunk ms of each over MAIN_PAIRS pairs timed in turns
    (packed, unpacked, unpacked, packed, ...) after a warm-up pair, the
    medians and their ratio, and ROADMAP's condition for keeping packing the
    default (K6 at its own shape within 1.5x of cuDNN's 2x2 in this run, the
    packed median no slower than the unpacked one) beside the processor's
    default; then the 21-face run of each with its launch counts. Returns
    (the packed run's counts, the packed processor, the faces, the pack)."""
    import inspect
    from comfyui_keep_torch import api
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pack = api.load_models(seed=0).load_device(torch.bfloat16)
    procs = {"packed": pack.processor(dtype=torch.bfloat16, phase512=True),
             "unpacked": pack.processor(dtype=torch.bfloat16,
                                        phase512=False)}
    rng = np.random.default_rng(3)
    faces = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
             for _ in range(FRAMES + 1)]
    runs = {k: [] for k in procs}
    for i in range(MAIN_PAIRS + 1):   # a warm-up pair, then the timed pairs
        order = list(procs) if i % 2 == 0 else list(procs)[::-1]
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            procs[name].restore_face_stream(faces[:FRAMES],
                                            max_clip_length=FRAMES)
            torch.cuda.synchronize()
            if i:
                runs[name].append(1e3 * (time.perf_counter() - t0))
    chunk_ms = {k: float(np.median(v)) for k, v in runs.items()}
    k6_over_cudnn = k6_own["ms"] / k6_own["library_ms"]
    holds = bool(k6_over_cudnn <= 1.5
                 and chunk_ms["packed"] <= chunk_ms["unpacked"])
    default = inspect.signature(KEEPFaceProcessor).parameters[
        "phase512"].default
    say("default", pairs=MAIN_PAIRS, packed_median_ms=chunk_ms["packed"],
        unpacked_median_ms=chunk_ms["unpacked"],
        packed_over_unpacked=chunk_ms["packed"] / chunk_ms["unpacked"],
        k6_own_ms=k6_own["ms"], cudnn_2x2_ms=k6_own["library_ms"],
        k6_over_cudnn=k6_over_cudnn, k6_limit=1.5,
        packing_condition_holds=holds, processor_default_phase512=default)

    outs, counts = {}, {}
    for name, proc in procs.items():
        K.reset_launch_counts()
        outs[name] = proc.restore_face_stream(faces, max_clip_length=FRAMES)
        torch.cuda.synchronize()
        counts[name] = dict(K.LAUNCHES)
    proc = procs["packed"]
    shapes_ok = (len(outs["packed"]) == FRAMES + 1 and all(
        o.dtype == np.uint8 and o.shape == (512, 512, 3)
        for o in outs["packed"]))
    # uint8 hides NaN (clip + round), so the network's float output of a
    # full chunk is checked for finiteness too, after the counts are read
    x20 = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces[:FRAMES]])
    finite = bool(np.isfinite(proc.restore_clip(x20)).all())
    want = serving_launches(12 * FRAMES + 12 * 2)
    ok = shapes_ok and finite and counts["packed"] == want
    say("main", faces=len(outs["packed"]), chunk_ms=chunk_ms["packed"],
        chunk_ms_runs=runs["packed"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        faces_per_s=FRAMES / (chunk_ms["packed"] / 1e3),
        launches=counts["packed"], expected_launches=want,
        outputs_uint8_512=shapes_ok, finite=finite, ok=ok)
    if not ok:
        fail(f"main path: launches {counts['packed']} (want {want}), shapes "
             f"{shapes_ok}, finite {finite}")
    # the unpacked path, reported beside it: bf16 argmax picks can flip
    # between the two summation orders, so their difference is not gated
    want_u = serving_launches(0)
    diff = np.stack([np.abs(a.astype(int) - b.astype(int)) for a, b in
                     zip(outs["packed"], outs["unpacked"])])
    ok = counts["unpacked"] == want_u
    say("main_unpacked", chunk_ms=chunk_ms["unpacked"],
        chunk_ms_runs=runs["unpacked"],
        faces_per_s=FRAMES / (chunk_ms["unpacked"] / 1e3),
        packed_over_unpacked=chunk_ms["packed"] / chunk_ms["unpacked"],
        launches=counts["unpacked"], expected_launches=want_u,
        packed_vs_unpacked_uint8_max=int(diff.max()),
        packed_vs_unpacked_uint8_mean=float(diff.mean()), ok=ok)
    if not ok:
        fail(f"main_unpacked: launches {counts['unpacked']} (want {want_u})")
    del procs["unpacked"]
    return counts["packed"], proc, faces, pack


def phase_stream(torch, proc, faces):
    """restore_face_stream(21 faces, carry_chunks=True) on the packed bf16
    processor: a 20-frame chunk, then a 1-frame chunk that starts from the
    carried state (no duplication) with GMFlow on the boundary pair. Then
    the same two chunks through restore_clip, whose float outputs must be
    finite."""
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    K.reset_launch_counts()
    outs = proc.restore_face_stream(faces, max_clip_length=FRAMES,
                                    carry_chunks=True)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    # the carried 1-frame chunk: LQ encoder 6, HQ encoder 6 (its frame
    # propagates from the carry), generator tail 6
    want = serving_launches(12 * FRAMES + 18)
    shapes_ok = (len(outs) == FRAMES + 1 and all(
        o.dtype == np.uint8 and o.shape == (512, 512, 3) for o in outs))
    x = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces])
    first, carry = proc.restore_clip(x[:FRAMES], return_carry=True)
    last = proc.restore_clip(x[FRAMES:], carry, x[FRAMES - 1])
    finite = bool(np.isfinite(first).all() and np.isfinite(last).all())
    reset_last = proc.restore_face_stream(faces[FRAMES:])[0]
    ok = shapes_ok and finite and counts == want
    say("stream", faces=len(outs), carry_chunks=True, launches=counts,
        expected_launches=want, outputs_uint8_512=shapes_ok, finite=finite,
        last_face_differs_from_reset=bool(
            not np.array_equal(outs[-1], reset_last)), ok=ok)
    if not ok:
        fail(f"stream: launches {counts} (want {want}), shapes {shapes_ok}, "
             f"finite {finite}")


def phase_api(torch, pack):
    """The node entry points on the card, with no OpenCV: api.restore_image
    on an aligned 512^2 face at factor 1 (no resize) and on a 400^2 face at
    factor 1.5 (utils/resize.py: LINEAR to 512^2, LANCZOS4 to 768^2), then
    api.restore_sequence on 3 aligned 512^2 frames at factor 2. Each output:
    its shape and uint8 dtype; the image against restore_face_stream on the
    same resized face (resized by the factor as the node does) within 1
    level; the frames equal to the inputs resized by the factor (aligned
    frames are returned, the restored faces pasted nowhere); each call's
    launches (one GMFlow call of a 2-frame chunk, or of the 3-frame one);
    and cv2 never imported."""
    from comfyui_keep_torch import api
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.utils.resize import resize
    rng = np.random.default_rng(5)
    face512 = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    face400 = rng.integers(0, 256, (400, 400, 3), dtype=np.uint8)
    frames = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
              for _ in range(3)]
    # one GMFlow call (6 window layers, 6 shifted, the global attention), no
    # code search, no packing: the pack serves unpacked
    want = {"attention[dv128]": 6, "attention[dv128+bias]": 6,
            "attention[dv2]": 1, "mlp_fused": 6,
            "global_correlation_expectation": 1, "vq_nearest_indices": 0,
            "fused_bias_lrelu": 0, "packed_conv2x2": 0}
    proc = pack.processor(dtype=torch.bfloat16)
    rows, ok_all = [], True
    for label, img, factor in (("image 512, x1", face512, 1.0),
                               ("image 400, x1.5", face400, 1.5)):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = api.restore_image(pack, img, factor, has_aligned=True,
                                dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(K.LAUNCHES)
        face = img if img.shape[0] == 512 else resize(img, (512, 512),
                                                      "linear")
        ref = proc.restore_face_stream([face], max_clip_length=2)[0]
        side = int(512 * factor)
        if side != 512:
            ref = resize(ref, (side, side), "lanczos4")
        shape_ok = out.dtype == np.uint8 and out.shape == (side, side, 3)
        diff = (int(np.abs(out.astype(int) - ref.astype(int)).max())
                if shape_ok else None)
        ok = bool(shape_ok and diff <= 1 and counts == want
                  and "cv2" not in sys.modules)
        rows.append(dict(call=f"restore_image, {label}", ms=ms,
                         shape=list(out.shape), dtype=str(out.dtype),
                         max_level_diff_vs_stream=diff, launches=counts,
                         ok=ok))
        ok_all &= ok
    K.reset_launch_counts()
    t0 = time.perf_counter()
    outs = api.restore_sequence(pack, frames, 2.0, has_aligned_frames=True,
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = dict(K.LAUNCHES)
    shapes_ok = len(outs) == 3 and all(
        o.dtype == np.uint8 and o.shape == (1024, 1024, 3) for o in outs)
    same = shapes_ok and all(np.array_equal(o, resize(f, (1024, 1024),
                                                      "lanczos4"))
                             for o, f in zip(outs, frames))
    ok = bool(shapes_ok and same and counts == want
              and "cv2" not in sys.modules)
    rows.append(dict(call="restore_sequence, 3 x 512, x2", ms=ms,
                     shape=[len(outs)] + list(outs[0].shape),
                     frames_equal_resized_inputs=same, launches=counts,
                     ok=ok))
    ok_all &= ok
    say("api", calls=rows, expected_launches=want,
        cv2_imported="cv2" in sys.modules, ok=bool(ok_all))
    if not ok_all:
        fail(f"api: {rows}")


def phase_vq(torch, iters=KERNEL_ITERS):
    """The nearest-codebook kernel at the training step's shape. Code n is
    s_n u_n (u_n of unit expected norm, s_n in [0.5, 2]); token t is a code
    plus noise, so the ||e||^2 term decides picks and a wrong sign or scale
    changes them. The last 24 codes repeat the first 24: the kernel must
    never pick a repeat (ties go to the lowest index). Picks must equal the
    plain version's wherever the plain distances' best-to-second gap
    exceeds the tolerance; elsewhere the kernel's pick must lie within the
    tolerance of the minimum."""
    from comfyui_keep_torch.ops import kernels as K
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    dup = 24
    e = (torch.randn(VQ_N, VQ_C, generator=g, device=dev) / math.sqrt(VQ_C)
         * (0.5 + 1.5 * torch.rand(VQ_N, 1, generator=g, device=dev)))
    e[VQ_N - dup:] = e[:dup]
    pick = torch.randint(0, VQ_N, (VQ_T,), generator=g, device=dev)
    z = e[pick] + 0.7 * torch.randn(VQ_T, VQ_C, generator=g,
                                    device=dev) / math.sqrt(VQ_C)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        zc, ec = z.to(dtype).contiguous(), e.to(dtype).contiguous()
        got = K.vq_nearest_indices(zc, ec).long()
        torch.cuda.synchronize()
        ref = K.vq_nearest_indices_plain(zc, ec).long()
        d = K.codebook_sq_norms(ec) - 2.0 * zc.float() @ ec.float().t()
        excess = (d.gather(1, got[:, None]) - d.gather(1, ref[:, None]))
        top2 = (-d).topk(2, dim=-1).values
        tol = VQ_RTOL * d.abs().max().item()
        clear = (top2[:, 0] - top2[:, 1]) > tol
        mismatched = int((got != ref)[clear].sum())
        err = excess.abs().max().item()
        repeats = int((got >= VQ_N - dup).sum())
        ms = time_ms(torch, lambda: K.vq_nearest_indices(zc, ec), iters)
        plain_ms = time_ms(torch, lambda: K.vq_nearest_indices_plain(zc, ec),
                           max(1, iters // 4))
        e2 = K.codebook_sq_norms(ec).to(dtype)

        def lib():
            return torch.addmm(e2, zc, ec.t(), alpha=-2).argmin(-1)
        lib_ms = time_ms(torch, lib, iters)
        # at ~0.02-0.06 ms a call the loop above can be bound by the host's
        # launches: the device's own time of each, from the profiler
        dev_ms = device_ms(torch, lambda: K.vq_nearest_indices(zc, ec),
                           iters)
        lib_dev_ms = device_ms(torch, lib, iters)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        op_s = 2 * VQ_T * VQ_N * VQ_C / peak
        byte_s = ((VQ_T + VQ_N) * VQ_C * zc.element_size()
                  + 4 * (VQ_N + VQ_T)) / HBM
        row = {"name": "vq_nearest_indices", "dtype": dname,
               "max_abs_err": err, "tol": tol,
               "picks_differing": int((got != ref).sum()),
               "picks_differing_past_tol": mismatched,
               "tokens_past_tol": int(clear.sum()), "repeat_codes_picked":
               repeats, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
               "bound_ms": 1e3 * max(op_s, byte_s),
               "bound_by": "operations" if op_s >= byte_s else "bytes",
               "ok": bool(mismatched == 0 and err <= tol and repeats == 0)}
        say("kernel", **row)
        rows[("vq_nearest_indices", dname)] = row
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"the vq kernel disagrees with its plain version: {bad}")
    return rows


def rel_margin(x):
    """Least gap between the largest and second-largest entry of the last
    axis, relative to the largest |x|."""
    top2 = x.float().topk(2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]).min() / x.abs().max()).item()


def tiny_training(torch, device, mixed_precision=False):
    """A KEEPTrainer on `device` over the tiny configuration with seeded
    random weights (GMFlow at 128 channels, 2 layers), and its batch: a
    64x64 clip of 3 frames."""
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.keep import KEEP
    from comfyui_keep_torch.models.vqgan import VQHQEncoder
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    opt = copy.deepcopy(TRAIN_OPT)
    opt["network_g"] = {"type": "KEEP", **TINY,
                        "fix_modules": ["quantize", "generator"]}
    opt["train"]["mixed_precision"] = mixed_precision
    hq = VQHQEncoder(**{k: TINY[k] for k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(6))
    with torch.no_grad():  # codes at the latents' scale: clear GT picks
        hq.quantize.embedding.weight.copy_(0.5 * torch.randn(
            TINY["codebook_size"], TINY["emb_dim"],
            generator=torch.Generator().manual_seed(3)))
    gm = GMFlow(num_layers=2, device="cpu",
                generator=torch.Generator().manual_seed(7))
    tr = KEEPTrainer(opt, hq_vqgan=hq, gmflow=gm, device=device)
    state = tr.make_state(KEEP(device="cpu", **TINY,
                               generator=torch.Generator().manual_seed(22)))
    rng = np.random.default_rng(8)
    batch = {k: torch.as_tensor(rng.random((1, 3, 64, 64, 3),
                                           dtype=np.float32) * 2 - 1)
             for k in ("lq", "gt")}
    return tr, state, batch


def pick_margins(torch, tr, state, batch):
    """Relative top-1/top-2 margins of the code logits and of the
    ground-truth code distances, from a no-grad forward."""
    from comfyui_keep_torch.models.vqgan import vq_indices
    with torch.no_grad():
        lq = batch["lq"].to(tr.device)
        _, aux = state.model.apply(lq, flows=tr._flows(lq), return_aux=True)
        gt = batch["gt"].to(tr.device)
        z = tr.hq_vqgan.encode(gt.reshape((-1,) + gt.shape[2:]))
        _, d = vq_indices(tr.hq_vqgan.quantize.embedding.weight, z)
    return rel_margin(aux["logits"]), rel_margin(-d)


def phase_train_parity(torch):
    """One stage-II micro-step of the tiny configuration: the card (kernels)
    against the CPU (plain versions), in f32 and in bf16 mixed precision."""
    from comfyui_keep_torch.ops import kernels as K
    res = {}
    for mp in (False, True):
        for dev in ("cpu", "cuda"):
            tr, state, batch = tiny_training(torch, dev, mp)
            if (dev, mp) == ("cpu", False):
                margins = pick_margins(torch, tr, state, batch)
                if (margins[0] < LOGIT_MARGIN_RTOL
                        or margins[1] < DIST_MARGIN_RTOL):
                    fail(f"train_parity: pick margins {margins} under "
                         f"{(LOGIT_MARGIN_RTOL, DIST_MARGIN_RTOL)}: a "
                         f"flipped pick would decide the check")
            K.reset_launch_counts()
            logs = tr.backward(state, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
            res[dev, mp] = ({k: float(v) for k, v in logs.items()},
                            {n: p.grad.detach().cpu() for n, p
                             in state.model.named_parameters()
                             if p.grad is not None},
                            dict(K.LAUNCHES))
    # two flow_from_clip calls (LQ and GT clips) of a 2-layer GMFlow, one
    # nearest-codebook launch for the GT codes
    want = {"attention[dv128]": 4, "attention[dv128+bias]": 4,
            "attention[dv2]": 2, "mlp_fused": 4,
            "global_correlation_expectation": 2, "vq_nearest_indices": 1,
            "fused_bias_lrelu": 0, "packed_conv2x2": 0}
    lf, f32 = res["cpu", False][:2]
    for mp in (False, True):
        (lc, gc, _), (lg, gg, counts) = res["cpu", mp], res["cuda", mp]
        if mp:
            loss_rtol = MP_LOSS_RTOL
            loss_err = max(abs(lg[k] - v) / (MP_GRAD_RATIO * abs(v - lf[k])
                                             + MP_LOSS_RTOL * abs(v))
                           for k, v in lc.items())
            grad_err = max(((gg[n] - g).norm() / (
                MP_GRAD_RATIO * (g - f32[n]).norm() + GRAD_RTOL
                * f32[n].norm() + GRAD_ATOL)).item() for n, g in gc.items())
        else:
            loss_rtol = LOSS_RTOL
            loss_err = max(abs(lg[k] - v) / (LOSS_RTOL * abs(v))
                           for k, v in lc.items())
            grad_err = max(((gg[n] - g).abs().max()
                            / (GRAD_RTOL * g.abs().max() + GRAD_ATOL)).item()
                           for n, g in gc.items())
        ok = bool(loss_err <= 1.0 and grad_err <= 1.0
                  and gc.keys() == gg.keys() and counts == want)
        precision = "bf16 mixed" if mp else "f32"
        say("train_parity", precision=precision, losses_cpu=lc,
            losses_card=lg, loss_err_over_tol=loss_err, loss_rtol=loss_rtol,
            grad_err_over_tol=grad_err, grad_rtol=GRAD_RTOL,
            grad_atol=GRAD_ATOL, mp_grad_ratio=MP_GRAD_RATIO if mp else None,
            leaves=len(gc), logit_margin=margins[0],
            distance_margin=margins[1],
            margin_rtol=(LOGIT_MARGIN_RTOL, DIST_MARGIN_RTOL),
            launches=counts, expected_launches=want, ok=ok)
        if not ok:
            fail(f"train_parity ({precision}): the card's step disagrees "
                 f"with the CPU's")


def phase_train(torch):
    """options/train_keep_stage2.yml's step at full width, f32 as configured
    and then with mixed precision. Returns each run's launch counts."""
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.vqgan import VQHQEncoder
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    data = TRAIN_OPT["datasets"]["train"]
    b, t = data["batch_size_per_gpu"], data["num_frame"]
    hq = VQHQEncoder(**{k: v for k, v in TRAIN_OPT["network_g"].items()
                        if k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    # per step: two flow_from_clip calls (LQ and GT clips) of the 6-layer
    # GMFlow, one nearest-codebook launch for the GT codes
    per_step = {"attention[dv128]": 12, "attention[dv128+bias]": 12,
                "attention[dv2]": 2, "mlp_fused": 12,
                "global_correlation_expectation": 2, "vq_nearest_indices": 1,
                "fused_bias_lrelu": 0, "packed_conv2x2": 0}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    watch = ("feat_emb.weight", "position_emb", "encoder.blocks.0.weight",
             "hq_encoder.blocks.0.weight", "ft_layers.0.linear1.weight",
             "idx_pred_layer.1.weight",
             "kalman_filter.kalman_gain_calculator.3.weight",
             "cft.32.scale.2.bias", "cfa.16.attn.to_out.0.bias")
    ema_leaf = "feat_emb.weight"
    runs = {}
    for mp in (False, True):
        opt = copy.deepcopy(TRAIN_OPT)
        opt["train"]["mixed_precision"] = mp
        tr = KEEPTrainer(opt, hq_vqgan=copy.deepcopy(hq),
                         gmflow=copy.deepcopy(gm))
        state = tr.make_state()
        size = tr.cfg["img_size"]
        g = torch.Generator(device="cuda").manual_seed(3)
        batch = {k: torch.rand((b, t, size, size, 3), generator=g,
                               device="cuda") * 2 - 1 for k in ("lq", "gt")}
        params = dict(state.model.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = tr.train_step(state, batch)    # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            if i == TRAIN_STEPS - 1:
                ema_prev = state.ema[ema_leaf].clone()
            state, logs = tr.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
        counts = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        frozen = [n for n, p in params.items() if not p.requires_grad]
        frozen_same = all(torch.equal(params[n], before[n]) for n in frozen)
        moved = [n for n, p in params.items() if p.requires_grad
                 and not torch.equal(p, before[n])]
        watch_moved = all(n in moved for n in watch)
        decay = tr.ema_decay
        want_ema = ema_prev * decay + params[ema_leaf].detach() * (1 - decay)
        ema_err = (state.ema[ema_leaf] - want_ema).abs().max().item()
        ema_ok = ema_err <= 1e-7 * want_ema.abs().max().item()
        finite = all(math.isfinite(v) for v in logs.values())
        ok = bool(finite and frozen_same and watch_moved and ema_ok
                  and counts == want)
        precision = "bf16 mixed" if mp else "f32"
        say("train", precision=precision, batch=b, frames=t, size=size,
            steps_timed=TRAIN_STEPS, ms_per_step=step_ms,
            frames_per_s=b * t / (step_ms / 1e3), peak_mem_gib=peak,
            losses=logs, launches_per_step={k: v / TRAIN_STEPS
                                            for k, v in counts.items()},
            frozen_leaves=len(frozen), frozen_unchanged=frozen_same,
            trainable_leaves=len(params) - len(frozen),
            trainable_moved=len(moved), watched_moved=watch_moved,
            ema_leaf=ema_leaf, ema_max_abs_err=ema_err, finite=finite, ok=ok)
        if not ok:
            fail(f"train ({precision}): finite {finite}, frozen unchanged "
                 f"{frozen_same}, watched leaves moved {watch_moved}, EMA "
                 f"{ema_ok}, launches {counts} (want {want})")
        runs["bfloat16" if mp else "float32"] = counts
        del tr, state, batch, params, before
        torch.cuda.empty_cache()
    return runs


def ulps(torch, got, ref):
    """Largest distance in units of the last place between two tensors of
    one float dtype (bf16 or f32), from their bit patterns."""
    it = torch.int16 if got.dtype == torch.bfloat16 else torch.int32

    def ordered(t):
        i = t.contiguous().view(it).long()
        return torch.where(i < 0, -(i & (2 ** (8 * t.element_size() - 1) - 1)),
                           i)
    return (ordered(got) - ordered(ref)).abs().max().item()


def phase_k5(torch, iters=KERNEL_ITERS):
    """K5 at StyleGAN2's shapes against its plain version (at most 1 ulp:
    the same operations in the same order), then fused_leaky_relu's
    gradients, first and second order, card against CPU."""
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.ops.native import fused_leaky_relu
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for shape in K5_SHAPES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
            got = K.fused_bias_lrelu(x, b)
            torch.cuda.synchronize()
            ref = K.fused_bias_lrelu_plain(x, b)
            err = (got.float() - ref.float()).abs().max().item()
            n_ulps = ulps(torch, got, ref)
            ms = time_ms(torch, lambda: K.fused_bias_lrelu(x, b), iters)
            plain_ms = time_ms(torch, lambda: K.fused_bias_lrelu_plain(x, b),
                               max(1, iters // 4))
            nbytes = 2 * x.numel() * x.element_size() + 4 * shape[1]
            op_s = 3 * x.numel() / PEAK_F32
            byte_s = nbytes / HBM
            row = {"name": "fused_bias_lrelu", "dtype": dname,
                   "shape": list(shape), "max_abs_err": err,
                   "max_ulps": n_ulps, "tol_ulps": 1, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": 1e3 * max(op_s, byte_s),
                   "bound_by": "operations" if op_s >= byte_s else "bytes",
                   "ok": bool(n_ulps <= 1)}
            say("kernel", **row)
            rows[(tuple(shape), dname)] = row
            del x, got, ref
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"the fused_bias_lrelu kernel disagrees with its plain version: "
             f"{bad}")
    gen = torch.Generator().manual_seed(6)
    x0, w, v = (torch.randn(4, 32, 64, 64, generator=gen) for _ in range(3))
    b0 = torch.randn(32, generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        x = x0.to(dev).requires_grad_(True)
        b = b0.to(dev).requires_grad_(True)
        out = fused_leaky_relu(x, b)
        gx, gb = torch.autograd.grad((out ** 2 * w.to(dev)).sum(), (x, b),
                                     create_graph=True)
        hx, hb = torch.autograd.grad((gx * v.to(dev)).sum(), (x, b))
        res[dev] = [t.detach().cpu() for t in (out, gx, gb, hx, hb)]
    errs = [((c - r).abs().max() / r.abs().max()).item()
            for c, r in zip(res["cuda"], res["cpu"])]
    ok = bool(errs[0] == 0 and max(errs[1:]) <= 1e-5)
    say("kernel_grad", name="fused_leaky_relu", shape=[4, 32, 64, 64],
        value_rel_err=errs[0], gx_rel_err=errs[1], gb_rel_err=errs[2],
        second_order_x_rel_err=errs[3], second_order_b_rel_err=errs[4],
        tol=1e-5, ok=ok)
    if not ok:
        fail(f"fused_leaky_relu's gradients on the card disagree with the "
             f"CPU's: {errs}")
    return rows


def sg2_opt(**train):
    """StyleGAN2Model options: the JAX trainer's defaults (r1 10, path 2,
    g_reg_every 4, d_reg_every 16, mixing 0.9, Adam 2e-3) with EMA 0.999."""
    return {"model_type": "StyleGAN2Model", "manual_seed": 0,
            "train": {"optim_g": {"lr": 2e-3}, "optim_d": {"lr": 2e-3},
                      "r1_reg_weight": 10.0, "path_reg_weight": 2.0,
                      "net_g_reg_every": 4, "net_d_reg_every": 16,
                      "mixing_prob": 0.9, "ema_decay": 0.999, **train}}


def g_launches(cfg, styles):
    """K5 launches of one generator forward: the mapping MLP per style, the
    first style conv and two per resolution above 4x4."""
    log = int(math.log2(cfg["out_size"]))
    return cfg["num_mlp"] * styles + 1 + 2 * (log - 2)


def d_launches(size):
    """K5 launches of one discriminator forward: the first conv, two per
    ResBlock, the final conv and the first linear layer."""
    return 1 + 2 * (int(math.log2(size)) - 2) + 1 + 1


def alternation_launches(cfg, draws, it, tr):
    """K5 launches of one alternation at iteration `it` with these draws."""
    size = cfg["out_size"]
    n = (g_launches(cfg, len(draws["d_styles"])) + 2 * d_launches(size)
         + g_launches(cfg, len(draws["g_styles"])) + d_launches(size))
    if it % tr.net_d_reg_every == 0:
        n += d_launches(size)
    if it % tr.net_g_reg_every == 0:
        n += g_launches(cfg, 1)
    return n


def phase_stylegan2_parity(torch):
    """A narrow StyleGAN2 in f32, card (K5) against CPU (plain): forward,
    then one alternation at iteration 16 from the same warm state and
    draws."""
    from comfyui_keep_torch.models.stylegan2 import (StyleGAN2Discriminator,
                                                     StyleGAN2Generator)
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training.trainers import StyleGAN2Trainer
    cfg, b = SG2_PARITY, SG2_BATCH
    size = cfg["out_size"]
    g_net = StyleGAN2Generator(**cfg, device="cpu",
                               generator=torch.Generator().manual_seed(7))
    d_net = StyleGAN2Discriminator(size, channel_multiplier=1, narrow=0.25,
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(8))
    z = torch.randn(b, cfg["num_style_feat"],
                    generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        img_c, _ = g_net([z])
        logit_c = d_net(img_c)
        K.reset_launch_counts()
        img_g, _ = copy.deepcopy(g_net).cuda()([z.cuda()])
        logit_g = copy.deepcopy(d_net).cuda()(img_c.cuda())
        torch.cuda.synchronize()
    fwd_launches = K.LAUNCHES["fused_bias_lrelu"]

    def within(a, r):
        return bool(((a.cpu() - r).abs() <= SG2_TOL["atol"]
                     + SG2_TOL["rtol"] * r.abs()).all())
    fwd_ok = (within(img_g, img_c) and within(logit_g, logit_c)
              and fwd_launches == g_launches(cfg, 1) + d_launches(size))

    opt = sg2_opt()
    opt["network_g"] = dict(cfg)
    opt["network_d"] = {"out_size": size, "channel_multiplier": 1}
    rng = np.random.default_rng(10)
    real = torch.as_tensor(rng.standard_normal((b, 3, size, size),
                                               dtype=np.float32))
    # both start from the CPU's state after alternation 15 (weights, both
    # Adams' moments, EMA): from warm moments an update is proportional to
    # its gradient, where Adam's first step is sign-like
    warm = StyleGAN2Trainer(opt, device="cpu")
    warm_state = warm.make_state(g_net, d_net)
    warm_state, _ = warm.gan_train_step(warm_state, {"gt": real}, 15)
    draws = warm.draw(16, b, warm_state.model)
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = StyleGAN2Trainer(opt, device=dev)
        state = tr.make_state(copy.deepcopy(warm_state.model),
                              copy.deepcopy(warm.disc))
        # copies: a CPU optimizer would share the warm state's tensors
        state.optimizer.load_state_dict(copy.deepcopy(
            warm_state.optimizer.state_dict()))
        tr.d_optimizer.load_state_dict(copy.deepcopy(
            warm.d_optimizer.state_dict()))
        state.ema = {k: v.to(dev, copy=True)
                     for k, v in warm_state.ema.items()}
        tr.mean_path_length = warm.mean_path_length
        before = {("G", n): p.detach().cpu().clone() for n, p
                  in state.model.named_parameters()}
        before.update({("D", n): p.detach().cpu().clone() for n, p
                       in tr.disc.named_parameters()})
        K.reset_launch_counts()
        state, logs = tr.gan_train_step(state, {"gt": real}, 16, draws=draws)
        if dev == "cuda":
            torch.cuda.synchronize()
        params = {("G", n): p for n, p in state.model.named_parameters()}
        params.update({("D", n): p for n, p in tr.disc.named_parameters()})
        opts = {"G": state.optimizer, "D": tr.d_optimizer}
        runs[dev] = dict(
            logs={**logs, "mean_path_length": tr.mean_path_length},
            delta={k: p.detach().cpu() - before[k] for k, p in params.items()},
            moments={(k, m): opts[k[0]].state[p][m].cpu() for k, p
                     in params.items() for m in ("exp_avg", "exp_avg_sq")},
            launches=K.LAUNCHES["fused_bias_lrelu"])
    c, g = runs["cpu"], runs["cuda"]
    loss_err = {k: abs(g["logs"][k] - v) / abs(v) for k, v in c["logs"].items()}
    moment_leaf_err, moment_worst = max(
        (((g["moments"][k] - r).norm() / r.norm()).item(), f"{k[0][0]}:"
         f"{k[0][1]}:{k[1]}") for k, r in c["moments"].items() if r.norm() > 0)
    moment_err = {}
    for net in ("G", "D"):
        for m in ("exp_avg", "exp_avg_sq"):
            keys = [k for k in c["moments"] if k[0][0] == net and k[1] == m]
            ref = torch.cat([c["moments"][k].reshape(-1) for k in keys])
            got = torch.cat([g["moments"][k].reshape(-1) for k in keys])
            moment_err[f"{net}:{m}"] = ((got - ref).norm()
                                        / ref.norm()).item()
    outside = total = 0
    leaf_out = {}
    for k, r in c["delta"].items():
        lim = GRAD_RTOL * r.abs().max() + GRAD_ATOL
        n_out = int(((g["delta"][k] - r).abs() > lim).sum())
        leaf_out[f"{k[0]}:{k[1]}"] = (n_out, r.numel())
        outside += n_out
        total += r.numel()
    share = 1.0 - outside / total
    want = alternation_launches(cfg, draws, 16, tr)
    ok = bool(fwd_ok and loss_err["l_d"] <= LOSS_RTOL
              and max(loss_err.values()) <= SG2_POST_RTOL
              and max(moment_err.values()) <= SG2_MOMENT_RTOL
              and share >= SG2_LEAF_SHARE
              and g["launches"] == want and c["launches"] == 0)
    say("stylegan2_parity", config=cfg, batch=b,
        image_max_abs_err=(img_g.cpu() - img_c).abs().max().item(),
        logits_max_abs_err=(logit_g.cpu() - logit_c).abs().max().item(),
        forward_tol=SG2_TOL, forward_launches=fwd_launches,
        losses_cpu=c["logs"], losses_card=g["logs"], loss_rel_err=loss_err,
        l_d_rtol=LOSS_RTOL, post_update_rtol=SG2_POST_RTOL,
        moment_l2_rel_err=moment_err, moment_rtol=SG2_MOMENT_RTOL,
        moment_worst_leaf=moment_worst, moment_worst_leaf_err=moment_leaf_err,
        leaf_elements_within=share,
        leaf_elements_outside_most=sorted(
            leaf_out.items(), key=lambda kv: -kv[1][0] / kv[1][1])[:4],
        leaf_share_min=SG2_LEAF_SHARE,
        leaf_tol=(GRAD_RTOL, GRAD_ATOL), styles=(len(draws["d_styles"]),
                                                 len(draws["g_styles"])),
        launches=g["launches"], expected_launches=want, ok=ok)
    if not ok:
        fail("stylegan2_parity: the card's StyleGAN2 disagrees with the CPU's")


def phase_stylegan2_sample(torch):
    """Config-f sampling at 1024x1024, B=4, bf16 then f32. Returns the K5
    launches of one forward per dtype."""
    from comfyui_keep_torch.models.stylegan2 import StyleGAN2Generator
    from comfyui_keep_torch.ops import kernels as K
    cfg, b = SG2_SAMPLE, SG2_BATCH
    g_net = StyleGAN2Generator(**cfg, device="cuda",
                               generator=torch.Generator().manual_seed(11))
    z = torch.randn(b, cfg["num_style_feat"], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    want = g_launches(cfg, 1)
    counts, images = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        net = copy.deepcopy(g_net).to(dtype) if dtype != torch.float32 \
            else g_net
        zd = z.to(dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            net([zd])                                     # warm-up
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net([zd])
                torch.cuda.synchronize()
                runs.append(1e3 * (time.perf_counter() - t0))
            K.reset_launch_counts()
            img, _ = net([zd])
            torch.cuda.synchronize()
        counts[dname] = dict(K.LAUNCHES)
        ms = float(np.median(runs))
        finite = bool(torch.isfinite(img).all())
        shape_ok = tuple(img.shape) == (b, 3, cfg["out_size"], cfg["out_size"])
        images[dname] = img.float()
        ok = bool(finite and shape_ok
                  and counts[dname]["fused_bias_lrelu"] == want
                  and counts[dname]["packed_conv2x2"] == 0)
        say("stylegan2_sample", dtype=dname, config=cfg, batch=b,
            ms_per_batch=ms, ms_runs=runs, images_per_s=b / (ms / 1e3),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            image_abs_max=img.float().abs().max().item(), finite=finite,
            shape_ok=shape_ok, k5_launches=counts[dname]["fused_bias_lrelu"],
            expected_k5_launches=want,
            k6_launches=counts[dname]["packed_conv2x2"], ok=ok)
        if not ok:
            fail(f"stylegan2_sample ({dname}): finite {finite}, shape "
                 f"{shape_ok}, K5 launches {counts[dname]} (want {want})")
        del img, net
    diff = (images["bfloat16"] - images["float32"]).abs()
    say("stylegan2_sample_bf16_vs_f32", max_abs=diff.max().item(),
        mean_abs=diff.mean().item(),
        f32_abs_mean=images["float32"].abs().mean().item())
    del g_net, images, diff
    torch.cuda.empty_cache()
    return counts


def phase_stylegan2_train(torch):
    """StyleGAN2Model at 256x256, B=4, f32: a warm-up alternation at
    iteration 16, then iterations 1..16. Returns the K5 launches of the 16
    alternations."""
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training.trainers import build_model
    size, b = SG2_TRAIN_SIZE, SG2_BATCH
    opt = sg2_opt()
    opt["network_g"] = {"out_size": size, "num_style_feat": 512,
                        "num_mlp": 8, "channel_multiplier": 2}
    opt["network_d"] = {"out_size": size, "channel_multiplier": 2}
    tr = build_model(opt)
    state = tr.make_state()
    g = torch.Generator(device="cuda").manual_seed(13)
    batch = {"gt": torch.rand((b, 3, size, size), generator=g,
                              device="cuda") * 2 - 1}
    params = dict(state.model.named_parameters())
    d_params = dict(tr.disc.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    d_before = {n: p.detach().clone() for n, p in d_params.items()}
    its = list(range(1, SG2_ALTERNATIONS + 1))
    cfg = {"out_size": size, "num_mlp": 8}
    want = sum(alternation_launches(cfg, tr.draw(it, b, state.model), it, tr)
               for it in its)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = tr.gan_train_step(state, batch, SG2_ALTERNATIONS)   # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    times, all_logs = {}, {}
    ema_leaf = "style_convs.0.modulated_conv.weight"
    for it in its:
        if it == its[-1]:
            ema_prev = state.ema[ema_leaf].clone()
        t0 = time.perf_counter()
        state, logs = tr.gan_train_step(state, batch, it)
        torch.cuda.synchronize()
        times[it] = 1e3 * (time.perf_counter() - t0)
        all_logs[it] = logs
    counts = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    decay = tr.ema_decay
    want_ema = ema_prev * decay + params[ema_leaf].detach() * (1 - decay)
    ema_err = (state.ema[ema_leaf] - want_ema).abs().max().item()
    ema_ok = ema_err <= 1e-7 * want_ema.abs().max().item()
    g_moved = [n for n, p in params.items() if not torch.equal(p, before[n])]
    d_moved = [n for n, p in d_params.items()
               if not torch.equal(p, d_before[n])]
    finite = all(math.isfinite(v) for lg in all_logs.values()
                 for v in lg.values())
    plain = [t for it, t in times.items() if it % tr.net_g_reg_every]
    path = [t for it, t in times.items()
            if it % tr.net_g_reg_every == 0 and it % tr.net_d_reg_every]
    r1_path = [t for it, t in times.items() if it % tr.net_d_reg_every == 0]
    n_r1 = sum("l_d_r1" in lg for lg in all_logs.values())
    n_path = sum("l_g_path" in lg for lg in all_logs.values())
    ok = bool(finite and tr.mean_path_length > 0 and ema_ok
              and len(g_moved) == len(params) and len(d_moved) == len(d_params)
              and n_r1 == 1 and n_path == 4
              and counts["fused_bias_lrelu"] == want
              and counts["packed_conv2x2"] == 0)
    say("stylegan2_train", size=size, batch=b, alternations=len(its),
        ms_plain_median=float(np.median(plain)), ms_path_median=float(
            np.median(path)), ms_r1_path=r1_path, ms_all=times,
        images_per_s=b / (float(np.median(plain)) / 1e3), peak_mem_gib=peak,
        losses_last=all_logs[its[-1]], mean_path_length=tr.mean_path_length,
        r1_alternations=n_r1, path_alternations=n_path,
        k5_launches=counts["fused_bias_lrelu"], expected_k5_launches=want,
        k5_launches_per_alternation=counts["fused_bias_lrelu"] / len(its),
        k6_launches=counts["packed_conv2x2"],
        g_leaves_moved=f"{len(g_moved)}/{len(params)}",
        d_leaves_moved=f"{len(d_moved)}/{len(d_params)}", ema_leaf=ema_leaf,
        ema_max_abs_err=ema_err, finite=finite, ok=ok)
    if not ok:
        fail(f"stylegan2_train: finite {finite}, mean path length "
             f"{tr.mean_path_length}, EMA {ema_ok}, G moved {len(g_moved)}/"
             f"{len(params)}, D moved {len(d_moved)}/{len(d_params)}, R1 "
             f"{n_r1}, path {n_path}, K5 launches "
             f"{counts['fused_bias_lrelu']} (want {want})")
    del tr, state, batch, params, d_params, before, d_before
    torch.cuda.empty_cache()
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, ROOT)
    from comfyui_keep_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi did not report the card: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("device", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        tf32="off (matmul and cudnn)")

    t0 = time.perf_counter()
    _build.build_all()
    say("build", seconds=time.perf_counter() - t0,
        ptxas={k: [ln for ln in v.splitlines() if "registers" in ln
                   or "spill" in ln] for k, v in _build.build_log.items()})

    krows = phase_kernels(torch)
    k6_rows = phase_k6(torch)
    vq_rows = phase_vq(torch)
    x, flows = phase_gmflow(torch)
    keep_k6 = phase_keep(torch, x, flows)
    counts, proc, faces, pack = phase_main(torch,
                                           k6_rows[(K6_OWN, "bfloat16")])
    phase_stream(torch, proc, faces)
    del proc
    phase_api(torch, pack)
    del pack
    torch.cuda.empty_cache()
    phase_train_parity(torch)
    train_counts = phase_train(torch)
    k5_rows = phase_k5(torch)
    phase_stylegan2_parity(torch)
    sample_counts = phase_stylegan2_sample(torch)
    sg2_train_counts = phase_stylegan2_train(torch)

    srcs = {"attention": ("comfyui_keep_torch/csrc/attention.cu",
                          "comfyui_keep_tpu/ops/pallas_kernels.py:210"),
            "global_correlation_expectation": (
                "comfyui_keep_torch/csrc/attention.cu",
                "comfyui_keep_tpu/ops/pallas_kernels.py:142"),
            "mlp_fused": ("comfyui_keep_torch/csrc/mlp.cu",
                          "comfyui_keep_tpu/ops/pallas_kernels.py:296"),
            "vq_nearest_indices": (
                "comfyui_keep_torch/csrc/vq.cu",
                "comfyui_keep_tpu/ops/pallas_kernels.py:51"),
            "fused_bias_lrelu": (
                "comfyui_keep_torch/csrc/fused_act.cu",
                "comfyui_keep_tpu/ops/pallas_kernels.py:98"),
            "packed_conv2x2": ("comfyui_keep_torch/csrc/packed_conv.cu",
                               "tools/_prof_packedconv.py:42")}
    table = []
    for (name, dname), r in krows.items():
        if dname != "bfloat16":
            continue
        src, replaces = srcs[name.split("[")[0]]
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": dname, "status": "ported",
            **({"unfused_ms": r["unfused_ms"]} if "unfused_ms" in r
               else {})})
    # the nearest-codebook kernel runs on the training path: f32 as
    # configured, bf16 under mixed precision; launches from those runs
    for (name, dname), r in vq_rows.items():
        src, replaces = srcs[name]
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train_counts[dname][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "dtype": dname, "status": "ported"})
    # K5 on StyleGAN2's paths: times at the largest activation; launches of
    # one 1024x1024 sampling forward in that dtype (the training run's f32
    # count over its 16 alternations beside it)
    for (shape, dname), r in k5_rows.items():
        if shape != K5_SHAPES[0]:
            continue
        src, replaces = srcs["fused_bias_lrelu"]
        table.append({
            "name": "fused_bias_lrelu", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sample_counts[dname]["fused_bias_lrelu"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": dname, "status": "ported",
            "launches_train_16_alternations": (
                sg2_train_counts["fused_bias_lrelu"]
                if dname == "float32" else None)})
    # K2's f32 form (erf gelu) runs on the f32 training step: its launches
    # from that run, its time at the chunk's rows and at the step's
    src, replaces = srcs["mlp_fused"]
    r, rs = krows[("mlp_fused", "float32")], krows[("mlp_fused[step]",
                                                   "float32")]
    table.append({
        "name": "mlp_fused", "route": "cuda", "source": src,
        "replaces": replaces,
        "launches": train_counts["float32"]["mlp_fused"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "unfused_ms": r["unfused_ms"], "dtype": "float32",
        "status": "ported", "step_rows_ms": rs["ms"],
        "step_rows_bound_ms": rs["bound_ms"],
        "step_rows_unfused_ms": rs["unfused_ms"],
        "launches_per": f"{TRAIN_STEPS} f32 training steps"})
    # K6 at its own shape, (257, 257, 256) VALID: bf16 with its launches
    # from the 21-face serving run, f32 with those of phase keep's packed
    # f32 forward (2 frames)
    for (label, dname), r in k6_rows.items():
        if label != K6_OWN:
            continue
        src, replaces = srcs["packed_conv2x2"]
        table.append({
            "name": "packed_conv2x2", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (counts["packed_conv2x2"] if dname == "bfloat16"
                         else keep_k6),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "unpacked_3x3_ms": r["unpacked_3x3_ms"], "dtype": dname,
            "status": "ported"})
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
