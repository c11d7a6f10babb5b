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
     detect   RetinaFace-ResNet50 (random weights, seed 0, f32) on 20
              synthetic 1280x720 frames through read_image and
              resize_for_detection (INTER_AREA to 1137x640, card against
              CPU bitwise): frame 0's raw heads card against CPU, the rows
              after the 0.97 threshold equal, ms per frame of the detector
              and of one detect_batch over the 20
     parse    ParseNet at 512^2, card against CPU: logits and the argmax
              agreement, ms per face
     unaligned  the whole-frame path through the api entry points, bf16,
              with a planted-face detector (the real RetinaFace on every
              frame plus planted FFHQ-template rows with landmark jitter)
              and ParseNet: restore_image on a 1280x720 frame with one face
              at factor 2 and on one with none (= its background resize),
              restore_sequence on 20 frames with two drifting faces (40
              faces, two 20-face chunks): shapes, the crops and paste-back
              card against CPU from the same rows, K1-K3 launches, ms per
              call and per face of detection, alignment, restore and paste
     nodes    the three ComfyUI nodes: the loader, both execution nodes with
              their default widgets ((None,): the loader builds no
              detector, as in the JAX package), an aligned face (=
              api.restore_image's pixels), an invalid pack, the pack
              offloaded after each call
     detect_yolo  YOLOv5n and YOLOv5l (random weights, seed 0, f32) on the
              20 frames of detect at their detection size: the 640^2
              letterbox card against CPU bitwise, the decoded predictions
              (25,200 x 16) card against CPU, the rows above 0.7, ms a
              frame, the best score
     parse_bisenet  BiSeNet at 512^2, card against CPU: logits and argmax
              agreement, ms a face
     upscale  RealESRGAN_x4plus, RealESRGAN_x2plus, realesr-general-x4v3
              and SwinIR-M x2 at their public widths, f32: card against CPU
              on a 64^2 tile, then tiled (512, overlap 64) on a 1280x720
              frame (ms, peak GiB); RealESRGANer.enhance (x2plus) on RGBA
              and gray frames, card against CPU small, timed at 720p
     full_workflow  BASELINE config 5: restore_sequence on the 20 frames
              of unaligned (40 planted faces), factor 2, KEEP bf16, YOLOv5l
              and BiSeNet, RealESRGAN_x2plus as background upscaler and
              realesr-general-x4v3 as face upscaler: shapes, finite chunks,
              K1-K3 launches (two GMFlow calls), one upscale per face and
              per frame, no cv2; ms a face by stage
     chunks   grouped chunk serving: 41 aligned 512^2 faces through
              restore_face_stream (bf16, 20-frame chunks,
              chunks_per_dispatch=2: a group of two chunks, then a
              duplicated 1-frame tail) in each chunk_batching form ("map",
              "batch", "stage"): ms a face, K1-K4 launches checked (GMFlow
              once per chunk in "map", once per group in the others, by
              form and at the group's shapes), the uint8 difference from
              "map" (reported) and "map" equal to the per-chunk loop bit
              for bit; each form's group program (restore_group) at G = 2
              and 4 chunks: ms a face (median of 3) and peak GiB; GMFlow on
              the group against GMFlow on each chunk (f32 gated in px), the
              forms' KEEP with forced picks against the group's; one group
              of each form with phase512=True, K6 launches checked
     need_upscale  KEEP.apply(need_upscale=True) on a 2-frame 128^2 clip,
              f32, card against CPU, picks forced from the CPU run
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
 16. gmflow_refine  GMFlow(num_scales=2) at full width (random weights, seed
              0) on two 512^2 pairs: apply_refine forward and bidirectional,
              f32 card against CPU (pixels), bf16 finite; GMFlow.apply with
              corr_radius=4 and prop_radius=1 card against CPU; the
              occlusion check on the bidirectional flows (scaled so both
              masks hold both values; the share that flips gated); ms a
              pair; K1-K3 launches a call checked, by form and by shape
              (L = 256 windows under the (64, 256, 256) mask at 1/4)
 17. vqgan    at 512^2, f32, card against CPU: VQAutoEncoder at full width
              with the nearest quantizer (codes equal to the CPU's but at
              near-ties, its generator on the CPU's codes; K4 once a
              forward, held against its plain version at T = 256) and with
              the Gumbel quantizer on one seeded draw; VQGANDiscriminator;
              Discriminator3D on (1, 8, 512, 512, 3)
 18. native   dcn_v2_pack at EDVR's shape (64 channels, 8 deformable groups,
              a 180x320 map) and correlation(max_displacement=4), card
              against CPU, ms
The kernel phase also holds K1 at the refinement's fine scale (L = 256,
the (64, 256, 256) mask, 256 windows) in both dtypes, and K1-K3 in bf16 at
the shapes of a group of 2 chunks (the "G2" rows). The kernel table's
K1-K4 rows carry their launches on slice 7's paths (launches_chunk_*,
launches_refine, launches_vqgan; null where a path did not run in the
row's dtype), taken from the kernels' own counters: the L256 and G2 rows
count their own shape alone (ops/kernels.py LAUNCHES_BY_SHAPE). A row
with no launch on its path fails the run.
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
REFINE_FEAT, REFINE_WINDOWS = 128, 64   # refinement's 1/4 scale of 512^2
CHUNK_RUNS = 3       # timed 41-face runs per chunk form, after a warm-up
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
# the whole-frame path: 1280x720 frames (capped at a 640 short side for
# detection); RetinaFace's and ParseNet's f32 heads card against CPU relative
# to their largest magnitude (cuDNN and the CPU sum in other orders, TF32
# off); the paste-back card against CPU in uint8 levels (blur and parser
# summation orders)
WHOLE_HW = (720, 1280)
DETECT_RTOL = 1e-3
UNALIGNED_LEVELS = 2
# BASELINE config 5's pieces: YOLOv5-face at the reference's 640 letterbox
# and the helper's 0.7 default threshold; the upscalers at their public
# configurations (Real-ESRGAN's RealESRGAN_x4plus / x2plus and
# realesr-general-x4v3, SwinIR's classical x2 SwinIR-M), in f32 as the JAX
# package runs them, each card against CPU on one 64^2 tile within
# SR_RTOL of the largest magnitude, then tiled as ComfyUI tiles (512, 64)
YOLO_SIZE, YOLO_THRESHOLD = 640, 0.7
SR_RTOL = 1e-3
SR_TILE, SR_OVERLAP = 512, 64
SR_MODELS = {
    "RealESRGAN_x4plus": ("RRDBNet", 4, dict(scale=4, num_feat=64,
                                             num_block=23, num_grow_ch=32)),
    "RealESRGAN_x2plus": ("RRDBNet", 2, dict(scale=2, num_feat=64,
                                             num_block=23, num_grow_ch=32)),
    "realesr-general-x4v3": ("SRVGGNetCompact", 4, dict(
        num_feat=64, num_conv=32, upscale=4, act_type="prelu")),
    "SwinIR-M_x2": ("SwinIR", 2, dict(
        upscale=2, in_chans=3, window_size=8, img_range=1.0,
        depths=(6,) * 6, embed_dim=180, num_heads=(6,) * 6, mlp_ratio=2.0,
        upsampler="pixelshuffle", resi_connection="1conv")),
}

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
# the VQGAN family's and the native ops' f32 outputs, card against CPU,
# relative to their largest magnitude (cuDNN and the CPU sum in other orders)
VQ_FAMILY_RTOL = 1e-3
# occlusion masks of the refinement's bidirectional flows, card against
# CPU: the share of pixels that may flip at the threshold
OCC_FLIP_SHARE = 1e-3
K1_K4 = ("attention[dv128]", "attention[dv128+bias]", "attention[dv2]",
         "global_correlation_expectation", "mlp_fused", "vq_nearest_indices")
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
    rtol, unfused PyTorch calls or None, launch key) at the shapes one
    20-frame 512x512 chunk gives each kernel; in bf16 also at the shapes of
    a group of G = 2 chunks ("G2", the "batch" and "stage" chunk forms); in
    both dtypes K1 at the refinement's fine scale ("L256"). The launch key
    is the LAUNCHES_BY_SHAPE key of a G2 or L256 case's shape, None for a
    case whose launches are its counter's over every shape."""
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

    # GMFlow refinement's fine scale (two 512^2 pairs): 256-token windows of
    # the 128x128 maps split 8 x 8, both images of both pairs, under the
    # (64, 256, 256) shifted-window mask on odd layers
    br, lr = 2 * 2 * REFINE_WINDOWS, (REFINE_FEAT // 8) ** 2
    qr, vr = rnd(br, lr, CH), rnd(br, lr, CH)
    kr = matched_keys(torch, qr, 0.7, g)
    mask_r = torch.as_tensor(shifted_window_mask(REFINE_FEAT, REFINE_FEAT, 8),
                             device=dev)
    mask_r_full = mask_r.repeat(br // REFINE_WINDOWS, 1, 1)[:, None].to(dtype)
    att_r = 2 * br * lr * lr * CH
    att_fl = 2 * bw * lw * lw * CH
    glb_fl = 2 * bg * lg * lg * CH
    exp_fl = 2 * bg * lg * lg * 2      # the 2-wide product
    rows = bw * lw
    rtol = KERNEL_RTOL[dname]
    step = [] if tanh else [
        ("mlp_fused[step]", "mlp_fused",
         (ssrc, smsg, w1, w2, gamma, beta, tanh),
         None, [(6 * ssrc.numel() * HID, peak)],
         3 * ssrc.numel() * isz + 3 * CH * HID * isz, rtol,
         lambda: mlp_unfused_at(ssrc, smsg), None)]
    group = []
    if tanh:
        # bf16, the grouped chunk forms' GMFlow at B = 2 clips: twice the
        # windows, maps and rows of one chunk, on fresh inputs (a batch
        # index that wraps at one chunk's count reads other data)
        bw2, bg2 = 2 * bw, 2 * bg
        q2, v2 = rnd(bw2, lw, CH), rnd(bw2, lw, CH)
        k2 = matched_keys(torch, q2, 0.7, g)
        mask2_full = mask.repeat(bw2 // WINDOWS, 1, 1)[:, None].to(dtype)
        qg2 = rnd(bg2, lg, CH)
        kg2 = matched_keys(torch, qg2, 0.8, g)
        vg2 = rnd(bg2, lg, 2, scale=8.0)
        grid_b2 = grid.to(dtype).expand(bg2, lg, 2)
        src2, msg2 = rnd(bw2, lw, CH), rnd(bw2, lw, CH)
        group = [
            ("attention[dv128] G2", "attention", (q2, k2, v2, scale),
             sdpa(q2, k2, v2), [(4 * att_fl, peak)], 4 * q2.numel() * isz,
             rtol, None, f"attention[dv128] B{bw2} L{lw}"),
            ("attention[dv128+bias] G2", "attention",
             (q2, k2, v2, scale, mask), sdpa(q2, k2, v2, mask2_full),
             [(4 * att_fl, peak)], 4 * q2.numel() * isz + mask.numel() * 4,
             rtol, None, f"attention[dv128+bias] B{bw2} L{lw}"),
            ("attention[dv2] G2", "attention", (qg2, kg2, vg2, scale),
             sdpa(qg2, kg2, vg2), [(2 * (glb_fl + exp_fl), peak)],
             (2 * qg2.numel() + 2 * vg2.numel()) * isz, rtol, None,
             f"attention[dv2] B{bg2} L{lg}"),
            ("global_correlation_expectation G2",
             "global_correlation_expectation", (qg2, kg2, grid),
             lambda: F.scaled_dot_product_attention(qg2, kg2, grid_b2,
                                                    scale=scale),
             [(2 * glb_fl, peak), (2 * exp_fl, PEAK_F32)],
             2 * qg2.numel() * isz + grid.numel() * 4 + bg2 * lg * 2 * 4,
             KERNEL_RTOL["float32"], None,
             f"global_correlation_expectation B{bg2} L{lg}"),
            ("mlp_fused G2", "mlp_fused",
             (src2, msg2, w1, w2, gamma, beta, tanh), None,
             [(12 * rows * CH * HID, peak)],
             3 * src2.numel() * isz + 3 * CH * HID * isz, rtol,
             lambda: mlp_unfused_at(src2, msg2), f"mlp_fused rows{2 * rows}"),
        ]
    return [
        ("attention[dv128]", "attention", (q, k, v, scale),
         sdpa(q, k, v), [(2 * att_fl, peak)], 4 * q.numel() * isz, rtol,
         None, None),
        ("attention[dv128+bias]", "attention", (q, k, v, scale, mask),
         sdpa(q, k, v, mask_full), [(2 * att_fl, peak)],
         4 * q.numel() * isz + mask.numel() * 4, rtol, None, None),
        ("attention[dv128] L256", "attention", (qr, kr, vr, scale),
         sdpa(qr, kr, vr), [(2 * att_r, peak)], 4 * qr.numel() * isz, rtol,
         None, f"attention[dv128] B{br} L{lr}"),
        ("attention[dv128+bias] L256", "attention", (qr, kr, vr, scale,
                                                     mask_r),
         sdpa(qr, kr, vr, mask_r_full), [(2 * att_r, peak)],
         4 * qr.numel() * isz + mask_r.numel() * 4, rtol, None,
         f"attention[dv128+bias] B{br} L{lr}"),
        ("attention[dv2]", "attention", (qg, kg, vg, scale),
         sdpa(qg, kg, vg), [(glb_fl + exp_fl, peak)],
         (2 * qg.numel() + 2 * vg.numel()) * isz, rtol, None, None),
        # softmax and expectation stay f32 in both dtypes: f32 tolerance
        ("global_correlation_expectation", "global_correlation_expectation",
         (qg, kg, grid),
         lambda: F.scaled_dot_product_attention(qg, kg, grid_b, scale=scale),
         [(glb_fl, peak), (exp_fl, PEAK_F32)],
         2 * qg.numel() * isz + grid.numel() * 4 + bg * lg * 2 * 4,
         KERNEL_RTOL["float32"], None, None),
        ("mlp_fused", "mlp_fused",
         (src, msg, w1, w2, gamma, beta, tanh),
         None, [(6 * rows * CH * HID, peak)],
         3 * src.numel() * isz + 3 * CH * HID * isz, rtol,
         lambda: mlp_unfused_at(src, msg), None),
    ] + group + step


def phase_kernels(torch, iters=KERNEL_ITERS):
    from comfyui_keep_torch.ops import kernels as K
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, fn_name, args, lib, flops, nbytes, rtol, unfused, key in \
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
                   "launch_key": key, "ok": bool(err <= tol)}
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


# -- whole frames: detection, parsing, the unaligned restore, the nodes ------

def whole_frames(n, seed):
    """n synthetic 1280x720 uint8 BGR frames: smooth colour ramps plus
    noise (random weights find no face in them; faces are planted)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:WHOLE_HW[0], 0:WHOLE_HW[1]].astype(np.float32)
    out = []
    for _ in range(n):
        base = np.stack([(xx * rng.uniform(0.05, 0.2) + yy * rng.uniform(
            0.05, 0.2) + rng.uniform(0, 255)) % 256 for _ in range(3)], -1)
        noise = rng.normal(0, 12, base.shape)
        out.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return out


def planted_landmarks(scale, angle_deg, cx, cy):
    """The FFHQ 5-point template under a similarity placed at (cx, cy), as
    tests/test_e2e_configs.py places its synthetic faces."""
    from comfyui_keep_torch.facelib.helper import FFHQ_TEMPLATE_512
    t = FFHQ_TEMPLATE_512 - FFHQ_TEMPLATE_512.mean(0)
    th = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (t @ rot.T) * scale + np.array([cx, cy])


def planted_row(landmarks, score=0.999):
    lm = np.asarray(landmarks, np.float32)
    x1, y1 = lm.min(0) - 10
    x2, y2 = lm.max(0) + 10
    return np.concatenate([[x1, y1, x2, y2, score],
                           lm.reshape(-1)]).astype(np.float32)


class StageTimer:
    """ms spent in wrapped calls, each bracketed by cuda.synchronize()."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {}

    def wrap(self, name, fn):
        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + 1e3 * (
                time.perf_counter() - t0)
            return out
        return timed


class PlantedDetector:
    """A detector for chip_smoke.py only: the real detector on the card on
    every frame (RetinaFace's detect_batch on every clip; YOLO, which has
    none, frame by frame; timed as "detect"), its rows kept (none, with
    random weights), and `planted[i]` appended to frame i's (i counts the
    single-frame calls since `planted` was set): rows in the frame's own
    coordinates, scaled to the detection image the helper hands in.
    `.model` is the real module, which the pack moves."""

    def __init__(self, detector, timer):
        self.single = timer.wrap("detect", detector)
        if hasattr(detector, "detect_batch"):
            self.batch = timer.wrap("detect", detector.detect_batch)
        else:
            self.detect_batch = None      # the helper detects frame by frame
        self.model = detector.model
        self._planted, self.calls = [], 0
        self.real_rows = 0

    @property
    def planted(self):
        return self._planted

    @planted.setter
    def planted(self, rows):
        self._planted, self.calls = rows, 0

    def _rows(self, real, i, det_h):
        self.real_rows += len(real)
        extra = np.asarray(self.planted[i], np.float32).reshape(-1, 15)
        return np.concatenate([real, extra * (det_h / WHOLE_HW[0])])

    def __call__(self, img, conf_threshold=0.8):
        i = self.calls % len(self.planted)
        self.calls += 1
        return self._rows(self.single(img, conf_threshold), i, img.shape[0])

    def detect_batch(self, frames, conf_threshold=0.8):
        reals = self.batch(frames, conf_threshold)
        return [self._rows(r, i, frames.shape[1]) for i, r in enumerate(reals)]


def rel_err(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def phase_detect(torch):
    """RetinaFace-ResNet50 from the factory (random weights, seed 0), f32,
    TF32 off, on 20 synthetic 1280x720 frames through read_image and
    resize_for_detection (INTER_AREA to 1137x640, card against CPU,
    bitwise): the raw box, score and landmark heads of frame 0 card against
    CPU within DETECT_RTOL of their largest magnitude; the rows after the
    0.97 threshold equal (priors within 1e-4 of it reported, not gated);
    ms per frame of the detector, and of one detect_batch over the 20.
    Returns the card detector."""
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.facelib.helper import FaceRestoreHelper
    from comfyui_keep_torch.models.retinaface import filter_sort_nms
    det = factory.init_detection_model("retinaface_resnet50",
                                       require_weights=False, seed=0)
    cpu = factory.init_detection_model("retinaface_resnet50",
                                       require_weights=False, seed=0,
                                       device="cpu")
    frames = whole_frames(FRAMES, seed=10)
    helper = FaceRestoreHelper()
    smalls = []
    for f in frames:
        helper.read_image(f)
        small, back = helper.resize_for_detection()
        smalls.append(small)
    helper_cpu = FaceRestoreHelper(device="cpu")
    helper_cpu.read_image(frames[0])
    small_cpu = helper_cpu.resize_for_detection()[0]
    area_equal = bool(torch.equal(smalls[0].cpu(), small_cpu))
    with torch.no_grad():
        x = smalls[0][None]
        raw = det.model(det.model.prepare(x))
        raw_cpu = cpu.model(cpu.model.prepare(small_cpu[None]))
        heads = det.model.decoded(x)
        heads_cpu = cpu.model.decoded(small_cpu[None])
    errs = {n: rel_err(g, c) for n, g, c in zip(("loc", "conf", "landms"),
                                                raw, raw_cpu)}
    h, w = small_cpu.shape[:2]
    scale = np.array([w, h, w, h], np.float32)
    scale1 = np.array([w, h] * 5, np.float32)
    rows = [filter_sort_nms(b[0].cpu().numpy() * scale, s[0].cpu().numpy(),
                            l[0].cpu().numpy() * scale1, 0.97, 0.4)
            for b, s, l in (heads, heads_cpu)]
    scores = heads_cpu[1][0]
    near = int(((scores - 0.97).abs() < 1e-4).sum())
    rows_equal = (rows[0].shape == rows[1].shape
                  and bool(np.allclose(rows[0], rows[1], atol=1e-2)))
    stack = torch.stack(smalls)
    det(smalls[0], 0.97)
    det.detect_batch(stack, 0.97)
    single = []
    for s in smalls[:5]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det(s, 0.97)
        single.append(1e3 * (time.perf_counter() - t0))
    batch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_frame = det.detect_batch(stack, 0.97)
        batch.append(1e3 * (time.perf_counter() - t0))
    ok = bool(area_equal and max(errs.values()) <= DETECT_RTOL
              and (rows_equal or near) and len(per_frame) == FRAMES)
    say("detect", frames=FRAMES, frame_hw=list(WHOLE_HW),
        detection_hw=[h, w], priors=int(scores.numel()),
        area_resize_card_equals_cpu=area_equal, heads_rel_err=errs,
        tol_rel=DETECT_RTOL, rows_card=len(rows[0]), rows_cpu=len(rows[1]),
        rows_equal=rows_equal, max_face_score=float(scores.max()),
        priors_near_threshold=near,
        detector_ms_per_frame=float(np.median(single)),
        detect_batch_ms=float(np.median(batch)),
        detect_batch_ms_per_frame=float(np.median(batch)) / FRAMES, ok=ok)
    if not ok:
        fail(f"detect: area {area_equal}, heads {errs}, rows {rows_equal} "
             f"(near threshold {near})")
    return det


def phase_parse(torch):
    """ParseNet at 512^2 from the factory (random weights, seed 0), f32:
    the logits card against CPU within DETECT_RTOL of their largest
    magnitude, the argmax agreement (reported), ms per face. Returns the
    card parser."""
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    parser = factory.init_parsing_model("parsenet", require_weights=False,
                                        seed=0)
    cpu = factory.init_parsing_model("parsenet", require_weights=False,
                                     seed=0, device="cpu")
    face = np.random.default_rng(11).integers(0, 256, (512, 512, 3),
                                              dtype=np.uint8)
    x = bgr_u8_to_rgb_pm1(face)[None]
    got, ref = parser(x), cpu(x)
    err = rel_err(got, ref)
    agree = float((got.argmax(-1).cpu() == ref.argmax(-1)).float().mean())
    ms = time_ms(torch, lambda: parser(x), 10)
    ok = bool(err <= DETECT_RTOL and got.shape == (1, 512, 512, 19))
    say("parse", logits_rel_err=err, tol_rel=DETECT_RTOL,
        argmax_agreement=agree, ms_per_face=ms, ok=ok)
    if not ok:
        fail(f"parse: logits rel err {err} > {DETECT_RTOL}")
    return parser


def phase_unaligned(torch, detector, parser):
    """The whole-frame restore through the api entry points, bf16, on a
    pack from api.load_models(detector=planted RetinaFace, parser=ParseNet):
    restore_image on a 1280x720 frame with one planted face at factor 2
    (parse mask on), on a frame with none (which must equal the background's
    LANCZOS4 resize, bitwise), and restore_sequence on 20 frames with two
    planted faces drifting a few px a frame (landmark jitter of 1 px x
    scale, so LMedS matters), only_center_face=False: 40 faces in two
    20-face chunks. Gates: shapes and uint8; the face-free frame; every
    frame with faces differs from its background; the image call's crops
    equal the port's on the CPU from the same landmarks, bitwise, and its
    paste-back (the same restored faces and matrices, the parser on the
    CPU) within UNALIGNED_LEVELS; K1-K3 launches of one GMFlow call for the
    image, two for the sequence, nothing of K4-K6; cv2 never imported.
    Reported: ms per call, and ms per face of detection, alignment, restore
    and paste. Returns the sequence's launch counts."""
    from comfyui_keep_torch import api
    from comfyui_keep_torch.facelib.helper import FaceRestoreHelper
    from comfyui_keep_torch.models.parsenet import make_parser_fn
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
    from comfyui_keep_torch.utils.resize import resize
    timer = StageTimer(torch)
    planted = PlantedDetector(detector, timer)
    pack = api.load_models(seed=0, detector=planted, parser=parser)
    pack.load_device(torch.bfloat16)
    helper = pack.face_helper
    helper.align_warp_face = timer.wrap("align", helper.align_warp_face)
    helper.paste_faces_to_input_image = timer.wrap(
        "paste", helper.paste_faces_to_input_image)
    stream = KEEPFaceProcessor.restore_face_stream
    KEEPFaceProcessor.restore_face_stream = timer.wrap("restore", stream)
    rng = np.random.default_rng(12)
    one = whole_frames(2, seed=13)
    frames = whole_frames(FRAMES, seed=14)
    up = (WHOLE_HW[0] * 2, WHOLE_HW[1] * 2, 3)
    try:
        # one planted face, factor 2, parse mask on
        lm = planted_landmarks(0.8, 6.0, 640, 380)
        planted.planted = [[planted_row(lm + rng.normal(0, 0.8, (5, 2)))]]
        K.reset_launch_counts()
        timer.ms.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = api.restore_image(pack, one[0], 2.0, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        image_ms = 1e3 * (time.perf_counter() - t0)
        image_counts = dict(K.LAUNCHES)
        image_stages = dict(timer.ms)
        crops = [c.copy() for c in helper.cropped_faces]
        restored = list(helper.restored_faces)
        matrices = list(helper.affine_matrices)
        landmarks = list(helper.all_landmarks_5)
        # the same rows on the CPU: crops bitwise, paste-back within tolerance
        cpu = FaceRestoreHelper(
            face_size=helper.face_size[0], parser=make_parser_fn(copy.deepcopy(
                parser.model).cpu()), device="cpu")
        cpu.read_image(one[0])
        cpu.all_landmarks_5 = landmarks
        cpu.align_warp_face()
        crops_equal = (len(crops) == 1 and all(
            np.array_equal(a, b) for a, b in zip(crops, cpu.cropped_faces)))
        cpu.restored_faces = restored
        cpu.affine_matrices = matrices
        cpu.upscale_factor = 2.0
        cpu.get_inverse_affine()
        bg = resize(one[0], up[1::-1], "lanczos4")
        paste_cpu = cpu.paste_faces_to_input_image(upsample_img=bg)
        d = np.abs(image.astype(int) - paste_cpu.astype(int))
        paste_max, paste_mean = int(d.max()), float(d.mean())
        # no face: the background resize, bitwise
        planted.planted = [[]]
        empty = api.restore_image(pack, one[1], 2.0, dtype=torch.bfloat16)
        empty_equal = bool(np.array_equal(
            empty, resize(one[1], up[1::-1], "lanczos4")))
        # the clip: two planted faces a frame, drifting
        planted.planted = [
            [planted_row(planted_landmarks(0.55, 6.0, 420 + 3 * i, 330 + 2 * i)
                         + rng.normal(0, 0.55, (5, 2))),
             planted_row(planted_landmarks(0.45, -12.0, 900 - 2 * i, 400 + i)
                         + rng.normal(0, 0.45, (5, 2)))]
            for i in range(FRAMES)]
        K.reset_launch_counts()
        timer.ms.clear()
        faces_seen = []
        KEEPFaceProcessor.restore_face_stream = timer.wrap(
            "restore", lambda self, faces, *a, **k: faces_seen.append(
                len(faces)) or stream(self, faces, *a, **k))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = api.restore_sequence(pack, frames, 2.0, only_center_face=False,
                                    dtype=torch.bfloat16)
        torch.cuda.synchronize()
        seq_ms = 1e3 * (time.perf_counter() - t0)
        seq_counts = dict(K.LAUNCHES)
        seq_stages = dict(timer.ms)
    finally:
        KEEPFaceProcessor.restore_face_stream = stream
    n_faces = sum(faces_seen)
    gmflow_call = {"attention[dv128]": 6, "attention[dv128+bias]": 6,
                   "attention[dv2]": 1, "mlp_fused": 6,
                   "global_correlation_expectation": 1,
                   "vq_nearest_indices": 0, "fused_bias_lrelu": 0,
                   "packed_conv2x2": 0}
    want_seq = {k: 2 * v for k, v in gmflow_call.items()}
    shapes_ok = (image.shape == up and image.dtype == np.uint8
                 and len(outs) == FRAMES and all(
                     o.shape == up and o.dtype == np.uint8 for o in outs))
    pasted = bool(not np.array_equal(image, bg) and all(
        not np.array_equal(o, resize(f, up[1::-1], "lanczos4"))
        for o, f in zip(outs[:2], frames[:2])))
    ok = bool(shapes_ok and pasted and empty_equal and crops_equal
              and paste_max <= UNALIGNED_LEVELS and n_faces == 2 * FRAMES
              and image_counts == gmflow_call and seq_counts == want_seq
              and "cv2" not in sys.modules)

    def per_face(stages, n):
        return {k: v / max(n, 1) for k, v in stages.items()}

    say("unaligned", image_ms=image_ms, image_faces=len(crops),
        image_stage_ms_per_face=per_face(image_stages, len(crops)),
        image_launches=image_counts, expected_image_launches=gmflow_call,
        crops_card_equal_cpu=crops_equal, paste_vs_cpu_max_levels=paste_max,
        paste_vs_cpu_mean_levels=paste_mean, tol_levels=UNALIGNED_LEVELS,
        no_face_equals_background=empty_equal, sequence_frames=FRAMES,
        sequence_faces=n_faces, sequence_ms=seq_ms,
        sequence_ms_per_face=seq_ms / max(n_faces, 1),
        sequence_stage_ms_per_face=per_face(seq_stages, n_faces),
        sequence_launches=seq_counts, expected_sequence_launches=want_seq,
        real_detector_rows=planted.real_rows, output_hw=list(up[:2]),
        outputs_uint8=shapes_ok, faces_pasted=pasted,
        cv2_imported="cv2" in sys.modules, ok=ok)
    if not ok:
        fail(f"unaligned: shapes {shapes_ok}, pasted {pasted}, empty "
             f"{empty_equal}, crops {crops_equal}, paste {paste_max}, faces "
             f"{n_faces}, launches {image_counts} / {seq_counts}")
    return seq_counts


def phase_nodes(torch):
    """The three nodes: the loader builds a pack (random KEEP, f32); both
    execution nodes on ComfyUI IMAGE arrays with their default widgets
    (whole frames) return (None,), as the JAX nodes do, since the loader
    builds no detector; an aligned 512^2 face through the image node gives
    api.restore_image's pixels; aligned frames through the sequence node
    come back as they went in; an invalid pack gives (None,); the pack ends
    offloaded after each call."""
    from comfyui_keep_torch import api, nodes
    from comfyui_keep_torch.utils.image import comfy_to_cv2, cv2_to_comfy
    loader = nodes.KEEP_ModelLoaderNode()
    req = loader.INPUT_TYPES()["required"]
    pack, = loader.load_model_pack(req["model"][1]["default"],
                                   req["detection_model"][1]["default"])

    def defaults(node):
        return {k: v[1]["default"] for k, v in
                node.INPUT_TYPES()["required"].items()
                if len(v) > 1 and "default" in v[1]}

    def on_host():
        return all(p.device.type == "cpu" for m in pack.models()
                   for p in m.parameters())

    img_node = nodes.KEEP_FaceUpscaleImageNode()
    seq_node = nodes.KEEP_ProcessImageSequenceNode()
    frames = np.stack(whole_frames(2, seed=15))[..., ::-1] / np.float32(255)
    frames = frames.astype(np.float32)
    rng = np.random.default_rng(16)
    faces = rng.random((2, 512, 512, 3)).astype(np.float32)
    rows = {}
    rows["image_default_widgets"] = img_node.upscale_face_image(
        frames[:1], pack, **defaults(img_node)) == (None,) and on_host()
    rows["sequence_default_widgets"] = seq_node.process_sequence(
        frames, pack, **defaults(seq_node)) == (None,) and on_host()
    t0 = time.perf_counter()
    out, = img_node.upscale_face_image(faces[:1], pack, 1.0, True, True,
                                       False)
    node_ms = 1e3 * (time.perf_counter() - t0)
    rows["image_aligned_offloaded"] = on_host()
    want = cv2_to_comfy(api.restore_image(pack, comfy_to_cv2(faces[:1]), 1.0,
                                          has_aligned=True))
    pack.offload()
    diff = (None if out is None or out.shape != want.shape
            else float(np.abs(out - want).max() * 255))
    rows["image_aligned_equals_api"] = diff == 0.0
    seq, = seq_node.process_sequence(faces, pack, 1.0, True, True, False, 20)
    rows["sequence_aligned_returns_frames"] = bool(
        seq is not None and np.array_equal(
            seq, np.concatenate([cv2_to_comfy(comfy_to_cv2(f)) for f in faces])))
    rows["sequence_aligned_offloaded"] = on_host()
    rows["invalid_pack"] = img_node.upscale_face_image(
        faces[:1], object(), 1.0, True, True, False) == (None,)
    ok = bool(all(rows.values()))
    say("nodes", checks=rows, aligned_image_max_diff_levels=diff,
        aligned_image_node_ms=node_ms, cv2_imported="cv2" in sys.modules,
        ok=ok and "cv2" not in sys.modules)
    if not ok or "cv2" in sys.modules:
        fail(f"nodes: {rows}")


def phase_detect_yolo(torch):
    """YOLOv5n and YOLOv5l from the factory (random weights, seed 0), f32,
    on the 20 synthetic 1280x720 frames of phase detect, through read_image
    and resize_for_detection (1137x640) as the helper feeds a detector:
    frame 0's letterbox (to 640^2, 140 rows of 114 above and below the
    640x360 frame) card against CPU, bitwise; its decoded predictions
    (25,200 x 16) card against CPU within DETECT_RTOL of their largest
    magnitude; the rows above the 0.7 threshold equal (scores within 1e-4
    of it reported); ms a frame of the detector (letterbox, network, decode,
    NMS, undo) over the 20 frames; the best score. Returns the YOLOv5l
    detector on the card."""
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.facelib.helper import FaceRestoreHelper
    from comfyui_keep_torch.facelib.yolov5face import letterbox
    frames = whole_frames(FRAMES, seed=10)
    helper = FaceRestoreHelper()
    smalls = []
    for f in frames:
        helper.read_image(f)
        smalls.append(helper.resize_for_detection()[0])
    helper_cpu = FaceRestoreHelper(device="cpu")
    helper_cpu.read_image(frames[0])
    small_cpu = helper_cpu.resize_for_detection()[0]
    box_card = letterbox(smalls[0].flip(-1), YOLO_SIZE)
    box_cpu = letterbox(small_cpu.flip(-1), YOLO_SIZE)
    box_equal = bool(torch.equal(box_card[0].cpu(), box_cpu[0])
                     and box_card[1:] == box_cpu[1:])
    rows, ok_all, dets = {}, box_equal, {}
    for name in ("YOLOv5n", "YOLOv5l"):
        det = factory.init_detection_model(name, require_weights=False,
                                           seed=0)
        cpu = factory.init_detection_model(name, require_weights=False,
                                           seed=0, device="cpu")
        pred = det.predictions(smalls[0])[0]
        pred_cpu = cpu.predictions(small_cpu)[0]
        err = rel_err(pred, pred_cpu)
        conf = (pred_cpu[:, 4] * pred_cpu[:, 15])
        near = int(((conf - YOLO_THRESHOLD).abs() < 1e-4).sum())
        got = det(smalls[0], YOLO_THRESHOLD)
        want = cpu(small_cpu, YOLO_THRESHOLD)
        rows_equal = (got.shape == want.shape
                      and bool(np.allclose(got, want, atol=1e-2)))
        det(smalls[0], YOLO_THRESHOLD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = 0.0
        for sm in smalls:
            det(sm, YOLO_THRESHOLD)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(smalls)
        for sm in smalls:
            p = det.predictions(sm)[0]
            best = max(best, float((p[:, 4] * p[:, 15]).max()))
        ok = bool(err <= DETECT_RTOL and tuple(pred.shape) == (25200, 16)
                  and (rows_equal or near))
        ok_all &= ok
        rows[name] = dict(predictions=list(pred.shape), pred_rel_err=err,
                          rows_card=len(got), rows_cpu=len(want),
                          rows_equal=rows_equal, scores_near_threshold=near,
                          best_score=best, ms_per_frame=ms, ok=ok)
        dets[name] = det
        del cpu
    say("detect_yolo", frames=FRAMES, detection_hw=list(small_cpu.shape[:2]),
        letterbox_hw=list(box_cpu[0].shape[:2]), letterbox_pad=box_cpu[2],
        letterbox_card_equals_cpu=box_equal, tol_rel=DETECT_RTOL,
        threshold=YOLO_THRESHOLD, models=rows, ok=bool(ok_all))
    if not ok_all:
        fail(f"detect_yolo: letterbox {box_equal}, {rows}")
    return dets["YOLOv5l"]


def phase_parse_bisenet(torch):
    """BiSeNet from the factory (random weights, seed 0), f32, on a 512^2
    face: the main head's logits card against CPU within DETECT_RTOL of
    their largest magnitude, the argmax agreement (reported), ms a face.
    Returns the card parser."""
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    parser = factory.init_parsing_model("bisenet", require_weights=False,
                                        seed=0)
    cpu = factory.init_parsing_model("bisenet", require_weights=False,
                                     seed=0, device="cpu")
    face = np.random.default_rng(17).integers(0, 256, (512, 512, 3),
                                              dtype=np.uint8)
    x = bgr_u8_to_rgb_pm1(face)[None]
    got, ref = parser(x), cpu(x)
    err = rel_err(got, ref)
    agree = float((got.argmax(-1).cpu() == ref.argmax(-1)).float().mean())
    ms = time_ms(torch, lambda: parser(x), 10)
    ok = bool(err <= DETECT_RTOL and got.shape == (1, 512, 512, 19))
    say("parse_bisenet", logits_rel_err=err, tol_rel=DETECT_RTOL,
        argmax_agreement=agree, ms_per_face=ms, ok=ok)
    if not ok:
        fail(f"parse_bisenet: logits rel err {err} > {DETECT_RTOL}")
    return parser


def sr_model(torch, name, device):
    """One of SR_MODELS at full width, random weights from seed 0."""
    from comfyui_keep_torch.models import sr_basic, swinir
    arch, _, kw = SR_MODELS[name]
    cls = swinir.SwinIR if arch == "SwinIR" else getattr(sr_basic, arch)
    return cls(device=device, generator=torch.Generator().manual_seed(0),
               **kw)


def phase_upscale(torch):
    """The four upscalers of SR_MODELS, f32: each card against CPU on one
    64^2 tile within SR_RTOL of its largest magnitude; then make_upscaler_fn
    (tile 512, overlap 64: ragged 384- and 272-px edge tiles) on one
    1280x720 frame on the card, ms a frame (after one warm-up frame) and
    peak GiB; then RealESRGANer.enhance with RealESRGAN_x2plus (tile 0,
    pre_pad 10) on an RGBA and a gray frame: 64x48 card against CPU within
    1 level, and 1280x720 timed on the card. Returns the card models of
    the full workflow."""
    from comfyui_keep_torch.pipeline.realesrganer import RealESRGANer
    from comfyui_keep_torch.pipeline.tiled import make_upscaler_fn
    rng = np.random.default_rng(18)
    tile = torch.from_numpy(rng.random((1, 3, 64, 64), dtype=np.float32))
    frame = whole_frames(1, seed=19)[0]
    rows, ok_all, keep = {}, True, {}
    for name, (arch, scale, _) in SR_MODELS.items():
        cpu = sr_model(torch, name, "cpu")
        card = copy.deepcopy(cpu).cuda()
        with torch.no_grad():
            ref = cpu(tile)
            got = card(tile.cuda())
        err = rel_err(got, ref)
        del cpu
        up = make_upscaler_fn(card, scale, SR_TILE, SR_OVERLAP)
        up(frame)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = up(frame)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        shape_ok = out.shape == (WHOLE_HW[0] * scale, WHOLE_HW[1] * scale, 3)
        ok = bool(err <= SR_RTOL and shape_ok and out.dtype == np.uint8)
        ok_all &= ok
        rows[name] = dict(arch=arch, scale=scale, tile_rel_err=err,
                          frame_ms=ms, peak_gib=peak, output_hw=list(
                              out.shape[:2]), ok=ok)
        if name in ("RealESRGAN_x2plus", "realesr-general-x4v3"):
            keep[name] = card
        else:
            del card, up
        torch.cuda.empty_cache()
    # RealESRGANer on alpha and gray frames
    x2 = keep["RealESRGAN_x2plus"]
    enh = RealESRGANer(2, x2)
    enh_cpu = RealESRGANer(2, copy.deepcopy(x2).cpu())
    small = {"RGBA": rng.integers(0, 256, (48, 64, 4), dtype=np.uint8),
             "L": rng.integers(0, 256, (48, 64), dtype=np.uint8)}
    big = {"RGBA": np.dstack([frame, rng.integers(0, 256, WHOLE_HW,
                                                  dtype=np.uint8)]),
           "L": frame[..., 1].copy()}
    enhance = {}
    for mode in ("RGBA", "L"):
        a, m = enh.enhance(small[mode])
        b, _ = enh_cpu.enhance(small[mode])
        levels = int(np.abs(a.astype(int) - b.astype(int)).max())
        enh.enhance(big[mode])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = enh.enhance(big[mode])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want = (WHOLE_HW[0] * 2, WHOLE_HW[1] * 2) + (
            (4,) if mode == "RGBA" else ())
        ok = bool(m == mode and levels <= 1 and a.shape == b.shape
                  and out.shape == want and out.dtype == np.uint8)
        ok_all &= ok
        enhance[mode] = dict(small_card_vs_cpu_max_levels=levels,
                             frame_ms=ms, output_shape=list(out.shape), ok=ok)
    del enh_cpu
    say("upscale", tile_hw=[64, 64], tol_rel=SR_RTOL, frame_hw=list(WHOLE_HW),
        tile=SR_TILE, overlap=SR_OVERLAP, models=rows,
        realesrganer_x2plus=enhance, ok=bool(ok_all))
    if not ok_all:
        fail(f"upscale: {rows} {enhance}")
    return keep


def phase_full_workflow(torch, detector, parser, sr):
    """BASELINE config 5 through the api entry points:
    api.load_models(detector=planted YOLOv5l, parser=BiSeNet,
    bg_upscaler=RealESRGAN_x2plus tiled (512, 64), face_upscaler=
    realesr-general-x4v3) -> restore_sequence on the 20 frames of phase
    unaligned (two planted faces drifting, 40 faces), factor 2, KEEP in
    bf16. Gates: 20 uint8 frames of 2560x1440, each differing from its
    upscaled background; finite restored chunks; K1-K3 launches twice one
    GMFlow call's, nothing of K4-K6; the background upscaled once a frame
    and each face once (their counters); cv2 never imported. Reported: ms
    a face, split into detection, alignment, restore, background upscale,
    face upscale and paste-back (without the face upscale inside it); the
    best real YOLO score on the frames. Returns the launch counts."""
    from comfyui_keep_torch import api
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
    from comfyui_keep_torch.pipeline.tiled import make_upscaler_fn
    timer = StageTimer(torch)
    planted = PlantedDetector(detector, timer)
    bg = make_upscaler_fn(sr["RealESRGAN_x2plus"], 2, SR_TILE, SR_OVERLAP)
    face = make_upscaler_fn(sr["realesr-general-x4v3"], 4, SR_TILE,
                            SR_OVERLAP)
    bg_t, face_t = timer.wrap("bg_upscale", bg), timer.wrap("face_upscale",
                                                            face)
    bg_t.model, face_t.model = bg.model, face.model
    pack = api.load_models(seed=0, detector=planted, parser=parser,
                           bg_upscaler=bg_t, face_upscaler=face_t)
    pack.load_device(torch.bfloat16)
    helper = pack.face_helper
    helper.align_warp_face = timer.wrap("align", helper.align_warp_face)
    helper.paste_faces_to_input_image = timer.wrap(
        "paste", helper.paste_faces_to_input_image)
    stream, clip = (KEEPFaceProcessor.restore_face_stream,
                    KEEPFaceProcessor.restore_clip)
    finite = []

    def checked_clip(self, *a, **k):
        out = clip(self, *a, **k)
        finite.append(bool(np.isfinite(out[0] if isinstance(out, tuple)
                                       else out).all()))
        return out

    KEEPFaceProcessor.restore_face_stream = timer.wrap("restore", stream)
    KEEPFaceProcessor.restore_clip = checked_clip
    rng = np.random.default_rng(20)
    frames = whole_frames(FRAMES, seed=14)
    planted.planted = [
        [planted_row(planted_landmarks(0.55, 6.0, 420 + 3 * i, 330 + 2 * i)
                     + rng.normal(0, 0.55, (5, 2))),
         planted_row(planted_landmarks(0.45, -12.0, 900 - 2 * i, 400 + i)
                     + rng.normal(0, 0.45, (5, 2)))]
        for i in range(FRAMES)]
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = api.restore_sequence(pack, frames, 2.0, only_center_face=False,
                                    dtype=torch.bfloat16)
        torch.cuda.synchronize()
        seq_ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(K.LAUNCHES)
    finally:
        KEEPFaceProcessor.restore_face_stream = stream
        KEEPFaceProcessor.restore_clip = clip
    stages = dict(timer.ms)
    n_faces, n_backgrounds = face.calls, bg.calls
    stages["paste_without_face_upscale"] = (stages.get("paste", 0.0)
                                            - stages.get("face_upscale", 0.0))
    best = 0.0
    for f in frames:
        helper.read_image(f)
        p = detector.predictions(helper.resize_for_detection()[0])[0]
        best = max(best, float((p[:, 4] * p[:, 15]).max()))
    gmflow_call = {"attention[dv128]": 6, "attention[dv128+bias]": 6,
                   "attention[dv2]": 1, "mlp_fused": 6,
                   "global_correlation_expectation": 1,
                   "vq_nearest_indices": 0, "fused_bias_lrelu": 0,
                   "packed_conv2x2": 0}
    want = {k: 2 * v for k, v in gmflow_call.items()}
    up = (WHOLE_HW[0] * 2, WHOLE_HW[1] * 2, 3)
    shapes_ok = len(outs) == FRAMES and all(
        o.shape == up and o.dtype == np.uint8 for o in outs)
    pasted = shapes_ok and all(not np.array_equal(o, bg(f))
                               for o, f in zip(outs[:2], frames[:2]))
    ok = bool(shapes_ok and pasted and finite and all(finite)
              and counts == want and n_faces == 2 * FRAMES
              and n_backgrounds == FRAMES and "cv2" not in sys.modules)
    say("full_workflow", frames=FRAMES, faces=n_faces, factor=2.0,
        detector="YOLOv5l (planted rows)", parser="bisenet",
        bg_upscaler="RealESRGAN_x2plus tiled 512/64",
        face_upscaler="realesr-general-x4v3 tiled 512/64",
        sequence_ms=seq_ms, ms_per_face=seq_ms / max(n_faces, 1),
        stage_ms_per_face={k: v / max(n_faces, 1) for k, v in stages.items()},
        launches=counts, expected_launches=want, faces_upscaled=n_faces,
        backgrounds_upscaled=n_backgrounds, chunks_finite=finite,
        real_detector_rows=planted.real_rows, best_real_score=best,
        output_hw=list(up[:2]), outputs_uint8=shapes_ok, faces_pasted=pasted,
        cv2_imported="cv2" in sys.modules, ok=ok)
    if not ok:
        fail(f"full_workflow: shapes {shapes_ok}, pasted {pasted}, finite "
             f"{finite}, launches {counts}, faces {n_faces}, backgrounds "
             f"{n_backgrounds}")
    return counts


def vq_picks_vs_plain(torch, K, z, e):
    """The nearest-codebook kernel's picks on the card against the plain
    version's on the same z (T, C) and codebook e (N, C): (the kernel's
    picks, {max_excess: the most a kernel pick's distance exceeds the
    minimum, tol: VQ_RTOL of the largest |distance|, differing: picks that
    differ, past_tol: picks that differ where the plain version's best and
    second distances lie more than tol apart, tokens_past_tol}). Agreement
    is past_tol == 0 and max_excess <= tol."""
    got = K.vq_nearest_indices(z, e).long()
    torch.cuda.synchronize()
    ref = K.vq_nearest_indices_plain(z, e).long()
    d = K.codebook_sq_norms(e) - 2.0 * z.float() @ e.float().t()
    excess = d.gather(1, got[:, None]) - d.gather(1, ref[:, None])
    top2 = (-d).topk(2, dim=-1).values
    tol = VQ_RTOL * d.abs().max().item()
    clear = (top2[:, 0] - top2[:, 1]) > tol
    return got, {"max_excess": excess.abs().max().item(), "tol": tol,
                 "differing": int((got != ref).sum()),
                 "past_tol": int((got != ref)[clear].sum()),
                 "tokens_past_tol": int(clear.sum())}


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
        got, pc = vq_picks_vs_plain(torch, K, zc, ec)
        err, tol, mismatched = pc["max_excess"], pc["tol"], pc["past_tol"]
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
               "picks_differing": pc["differing"],
               "picks_differing_past_tol": mismatched,
               "tokens_past_tol": pc["tokens_past_tol"],
               "repeat_codes_picked": repeats, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
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


def k1_launches(counts):
    """K1 to K4's entries of a LAUNCHES snapshot."""
    return {k: counts[k] for k in K1_K4}


def launch_counts(K):
    """A snapshot of LAUNCHES and LAUNCHES_BY_SHAPE in one dict: the
    counters by form, and K1-K4's launches by the shape they ran at."""
    return {**K.LAUNCHES, **K.LAUNCHES_BY_SHAPE}


def gmflow_launches(calls, layers=6, global_matching=1):
    """K1-K4 launches of `calls` GMFlow passes of `layers` transformer
    layers at one window split: each layer's self and cross attention,
    half of the layers shifted (the mask), one FFN each; global matching
    and propagation once per pass when taken."""
    return {"attention[dv128]": calls * layers,
            "attention[dv128+bias]": calls * layers,
            "attention[dv2]": calls * global_matching,
            "global_correlation_expectation": calls * global_matching,
            "mlp_fused": calls * layers, "vq_nearest_indices": 0}


def group_launches(g):
    """K1-K3 launches by shape of one GMFlow pass over a group of g 20-frame
    512^2 chunks (B = g clips): g * 152 windows of 1024 tokens in each of the
    6 layers (self and cross attention in one launch, half of them under
    the mask), g * 19 maps of 4096 tokens in global matching and
    propagation, g * 155,648 rows in each layer's FFN."""
    pairs = g * (FRAMES - 1)
    windows, lw, lg = 2 * pairs * WINDOWS, (FEAT // 2) ** 2, FEAT * FEAT
    return {f"attention[dv128] B{windows} L{lw}": 6,
            f"attention[dv128+bias] B{windows} L{lw}": 6,
            f"attention[dv2] B{pairs} L{lg}": 1,
            f"global_correlation_expectation B{pairs} L{lg}": 1,
            f"mlp_fused rows{windows * lw}": 6}


def phase_chunks(torch, pack):
    """Grouped chunk serving at the main path's width (bf16, 512^2, 20-frame
    chunks): 41 faces through restore_face_stream with
    chunks_per_dispatch=2 (one group of two chunks, then a duplicated
    1-frame tail) in each chunk_batching form. Per form: ms a face (the
    median of CHUNK_RUNS timed runs after a warm-up; the last one's
    launches and output kept), K1-K4 launches ("map" runs GMFlow once per
    chunk, "batch" and "stage" once per group), the uint8 difference from
    "map" (reported), and "map" against the per-chunk loop, bit for bit.
    Then each form's group program alone (restore_group) at G = 2 and G = 4
    chunks: ms a face and peak device memory. Then chunks_parity, and one
    group of each form with phase512=True, its K6 launches checked.
    Returns {form: counts}."""
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.utils.image import (bgr_u8_to_rgb_pm1,
                                                rgb_pm1_to_bgr_u8)
    rng = np.random.default_rng(6)
    n = 2 * FRAMES + 1
    faces = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
             for _ in range(n)]
    x = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces])
    want = {"map": gmflow_launches(3), "batch": gmflow_launches(2),
            "stage": gmflow_launches(2)}
    # the grouped forms run GMFlow once at the group's shapes, "map" never
    g2 = group_launches(2)
    want_g2 = {"map": dict.fromkeys(g2, 0), "batch": g2, "stage": g2}
    outs, counts, face_ms = {}, {}, {}
    for form in ("map", "batch", "stage"):
        proc = pack.processor(dtype=torch.bfloat16, chunk_batching=form,
                              chunks_per_dispatch=2)
        proc.restore_face_stream(faces, max_clip_length=FRAMES)  # warm-up
        runs = []
        for _ in range(CHUNK_RUNS):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            outs[form] = proc.restore_face_stream(faces,
                                                  max_clip_length=FRAMES)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0) / n)
        face_ms[form] = float(np.median(runs))
        counts[form] = launch_counts(K)
        if form == "map":
            loop = [rgb_pm1_to_bgr_u8(o) for s in (0, FRAMES)
                    for o in proc.restore_clip(x[s:s + FRAMES])]
            loop.append(rgb_pm1_to_bgr_u8(proc.restore_clip(
                np.concatenate([x[-1:], x[-1:]]))[0]))
            map_is_loop = all(np.array_equal(a, b)
                              for a, b in zip(outs["map"], loop))
        diff = np.stack([np.abs(a.astype(int) - b.astype(int))
                         for a, b in zip(outs[form], outs["map"])])
        at_g2 = {k: counts[form].get(k, 0) for k in g2}
        ok = (k1_launches(counts[form]) == want[form]
              and at_g2 == want_g2[form]
              and len(outs[form]) == n and all(
                  o.dtype == np.uint8 and o.shape == (512, 512, 3)
                  for o in outs[form])
              and (form != "map" or map_is_loop))
        say("chunks", form=form, faces=n, chunks_per_dispatch=2,
            ms_per_face=face_ms[form], ms_per_face_runs=runs,
            launches=k1_launches(counts[form]),
            expected_launches=want[form], launches_at_group_shapes=at_g2,
            expected_launches_at_group_shapes=want_g2[form],
            vs_map_uint8_max=int(diff.max()),
            vs_map_share_past_1_level=float((diff > 1).mean()),
            **({"map_equals_chunk_loop": map_is_loop} if form == "map"
               else {}), ok=bool(ok))
        if not ok:
            fail(f"chunks ({form}): launches {k1_launches(counts[form])} "
                 f"(want {want[form]}), at the group's shapes {at_g2} (want "
                 f"{want_g2[form]}), or map differs from the chunk loop")
        # the group program alone at G = 2 and 4: ms a face (the median of
        # CHUNK_RUNS timed calls after a warm-up) and peak device memory
        for g in (2, 4):
            clips = np.stack([x[:FRAMES]] * g)
            proc.restore_group(clips)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(CHUNK_RUNS):
                t0 = time.perf_counter()
                out = proc.restore_group(clips)
                torch.cuda.synchronize()
                runs.append(1e3 * (time.perf_counter() - t0) / (g * FRAMES))
            say("chunks_group", form=form, G=g, frames=g * FRAMES,
                ms_per_face=float(np.median(runs)), ms_per_face_runs=runs,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                finite=bool(np.isfinite(out).all()))
            if not np.isfinite(out).all():
                fail(f"chunks_group ({form}, G={g}): non-finite output")
        del proc
        torch.cuda.empty_cache()
    chunks_parity(torch, pack, x)
    # phase-packed KEEP in each form, one group of 2 chunks: the LQ encoder
    # (6 K6 launches) once a call, the HQ encoder 6 per propagated frame,
    # the generator tail 6 per decode (frame 0 batched over the group in
    # "batch" and "stage", per chunk in "map")
    want_k6 = {"map": 2 * 12 * FRAMES, "batch": 12 * FRAMES,
               "stage": 6 + 6 + 2 * 12 * (FRAMES - 1)}
    clips = np.stack([x[:FRAMES], x[FRAMES:2 * FRAMES]])
    for form in ("map", "batch", "stage"):
        proc = pack.processor(dtype=torch.bfloat16, chunk_batching=form,
                              phase512=True)
        K.reset_launch_counts()
        out = proc.restore_group(clips)
        torch.cuda.synchronize()
        k6 = K.LAUNCHES["packed_conv2x2"]
        ok = bool(k6 == want_k6[form] and np.isfinite(out).all())
        say("chunks_packed", form=form, G=2, k6_launches=k6,
            expected_k6_launches=want_k6[form],
            finite=bool(np.isfinite(out).all()), ok=ok)
        if not ok:
            fail(f"chunks_packed ({form}): K6 {k6} != {want_k6[form]} or "
                 f"non-finite output")
        del proc
    torch.cuda.empty_cache()
    return counts


def chunks_parity(torch, pack, x):
    """Where the batched forms part from "map". On one group (two 20-frame
    chunks), in bf16 and in f32: GMFlow on the group (B = 2 clips, the
    kernels at the group's shapes) against GMFlow on each chunk, in pixels;
    then, on the group's flows, KEEP.apply on the group (B = 2, the "batch"
    form) against KEEP.apply on each chunk: the share of picks that differ
    and frame 0's logits (the batched encoder's rounding only); then each
    chunk's apply and the group's apply_chunks ("stage") with the picks
    forced to the group's, against the group's output. f32 is held to
    FLOW_TOL_PX and to KEEP's tolerance with the picks forced; bf16 is
    reported (the kernels' bf16 forms at the group's shapes are held to
    their plain versions in phase kernel)."""
    from comfyui_keep_torch.models.gmflow import flow_from_clip
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        proc = pack.processor(dtype=dtype)
        keep = proc.keep
        xg = torch.as_tensor(np.stack([x[:FRAMES], x[FRAMES:2 * FRAMES]])
                             ).to("cuda", dtype)
        with torch.no_grad():
            flows = flow_from_clip(proc.gmflow, xg)
            flow_err = max(
                (f[c:c + 1].float() - fc.float()).abs().max().item()
                for c in range(2)
                for f, fc in zip(flows, flow_from_clip(proc.gmflow,
                                                       xg[c:c + 1])))
            out_b, aux_b = keep.apply(xg, flows, return_aux=True)
            out_b = out_b.float()
            logits_b = aux_b["logits"].reshape((2, FRAMES)
                                               + aux_b["logits"].shape[1:])
            picks_b = logits_b.argmax(-1)
            share, logit0, forced = [], [], []
            for c in range(2):
                fc = tuple(f[c:c + 1] for f in flows)
                _, aux = keep.apply(xg[c:c + 1], fc, return_aux=True)
                lc = aux["logits"].reshape(logits_b[c].shape)
                share.append((lc.argmax(-1) != picks_b[c]).float().mean()
                             .item())
                logit0.append((lc[0].float() - logits_b[c, 0].float()).abs()
                              .max().item())
                forced.append(keep.apply(xg[c:c + 1], fc, force_indices=(
                    picks_b[c:c + 1]))[0].float())
            forced = torch.stack(forced)
            stage = keep.apply_chunks(xg, flows,
                                      force_indices=picks_b).float()
        lim = KEEP_ATOL + KEEP_RTOL * out_b.abs()
        d, ds = (forced - out_b).abs(), (stage - out_b).abs()
        held = bool((d <= lim).all() and (ds <= lim).all()
                    and flow_err <= FLOW_TOL_PX)
        good = held or dtype == torch.bfloat16
        ok = ok and good
        say("chunks_parity", dtype=str(dtype).split(".")[-1], G=2,
            frames=FRAMES, group_vs_chunk_flow_max_abs_diff_px=flow_err,
            flow_tol_px=FLOW_TOL_PX, picks_share_differing_per_chunk=share,
            frame0_logits_max_abs_diff=logit0,
            logits_abs_max=logits_b.float().abs().max().item(),
            per_chunk_forced_max_abs_diff=d.max().item(),
            per_chunk_forced_mean_abs_diff=d.mean().item(),
            stage_forced_max_abs_diff=ds.max().item(),
            stage_forced_mean_abs_diff=ds.mean().item(),
            within_keep_tolerance=held, atol=KEEP_ATOL, rtol=KEEP_RTOL,
            gated=dtype == torch.float32, ok=good)
        del proc, keep, xg, flows, out_b, aux_b, forced, stage
        torch.cuda.empty_cache()
    if not ok:
        fail("chunks_parity: f32 GMFlow on the group outside FLOW_TOL_PX of "
             "GMFlow on each chunk, or the batched forms with forced picks "
             "outside KEEP's tolerance of the group's output")


def phase_need_upscale(torch):
    """KEEP.apply(need_upscale=True) on a 2-frame 128^2 clip (x4 bilinear
    to 512^2 first), f32, zero flows at the upscaled size: card against
    CPU, picks forced from the CPU run."""
    from comfyui_keep_torch.models.keep import KEEP
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(2))
    net_cuda = copy.deepcopy(net).cuda()
    x = torch.as_tensor(np.random.default_rng(7).random(
        (1, 2, 128, 128, 3), dtype=np.float32) * 2 - 1)
    out_c, aux_c = net.apply(x, return_aux=True, need_upscale=True)
    picks = aux_c["logits"].argmax(-1).reshape(1, 2, -1)
    out_g, aux_g = net_cuda.apply(x.cuda(), return_aux=True, need_upscale=True,
                                  force_indices=picks.cuda())
    d = (out_g.cpu() - out_c).abs()
    dl = (aux_g["logits"].cpu() - aux_c["logits"]).abs()
    ok = bool(out_g.shape == (1, 2, 512, 512, 3)
              and (d <= KEEP_ATOL + KEEP_RTOL * out_c.abs()).all()
              and (dl <= KEEP_ATOL + KEEP_RTOL * aux_c["logits"].abs()).all())
    say("need_upscale", input=[1, 2, 128, 128, 3],
        output=list(out_g.shape), max_abs_err=d.max().item(),
        logits_max_abs_err=dl.max().item(), atol=KEEP_ATOL, rtol=KEEP_RTOL,
        ok=ok)
    if not ok:
        fail("need_upscale: KEEP card vs CPU outside atol/rtol")


def refine_launches(pairs):
    """K1-K3 launches by shape of one apply_refine call with the defaults
    on `pairs` 512^2 image pairs (a bidirectional call: twice the pairs).
    Scale 0 (1/8, split 2): 4 windows of 1024 tokens per image, global
    matching and propagation at 4096; scale 1 (1/4, split 8): 64 windows
    of 256 tokens per image, the odd layers under the (64, 256, 256) mask;
    6 layers at each scale, the FFN over every token of both images."""
    l0, l1 = (FEAT // 2) ** 2, (REFINE_FEAT // 8) ** 2
    b0, b1 = 2 * pairs * WINDOWS, 2 * pairs * REFINE_WINDOWS
    return {f"attention[dv128] B{b0} L{l0}": 6,
            f"attention[dv128+bias] B{b0} L{l0}": 6,
            f"attention[dv128] B{b1} L{l1}": 6,
            f"attention[dv128+bias] B{b1} L{l1}": 6,
            f"attention[dv2] B{pairs} L{FEAT * FEAT}": 1,
            f"global_correlation_expectation B{pairs} L{FEAT * FEAT}": 1,
            f"mlp_fused rows{2 * pairs * FEAT * FEAT}": 6,
            f"mlp_fused rows{2 * pairs * REFINE_FEAT ** 2}": 6}


def phase_gmflow_refine(torch, iters=3):
    """GMFlow(num_scales=2), the refinement model at full width (128
    channels, 6 layers; random weights, seed 0), on two 512x512 pairs:
    apply_refine with the defaults (splits 2 then 8: 1024-token windows at
    1/8 resolution, then 256-token windows under the (64, 256, 256) shifted
    mask at 1/4; global then radius-4 matching and global then radius-1
    propagation), forward and bidirectional, f32 card against CPU in
    pixels; bf16 finite; GMFlow.apply with corr_radius=4, prop_radius=1
    card against CPU; the occlusion masks of the bidirectional flows, card
    against CPU; ms a pair; K1-K3 launches a call, by form and by shape,
    checked. Returns the launch counts (launch_counts) of the forward call,
    by dtype."""
    from comfyui_keep_torch.models.gmflow import (
        GMFlow, forward_backward_consistency_check)
    from comfyui_keep_torch.ops import kernels as K
    gm = GMFlow(device="cpu", num_scales=2,
                generator=torch.Generator().manual_seed(0))
    gm_cuda = copy.deepcopy(gm).cuda()
    rng = np.random.default_rng(8)
    img0, img1 = (torch.as_tensor(rng.random((2, 512, 512, 3),
                                             dtype=np.float32) * 255)
                  for _ in range(2))
    g0, g1 = img0.cuda(), img1.cuda()
    errs, ok = {}, True
    want = {k: a + b for (k, a), b in zip(
        gmflow_launches(1).items(),
        gmflow_launches(1, global_matching=0).values())}
    for name, kw in (("forward", {}), ("bidirectional",
                                       {"pred_bidir_flow": True})):
        cpu = gm.apply_refine(img0, img1, **kw)
        K.reset_launch_counts()
        got = gm_cuda.apply_refine(g0, g1, **kw)
        torch.cuda.synchronize()
        snap = launch_counts(K)
        shapes = dict(K.LAUNCHES_BY_SHAPE)
        if name == "forward":
            fwd_snap = snap
        else:
            cpu_bidir, gpu_bidir = cpu, got
        want_shapes = refine_launches(2 * (2 if kw else 1))
        counts = k1_launches(snap)
        err = (got.cpu() - cpu).abs().max().item()
        errs[name] = err
        ms = time_ms(torch, lambda: gm_cuda.apply_refine(g0, g1, **kw), iters)
        good = bool(np.isfinite(err) and err <= FLOW_TOL_PX
                    and counts == want and shapes == want_shapes
                    and got.shape == (2 * (2 if kw else 1), 1024, 1024, 2))
        ok = ok and good
        say("gmflow_refine", call=f"apply_refine {name}", dtype="float32",
            pairs=2, output=list(got.shape), max_abs_err_px=err,
            tol_px=FLOW_TOL_PX, flow_abs_max_px=cpu.abs().max().item(),
            ms_per_pair=ms / 2, launches=counts, expected_launches=want,
            launches_by_shape=shapes, expected_launches_by_shape=want_shapes,
            ok=good)
    gm_bf16 = copy.deepcopy(gm_cuda).to(torch.bfloat16)
    b0, b1 = g0.to(torch.bfloat16), g1.to(torch.bfloat16)
    K.reset_launch_counts()
    out = gm_bf16.apply_refine(b0, b1)
    torch.cuda.synchronize()
    bf16_snap = launch_counts(K)
    bf16_shapes = dict(K.LAUNCHES_BY_SHAPE)
    finite = bool(torch.isfinite(out.float()).all())
    ms = time_ms(torch, lambda: gm_bf16.apply_refine(b0, b1), iters)
    good = bool(finite and k1_launches(bf16_snap) == want
                and bf16_shapes == refine_launches(2))
    say("gmflow_refine", call="apply_refine forward", dtype="bfloat16",
        pairs=2, ms_per_pair=ms / 2, finite=finite,
        launches=k1_launches(bf16_snap), launches_by_shape=bf16_shapes,
        max_abs_diff_from_f32_cpu_px=(out.float().cpu() - cpu_bidir[:2])
        .abs().max().item(), ok=good)
    ok = ok and good
    del gm_bf16
    # GMFlow.apply on the single-scale backbone, local matching and
    # propagation: no global correlation, no 2-wide attention
    cpu = gm.apply(img0, img1, corr_radius=4, prop_radius=1)
    K.reset_launch_counts()
    got = gm_cuda.apply(g0, g1, corr_radius=4, prop_radius=1)
    torch.cuda.synchronize()
    counts = k1_launches(K.LAUNCHES)
    want_apply = gmflow_launches(1, global_matching=0)
    err = (got.cpu() - cpu).abs().max().item()
    ms = time_ms(torch, lambda: gm_cuda.apply(g0, g1, corr_radius=4,
                                              prop_radius=1), iters)
    good = bool(np.isfinite(err) and err <= FLOW_TOL_PX
                and counts == want_apply)
    ok = ok and good
    say("gmflow_refine", call="apply corr_radius=4 prop_radius=1",
        dtype="float32", pairs=2, max_abs_err_px=err, tol_px=FLOW_TOL_PX,
        ms_per_pair=ms / 2, launches=counts, expected_launches=want_apply,
        ok=good)
    # occlusion masks of the bidirectional flows. Random weights give flows
    # of up to ~80 px that no pair agrees on, so every pixel is occluded:
    # both sides' flows are scaled by the power of two that brings the
    # CPU's occluded share nearest one half, and both masks must hold both
    # values. A pixel whose residual lies within the flows' card-vs-CPU
    # error of the threshold can flip: at most OCC_FLIP_SHARE of them.
    fc, bc = cpu_bidir[:2], cpu_bidir[2:]
    fg, bg = gpu_bidir[:2], gpu_bidir[2:]
    s = min((2.0 ** -k for k in range(12)), key=lambda s: abs(
        forward_backward_consistency_check(fc * s, bc * s)[0].mean().item()
        - 0.5))
    occ_c = forward_backward_consistency_check(fc * s, bc * s)
    occ_g = forward_backward_consistency_check(fg * s, bg * s)
    share = max((a.cpu() != b).float().mean().item()
                for a, b in zip(occ_g, occ_c))
    occluded = [o.mean().item() for o in occ_c]
    good = bool(all(0 < o < 1 for o in occluded) and share <= OCC_FLIP_SHARE)
    ok = ok and good
    say("gmflow_refine", call="forward_backward_consistency_check",
        flow_scale=s, occluded_share=occluded,
        card_vs_cpu_share_differing=share, tol_share=OCC_FLIP_SHARE, ok=good)
    if not ok:
        fail(f"gmflow_refine: card vs CPU {errs} px (tol {FLOW_TOL_PX}), "
             f"launches off, bf16 not finite, or the occlusion masks differ")
    del gm_cuda
    torch.cuda.empty_cache()
    return {"float32": fwd_snap, "bfloat16": bf16_snap}


def phase_vqgan(torch):
    """The rest of the VQGAN family at 512^2, f32, card against CPU (random
    weights, seeded): VQAutoEncoder at full width (nf 64, ch_mult
    (1,2,2,4,4,8)) with the nearest quantizer, then with the Gumbel
    quantizer on one seeded uniform draw. For each: the card's codes
    against the CPU's, held to be equal except at near-ties (a card pick's
    CPU score within VQ_FAMILY_RTOL of the largest |score| of the CPU's
    best: the encoders' f32 outputs differ by summation order); the
    generator's output on the CPU's codes; for the nearest one, K4 launched
    once a forward and held against its plain version on the card's
    encoder output (T = 256 tokens). Then VQGANDiscriminator (ndf 64, 4
    layers) and Discriminator3D on (1, 8, 512, 512, 3), the stage-III yml's
    num_frame. Outputs within VQ_FAMILY_RTOL of their largest magnitude.
    Returns the launch counts (launch_counts) of the nearest forward."""
    from comfyui_keep_torch.models import vqgan as V
    from comfyui_keep_torch.ops import kernels as K
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.random((1, 512, 512, 3), dtype=np.float32) * 2
                        - 1)
    ok, counts = True, None
    for quantizer in ("nearest", "gumbel"):
        net = V.VQAutoEncoder(quantizer=quantizer, device="cpu",
                              generator=torch.Generator().manual_seed(10))
        net_cuda = copy.deepcopy(net).cuda()
        uniform = (torch.rand((1, 16, 16, 1024),
                              generator=torch.Generator().manual_seed(11))
                   if quantizer == "gumbel" else None)
        with torch.no_grad():
            out_c, loss_c, st_c = net(x, uniform=uniform)
            K.reset_launch_counts()
            out_g, loss_g, st_g = net_cuda(
                x.cuda(), uniform=None if uniform is None else uniform.cuda())
            torch.cuda.synchronize()
            if quantizer == "nearest":
                counts = launch_counts(K)
            ms = time_ms(torch, lambda: net_cuda(
                x.cuda(), uniform=None if uniform is None
                else uniform.cuda()), 3)
            idx = st_c["min_encoding_indices"].reshape(1, 16, 16)
            table = (net.quantize.embedding.weight if quantizer == "nearest"
                     else net.quantize.embed.weight)
            z_q = table[idx].permute(0, 3, 1, 2).contiguous()
            dec_c = net.generator(z_q)
            dec_g = net_cuda.generator(z_q.cuda())
            # the CPU's scores of every code: -distance for the nearest
            # quantizer (|z|^2 dropped), logits + Gumbel noise for the other
            z_c = net.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            z_c = z_c.reshape(-1, z_c.shape[-1])
            if quantizer == "nearest":
                score = 2.0 * z_c @ table.t() - K.codebook_sq_norms(table)
            else:
                w = net.quantize.proj.weight
                score = (z_c @ w.reshape(w.shape[0], -1).t()
                         + net.quantize.proj.bias)
                u = uniform.reshape(-1, uniform.shape[-1])
                score = score - torch.log(-torch.log(u + 1e-20) + 1e-20)
            idx_c = st_c["min_encoding_indices"].reshape(-1, 1)
            idx_g = st_g["min_encoding_indices"].cpu().reshape(-1, 1).long()
            excess = (score.gather(1, idx_c) - score.gather(1, idx_g)).max()
            tie_tol = VQ_FAMILY_RTOL * score.abs().max().item()
            if quantizer == "nearest":
                # K4 on the card's own encoder output, at this T
                z_g = net_cuda.encoder(x.cuda().permute(0, 3, 1, 2))
                z_g = z_g.permute(0, 2, 3, 1).reshape(-1, z_g.shape[1])
                _, k4 = vq_picks_vs_plain(torch, K, z_g.contiguous(),
                                          net_cuda.quantize.embedding.weight)
        flips = (idx_g != idx_c).float().mean().item()
        err = (dec_g.cpu() - dec_c).abs().max().item()
        tol = VQ_FAMILY_RTOL * dec_c.abs().max().item()
        good = bool(err <= tol and torch.isfinite(out_g).all()
                    and excess.item() <= tie_tol)
        extra = {}
        if quantizer == "nearest":
            k4_ok = k4["past_tol"] == 0 and k4["max_excess"] <= k4["tol"]
            good = bool(good and k4_ok
                        and counts["vq_nearest_indices"] == 1
                        and counts.get("vq_nearest_indices T256") == 1)
            extra = {"launches": k1_launches(counts),
                     "launches_at_t256": counts.get(
                         "vq_nearest_indices T256", 0),
                     "expected_k4_launches": 1,
                     "k4_vs_plain_at_t256": k4}
        ok = ok and good
        say("vqgan", model=f"VQAutoEncoder ({quantizer})", input=[1, 512, 512,
                                                               3],
            codes_share_differing=flips,
            codes_cpu_score_excess=excess.item(), codes_tie_tol=tie_tol,
            output_max_abs_diff_unforced=(out_g.cpu() - out_c).abs().max()
            .item(), loss_card=loss_g.item(), loss_cpu=loss_c.item(),
            decoded_on_cpu_codes_max_abs_err=err, tol=tol, ms=ms, **extra,
            ok=good)
        del net_cuda
    for name, net, xin in (
            ("VQGANDiscriminator", V.VQGANDiscriminator(
                device="cpu", generator=torch.Generator().manual_seed(12)),
             x),
            ("Discriminator3D", V.Discriminator3D(
                device="cpu", generator=torch.Generator().manual_seed(13)),
             torch.as_tensor(rng.random((1, 8, 512, 512, 3),
                                        dtype=np.float32) * 2 - 1))):
        net_cuda = copy.deepcopy(net).cuda()
        with torch.no_grad():
            ref = net(xin)
            got = net_cuda(xin.cuda())
            ms = time_ms(torch, lambda: net_cuda(xin.cuda()), 3)
        err = (got.cpu() - ref).abs().max().item()
        tol = VQ_FAMILY_RTOL * ref.abs().max().item()
        good = bool(err <= tol and got.shape == ref.shape)
        ok = ok and good
        say("vqgan", model=name, input=list(xin.shape),
            output=list(got.shape), max_abs_err=err, tol=tol, ms=ms, ok=good)
        del net_cuda
    if not ok:
        fail("vqgan: a model's card output or codes are outside their "
             "tolerance of the CPU's, K4 disagrees with its plain version, "
             "or K4 did not launch once a nearest forward")
    torch.cuda.empty_cache()
    return counts


def phase_native(torch, iters=5):
    """dcn_v2_pack at EDVR's shape (64 channels, 8 deformable groups, one
    180x320 frame: PCD alignment's finest level of a 720x1280 clip /4) and
    correlation(max_displacement=4) on those maps, f32, card against CPU
    within VQ_FAMILY_RTOL of the largest magnitude; ms."""
    from comfyui_keep_torch.ops import native
    g = torch.Generator().manual_seed(15)
    c, dg, h, w = 64, 8, 180, 320
    x, feat = (torch.randn(1, c, h, w, generator=g) for _ in range(2))
    weight = torch.randn(c, c, 3, 3, generator=g) / math.sqrt(9 * c)
    bias = torch.randn(c, generator=g) * 0.1
    ow = torch.randn(dg * 27, c, 3, 3, generator=g) / math.sqrt(9 * c)
    ob = torch.randn(dg * 27, generator=g) * 0.1
    args = (x, feat, weight, bias, ow, ob)
    ok = True
    for name, fn, a in (
            ("dcn_v2_pack", lambda *t: native.dcn_v2_pack(
                *t, deformable_groups=dg), args),
            ("correlation", lambda *t: native.correlation(t[0], t[1], 4),
             (x, feat))):
        ref = fn(*a)
        ca = tuple(t.cuda() for t in a)
        got = fn(*ca)
        err = (got.cpu() - ref).abs().max().item()
        tol = VQ_FAMILY_RTOL * ref.abs().max().item()
        ms = time_ms(torch, lambda: fn(*ca), iters)
        good = bool(err <= tol and got.shape == ref.shape)
        ok = ok and good
        say("native", op=name, input=[1, c, h, w], output=list(got.shape),
            max_abs_err=err, tol=tol, ms=ms, ok=good)
    if not ok:
        fail("native: an op's card output is outside its tolerance")


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
    chunk_counts = phase_chunks(torch, pack)
    del pack
    torch.cuda.empty_cache()
    phase_need_upscale(torch)
    detector = phase_detect(torch)
    parser = phase_parse(torch)
    whole_counts = phase_unaligned(torch, detector, parser)
    del detector, parser
    phase_nodes(torch)
    torch.cuda.empty_cache()
    yolo = phase_detect_yolo(torch)
    bisenet = phase_parse_bisenet(torch)
    sr = phase_upscale(torch)
    config5_counts = phase_full_workflow(torch, yolo, bisenet, sr)
    del yolo, bisenet, sr
    torch.cuda.empty_cache()
    phase_train_parity(torch)
    train_counts = phase_train(torch)
    k5_rows = phase_k5(torch)
    phase_stylegan2_parity(torch)
    sample_counts = phase_stylegan2_sample(torch)
    sg2_train_counts = phase_stylegan2_train(torch)
    refine_counts = phase_gmflow_refine(torch)
    vqgan_counts = phase_vqgan(torch)
    phase_native(torch)

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

    def slice7(key, dname):
        """Launches counted at `key` (a LAUNCHES counter: every shape; a
        LAUNCHES_BY_SHAPE key: that shape alone) on slice 7's paths, null
        where a path did not run in this dtype: the chunk forms' 41-face
        runs (bf16 only), one apply_refine forward (each dtype), one
        nearest VQAutoEncoder forward (f32 only)."""
        bf16 = dname == "bfloat16"
        return {f"launches_chunk_{form}":
                chunk_counts[form].get(key, 0) if bf16 else None
                for form in ("batch", "stage", "map")} | {
                "launches_refine": refine_counts[dname].get(key, 0),
                "launches_vqgan": None if bf16 else vqgan_counts.get(key, 0)}

    table = []
    for (name, dname), r in krows.items():
        counter, _, at = name.partition(" ")
        if dname != "bfloat16" and not at:
            continue
        src, replaces = srcs[counter.split("[")[0]]
        key = r["launch_key"]
        if at == "G2":
            # the grouped chunk forms' shapes: launches at this shape in
            # the "batch" form's 41-face run
            launches = chunk_counts["batch"].get(key, 0)
            extra = {"launches_at": key, **slice7(key, dname),
                     "launches_of": 'the "batch" chunk form\'s 41-face run'}
        elif at == "L256":
            # the refinement's fine scale: launches at this shape in one
            # apply_refine forward call (2 pairs) in this dtype
            launches = refine_counts[dname].get(key, 0)
            extra = {"launches_at": key, **slice7(key, dname),
                     "launches_of": "one apply_refine forward call (2 "
                                    "pairs)"}
        else:
            extra = {"launches_whole_frame_sequence": whole_counts[name],
                     "launches_full_workflow": config5_counts[name],
                     **slice7(counter, dname)}
            launches = counts[name]
        if "unfused_ms" in r:
            extra["unfused_ms"] = r["unfused_ms"]
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": dname, "status": "ported", **extra})
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
            "dtype": dname, "status": "ported", **slice7(name, dname)})
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
        "status": "ported", **slice7("mlp_fused", "float32"),
        "step_rows_ms": rs["ms"],
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
    idle = [(t["name"], t["dtype"]) for t in table if not t["launches"]]
    if idle:
        fail(f"kernels with no launch on their path's run: {idle}")
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
