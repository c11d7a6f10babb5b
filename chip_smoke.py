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
              (mlp_fused[step]); K1-K3 in f32 at the GMFlow training
              step's shapes (the "flow step" rows, phase 21)
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
     k6_levels  (packed_conv2x2, K6) at every new shape of slice 13's
              serving forms (K6_LEVEL_CASES: the encoder's levels 2-5 with
              their parity-0 Downsamples, the generator's levels 2-3 with
              the four packed -> packed Upsample planes, GMFlow's packed
              layer1), bf16 and f32: max|d| and tolerance, kernel / plain /
              F.conv2d ms, the bound
     packing_levels  KEEP at full width, f32 (TF32 off), on phase keep's
              clip with the CPU's picks forced, packed at each
              (phase_levels, phase_enc_levels) of LEVEL_CHECKS: outputs and
              logits within KEEP's tolerance of the CPU, K6 launches equal
              to the count derived from the plans; then the 20-frame bf16
              chunk of unpacked, (1, 1), (2, 1), (3, 1), (1, 2), (1, 5),
              (3, 2) and pack_gmflow=True processors in turns after a
              warm-up round over 3 rounds: median ms, ratio to unpacked,
              peak GiB, K6 launches against the plans', the uint8 distance
              from the unpacked output (reported)
     gmflow_packed  GMFlow.prepare_packed at 512^2: f32 flows against the
              unpacked backbone on the card (5e-2 px), 4 K6 launches a call;
              bf16 ms a pair of both forms
     int8_acts  tools/torch_bf16_fidelity.py --int8-acts (20 frames,
              unpacked and packed): pick agreement and forced PSNR beside
              the floors PERF.md predicted (reported); the bf16 chunk with
              and without int8 storage, unpacked and packed: median ms and
              the int8 boundaries a chunk stores against the plans' count
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
              their default widgets ((None,) on a pack loaded without
              model_rootpath: no detector, as in the JAX package), an
              aligned face (= api.restore_image's pixels), an invalid
              pack, the pack offloaded after each call; then the loader
              with model_rootpath: random RetinaFace-ResNet50 (made to find
              a face) and ParseNet .pth files in a temporary directory, a
              960x640 frame restored through the image node's default
              widgets on the card, detections card against CPU
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
              and gray frames, card against CPU small, timed at 720p;
              SwinIR at sizes off its window (padded and cropped): a 37x53
              tile card against CPU and against the pre-padded tile, a
              480x854 frame tiled (a 406-px edge tile)
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
              and 4 chunks: ms a face (median of 2) and peak GiB; GMFlow on
              the group against GMFlow on each chunk (f32 gated in px), the
              forms' KEEP with forced picks against the group's; one group
              of each form with phase512=True, K6 launches checked
     parallel  comfyui_keep_torch/parallel/ at the same width (KEEP +
              GMFlow 512^2 bf16, 41 faces, 20-frame chunks) in a world-1
              NCCL group: restore_chunks_parallel, ms a face and K1-K4
              launches, bit for bit against the processor's chunk body on
              the whole chunks and the padded tail; the ring at one rank
              against carried streaming, bit for bit; parallel_train: two
              SRTrainer steps and one stage-II KEEPTrainer step (full
              width, f32, K1-K4 counted) on the mesh against the meshless
              ones (cuDNN deterministic); parallel_two_ranks: this script
              started twice with --parallel-rank (gloo, both ranks on the
              card; collectives staged through the host): chunk-parallel
              restore against world 1 and the ring over two chunks a clip
              against carried streaming, bit for bit, the data-parallel
              SR step's weights equal on both ranks, ms a face and a step
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
     train_gan  options/train_keep_stage3_gan.yml (STAGE3_FORCE: the one
              departure, the dataset's scale 1) through
              tools/torch_train.py's main (train_pipeline) at full width
              (KEEP 512x512, Discriminator3D, B=1 x 8 frames, f32, random
              weights; the frozen VQHQEncoder and GMFlow loaded from .pth
              files through path.pretrain_network_hq / _flow) on a
              synthetic 12-frame PNG clip in VFHQ layout: 2 iterations
              with a save at 2, an auto_resume alone (no step), then
              auto_resume to 3. Losses
              finite with l_g_gan, l_d, l_d_real, l_d_fake; frozen leaves
              unchanged, watched G and D leaves moved from the init, D's
              weight_u advanced (torch's spectral_norm in training; one
              layer held to torch.nn.utils.spectral_norm over train and
              eval forwards), the EMA rule; K1-K4 launches per alternation
              as derived from the code (two flow_from_clip calls and one
              codebook search), counted over the 2 iterations and over
              the resumed one; net_g_2.pth and 2.state written; the
              resume starting at 2 with every restored tensor equal to
              the saved one; the resumed step against the uninterrupted
              one on its batch, cuDNN deterministic (GAN_RESUME_RTOL),
              and a lost EMA or lost Adam moments reading above it. ms
              per alternation (train_pipeline's step times), data ms
              (AvgTimer), peak GiB, save and resume seconds
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
              0) on two 512^2 pairs (and the published form's upsampler,
              upsample_factor=4: the input's size, card against CPU on a
              128^2 crop): apply_refine forward and bidirectional,
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
 19. archs    every arch slice 8 added behind build_network, at its
              published width (random weights, seeded): card against CPU
              on a small input within the JAX package's golden tolerance
              (DFDNet with the CPU's dictionary picks forced, ECBSR's
              re-parameterised form against the training form), then ms a
              call and peak GiB at its users' size: SpyNet, BasicVSR,
              IconVSR and BasicVSR++ on 15 REDS 180x320 frames, EDVR on 5,
              DUF on 7, TOFlow on 7 Vimeo-90K 256x448 frames, RCAN, RIDNet
              and ECBSR on one 180x320 frame, HiFaceGAN, DFDNet and VGG19
              at 512^2, the discriminators at 128^2 and 256^2 (B=16),
              ArcFace on 16 gray 128^2 faces, Inception on 50 faces
 20. metrics  PSNR and SSIM of 20 512^2 faces: the numpy forms on the host
              against the tensor twins on the card (float64 within 1e-8,
              1e-6 on Y; float32 1e-4), ms; NIQE of one face; FID between
              two sets of 50 faces (Inception on the card); cv2 never
              imported
 21. flow_kernel  the backward kernels at the shapes of K1-K3's "flow
              step" rows of phase kernel (the GMFlow training step's, 384
              x 512, B = 8: 64 windows of 768 tokens with and without the
              shifted mask, 8 maps of 3072 for the global attention and
              the correlation, 49,152 FFN rows; their forwards held
              there), f32 and once in bf16 on the same values: from the
              kernel forward's saved statistics, each gradient's distance
              to the plain version's float64 autograd within BWD_RATIO of
              the plain backward's own (floor BWD_FLOOR), two calls
              bitwise equal, no (B, L, L) allocation for K1 / K3 and in
              bf16 none (rows, H) wide for K2 (the call's peak bytes), the
              backward's ms beside the plain backward's, SDPA's forward +
              backward and SDPA's backward alone (K1 / K3), the unfused
              autograd backward as K2's reference, each form's precision
              scheme (BWD_PRECISION) and the bound at that scheme's rate
              (3xTF32 at the TF32 tensor cores')
     train_flow  GMFlowTrainer (tools/torch_train_flow.py's defaults)
              on a synthetic FlyingChairs directory (FLOW_PAIRS pairs)
              through build_train_dataset("chairs") and the loader, B = 8,
              f32: the loader's steady s a batch alone, then 1 + 3 steps
              inside one epoch on the reference's two-term loss (the
              flow before propagation, weight gamma, then the final one;
              recomputed in float64 from the two flows on one batch):
              losses and metrics finite, every gradient
              non-zero (the three leaves whose true gradient is zero at
              noise), the LR on optax's one-cycle schedule, K1-K3 launches
              a step as one GMFlow forward implies and as many backward
              kernel launches (by counter and by shape), ms a step
              (forward, backward, update apart), the wait for data a step,
              the backward kernels' ms a step, peak GiB; one mixed-
              precision step on the same batch (train_flow_bf16: K1-K3's
              bf16 forms and backward kernels, launches as in f32); one
              pair's step (train_flow_parity), leaf by leaf: the
              card against the CPU both in float64, the card's f32 step
              against the CPU's float64 within 3x its module group's f32
              noise (three f32 witnesses), a TF32 control that must fail
              that; one more epoch trained
              through, s a step with its data (train_flow_epoch);
              validate_chairs on the validation split, ms a pair; then
              tools/torch_train_flow.py's main for FLOW_CLI_STEPS steps
              with a save at the last, and a --resume of that .pth whose
              weights equal the file's (train_flow_cli)
 22. sr_test  options/test_keep.yml through tools/torch_test.py's main
              (test_pipeline) on synthetic PNG pairs, card against CPU,
              save_img; an SRModel through tools/torch_train.py's main
              (train_pipeline) with validation every iteration; one
              step each of SRGAN (ESRGAN x4), Real-ESRGAN x4plus (its batch
              from RealESRGANDataset on synthetic PNGs through the loader
              and CUDAPrefetcher, then its feed) and BasicVSR (REDS clips
              from REDSRecurrentDataset, fix_flow); none of K1-K6 launched
 23. profiler  utils/profiler.py: keep_latency_benchmark (KEEP at full
              width, 20 frames, bf16: ms a frame, faces/s), trace() around
              a 2-frame forward (a non-empty Chrome trace with device
              kernels), time_fn against CUDA events on the same calls
              (within TIME_FN_RTOL)
 24. fidelity  tools/torch_bf16_fidelity.py's report (20 frames, unpacked:
              f32 with TF32 off, bf16, bf16 with the f32 picks forced):
              K1-K3 launched by three GMFlow passes, index_agreement and
              psnr_db_forced finite and above FIDELITY_MIN_*
 25. io       PrefetchReader / IOConsumer round-trip 20 720p PNG frames
              bit for bit; VideoWriter -> VideoReader on 20 smooth 720p
              frames within VIDEO_PSNR_DB where ffmpeg is on the machine,
              else `ffmpeg: absent` and both classes raising
 26. zoo      tools/torch_synth_zoo.py's five files at full width, loaded
              by api.load_models (weights equal to the file's), the
              RetinaFace and ParseNet factories (detections at 0.97) and
              factory.load_reference into tiled x2 upscalers
The kernel phase also holds K1 at the refinement's fine scale (L = 256,
the (64, 256, 256) mask, 256 windows) in both dtypes, and K1-K3 in bf16 at
the shapes of a group of 2 chunks (the "G2" rows). The kernel table's
K1-K4 rows carry their launches on slice 7's paths (launches_chunk_*,
launches_refine, launches_vqgan; null where a path did not run in the
row's dtype), taken from the kernels' own counters: the L256 and G2 rows
count their own shape alone (ops/kernels.py LAUNCHES_BY_SHAPE), and so do
the "flow step" rows, with their launches over train_flow's 3 steps, and
the backward kernels' rows ("attention_bwd[dv128] flow step" and the like;
f32 with train_flow's launches, bf16 with train_flow_bf16's). A row with
no launch on its path fails the run.
Every phase that counts launches counts K6 too: the training and StyleGAN2
phases expect none. The script exits non-zero, printing no verdict, if
there is no CUDA device, if a kernel does not build or disagrees, or if any
phase fails. TF32 is off for matmuls and convolutions, so f32 means f32.
"""
import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12   # H100 SXM dense TF32 tensor-core FLOP/s
# the rate of a product the f32 kernels run as 3xTF32 (three TF32 products
# for each on the tensor cores): op_seconds counts it at PEAK_TF32, and
# with fma=True at the FMA pipe's PEAK_F32 (the rows' fma_bound_ms)
F32_TC = "3xTF32"
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
CHUNK_RUNS = 2       # timed 41-face runs per chunk form, after a warm-up
STEP_PAIRS = 14      # the f32 training step's GMFlow: B=2 clips x 7 pairs
KERNEL_ITERS = 20    # timed launches per kernel (a quarter for plain versions)
MAIN_PAIRS = 10      # packed / unpacked chunk pairs timed in turns
VQ_T, VQ_N, VQ_C = 4096, 1024, 256   # B=2 x 8 frames x 16x16 latents
# both dtypes accumulate the products in f32 (bf16 products are exact), so
# kernel and plain distances differ by summation order only
VQ_RTOL = 1e-5
TRAIN_STEPS = 2      # timed steps per training run, after one warm-up step
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

# the shipped ymls, read by the port's YAML reader (utils/options.py; the
# card machine has no pyyaml), each with its departures applied as
# --force_yml applies them; tests/test_torch_{training,gan_training,
# validation}.py hold each to pyyaml's load of the same yml with the same
# departures
STAGE2_YML, STAGE3_YML, TEST_YML = ("train_keep_stage2.yml",
                                    "train_keep_stage3_gan.yml",
                                    "test_keep.yml")
# stage III's one departure: the dataset's `scale: 1`, full-size LQ clips.
# The yml sets none, and the dataset's default of 4 gives KEEP's 512 net a
# 128^2 LQ clip, which the port's KEEP trainers run with need_upscale as
# the reference trains (JAX raises on it); the departure keeps the phase's
# data path and shapes those of earlier runs. Phase train_gan then points
# the dataset at its synthetic clip and the run at a temporary directory,
# and runs 2 iterations with a save at 2, then resumes to 3, all through
# tools/torch_train.py.
STAGE3_FORCE = ("datasets:train:scale=1",)


def yml_path(name):
    return os.path.join(ROOT, "options", name)


def yml_opt(name, force=()):
    """options/<name> as the port reads it, `force` applied as --force_yml
    applies it."""
    from comfyui_keep_torch.utils.options import apply_force_yml, yaml_load
    return apply_force_yml(yaml_load(yml_path(name)), force)


def train_opt():
    """options/train_keep_stage2.yml (phases train_parity, train and
    parallel_train)."""
    return yml_opt(STAGE2_YML)


def stage3_opt():
    """options/train_keep_stage3_gan.yml with STAGE3_FORCE."""
    return yml_opt(STAGE3_YML, STAGE3_FORCE)


def test_opt():
    """options/test_keep.yml (phases sr_test and parallel_train)."""
    return yml_opt(TEST_YML)


def tool(name):
    """tools/<name>.py as a module (imported once)."""
    import importlib.util
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def flow_opt():
    """GMFlowTrainer's options from tools/torch_train_flow.py's argument
    defaults (the chairs stage, 384 x 512, B = 8)."""
    tf = tool("torch_train_flow")
    return tf.flow_opt(tf.parse_args([]))


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
# the backward kernels' counters (ops/kernels.py), each zero on every path
# that records no gradient through K1-K3
BWD_COUNTERS = ("attention_bwd[dv128]", "attention_bwd[dv128+bias]",
                "attention_bwd[dv2]", "global_correlation_expectation_bwd",
                "mlp_fused_bwd")
NO_BWD = dict.fromkeys(BWD_COUNTERS, 0)


T0 = time.perf_counter()


def say(phase, **kw):
    """One phase line; t_s is the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


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


def device_events(torch, calls, iters):
    """The device kernels of iters calls of each fn in calls, in one
    torch.profiler trace, in the order they ran: [(name, us)]. Read from
    prof.events(), one entry a kernel launch (self times summed from
    key_averages() read a fraction of K2's backward launches, or none).
    The trace follows a warm-up cycle of one call each (traced and
    dropped): traces taken late in a long process without one lost their
    first kernels."""
    kept = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=lambda p: kept.append(list(p.events()))) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        prof.step()
        for fn in calls:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        prof.step()
    ev = sorted((e for e in (kept[0] if kept else [])
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in ev]


def device_ms(torch, fn, iters):
    """Device time per call of fn from torch.profiler: the device time of
    every kernel over iters calls, divided by iters (host gaps between
    launches excluded, unlike time_ms)."""
    return sum(us for _, us in device_events(torch, [fn], iters)) / 1e3 / iters


PORT_KERNEL = "keep::"   # every kernel of comfyui_keep_torch/csrc/ is in it


def kernel_name(name):
    """A device kernel's name without its return type, namespaces and
    parameters: 'mlp_bwd_gemm_kernel<1, false>'."""
    name = name.split("(")[0].removeprefix("void ")
    head, lt, tail = name.partition("<")
    return head.split("::")[-1] + lt + tail


def paired_device_ms(torch, kernel, other, iters, bound_ms, ms, other_ms):
    """Device ms a call of a port wrapper and of its yardstick (a PyTorch
    call, or the unfused reference) from one torch.profiler trace: iters
    calls of kernel, then iters of other. The wrapper's time is its
    kernels' (PORT_KERNEL in the name), each also by name
    (device_kernels); the yardstick's every kernel after the wrapper's
    last. A reading is refused, its times None and the reason in
    device_refused, when a count of kernels is no multiple of iters or a
    time lies below bound_ms (the least the work can take: records were
    lost) or above 1.25 times its CUDA-event ms (ms, other_ms) plus 10 us;
    the trace is taken twice before it is refused."""
    for _ in range(2):
        ev = device_events(torch, [kernel, other], iters)
        mine = [i for i, (n, _) in enumerate(ev) if PORT_KERNEL in n]
        theirs = ev[mine[-1] + 1:] if mine else []
        k_ms = sum(ev[i][1] for i in mine) / 1e3 / iters
        o_ms = sum(us for _, us in theirs) / 1e3 / iters
        why = None
        if not mine or len(mine) % iters or not theirs or len(theirs) % iters:
            why = (f"{len(mine)} port kernels and {len(theirs)} yardstick "
                   f"kernels over {iters} calls each")
        else:
            for what, t, ev_ms in (("kernel", k_ms, ms), ("yardstick", o_ms,
                                                          other_ms)):
                if not bound_ms <= t <= 1.25 * ev_ms + 0.01:
                    why = (f"{what} device ms {t} outside [bound {bound_ms}, "
                           f"1.25 x event ms {ev_ms} + 0.01]")
        if why is None:
            per = {}
            for i in mine:
                k = kernel_name(ev[i][0])
                per[k] = per.get(k, 0.0) + ev[i][1] / 1e3 / iters
            return {"kernel": k_ms, "other": o_ms, "kernels": per,
                    "refused": None}
    return {"kernel": None, "other": None, "kernels": None, "refused": why}


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


def op_seconds(flops, fma=False):
    """The least seconds of [(flops, rate)]: F32_TC items as three TF32
    products at PEAK_TF32 (fma: one pass of the FMA pipe at PEAK_F32)."""
    return sum((f / PEAK_F32 if fma else 3 * f / PEAK_TF32) if p == F32_TC
               else f / p for f, p in flops)


def kernel_cases(torch, dtype):
    """(counter, wrapper, args, library call, [(flops, peak rate)], bytes,
    rtol, unfused PyTorch calls or None, launch key) at the shapes one
    20-frame 512x512 chunk gives each kernel; in bf16 also at the shapes of
    a group of G = 2 chunks ("G2", the "batch" and "stage" chunk forms); in
    both dtypes K1 at the refinement's fine scale ("L256"). The launch key
    is the LAUNCHES_BY_SHAPE key of a G2 or L256 case's shape, None for a
    case whose launches are its counter's over every shape. The "flow
    step" cases are flow_step_cases': every form in f32, and K1's window
    forms and K2 in bf16 as the mixed-precision step runs them."""
    import torch.nn.functional as F
    from comfyui_keep_torch.models.gmflow import shifted_window_mask
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    isz = torch.finfo(dtype).bits // 8
    dname = str(dtype).split(".")[-1]
    peak = PEAK_BF16 if dtype == torch.bfloat16 else F32_TC

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
    flow = []
    if tanh:
        # bf16, the mixed-precision GMFlow step's shapes (flow_step_cases'
        # on the same values): K1's window forms at B = 64, L = 768 beside
        # SDPA, and K2 at 49,152 rows
        for name, fn_name, args, _, fl, _, _, _, key in \
                flow_step_cases(torch):
            if fn_name == "attention" and args[2].shape[-1] == CH:
                a = bf16_args(torch, fn_name, args)
                m = a[4] if len(a) > 4 else None
                full = None if m is None else m.repeat(
                    a[0].shape[0] // m.shape[0], 1, 1)[:, None].to(dtype)
                flow.append((name, fn_name, a, sdpa(a[0], a[1], a[2], full),
                             [(f, peak) for f, _ in fl],
                             4 * a[0].numel() * isz
                             + (0 if m is None else m.numel() * 4), rtol,
                             None, key))
            elif fn_name == "mlp_fused":
                a = bf16_args(torch, fn_name, args)
                flow.append((name, fn_name, a, None,
                             [(f, peak) for f, _ in fl],
                             3 * a[0].numel() * isz + 3 * CH * HID * isz,
                             rtol, None, key))
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
         sdpa(qg, kg, vg),
         [(glb_fl + exp_fl, peak)] if tanh
         else [(glb_fl, peak), (exp_fl, PEAK_F32)],
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
    ] + group + step + (flow if tanh else flow_step_cases(torch))


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
            op_s = op_seconds(flops)
            byte_s = nbytes / HBM
            row = {"name": name, "dtype": dname, "max_abs_err": err,
                   "tol": tol, "ref_spread": spread, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": 1e3 * max(op_s, byte_s),
                   "bound_by": "operations" if op_s >= byte_s else "bytes",
                   "launch_key": key, "ok": bool(err <= tol)}
            if dtype == torch.float32:
                # f32 runs as 3xTF32: the FMA pipe's bound beside it
                row["fma_bound_ms"] = 1e3 * max(op_seconds(flops, fma=True),
                                                byte_s)
            if unfused is not None:   # reported, not gated
                row["unfused_ms"] = time_ms(torch, unfused, iters)
            if lib_ms is not None:  # reported, not gated
                row["vs_library"] = ms / lib_ms
            if lib is not None and dtype == torch.float32:
                row["library_kernels"] = kernel_names(torch, lib)
            say("kernel", **row)
            rows[(name, dname)] = row
            del got, ref
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return rows


def k6_plan(K, b, hi, cin, cout, kh, kw, pads, dtype):
    """K6's route, tile (BM x BN) and ring stages at a square input
    (ops/kernels.py:packed_conv_plan)."""
    (pt, pb), (pl, pr) = pads
    p = K.packed_conv_plan(b, hi, hi, cin, cout, kh, kw, ((pt, pb), (pl, pr)),
                           dtype)
    return {"route": p.route, "tile": [p.bm, p.bn], "stages": p.stages}


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
            flops = 2 * got.numel() * 4 * cin
            op_s, byte_s, f32_extra = k6_bound(
                torch, dtype, flops, (x.numel() + w.numel() + got.numel())
                * x.element_size(), lambda: K.packed_conv2x2(x, w, pads),
                lambda: F.conv2d(xl, wl, padding=pads[0][0]), ms, lib_ms,
                iters)
            row = {"name": "packed_conv2x2", "case": label, "dtype": dname,
                   "x": [b, hi, hi, cin], "w": [2, 2, cin, cout],
                   "pads": pads, "plan": k6_plan(K, b, hi, cin, cout, 2, 2,
                                                 pads, dtype),
                   "max_abs_err": err, "tol": tol,
                   "ref_spread": spread, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "unpacked_3x3_ms": unpacked_ms,
                   "unpacked_3x3": [kind, b, uci, uco],
                   "bound_ms": 1e3 * max(op_s, byte_s),
                   "bound_by": "operations" if op_s >= byte_s else "bytes",
                   **f32_extra, "ok": bool(err <= tol)}
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

                def fused_call():
                    return K.packed_conv2x2(x, w, pads, bias, mc)

                def lib_bias():
                    return F.conv2d(xl, wl, bias, padding=1)
                fms = time_ms(torch, fused_call, iters)
                flib = time_ms(torch, lib_bias, iters)
                frow = dict(row, case=label + ", + bias + mask",
                            max_abs_err=ferr, tol=ftol, ref_spread=fspread,
                            ms=fms,
                            plain_ms=time_ms(
                                torch, lambda: K.packed_conv2x2_plain(
                                    x, w, pads, bias, mc), max(1, iters // 4)),
                            unfused_ms=time_ms(torch, unfused, iters),
                            library_ms=flib,
                            library="cuDNN conv2d + bias (no mask)",
                            **k6_bound(torch, dtype, flops, (
                                x.numel() + w.numel() + got.numel())
                                * x.element_size(), fused_call, lib_bias,
                                fms, flib, iters)[2],
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
    which must launch K6 12 times per frame. Returns that count (the f32
    kernel's launches in the kernel table; the serving runs count the bf16
    kernel's) and what phase packing_levels compares with: the card's
    network, the clip, the flows, the CPU's output and logits, the
    picks."""
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
    return k6, {"net": net_cuda, "x": x, "flows": flows, "out": out_c,
                "logits": aux_c["logits"], "picks": picks}


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
            "fused_bias_lrelu": 0, "packed_conv2x2": k6_per_frame_chunks,
            **NO_BWD}


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

    outs, counts, k6_shapes = {}, {}, {}
    for name, proc in procs.items():
        K.reset_launch_counts()
        outs[name] = proc.restore_face_stream(faces, max_clip_length=FRAMES)
        torch.cuda.synchronize()
        counts[name] = dict(K.LAUNCHES)
        k6_shapes[name] = dict(K.PACKED_CONV_SHAPES)
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
        k6_launches_by_shape=k6_shapes["packed"],
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


# slice 13's serving forms: multi-level packing, GMFlow's packed backbone,
# int8 activation storage (PERF.md section 6, PR 17)
# K6 at the new shapes of those forms at 512^2 input, per frame of their
# stack: (label, B, Hi = Wi, Cin, Cout, kh, kw, pads); the LQ encoder and
# GMFlow's backbone batch a chunk's 20 frames
K6_P0 = ((0, 1), (0, 1))
K6_LEVEL_CASES = (
    ("enc L2 res 64->128 conv1, parity 0->1", FRAMES, 128, 256, 512, 2, 2,
     K6_SAME),
    ("enc L2 res conv2, parity 1->0", FRAMES, 129, 512, 512, 2, 2, K6_VALID),
    ("enc L2 res 128 conv1, parity 0->1", FRAMES, 128, 512, 512, 2, 2,
     K6_SAME),
    ("enc L2 downsample p0", FRAMES, 128, 512, 128, 2, 2, K6_P0),
    ("enc L3 res conv1, parity 0->1", FRAMES, 64, 512, 512, 2, 2, K6_SAME),
    ("enc L3 res conv2, parity 1->0", FRAMES, 65, 512, 512, 2, 2, K6_VALID),
    ("enc L3 downsample p0", FRAMES, 64, 512, 128, 2, 2, K6_P0),
    ("enc L4 res 128->256 conv1", FRAMES, 32, 512, 1024, 2, 2, K6_SAME),
    ("enc L4 res conv2", FRAMES, 33, 1024, 1024, 2, 2, K6_VALID),
    ("enc L4 res 256 conv1", FRAMES, 32, 1024, 1024, 2, 2, K6_SAME),
    ("enc L4 downsample p0", FRAMES, 32, 1024, 256, 2, 2, K6_P0),
    ("enc L5 res conv1", FRAMES, 16, 1024, 1024, 2, 2, K6_SAME),
    ("enc L5 res conv2", FRAMES, 17, 1024, 1024, 2, 2, K6_VALID),
    ("enc L5 downsample p0", FRAMES, 16, 1024, 256, 2, 2, K6_P0),
    ("gen L3 upsample from 64^2", 1, 64, 256, 1024, 2, 2, K6_SAME),
    ("gen L3 res 256->128 conv1", 1, 65, 1024, 512, 2, 2, K6_VALID),
    ("gen L3 res conv2", 1, 64, 512, 512, 2, 2, K6_SAME),
    ("gen L3 res 128 conv1", 1, 65, 512, 512, 2, 2, K6_VALID),
    ("gen p2p 65 plane ee", 1, 65, 512, 512, 1, 1, K6_VALID),
    ("gen p2p 65 plane eo", 1, 65, 512, 512, 1, 2, K6_VALID),
    ("gen p2p 65 plane oe", 1, 65, 512, 512, 2, 1, K6_VALID),
    ("gen p2p 65 plane oo", 1, 65, 512, 512, 2, 2, K6_VALID),
    ("gen L2 upsample from 128^2", 1, 128, 128, 512, 2, 2, K6_SAME),
    ("gen L2 res conv1", 1, 129, 512, 512, 2, 2, K6_VALID),
    ("gen L2 res conv2", 1, 128, 512, 512, 2, 2, K6_SAME),
    ("gen p2p 129 plane ee", 1, 129, 512, 512, 1, 1, K6_VALID),
    ("gen p2p 129 plane eo", 1, 129, 512, 512, 1, 2, K6_VALID),
    ("gen p2p 129 plane oe", 1, 129, 512, 512, 2, 1, K6_VALID),
    ("gen p2p 129 plane oo", 1, 129, 512, 512, 2, 2, K6_VALID),
    ("gmflow layer1 conv1, parity 0->1", FRAMES, 128, 256, 256, 2, 2,
     K6_SAME),
    ("gmflow layer1 conv2, parity 1->0", FRAMES, 129, 256, 256, 2, 2,
     K6_VALID),
)
K6_LEVEL_ITERS = 10     # timed launches per new K6 row (plain: a quarter)
# phase packing_levels: (phase_levels, phase_enc_levels) held in f32 to the
# CPU's unpacked KEEP, and the serving configurations timed in turns (bf16
# chunks; every new K6 shape runs in one of them)
LEVEL_CHECKS = ((2, 1), (3, 1), (1, 2), (1, 5), (3, 2))
LEVEL_TIMED = (("unpacked", dict()),
               ("(1, 1)", dict(phase512=True)),
               ("(2, 1)", dict(phase512=True, phase_levels=2)),
               ("(3, 1)", dict(phase512=True, phase_levels=3)),
               ("(1, 2)", dict(phase512=True, phase_enc_levels=2)),
               ("(1, 5)", dict(phase512=True, phase_enc_levels=5)),
               ("(3, 2)", dict(phase512=True, phase_levels=3,
                               phase_enc_levels=2)),
               ("pack_gmflow", dict(pack_gmflow=True)))
LEVEL_ROUNDS = 3        # timed rounds in turns, after a warm-up round
# phase int8_acts: the fidelity report's floors, predicted in PERF.md
# (section 6, PR 17) before the first card run and not moved after it: the
# forced bf16 + int8 run's own picks against the f32 run's, its uint8 PSNR
INT8_FLOOR_AGREEMENT, INT8_FLOOR_PSNR_FORCED = 0.70, 28.0
INT8_TIMED = (("bf16", dict()), ("bf16+int8", dict(int8_acts=True)),
              ("packed", dict(phase512=True)),
              ("packed+int8", dict(phase512=True, int8_acts=True)))


def k6_bound(torch, dtype, flops, nbytes, kernel, library, ms, lib_ms,
             iters):
    """(operation seconds, byte seconds, f32 extras) of one K6 call: bf16
    products at PEAK_BF16, f32 as the kernel computes them, 3xTF32 (F32_TC);
    for f32 also fma_bound_ms (the FMA pipe's bound), the kernel's and
    cuDNN's device ms from one torch.profiler trace (paired_device_ms;
    device_kernels: the weights' split and the convolution apart) beside
    their event ms, and ms over cuDNN's (vs_library)."""
    byte_s = nbytes / HBM
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16, byte_s, {}
    op_s = op_seconds([(flops, F32_TC)])
    dev = paired_device_ms(torch, kernel, library, iters,
                           1e3 * max(op_s, byte_s), ms, lib_ms)
    return op_s, byte_s, {
        "fma_bound_ms": 1e3 * max(op_seconds([(flops, F32_TC)], fma=True),
                                  byte_s),
        "device_ms": dev["kernel"], "library_device_ms": dev["other"],
        "device_kernels": dev["kernels"], "device_refused": dev["refused"],
        "vs_library": ms / lib_ms}


def k6_extra(row):
    """A K6 row's f32 extras (k6_bound) for the final kernels line."""
    return {k: row[k] for k in ("fma_bound_ms", "device_ms",
                                "library_device_ms", "device_kernels",
                                "device_refused", "vs_library")
            if k in row}


def k6_row(torch, g, dtype, label, b, hi, cin, cout, kh, kw, pads, iters):
    """One K6 row at a new shape: max|d| against the plain version within
    KERNEL_RTOL x the plain output's spread, kernel / plain / F.conv2d ms
    on the same packed tensor (channels-last; a (0, 1) pad applied before
    the timed call), the bound."""
    import torch.nn.functional as F
    from comfyui_keep_torch.ops import kernels as K
    dname = str(dtype).split(".")[-1]
    x = torch.randn(b, hi, hi, cin, generator=g, device="cuda").to(dtype)
    w = (torch.randn(kh, kw, cin, cout, generator=g, device="cuda")
         / math.sqrt(kh * kw * cin)).to(dtype)
    got = K.packed_conv2x2(x, w, pads)
    torch.cuda.synchronize()
    ref = K.packed_conv2x2_plain(x, w, pads).float()
    err = (got.float() - ref).abs().max().item()
    spread = (ref - ref.mean()).abs().max().item()
    tol = KERNEL_RTOL[dname] * spread
    ms = time_ms(torch, lambda: K.packed_conv2x2(x, w, pads), iters)
    plain_ms = time_ms(torch, lambda: K.packed_conv2x2_plain(x, w, pads),
                       max(1, iters // 4))
    (pt, pb), (pl, pr) = pads
    xl = x.permute(0, 3, 1, 2)
    if pt != pb or pl != pr:
        xl = F.pad(xl, (pl, pr, pt, pb))
        sym = 0
    else:
        sym = pt
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_ms = time_ms(torch, lambda: F.conv2d(xl, wl, padding=sym), iters)
    op_s, byte_s, f32_extra = k6_bound(
        torch, dtype, 2 * got.numel() * kh * kw * cin,
        (x.numel() + w.numel() + got.numel()) * x.element_size(),
        lambda: K.packed_conv2x2(x, w, pads),
        lambda: F.conv2d(xl, wl, padding=sym), ms, lib_ms, iters)
    row = {"name": "packed_conv2x2", "case": label, "dtype": dname,
           "x": [b, hi, hi, cin], "w": [kh, kw, cin, cout], "pads": pads,
           "plan": k6_plan(K, b, hi, cin, cout, kh, kw, pads, dtype),
           "shape_key": K.packed_conv_shape(hi, hi, cin, kh, kw, cout, pads),
           "max_abs_err": err, "tol": tol, "ref_spread": spread, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "cuDNN conv2d, channels-last",
           "bound_ms": 1e3 * max(op_s, byte_s),
           "bound_by": "operations" if op_s >= byte_s else "bytes",
           **f32_extra, "ok": bool(err <= tol)}
    say("kernel", **row)
    return row


def phase_k6_levels(torch, iters=K6_LEVEL_ITERS):
    """K6 at every new shape of the multi-level forms and GMFlow's packed
    backbone (K6_LEVEL_CASES), bf16 and f32 (k6_row)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case in K6_LEVEL_CASES:
            row = k6_row(torch, g, dtype, *case, iters)
            rows[(case[0], row["dtype"])] = row
        torch.cuda.empty_cache()
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"the packed conv kernel disagrees with its plain version at "
             f"the new shapes: {bad}")
    return rows


def keep_plan_counts(keep, levels, enc_levels):
    """(K6 launches, int8 boundaries) per packed pass of each stack of a
    KEEP packed at (levels, enc_levels), derived from its plans: the
    encoder's packed prefix (phase_encoder_end) launches one per conv and
    Downsample and two per res block; the generator's packed tail
    (phase_generator_start) one for its first Upsample, four per packed ->
    packed Upsample, two per res block, one for the conv. Returns {"enc":
    K6 per encoder pass, "gen": per generator pass, "enc_q": boundaries per
    packed encoder pass, "gen_q": per packed tail}."""
    from comfyui_keep_torch.models.vqgan import (phase_encoder_end,
                                                 phase_generator_start)
    cfg = keep.cfg
    per = {"conv": 1, "res": 2, "down": 1, "norm": 0}
    end = phase_encoder_end(keep.enc_plan, enc_levels)
    fuse = {keep.gen_tap[f] for f in (tuple(cfg["cft_list"])
                                      + tuple(cfg["cfa_list"])
                                      + tuple(cfg["temp_reg_list"]))}
    start = phase_generator_start(keep.gen_plan, fuse, levels)
    enc = sum(per[s[0]] for s in keep.enc_plan[:end + 1])
    tail = keep.gen_plan[start:]
    gen = sum(4 if s[0] == "up" and j else 1 if s[0] == "up" else per[s[0]]
              for j, s in enumerate(tail))
    norms = sum(s[0] == "norm" for s in keep.enc_plan)
    return {"enc": enc, "gen": gen,
            "enc_q": len(keep.enc_plan) - 2 - norms,
            "enc_q_unpacked": len(keep.enc_plan) - 1 - norms,
            "gen_q": len(tail) - 1 - sum(s[0] == "norm" for s in tail)}


def phase_packing_levels(torch, keep_ref, pack, faces):
    """Multi-level packing. Correctness: the full-width f32 KEEP of phase
    keep (TF32 off) on its 2-frame clip, picks forced from the CPU's
    unpacked run, at each (phase_levels, phase_enc_levels) of LEVEL_CHECKS:
    output and logits within KEEP_ATOL + KEEP_RTOL |ref| of the CPU's, K6
    launches equal to the plans' count (keep_plan_counts). Timing: the
    20-frame bf16 chunk of each LEVEL_TIMED processor on the pack, in turns
    after a warm-up round over LEVEL_ROUNDS rounds: median ms, ratio to
    unpacked, peak GiB, K6 launches against the plans', uint8 max and mean
    distance from the unpacked output (not gated: bf16 picks can flip).
    Returns the K6 launches by shape of the f32 checks and of the bf16
    runs."""
    from comfyui_keep_torch.ops import kernels as K
    net, x, flows = keep_ref["net"], keep_ref["x"], keep_ref["flows"]
    out_c, logits_c, picks = (keep_ref["out"], keep_ref["logits"],
                              keep_ref["picks"])
    lim = KEEP_ATOL + KEEP_RTOL * out_c.abs()
    llim = KEEP_ATOL + KEEP_RTOL * logits_c.abs()
    t = x.shape[1]
    f32_shapes, ok = {}, True
    for levels, enc_levels in LEVEL_CHECKS:
        packed = net.prepare_phase512(levels, enc_levels)
        K.reset_launch_counts()
        with torch.no_grad():
            out, aux = packed.apply(
                x.cuda(), flows=tuple(f.cuda() for f in flows),
                return_aux=True, force_indices=picks.cuda())
        torch.cuda.synchronize()
        k6 = K.LAUNCHES["packed_conv2x2"]
        for k, v in K.PACKED_CONV_SHAPES.items():
            f32_shapes[k] = f32_shapes.get(k, 0) + v
        c = keep_plan_counts(net, levels, enc_levels)
        want = (c["enc"] + c["gen"]) * t
        d = (out.cpu() - out_c).abs()
        dl = (aux["logits"].cpu() - logits_c).abs()
        good = bool((d <= lim).all() and (dl <= llim).all() and k6 == want)
        ok = ok and good
        say("packing_levels", part="f32 against the CPU", levels=levels,
            enc_levels=enc_levels, max_abs_err=d.max().item(),
            logits_max_abs_err=dl.max().item(), atol=KEEP_ATOL,
            rtol=KEEP_RTOL, k6_launches=k6, expected_k6_launches=want,
            k6_per_frame=k6 / t, ok=good)
        del packed, out, aux
    if not ok:
        fail("packing_levels: a multi-level KEEP is outside KEEP's "
             "tolerance of the CPU, or its K6 launches differ from its "
             "plans'")

    procs = {name: pack.processor(dtype=torch.bfloat16, **kw)
             for name, kw in LEVEL_TIMED}
    runs = {k: [] for k in procs}
    peaks = {k: 0.0 for k in procs}
    counts, outs, bf16_shapes = {}, {}, {}
    for i in range(LEVEL_ROUNDS + 1):   # a warm-up round, then timed ones
        order = list(procs) if i % 2 == 0 else list(procs)[::-1]
        for name in order:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            a = time.perf_counter()
            outs[name] = procs[name].restore_face_stream(
                faces[:FRAMES], max_clip_length=FRAMES)
            torch.cuda.synchronize()
            if i:
                runs[name].append(1e3 * (time.perf_counter() - a))
                peaks[name] = max(peaks[name],
                                  torch.cuda.max_memory_allocated() / 2 ** 30)
            counts[name] = K.LAUNCHES["packed_conv2x2"]
            if i == LEVEL_ROUNDS:
                for k, v in K.PACKED_CONV_SHAPES.items():
                    bf16_shapes[k] = bf16_shapes.get(k, 0) + v
    base = float(np.median(runs["unpacked"]))
    ok = True
    for name, kw in LEVEL_TIMED:
        want = 0
        if kw.get("phase512"):
            c = keep_plan_counts(pack.keep, kw.get("phase_levels", 1),
                                 kw.get("phase_enc_levels", 1))
            want = (c["enc"] + c["gen"]) * FRAMES
        if kw.get("pack_gmflow"):
            want += 4        # layer1's two blocks, one backbone call
        diff = np.stack([np.abs(a.astype(int) - b.astype(int)) for a, b in
                         zip(outs[name], outs["unpacked"])])
        med = float(np.median(runs[name]))
        good = counts[name] == want
        ok = ok and good
        say("packing_levels", part="bf16 chunk", config=name,
            chunk_ms_median=med, chunk_ms_runs=runs[name],
            over_unpacked=med / base, peak_mem_gib=peaks[name],
            k6_launches=counts[name], expected_k6_launches=want,
            uint8_max_from_unpacked=int(diff.max()),
            uint8_mean_from_unpacked=float(diff.mean()), ok=good)
    del procs
    torch.cuda.empty_cache()
    if not ok:
        fail("packing_levels: a timed configuration's K6 launches differ "
             "from its plans'")
    return {"float32": f32_shapes, "bfloat16": bf16_shapes}


def phase_gmflow_packed(torch, x):
    """GMFlow's packed backbone (GMFlow.prepare_packed) at 512^2: f32 with
    TF32 off on phase gmflow's 2-frame clip, packed against unpacked on the
    card within FLOW_TOL_PX, 4 K6 launches per extract_features call; then
    bf16 ms per pair of both forms on a 20-frame clip (19 pairs). Returns
    the K6 launches by shape of the f32 and bf16 packed calls."""
    from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
    from comfyui_keep_torch.ops import kernels as K
    gm = GMFlow(device="cpu",
                generator=torch.Generator().manual_seed(1)).cuda()
    packed = gm.prepare_packed()
    shapes = {}
    with torch.no_grad():
        xc = x.cuda()
        plain = flow_from_clip(gm, xc)
        K.reset_launch_counts()
        got = flow_from_clip(packed, xc)
        torch.cuda.synchronize()
        k6 = K.LAUNCHES["packed_conv2x2"]
        shapes["float32"] = dict(K.PACKED_CONV_SHAPES)
        err = max((a - b).abs().max().item() for a, b in zip(got, plain))
        gb = copy.deepcopy(gm).to(torch.bfloat16)
        pb = gb.prepare_packed()
        rng = np.random.default_rng(5)
        clip = torch.as_tensor(rng.random((1, FRAMES, 512, 512, 3),
                                          dtype=np.float32) * 2 - 1,
                               device="cuda").to(torch.bfloat16)
        ms_plain = time_ms(torch, lambda: flow_from_clip(gb, clip), 3)
        K.reset_launch_counts()
        ms_packed = time_ms(torch, lambda: flow_from_clip(pb, clip), 3)
        k6_bf16 = K.LAUNCHES["packed_conv2x2"]
        shapes["bfloat16"] = dict(K.PACKED_CONV_SHAPES)
    pairs = FRAMES - 1
    ok = bool(np.isfinite(err) and err <= FLOW_TOL_PX and k6 == 4
              and k6_bf16 == 4 * 4)
    say("gmflow_packed", max_abs_err_px=err, tol_px=FLOW_TOL_PX,
        k6_launches=k6, expected_k6_launches=4,
        bf16_ms_per_pair_unpacked=ms_plain / pairs,
        bf16_ms_per_pair_packed=ms_packed / pairs,
        packed_over_unpacked=ms_packed / ms_plain,
        bf16_k6_launches_4_calls=k6_bf16, ok=ok)
    if not ok:
        fail(f"gmflow_packed: max|d| {err} px (tol {FLOW_TOL_PX}), K6 "
             f"launches {k6} / {k6_bf16} (want 4 / 16)")
    del gm, packed, gb, pb
    torch.cuda.empty_cache()
    return shapes


def phase_int8_acts(torch, pack, faces):
    """int8 activation storage. tools/torch_bf16_fidelity.py --int8-acts at
    20 frames, unpacked and packed (one level): pick agreement with the f32
    run and psnr_db_forced beside the floors PERF.md predicted
    (INT8_FLOOR_*; reported, not gated). Then the 20-frame bf16 chunk with
    and without int8, unpacked and packed, in turns after a warm-up round
    over LEVEL_ROUNDS rounds: median ms and the int8 boundaries a chunk
    stores, against the plans' count. Gated: finite numbers and outputs,
    the counts."""
    from comfyui_keep_torch.models import vqgan
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    fid = tool("torch_bf16_fidelity")
    ok = True
    for phase512 in (False, True):
        a = time.perf_counter()
        rep = fid.fidelity(FRAMES, "bf16", phase512=phase512, int8_acts=True)
        nums = [v for k, v in rep.items() if isinstance(v, float)]
        good = bool(all(math.isfinite(v) for v in nums
                        if v != rep["psnr_db"]))
        ok = ok and good
        say("int8_acts", part="fidelity", **rep,
            seconds=time.perf_counter() - a,
            floor_agreement=INT8_FLOOR_AGREEMENT,
            floor_psnr_forced=INT8_FLOOR_PSNR_FORCED,
            agreement_above_floor=bool(
                rep["index_agreement"] >= INT8_FLOOR_AGREEMENT),
            psnr_forced_above_floor=bool(
                rep["psnr_db_forced"] >= INT8_FLOOR_PSNR_FORCED), ok=good)
    procs = {name: pack.processor(dtype=torch.bfloat16, **kw)
             for name, kw in INT8_TIMED}
    runs = {k: [] for k in procs}
    counts = {}
    for i in range(LEVEL_ROUNDS + 1):
        order = list(procs) if i % 2 == 0 else list(procs)[::-1]
        for name in order:
            torch.cuda.synchronize()
            vqgan.INT8_BOUNDARIES["count"] = 0
            a = time.perf_counter()
            procs[name].restore_face_stream(faces[:FRAMES],
                                            max_clip_length=FRAMES)
            torch.cuda.synchronize()
            if i:
                runs[name].append(1e3 * (time.perf_counter() - a))
            counts[name] = vqgan.INT8_BOUNDARIES["count"]
    c = keep_plan_counts(pack.keep, 1, 1)
    want = {"bf16": 0, "packed": 0,
            "bf16+int8": c["enc_q_unpacked"] * FRAMES,
            "packed+int8": (c["enc_q"] + c["gen_q"]) * FRAMES}
    x20 = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces[:FRAMES]])
    for name, kw in INT8_TIMED:
        finite = (bool(np.isfinite(procs[name].restore_clip(x20)).all())
                  if kw.get("int8_acts") else True)
        med = float(np.median(runs[name]))
        base = float(np.median(runs["packed" if kw.get("phase512")
                                    else "bf16"]))
        good = counts[name] == want[name] and finite
        ok = ok and good
        say("int8_acts", part="bf16 chunk", config=name, chunk_ms_median=med,
            chunk_ms_runs=runs[name], over_int8_free=med / base,
            int8_boundaries=counts[name], expected_int8_boundaries=want[name],
            int8_boundaries_per_frame=counts[name] / FRAMES, finite=finite,
            ok=good)
    del procs
    torch.cuda.empty_cache()
    if not ok:
        fail("int8_acts: a non-finite report or output, or int8 boundaries "
             "other than the plans' count")


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
            "fused_bias_lrelu": 0, "packed_conv2x2": 0, **NO_BWD}
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
                   "packed_conv2x2": 0, **NO_BWD}
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


FACE_CONF = 0.97          # the processor's detection threshold


def face_finding_detector(torch, name, frame_bgr, seed=0):
    """A random RetinaFace (`name`, on the CPU) that finds a face on
    `frame_bgr` (random weights find none): random BatchNorm statistics;
    the landmark heads' weights zero and their biases the FFHQ template
    about each prior, so a detection carries a face-shaped set of five
    points; the box heads zero (boxes are the priors); the class heads'
    weights scaled by 100, then the face logit's bias moved so that the k
    top anchors on this frame pass FACE_CONF, k in 1..4 where the gap to
    the next margin is widest (tests/test_torch_nodes.py builds the same).
    Returns (detector, k, that gap)."""
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.facelib.helper import FFHQ_TEMPLATE_512
    det = factory.init_detection_model(name, require_weights=False,
                                       seed=seed, device="cpu")
    m = det.model
    g = torch.Generator().manual_seed(seed + 1)
    rel = (FFHQ_TEMPLATE_512 - FFHQ_TEMPLATE_512.mean(0)) / 256
    with torch.no_grad():
        for b in m.modules():
            if isinstance(b, torch.nn.BatchNorm2d):
                c = b.num_features
                b.weight.copy_(torch.rand(c, generator=g) + 0.5)
                b.bias.copy_(torch.randn(c, generator=g) * 0.1)
                b.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                b.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
        for h in m.LandmarkHead:
            h.conv1x1.weight.zero_()
            h.conv1x1.bias.copy_(torch.as_tensor(
                np.tile(rel.reshape(-1) / 0.1, 2), dtype=torch.float32))
        for h in m.BboxHead:
            h.conv1x1.weight.zero_()
            h.conv1x1.bias.zero_()
        for h in m.ClassHead:
            h.conv1x1.weight.mul_(100.0)
    raw = []
    hooks = [h.register_forward_hook(lambda mod, a, o: raw.append(o))
             for h in m.ClassHead]
    with torch.no_grad():
        m(m.prepare(torch.from_numpy(frame_bgr[None])))
    for h in hooks:
        h.remove()
    logits = torch.cat(raw, 1)[0].double()
    margin = np.sort((logits[:, 1] - logits[:, 0]).numpy())[::-1]
    k = 1 + int(np.argmax(margin[:4] - margin[1:5]))
    shift = np.log(FACE_CONF / (1 - FACE_CONF)) - (margin[k - 1]
                                                   + margin[k]) / 2
    with torch.no_grad():
        for h in m.ClassHead:
            h.conv1x1.bias[1::2] += shift
    return det, k, float(margin[k - 1] - margin[k])


def phase_nodes(torch):
    """The three nodes: the loader builds a pack (random KEEP, f32); both
    execution nodes on ComfyUI IMAGE arrays with their default widgets
    (whole frames) return (None,) on a pack loaded without model_rootpath,
    as the JAX nodes do, since that loader builds no detector; an aligned
    512^2 face through the image node gives api.restore_image's pixels;
    aligned frames through the sequence node come back as they went in; an
    invalid pack gives (None,); the pack ends offloaded after each call.
    Then the loader with model_rootpath: the widgets' default detector
    (RetinaFace-ResNet50, made to find a face: face_finding_detector) and
    ParseNet written as reference-named .pth files to a temporary
    directory, read by the loader; a 960x640 frame through the image node
    with its default widgets on the card: a face restored and pasted, the
    card's detection rows against the CPU's within DETECT_RTOL, ms a
    call."""
    from comfyui_keep_torch import api, nodes
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.utils.image import comfy_to_cv2, cv2_to_comfy
    loader = nodes.KEEP_ModelLoaderNode()
    req = loader.INPUT_TYPES()["required"]
    pack, = loader.load_model_pack(req["model"][1]["default"],
                                   req["detection_model"][1]["default"])

    def defaults(node):
        return {k: v[1]["default"] for k, v in
                node.INPUT_TYPES()["required"].items()
                if len(v) > 1 and "default" in v[1]}

    def on_host(p=None):
        return all(q.device.type == "cpu" for m in (p or pack).models()
                   for q in m.parameters())

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
    del pack

    # the loader with model_rootpath: detector and parser from .pth files
    name = req["detection_model"][1]["default"]
    frame = np.ascontiguousarray(whole_frames(1, seed=17)[0][:640, :960])
    work = tempfile.mkdtemp(prefix="nodes_")
    try:
        det, k, gap = face_finding_detector(torch, name, frame)
        torch.save({n: v for n, v in det.model.state_dict().items()
                    if not n.endswith("num_batches_tracked")},
                   os.path.join(work, factory.MODEL_NAMES[name]))
        parser = factory.init_parsing_model("parsenet", require_weights=False,
                                            seed=0, device="cpu")
        torch.save(parser.model.state_dict(),
                   os.path.join(work, factory.MODEL_NAMES["parsenet"]))
        del det, parser
        t0 = time.perf_counter()
        rpack, = loader.load_model_pack(req["model"][1]["default"], name,
                                        model_rootpath=work)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    helper = rpack.face_helper
    rows_cpu = helper.detector(frame, FACE_CONF)
    image = (frame[..., ::-1] / np.float32(255)).astype(np.float32)[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, = img_node.upscale_face_image(image, rpack, **defaults(img_node))
    rootpath_ms = 1e3 * (time.perf_counter() - t0)
    rows["rootpath_offloaded"] = on_host(rpack)
    n_faces = len(helper.restored_faces)
    rpack.load_device()
    rows_card = helper.detector(frame, FACE_CONF)
    rpack.offload()
    det_err = (float(np.abs(rows_card - rows_cpu).max() / max(
        np.abs(rows_cpu).max(), 1e-30)) if rows_card.shape == rows_cpu.shape
        and len(rows_cpu) else None)
    got = None if out is None else comfy_to_cv2(out)
    rows["rootpath_helper_built"] = bool(
        helper is not None and helper.use_parse
        and helper.parser is not None)
    rows["rootpath_detections_card_vs_cpu"] = bool(
        det_err is not None and det_err <= DETECT_RTOL)
    rows["rootpath_whole_frame_restored"] = bool(
        got is not None and got.shape == frame.shape and got.dtype == np.uint8
        and n_faces == 1 and not np.array_equal(got, frame))
    ok = bool(all(rows.values()))
    say("nodes", checks=rows, aligned_image_max_diff_levels=diff,
        aligned_image_node_ms=node_ms, rootpath_detector=name,
        rootpath_load_s=load_s, rootpath_anchors_passing=k,
        rootpath_margin_gap=gap, rootpath_detections=len(rows_cpu),
        rootpath_rows_rel_err=det_err, tol_rel=DETECT_RTOL,
        rootpath_faces_restored=n_faces, rootpath_frame_hw=list(
            frame.shape[:2]), rootpath_image_node_ms=rootpath_ms,
        cv2_imported="cv2" in sys.modules,
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
    1 level, and 1280x720 timed on the card. SwinIR also takes a size that
    is not a window multiple (swinir_ragged). Returns the card models of
    the full workflow."""
    from comfyui_keep_torch.pipeline.realesrganer import RealESRGANer
    from comfyui_keep_torch.pipeline.tiled import make_upscaler_fn
    rng = np.random.default_rng(18)
    tile = torch.from_numpy(rng.random((1, 3, 64, 64), dtype=np.float32))
    frame = whole_frames(1, seed=19)[0]
    rows, ok_all, keep = {}, True, {}
    ragged = None
    for name, (arch, scale, _) in SR_MODELS.items():
        cpu = sr_model(torch, name, "cpu")
        card = copy.deepcopy(cpu).cuda()
        with torch.no_grad():
            ref = cpu(tile)
            got = card(tile.cuda())
        err = rel_err(got, ref)
        if arch == "SwinIR":
            ragged = swinir_ragged(torch, cpu, card, scale, frame)
            ok_all &= ragged["ok"]
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
        realesrganer_x2plus=enhance, swinir_ragged=ragged, ok=bool(ok_all))
    if not ok_all:
        fail(f"upscale: {rows} {enhance} {ragged}")
    return keep


# a frame 854 px wide: at tile 512 / overlap 64 its edge tile is 406 px,
# not a multiple of SwinIR's 8-px window
RAGGED_HW = (480, 854)


def swinir_ragged(torch, cpu, card, scale, frame):
    """SwinIR at a size that is not a window multiple, which it pads to one
    (reflect, bottom and right) and crops back: a 37x53 tile card against
    CPU within SR_RTOL, and against the card's forward on the tile padded
    by F.pad beforehand, cropped (the same computation: within 1e-6,
    reported whether bitwise); then make_upscaler_fn (SR_TILE, SR_OVERLAP)
    over a RAGGED_HW frame, whose edge tile is ragged: output shape and
    dtype, ms a frame after one warm-up."""
    import torch.nn.functional as F
    from comfyui_keep_torch.pipeline.tiled import (make_upscaler_fn,
                                                   tile_origins)
    ws = card.window_size
    x = torch.from_numpy(np.random.default_rng(20).random(
        (1, 3, 37, 53), dtype=np.float32))
    xc = x.cuda()
    with torch.no_grad():
        ref = cpu(x)
        got = card(xc)
        padded = F.pad(xc, (0, -53 % ws, 0, -37 % ws), mode="reflect")
        pre = card(padded)[:, :, :37 * scale, :53 * scale]
    err = rel_err(got, ref)
    pad_err = rel_err(got, pre)
    edge = RAGGED_HW[1] - tile_origins(RAGGED_HW[1], SR_TILE, SR_OVERLAP)[-1]
    img = np.ascontiguousarray(frame[:RAGGED_HW[0], :RAGGED_HW[1]])
    up = make_upscaler_fn(card, scale, SR_TILE, SR_OVERLAP)
    up(img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = up(img)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    ok = bool(got.shape == (1, 3, 37 * scale, 53 * scale) and err <= SR_RTOL
              and pad_err <= 1e-6 and edge % ws != 0
              and out.shape == (RAGGED_HW[0] * scale, RAGGED_HW[1] * scale, 3)
              and out.dtype == np.uint8)
    return dict(tile_hw=[37, 53], window=ws, tile_rel_err=err,
                vs_prepadded_rel_err=pad_err,
                vs_prepadded_bitwise=bool(torch.equal(got, pre)),
                frame_hw=list(RAGGED_HW), edge_tile_px=edge,
                output_hw=list(out.shape[:2]), frame_ms=ms, ok=ok)


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
                   "packed_conv2x2": 0, **NO_BWD}
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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        op_s = 2 * VQ_T * VQ_N * VQ_C / peak
        byte_s = ((VQ_T + VQ_N) * VQ_C * zc.element_size()
                  + 4 * (VQ_N + VQ_T)) / HBM
        # at ~0.02-0.06 ms a call the loop above can be bound by the host's
        # launches: the device's own time of each, from one profiler trace
        dev = paired_device_ms(torch, lambda: K.vq_nearest_indices(zc, ec),
                               lib, iters, 1e3 * max(op_s, byte_s), ms,
                               lib_ms)
        row = {"name": "vq_nearest_indices", "dtype": dname,
               "max_abs_err": err, "tol": tol,
               "picks_differing": pc["differing"],
               "picks_differing_past_tol": mismatched,
               "tokens_past_tol": pc["tokens_past_tol"],
               "repeat_codes_picked": repeats, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "device_ms": dev["kernel"], "library_device_ms": dev["other"],
               "device_kernels": dev["kernels"],
               "device_refused": dev["refused"],
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
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    opt = train_opt()
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
            "fused_bias_lrelu": 0, "packed_conv2x2": 0, **NO_BWD}
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
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    yml = train_opt()
    data = yml["datasets"]["train"]
    b, t = data["batch_size_per_gpu"], data["num_frame"]
    hq = VQHQEncoder(**{k: v for k, v in yml["network_g"].items()
                        if k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    # per step: two flow_from_clip calls (LQ and GT clips) of the 6-layer
    # GMFlow, one nearest-codebook launch for the GT codes
    per_step = {"attention[dv128]": 12, "attention[dv128+bias]": 12,
                "attention[dv2]": 2, "mlp_fused": 12,
                "global_correlation_expectation": 2, "vq_nearest_indices": 1,
                "fused_bias_lrelu": 0, "packed_conv2x2": 0, **NO_BWD}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    watch = ("feat_emb.weight", "position_emb", "encoder.blocks.0.weight",
             "hq_encoder.blocks.0.weight", "ft_layers.0.linear1.weight",
             "idx_pred_layer.1.weight",
             "kalman_filter.kalman_gain_calculator.3.weight",
             "cft.32.scale.2.bias", "cfa.16.attn.to_out.0.bias")
    ema_leaf = "feat_emb.weight"
    runs = {}
    for mp in (False, True):
        opt = copy.deepcopy(yml)
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
    ok = ok and phase_gmflow_refine_x4(torch, g0, g1, img0, img1, iters)
    if not ok:
        fail(f"gmflow_refine: card vs CPU {errs} px (tol {FLOW_TOL_PX}), "
             f"launches off, bf16 not finite, the occlusion masks differ, "
             f"or the x4 model's output is off")
    del gm_cuda
    torch.cuda.empty_cache()
    return {"float32": fwd_snap, "bfloat16": bf16_snap}


def phase_gmflow_refine_x4(torch, g0, g1, img0, img1, iters):
    """The published refinement model's form, GMFlow(num_scales=2,
    upsample_factor=4) (random weights, seed 1): its convex upsampler has
    4^2 * 9 = 144 mask channels, and apply_refine on the two 512x512 pairs
    returns the input's size, finite, on the card; card against CPU on one
    128x128 crop of the first pair within FLOW_TOL_PX; ms a pair. Returns
    whether every check held."""
    from comfyui_keep_torch.models.gmflow import GMFlow
    x4 = GMFlow(device="cpu", num_scales=2, upsample_factor=4,
                generator=torch.Generator().manual_seed(1))
    x4_cuda = copy.deepcopy(x4).cuda()
    out = x4_cuda.apply_refine(g0, g1)
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: x4_cuda.apply_refine(g0, g1), iters)
    c0, c1 = img0[:1, :128, :128], img1[:1, :128, :128]
    ref = x4.apply_refine(c0, c1)
    got = x4_cuda.apply_refine(c0.cuda(), c1.cuda())
    err = (got.cpu() - ref).abs().max().item()
    channels = x4.upsampler[2].out_channels
    good = bool(out.shape == g0.shape[:3] + (2,)
                and torch.isfinite(out).all() and channels == 144
                and got.shape == (1, 128, 128, 2) and np.isfinite(err)
                and err <= FLOW_TOL_PX)
    say("gmflow_refine", call="apply_refine upsample_factor=4",
        dtype="float32", pairs=2, output=list(out.shape),
        upsampler_mask_channels=channels, ms_per_pair=ms / 2,
        crop_hw=[128, 128], crop_max_abs_err_px=err, tol_px=FLOW_TOL_PX,
        ok=good)
    del x4_cuda
    return good


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


# slice 8: the archs behind build_network, each at its JAX init defaults (the
# published widths), f32. Card against CPU on a small input, outputs scaled
# by their largest magnitude, within the (atol, rtol) of the JAX package's
# golden tests against the reference (1e-4 / 1e-3 where it has none); then
# timed on the card at a size its users run. DFDNet's dictionary: random
# atoms of (3, C, 8, 8), as tests/test_face_restore_archs.py draws them.
ARCH_TOL = {"SpyNet": (1e-3, 1e-2), "TOFlow": (1e-3, 1e-2),
            "BasicVSR": (2e-3, 1e-2), "EDVR": (2e-3, 1e-2),
            "BasicVSRPlusPlus": (3e-3, 1e-2), "IconVSR": (3e-3, 1e-2),
            "DUF": (1e-4, 1e-3), "RCAN": (1e-4, 1e-3), "ECBSR": (1e-4, 1e-3),
            "RIDNet": (1e-3, 1e-3), "VGGStyleDiscriminator": (1e-3, 1e-3),
            "UNetDiscriminatorSN": (5e-3, 1e-2),
            "ResNetArcFace": (1e-3, 1e-2)}
# timed calls per arch at its users' size, after one warm-up call (3 until
# slice 13's phases took ~70 s of the 1,200 s budget)
ARCH_TIME_ITERS = 2
REDS_HW = (180, 320)  # REDS x4 low-resolution frames
DFD_LOCS = ((96, 96, 160, 160), (352, 96, 416, 160), (224, 192, 288, 288),
            (192, 352, 320, 416))   # the JAX package's 512^2 part boxes
DFD_SMALL_LOCS = ((16, 16, 48, 48), (64, 16, 96, 48), (32, 48, 80, 80),
                  (32, 80, 96, 112))   # inside a 128^2 face's features
DFD_SCORE_RTOL = 1e-4   # as tests/test_torch_face_archs.py holds them to JAX
METRIC_FACES, FID_FACES = 20, 50
METRIC_RTOL_F64, METRIC_RTOL_Y, METRIC_RTOL_F32 = 1e-8, 1e-6, 1e-4


def arch_cases(torch):
    """(label, arch, constructor keywords, small input, users' input,
    what the users' input is), the inputs as functions of a seed giving
    CPU tensors (a clip (B, T, 3, H, W), an image batch, or the forward's
    argument tuple)."""
    from comfyui_keep_torch.models.dfdnet import CHANNEL_SIZES, FEATURE_SIZES
    from comfyui_keep_torch.models.dfdnet import PARTS

    def rnd(*shape):
        return lambda seed: torch.rand(
            shape, generator=torch.Generator().manual_seed(seed))

    def pair(*shape):
        return lambda seed: (rnd(*shape)(seed), rnd(*shape)(seed + 1))

    def dfd(size, locs):
        return lambda seed: (rnd(1, 3, size, size)(seed) * 2 - 1,
                             [torch.tensor([b]) for b in locs])

    h, w = REDS_HW
    g = torch.Generator().manual_seed(30)
    atoms = {str(fs): {p: torch.randn(3, c, 8, 8, generator=g) * 0.1
                       for p in PARTS}
             for fs, c in zip(FEATURE_SIZES, CHANNEL_SIZES)}
    return [
        ("SpyNet", "SpyNet", {}, pair(2, 3, 64, 64), pair(14, 3, h, w),
         "14 REDS frame pairs (a 15-frame clip)"),
        ("BasicVSR", "BasicVSR", {}, rnd(1, 3, 3, 64, 64),
         rnd(1, 15, 3, h, w), "15 REDS frames, x4"),
        ("IconVSR", "IconVSR", {}, rnd(1, 5, 3, 64, 64), rnd(1, 15, 3, h, w),
         "15 REDS frames, x4"),
        ("BasicVSRPlusPlus", "BasicVSRPlusPlus", {}, rnd(1, 3, 3, 64, 64),
         rnd(1, 15, 3, h, w), "15 REDS frames, x4"),
        ("EDVR", "EDVR", {}, rnd(1, 5, 3, 64, 64), rnd(1, 5, 3, h, w),
         "5 REDS frames, x4 of the centre one"),
        ("DUF", "DUF", {}, rnd(1, 7, 3, 32, 32), rnd(1, 7, 3, h, w),
         "7 REDS frames, x4 of the centre one"),
        ("TOFlow", "TOFlow", {}, rnd(1, 7, 3, 64, 64),
         rnd(1, 7, 3, 256, 448), "7 Vimeo-90K frames"),
        ("RCAN", "RCAN", {}, rnd(1, 3, 32, 32), rnd(1, 3, h, w),
         "one 180x320 frame, x4"),
        ("RIDNet", "RIDNet", {}, lambda s: rnd(1, 3, 48, 48)(s) * 255,
         lambda s: rnd(1, 3, h, w)(s) * 255, "one 180x320 frame"),
        ("ECBSR", "ECBSR", {}, rnd(1, 1, 48, 48), rnd(1, 1, h, w),
         "one 180x320 Y frame, x4"),
        ("ECBSR (re-parameterised)", "ECBSR", {}, rnd(1, 1, 48, 48),
         rnd(1, 1, h, w), "one 180x320 Y frame, x4"),
        ("HiFaceGAN", "HiFaceGAN", {}, rnd(1, 3, 64, 64),
         rnd(1, 3, 512, 512), "one 512^2 face"),
        ("HiFaceGANDiscriminator 256", "HiFaceGANDiscriminator", {},
         rnd(1, 6, 64, 64), rnd(1, 6, 256, 256), "one 256^2 pair"),
        ("DFDNet", "DFDNet", {"dictionary": atoms},
         dfd(128, DFD_SMALL_LOCS), dfd(512, DFD_LOCS), "one 512^2 face"),
        ("VGG19", "VGGFeatureExtractor",
         {"layer_name_list": ("relu1_1", "relu2_1", "relu3_1", "relu4_1",
                              "relu5_1", "conv5_4")},
         rnd(1, 3, 64, 64), rnd(1, 3, 512, 512), "one 512^2 face"),
        ("VGGStyleDiscriminator 128", "VGGStyleDiscriminator", {},
         rnd(2, 3, 128, 128), rnd(16, 3, 128, 128), "B=16 128^2 patches"),
        ("VGGStyleDiscriminator 256", "VGGStyleDiscriminator",
         {"input_size": 256}, rnd(2, 3, 256, 256), rnd(16, 3, 256, 256),
         "B=16 256^2 patches"),
        ("UNetDiscriminatorSN 128", "UNetDiscriminatorSN", {},
         rnd(2, 3, 64, 64), rnd(16, 3, 128, 128), "B=16 128^2 patches"),
        ("UNetDiscriminatorSN 256", "UNetDiscriminatorSN", {},
         rnd(2, 3, 64, 64), rnd(16, 3, 256, 256), "B=16 256^2 patches"),
        ("ResNetArcFace", "ResNetArcFace", {}, rnd(2, 1, 128, 128),
         rnd(16, 1, 128, 128), "B=16 128^2 gray faces"),
        ("InceptionV3", "InceptionV3", {}, rnd(1, 3, 64, 64),
         rnd(FID_FACES, 3, 512, 512), "50 512^2 faces resized to 299^2"),
    ]


def flat_outputs(out):
    """An arch's output as a list of tensors (a dict's values in key
    order, nested lists flattened)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


# deep plain conv stacks whose default-init output is their last bias
# whatever the input (~sqrt(3) lost a layer): He-scaled for the card against
# CPU check and the timing (tests/torch_port_helpers.py he_scaled)
HE_SCALED = ("VGGFeatureExtractor", "VGGStyleDiscriminator", "ResNetArcFace",
             "InceptionV3")


def he_scale(torch, net):
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                              torch.nn.Linear)):
                m.weight.mul_(math.sqrt(6))


def live_offsets(torch, net, seed):
    """The deformable layers' zero-initialised offset predictors drawn
    N(0, 0.05^2), so the deformable sampling moves off the grid."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in net.named_modules():
            if name.endswith("conv_offset"):
                last = m[-1] if isinstance(m, torch.nn.Sequential) else m
                last.weight.copy_(torch.randn(last.weight.shape, generator=g)
                                  * 0.05)
                last.bias.copy_(torch.randn(last.bias.shape, generator=g)
                                * 0.05)


def phase_archs(torch, card_name):
    """Each arch of arch_cases at full width (random weights, seeded; the
    deformable offsets live; HE_SCALED's weights He-scaled): card against
    CPU on the small input (DFDNet: the dictionary scores within
    DFD_SCORE_RTOL of their largest, the same picks wherever the CPU's top
    two differ by more, then the CPU's picks forced, as the CPU tests do
    against JAX; the re-parameterised ECBSR against the CPU's training
    form within 2e-5 of its scale), then on the card at its users' size:
    ms a call (after one warm-up) and peak GiB."""
    from comfyui_keep_torch.models import build_network
    rows, ok_all = {}, True
    for i, (label, arch, kw, small, big, what) in enumerate(arch_cases(torch)):
        t0 = time.perf_counter()
        cpu = build_network(arch)(device="cpu", generator=torch.Generator()
                                  .manual_seed(40 + i), **kw)
        live_offsets(torch, cpu, 60 + i)
        if arch in HE_SCALED:
            he_scale(torch, cpu)
        net = copy.deepcopy(cpu).cuda()
        xs = small(70 + i)
        xs = xs if isinstance(xs, tuple) else (xs,)
        xc = tuple(t.cuda() if torch.is_tensor(t) else t for t in xs)
        extra = {}
        rep = label.endswith("(re-parameterised)")
        with torch.no_grad():
            if arch == "DFDNet":
                _, _, scores = cpu.swap_features(*xs)
                picks = {k: int(v.argmax()) for k, v in scores.items()}
                _, _, scores_c = net.swap_features(*xc)
                ref, got = cpu(*xs, picks=picks), net(*xc, picks=picks)
                extra["score_rel_err"] = max(
                    rel_err(scores_c[k], v) for k, v in scores.items())
                extra["picks_differing_unforced"] = sum(
                    int(scores_c[k].argmax()) != p for k, p in picks.items())
                extra["picks_differing_past_margin"] = sum(
                    int(scores_c[k].argmax()) != picks[k]
                    and float(v.topk(2).values.diff().abs())
                    > DFD_SCORE_RTOL * float(v.abs().max())
                    for k, v in scores.items())
            elif rep:
                ref = cpu(*xs)
                got = net.apply_rep(net.rep_params(), *xc)
            else:
                ref, got = cpu(*xs), net(*xc)
        refs, gots = flat_outputs(ref), flat_outputs(got)
        atol, rtol = (2e-5, 0.0) if rep else ARCH_TOL.get(arch, (1e-4, 1e-3))
        scale = max(r.abs().max().item() for r in refs)
        err = max((g.cpu() - r).abs().max().item() for g, r in zip(gots, refs))
        close = all(torch.allclose(g.cpu() / scale, r / scale, atol=atol,
                                   rtol=rtol) for g, r in zip(gots, refs))
        finite = all(torch.isfinite(g).all().item() for g in gots)
        cpu_s = time.perf_counter() - t0
        del cpu
        xb = big(90 + i)
        xb = tuple(t.cuda() if torch.is_tensor(t) else t
                   for t in (xb if isinstance(xb, tuple) else (xb,)))
        reps = net.rep_params() if rep else None

        def call():
            with torch.no_grad():
                return net.apply_rep(reps, *xb) if rep else net(*xb)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, call, ARCH_TIME_ITERS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = flat_outputs(call())
        big_ok = all(torch.isfinite(o).all().item() for o in out)
        ok = bool(close and finite and big_ok and len(gots) == len(refs)
                  and extra.get("score_rel_err", 0) <= DFD_SCORE_RTOL
                  and not extra.get("picks_differing_past_margin"))
        ok_all &= ok
        rows[label] = dict(arch=arch, small_input=list(xs[0].shape),
                           max_abs_err=err, scale=scale, atol=atol,
                           rtol=rtol, input=list(xb[0].shape), users=what,
                           output=list(out[0].shape), ms=ms, peak_gib=peak,
                           cpu_check_s=cpu_s, **extra, ok=ok)
        say("archs", name=label, card=card_name, **rows[label])
        del net, xb
        torch.cuda.empty_cache()
    if not ok_all:
        fail(f"archs: {[k for k, r in rows.items() if not r['ok']]} outside "
             f"tolerance, not finite, or mis-shaped")
    return rows


def smooth_faces(n, seed, size=512):
    """n synthetic BGR faces in [0, 255] (float64): smooth shading and an
    oval, with grain, each shifted."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(0.4, 0.6, 2)
        oval = ((xx - cx) / 0.3) ** 2 + ((yy - cy) / 0.4) ** 2 < 1
        base = 90 + 60 * np.sin(6 * xx + rng.uniform(0, 3)) * np.cos(
            5 * yy) + 70 * oval
        img = base[..., None] * rng.uniform(0.7, 1.1, 3)
        out.append(np.clip(img + rng.normal(0, 6, img.shape), 0, 255))
    return out


def phase_metrics(torch, card_name):
    """PSNR and SSIM of 20 512^2 faces against degraded copies (grain and a
    shift of levels): the numpy forms on the host (cv2 never imported)
    against the tensor twins on the card, batched, in float64 (within 1e-8
    relative; 1e-6 on the Y channel, which the numpy forms convert in
    float32) and float32 (1e-4), with and without the Y channel and a
    4-pixel crop; ms of each. NIQE of one face (Y channel), on the host.
    FID between two sets of 50 faces: InceptionV3 (random weights, seeded)
    on the card through make_fid_feature_fn, then the distance on the
    host (Inception He-scaled, as in phase archs); its seconds and a
    finite value."""
    from comfyui_keep_torch import metrics as M
    from comfyui_keep_torch.metrics import fid as F
    from comfyui_keep_torch.models.inception import (InceptionV3,
                                                     make_fid_feature_fn)
    faces = smooth_faces(FID_FACES, 31)
    rng = np.random.default_rng(32)
    worse = [np.clip(f + rng.normal(0, 10, f.shape) + 4, 0, 255)
             for f in faces]

    def batch(imgs, dtype):   # BGR [0, 255] HWC -> RGB [0, 1] NCHW on card
        a = np.stack(imgs[:METRIC_FACES])[..., ::-1] / 255.0
        return torch.from_numpy(a.copy()).permute(0, 3, 1, 2).to(
            "cuda", dtype)

    rows, ok_all = [], True
    for crop, y in ((0, False), (4, True)):
        t0 = time.perf_counter()
        psnr = [M.calculate_psnr(a, b, crop, test_y_channel=y)
                for a, b in zip(faces[:METRIC_FACES], worse)]
        ssim = [M.calculate_ssim(a, b, crop, test_y_channel=y)
                for a, b in zip(faces[:METRIC_FACES], worse)]
        np_ms = 1e3 * (time.perf_counter() - t0) / METRIC_FACES
        res = {}
        for dtype in (torch.float64, torch.float32):
            x, x2 = batch(faces, dtype), batch(worse, dtype)

            def twins():
                return (M.calculate_psnr_pt(x, x2, crop, y),
                        M.calculate_ssim_pt(x, x2, crop, y))

            p, s = (t.cpu().double().numpy() for t in twins())
            ms = time_ms(torch, twins, 3)
            # the numpy PSNR with the twin's 1e-8 added to its [0, 1] mse
            want_p = 10 * np.log10(1 / (10 ** (-np.array(psnr) / 10) + 1e-8))
            perr = float(np.max(np.abs(p - want_p) / np.abs(want_p)))
            serr = float(np.max(np.abs(s - np.array(ssim)) / np.abs(ssim)))
            tol = (METRIC_RTOL_F32 if dtype == torch.float32 else
                   METRIC_RTOL_Y if y else METRIC_RTOL_F64)
            good = bool(perr <= tol and serr <= tol)
            ok_all &= good
            res[str(dtype).split(".")[1]] = dict(
                psnr_rel_err=perr, ssim_rel_err=serr, tol=tol,
                twins_ms_for_20=ms, ok=good)
        rows.append(dict(crop_border=crop, y_channel=y,
                         numpy_ms_a_face=np_ms,
                         mean_psnr=float(np.mean(psnr)),
                         mean_ssim=float(np.mean(ssim)), twins=res))
    t0 = time.perf_counter()
    niqe = M.calculate_niqe(faces[0], 0)
    niqe_s = time.perf_counter() - t0
    net = InceptionV3(generator=torch.Generator().manual_seed(33))
    he_scale(torch, net)
    fn = make_fid_feature_fn(net)

    t0 = time.perf_counter()
    sets = []
    for imgs in (faces, worse):
        a = np.stack(imgs)[..., ::-1] / 255.0
        x = torch.from_numpy(a.astype(np.float32)).permute(0, 3, 1, 2)
        sets.append(F.extract_inception_features([x.cuda()], fn))
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid = M.calculate_fid(*F.feature_stats(sets[0]),
                          *F.feature_stats(sets[1]))
    fid_s = time.perf_counter() - t0
    fid_ok = bool(np.isfinite(fid) and sets[0].shape == (FID_FACES, 2048))
    ok_all &= fid_ok and bool(np.isfinite(niqe))
    no_cv2 = "cv2" not in sys.modules
    ok_all &= no_cv2
    say("metrics", card=card_name, faces=METRIC_FACES, size=[512, 512],
        psnr_ssim=rows, niqe_y=niqe, niqe_s=niqe_s, fid_faces=FID_FACES,
        fid=fid, fid_features_s=feat_s, fid_distance_s=fid_s,
        cv2_imported=not no_cv2, ok=bool(ok_all))
    if not ok_all:
        fail("metrics: a twin outside its tolerance of the numpy form, a "
             "non-finite NIQE or FID, or cv2 imported")
    del net
    torch.cuda.empty_cache()


# train_gan: the resumed step against the uninterrupted one on one batch,
# with cuDNN deterministic, as each group's distance between the two
# continuations over that group's own change in the step. The step is not
# bitwise repeatable on the card (grid_sample's backward, in the temporal
# loss's flow warp, adds with atomics). The card read G 9.4e-10, EMA
# 3.8e-10, G's Adam moments 9.4e-9 and D 0 in two runs: the limits sit ~10x
# and more above them. The phase also reads what a resume that lost the
# EMA, or G's Adam moments, would give (GAN_RESUME_CONTROLS): each must
# read above its group's limit.
GAN_RESUME_RTOL = {"G": 1e-6, "EMA": 1e-6, "G Adam": 1e-7, "D": 1e-7,
                   "D Adam": 1e-7}
GAN_RESUME_CONTROLS = {"lost EMA": "EMA", "lost G Adam moments": "G"}
GAN_CLIP_FRAMES = 12


def write_vfhq_clip(root, frames, size):
    """A synthetic VFHQ-layout clip: `frames` smooth moving 512^2 patterns
    as PNG (utils/png.py) under root/GT/clip_000, and its meta file (one
    line a frame, clip/length/index). Returns (dataroot_gt, meta file)."""
    from comfyui_keep_torch.utils import png
    clip = os.path.join(root, "GT", "clip_000")
    os.makedirs(clip)
    yy, xx = np.mgrid[0:size, 0:size] / size
    rng = np.random.default_rng(0)
    waves = rng.uniform(0.5, 4.0, (3, 2))
    for i in range(frames):
        img = np.stack([np.sin(2 * np.pi * (a * xx + b * yy) + 0.3 * i + c)
                        for c, (a, b) in enumerate(waves)], axis=-1)
        png.imwrite_bgr(os.path.join(clip, f"{i:08d}.png"),
                        ((img + 1) * 127.5).astype(np.uint8))
    meta = os.path.join(root, "meta_info.txt")
    with open(meta, "w") as f:
        f.writelines(f"clip_000/{frames}/{i}\n" for i in range(frames))
    return os.path.join(root, "GT"), meta


def phase_train_gan(torch, card):
    """KEEP stage III through the train loop at full width:
    tools/torch_train.py's main on options/train_keep_stage3_gan.yml with
    STAGE3_FORCE (KEEP 512^2, Discriminator3D, B = 1 x 8 frames, f32; the
    frozen VQHQEncoder and GMFlow from seeds 1 and 2, saved as .pth files
    and loaded from path.pretrain_network_hq / _flow) over a synthetic
    12-frame clip, 2 iterations with a save at 2; an auto-resume
    alone (to total_iter 2: no step) against the saved state; an
    auto-resume to 3, its step against the uninterrupted one on the same
    batch. Returns the K1-K6 launches of the resumed run's one alternation,
    its counters reset just before it."""
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.keep import config
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    from comfyui_keep_torch.ops import kernels as K
    cfg = config("KEEP", **{k: v for k, v in stage3_opt()["network_g"].items()
                            if k not in ("type", "fix_modules")})
    cli = tool("torch_train")
    # one alternation: KEEPTrainer._loss_outs runs flow_from_clip on the LQ
    # clip and (temporal_warp_type GT) on the GT clip, and one
    # nearest-codebook launch for the GT codes (_gt_indices);
    # Discriminator3D launches none of K1-K6
    per_iter = {**gmflow_launches(2), "vq_nearest_indices": 1,
                "fused_bias_lrelu": 0, "packed_conv2x2": 0}
    watch = ("feat_emb.weight", "position_emb", "encoder.blocks.0.weight",
             "ft_layers.0.linear1.weight", "idx_pred_layer.1.weight",
             "cft.32.scale.2.bias")
    ema_leaf = "feat_emb.weight"

    def flat(tr, st):
        """Every tensor a resume restores, by group."""
        osd, dsd = st.optimizer.state_dict(), tr.d_optimizer.state_dict()
        return {"G": st.model.state_dict(), "EMA": st.ema,
                "G Adam": {f"{i}.{k}": v for i, s in osd["state"].items()
                           for k, v in s.items()},
                "D": tr.disc.state_dict(),
                "D Adam": {f"{i}.{k}": v for i, s in dsd["state"].items()
                           for k, v in s.items()}}

    def cloned(groups):
        return {g: {k: v.clone() for k, v in d.items()}
                for g, d in groups.items()}

    def over_step(got, straight, saved):
        """|got - straight| / |straight - saved| over a group's tensors."""
        dist = sum((got[k].float() - straight[k].float()).norm() ** 2
                   for k in saved) ** 0.5
        moved = sum((straight[k].float() - saved[k].float()).norm() ** 2
                    for k in saved) ** 0.5
        if moved > 0:
            return (dist / moved).item()
        return 0.0 if dist == 0 else math.inf

    def runs(total_iter, resume=False):
        """The CLI to `total_iter`, its run under `work`."""
        argv = ["-opt", yml_path(STAGE3_YML), "--force_yml", *STAGE3_FORCE,
                f"path:pretrain_network_hq={hq_pth}",
                f"path:pretrain_network_flow={flow_pth}",
                f"datasets:train:dataroot_gt={gt_root}",
                f"datasets:train:meta_info_file={meta}",
                "logger:print_freq=1", "logger:save_checkpoint_freq=2",
                f"train:total_iter={total_iter}"]
        state, logs = cli.main(argv + (["--auto_resume"] if resume else []),
                               root_path=work)
        torch.cuda.synchronize()
        return state, logs.pop("run"), logs

    cudnn_det = torch.backends.cudnn.deterministic
    work = tempfile.mkdtemp(prefix="train_gan_")
    try:
        gt_root, meta = write_vfhq_clip(work, GAN_CLIP_FRAMES,
                                        cfg["img_size"])
        hq_pth, flow_pth = (os.path.join(work, "vqgan.pth"),
                            os.path.join(work, "gmflow.pth"))
        torch.save({"params_ema": VQHQEncoder(
            **{k: cfg[k] for k in HQ_KEYS}, device="cpu",
            generator=torch.Generator().manual_seed(1)).state_dict()}, hq_pth)
        torch.save({"params": GMFlow(
            device="cpu", generator=torch.Generator().manual_seed(2)
        ).state_dict()}, flow_pth)
        exp = os.path.join(work, "experiments", stage3_opt()["name"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        st1, run1, logs1 = runs(2)
        counts = {k: launch_counts(K).get(k, 0) for k in per_iter}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr1 = run1["trainer"]
        # the inits the run started from, made again as make_state makes
        # them (on the CPU, from manual_seed)
        init = tr1.init_model().state_dict()
        d_init = tr1.init_disc().state_dict()
        params = {n: p.detach().cpu() for n, p
                  in st1.model.named_parameters()}
        frozen = [n for n, p in st1.model.named_parameters()
                  if not p.requires_grad]
        frozen_same = bool(frozen) and all(
            n.split(".")[0] in ("quantize", "generator")
            and torch.equal(params[n], init[n]) for n in frozen)
        watch_moved = all(not torch.equal(params[n], init[n]) for n in watch)
        d_sd = {k: v.cpu() for k, v in tr1.disc.state_dict().items()}
        d_moved = all(not torch.equal(d_sd[k], v) for k, v in d_init.items()
                      if k.endswith("orig"))
        u_moved = all(not torch.equal(d_sd[k], v) for k, v in d_init.items()
                      if k.endswith("weight_u"))
        del init, d_init, params, d_sd
        files = sorted(os.listdir(os.path.join(exp, "models"))
                       + os.listdir(os.path.join(exp, "training_states")))
        # run 1's state, untouched since its save at iteration 2
        saved = cloned(flat(tr1, st1))

        # an auto-resume alone: total_iter 2 leaves no step to take
        st2, run2, _ = runs(2, resume=True)
        got = flat(run2["trainer"], st2)
        restored_equal = bool(
            st2.iter == 2 and run2["start_iter"] == 2 and not run2["step_s"]
            and run2["restored"].get("kept", 0) == 0 and all(
                got[g].keys() == saved[g].keys()
                and all(torch.equal(got[g][k], v) for k, v in saved[g].items())
                for g in saved))
        resume_alone_s = run2["resume_s"]
        del st2, run2, got
        torch.cuda.empty_cache()

        # an auto-resume to iteration 3: one alternation, counted alone
        torch.backends.cudnn.deterministic = True
        K.reset_launch_counts()
        st3, run3, logs3 = runs(3, resume=True)
        counts3 = {k: launch_counts(K).get(k, 0) for k in per_iter}
        resumed = flat(run3["trainer"], st3)
        decay = tr1.ema_decay
        leaf3 = dict(st3.model.named_parameters())[ema_leaf].detach()
        want_ema = saved["EMA"][ema_leaf] * decay + leaf3 * (1 - decay)
        ema_err = (st3.ema[ema_leaf] - want_ema).abs().max().item()
        ema_ok = ema_err <= 1e-7 * want_ema.abs().max().item()
        # the uninterrupted third step on the batch the resumed one took
        t0 = time.perf_counter()
        tr1.train_step(st1, run3["batch"])
        torch.cuda.synchronize()
        straight_ms = 1e3 * (time.perf_counter() - t0)
        straight = cloned(flat(tr1, st1))
        resume_err = {g: over_step(resumed[g], straight[g], saved[g])
                      for g in saved}
        resume_ok = all(resume_err[g] <= GAN_RESUME_RTOL[g] for g in saved)

        # controls: a resume that set the EMA to the restored weights (as a
        # fresh state's EMA starts) ends the step at d W_2 + (1 - d) W_3; a
        # resume that lost G's Adam moments takes the step from fresh ones
        g3 = resumed["G"]
        lost_ema = {k: saved["G"][k] * decay + g3[k] * (1 - decay)
                    for k in saved["EMA"]}
        control = {"lost EMA": over_step(lost_ema, straight["EMA"],
                                         saved["EMA"])}
        st1.model.load_state_dict(saved["G"])
        tr1.disc.load_state_dict(saved["D"])
        st1.optimizer.state.clear()
        st1.iter = 2
        tr1.train_step(st1, run3["batch"])
        torch.cuda.synchronize()
        control["lost G Adam moments"] = over_step(
            st1.model.state_dict(), straight["G"], saved["G"])
        controls_ok = all(control[c] > GAN_RESUME_RTOL[g]
                          for c, g in GAN_RESUME_CONTROLS.items())
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        import shutil
        shutil.rmtree(work, ignore_errors=True)

    sn = spectral_norm_vs_torch(torch, tr1.init_disc())
    gan_keys = {"l_g_gan", "l_d", "l_d_real", "l_d_fake"}
    finite = all(math.isfinite(v) for lg in (logs1, logs3)
                 for v in lg.values())
    want = {k: 2 * v for k, v in per_iter.items()}
    ok = bool(finite and gan_keys <= logs1.keys() and gan_keys <= logs3.keys()
              and frozen_same and watch_moved and d_moved and u_moved
              and sn["ok"] and ema_ok and counts == want and counts3 == per_iter
              and files == ["2.state", "net_g_2.pth"] and restored_equal
              and run3["start_iter"] == 2 and st3.iter == 3 and resume_ok
              and controls_ok)
    say("train_gan", card=card, batch=1, frames=8, size=cfg["img_size"],
        precision="f32", first_alternation_ms=1e3 * run1["step_s"][0],
        ms_per_alternation=1e3 * run1["step_s"][1],
        resumed_alternation_ms=1e3 * run3["step_s"][0],
        uninterrupted_third_ms=straight_ms,
        data_ms_per_iteration=1e3 * logs1["data_time"],
        iteration_ms_avg_timer=1e3 * logs1["time"],
        data_ms_resumed_run=1e3 * logs3["data_time"], peak_mem_gib=peak,
        save_s=run1["save_s"], resume_s=[resume_alone_s, run3["resume_s"]],
        losses=logs1, losses_resumed=logs3,
        launches_run1=counts, launches_resumed=counts3,
        expected_per_alternation=per_iter,
        frozen_leaves=len(frozen), frozen_unchanged=frozen_same,
        watched_moved=watch_moved, d_moved=d_moved, weight_u_moved=u_moved,
        spectral_norm_vs_torch=sn,
        ema_max_abs_err=ema_err, files=files,
        resumed_at=run3["start_iter"], restored_equal_saved=restored_equal,
        resume_err_over_step=resume_err, resume_rtol=GAN_RESUME_RTOL,
        resume_controls=control, cudnn_deterministic_in_resume_check=True,
        ok=ok)
    if not ok:
        fail(f"train_gan: finite {finite}, frozen unchanged {frozen_same}, "
             f"watched moved {watch_moved}, D moved {d_moved}, u moved "
             f"{u_moved}, spectral norm {sn}, EMA {ema_ok}, launches {counts} (want {want}) / "
             f"{counts3}, files {files}, restored {restored_equal}, resume "
             f"{resume_err}, controls {control}")
    del tr1, st1, st3, run1, run3, saved, straight, resumed, lost_ema
    torch.cuda.empty_cache()
    return counts3


SN_MODES = ("train", "train", "eval", "train")
SN_RTOL = 1e-5


def spectral_norm_vs_torch(torch, disc):
    """Discriminator3D's second spectral-norm layer (`disc`, on the card)
    against torch.nn.utils.spectral_norm on an nn.Conv3d with the same
    weight_orig, u and v, over SN_MODES forwards on one (1, C, 8, 64, 64)
    input: each training forward's output and advanced u and v within
    SN_RTOL of their largest magnitude, u moved; the eval forward moves
    neither vector (its output, the JAX package's form, is not torch's)."""
    layer = disc.conv[2].cuda()
    w = layer.weight_orig
    ref = torch.nn.Conv3d(w.shape[1], w.shape[0], w.shape[2:],
                          layer.stride, layer.padding, bias=False).cuda()
    ref = torch.nn.utils.spectral_norm(ref)
    with torch.no_grad():
        for n in ("weight_orig", "weight_u", "weight_v"):
            getattr(ref, n).copy_(getattr(layer, n))
    x = torch.randn((1, w.shape[1], 8, 64, 64), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(21))
    errs, moved, kept = [], 0, True
    for mode in SN_MODES:
        layer.train(mode == "train")
        ref.train(mode == "train")
        u_in = layer.weight_u.clone()
        with torch.no_grad():
            got, want = layer(x), ref(x)
        bufs = max(rel_err(layer.weight_u, ref.weight_u),
                   rel_err(layer.weight_v, ref.weight_v))
        if mode == "train":
            errs.append(max(rel_err(got, want), bufs))
            moved += not torch.equal(layer.weight_u, u_in)
        else:
            kept = kept and torch.equal(layer.weight_u, u_in) and bufs == 0
    return {"modes": list(SN_MODES), "train_max_rel_err": max(errs),
            "tol_rel": SN_RTOL, "u_moved_each_train_forward":
            moved == SN_MODES.count("train"), "eval_kept_u_v": bool(kept),
            "ok": bool(max(errs) <= SN_RTOL and kept
                       and moved == SN_MODES.count("train"))}


# GMFlow training (phase train_flow): tools/torch_train_flow.py's defaults
# (flow_opt), the chairs stage at 384 x 512, B = 8, f32
FLOW_HW, FLOW_B, FLOW_STEPS, FLOW_WORKERS = (384, 512), 8, 3, 4
# the CLI's run: the fewest steps the one-cycle schedule takes (its warm-up
# is int(0.05 (num_steps + 10)) updates and may not be empty)
FLOW_CLI_STEPS = 10
# pairs written: every 10th is validation; the rest hold the warm-up, the
# timed, the by-parts and the one-pair steps' batches plus the loader's
# 2 * workers in flight, so no epoch ends (and no queue refills from empty)
# while the steps are timed
FLOW_PAIRS = -(-10 * FLOW_B * (FLOW_STEPS + 3 + 2 * FLOW_WORKERS) // 9)
# GMFlow's leaves whose true gradient is zero (a bias an InstanceNorm
# follows, the key bias under a softmax): their gradients are rounding noise
FLOW_ZERO_GRAD = ("backbone.layer2.0.downsample.0.bias",
                  "backbone.layer3.0.downsample.0.bias",
                  "feature_flow_attn.k_proj.bias")
# the backward kernels (phase flow_kernel), each gradient against float64
# (the plain version's autograd on the same values in float64): its max|d|
# over the float64 gradient's largest within BWD_RATIO times the plain
# backward's own distance (the same formula in torch ops, in f32, on the
# same saved statistics), or BWD_FLOOR if that is larger. The kernel sums
# in another order than the plain backward, so it may stand as far off
# float64; the ratio leaves room for the order, not for a wrong term (a
# dropped Delta, scale or rounding moves a gradient by far more)
BWD_RATIO, BWD_FLOOR = 3.0, 1e-6
BWD_ITERS = 10       # timed backward calls per form (a quarter for plain)
# K2's f32 backward may allocate at its peak no more than its FMA form did
# at the GMFlow step's shape (530,449,408 B at 49,152 rows, H = 1024), per
# row and hidden unit: da and h, (rows, H) f32 each, are most of it
MLP_F32_BWD_PEAK_PER_ROW_UNIT = 530_449_408 / (49_152 * 1024)
# the whole GMFlow step on one pair (flow_step_gates; FLOW_ZERO_GRAD leaves
# held as noise, below FLOW_NOISE of the tree's largest gradient; losses
# within LOSS_RTOL), each leaf against its own limit:
# - the card against the CPU with rounding out of the way: both in float64
#   (the plain versions too), max|d| within FLOW_F64_RTOL of the leaf's
#   largest (4.0e-14 to 6.2e-14 measured at 384 x 512, PR 14's card runs);
# - the card's f32 step (kernels) against the CPU's float64 one by
#   relative L2, within FLOW_F32_RATIO times its module group's f32 noise
#   plus FLOW_F32_FLOOR. The f32 step is ill-conditioned (the backbone's
#   InstanceNorms cancel): f32 steps are 1e-4 to 5e-3 off float64 in the
#   backbone, ~1e-5 elsewhere, and which leaf is worst moves with the
#   algorithms (one leaf 4.9e-5 on the CPU, 1.4e-3 without cuDNN), so a
#   leaf's noise is the largest distance three f32 witnesses (the CPU, the
#   card with the plain versions, the card without cuDNN) show on any leaf
#   of its group (backbone, transformer, feature_flow_attn, upsampler).
#   Besides, on 5 of 9 pairs (PR 14's card runs) some f32 runs' upsampler
#   gradients sat 1.4e-4 to 1.7e-3 off float64 while others of the same
#   pair sat near 1e-6: a jump no witness need share, which the floor
#   covers. The card with TF32 allowed is a control: it must break that
#   limit on some leaf (5.0x to 51x over it on those 9 pairs). The card
#   with the kernels against the card with the plain versions, both f32,
#   is held to the same limit.
FLOW_GRAD_ATOL, FLOW_NOISE = 1e-6, 1e-5
FLOW_F64_RTOL = 1e-10
FLOW_F32_RATIO, FLOW_F32_FLOOR = 3.0, 3e-3


def write_chairs(root, n, hw, seed=0):
    """A FlyingChairs-layout directory: n pairs of smooth random .ppm
    frames, the second the first shifted by a whole-pixel flow, with its
    .flo (the flow constant over the frame)."""
    import torch
    from comfyui_keep_torch.data.flow_datasets import write_flo
    from comfyui_keep_torch.utils import ppm
    os.makedirs(root, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    for i in range(1, n + 1):
        coarse = torch.rand((3, h // 16 + 3, w // 16 + 3), generator=g)
        img = torch.nn.functional.interpolate(
            coarse[None], scale_factor=16, mode="bicubic",
            align_corners=False)[0, :, :h + 16, :w + 16]
        img = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(1, 2, 0)
        dx, dy = (int(v) for v in torch.randint(-6, 7, (2,), generator=g))
        a = img[8:8 + h, 8:8 + w].numpy()
        b = img[8 - dy:8 - dy + h, 8 - dx:8 - dx + w].numpy()
        ppm.write(os.path.join(root, f"{i:05d}_img1.ppm"), a)
        ppm.write(os.path.join(root, f"{i:05d}_img2.ppm"), b)
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0], flow[..., 1] = -dx, -dy
        write_flo(os.path.join(root, f"{i:05d}_flow.flo"), flow)
    return root


def flow_step_cases(torch):
    """kernel_cases' rows (f32) of K1-K3 at the GMFlow step's shapes, named
    "<counter> flow step": 384 x 512 gives 48 x 64 features; attn_splits 2
    gives 24 x 32 windows, B = 2 images x 8 pairs x 4 = 64 windows of 768
    tokens; the global flow attention and the correlation run over B = 8
    maps of 3072 tokens; the FFN tail over 2 x 8 x 3072 = 49,152 rows."""
    import torch.nn.functional as F
    from comfyui_keep_torch.models.gmflow import shifted_window_mask
    g = torch.Generator(device="cuda").manual_seed(3)
    fh, fw = FLOW_HW[0] // 8, FLOW_HW[1] // 8
    bw, lw = 2 * FLOW_B * 4, (fh // 2) * (fw // 2)
    bg, lg = FLOW_B, fh * fw
    scale = 1.0 / math.sqrt(CH)
    rtol = KERNEL_RTOL["float32"]

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    q, v = rnd(bw, lw, CH), rnd(bw, lw, CH)
    k = matched_keys(torch, q, 0.7, g)
    mask = torch.as_tensor(shifted_window_mask(fh, fw, 2), device="cuda")
    mask_full = mask.repeat(bw // 4, 1, 1)[:, None]
    qg = rnd(bg, lg, CH)
    kg = matched_keys(torch, qg, 0.8, g)
    vg = rnd(bg, lg, 2, s=8.0)
    ys, xs = torch.meshgrid(torch.arange(fh, device="cuda",
                                         dtype=torch.float32),
                            torch.arange(fw, device="cuda",
                                         dtype=torch.float32), indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(lg, 2).contiguous()
    src, msg = rnd(bw, lw, CH), rnd(bw, lw, CH)
    w1, w2 = rnd(HID, 2 * CH, s=0.05), rnd(CH, HID, s=0.05)
    gamma, beta = rnd(CH), rnd(CH)

    def sdpa(a, b_, c, m=None):
        return lambda: F.scaled_dot_product_attention(
            a[:, None], b_[:, None], c[:, None], attn_mask=m, scale=scale)

    att_fl = 2 * bw * lw * lw * CH
    glb_fl, exp_fl = 2 * bg * lg * lg * CH, 2 * bg * lg * lg * 2
    rows = bw * lw
    return [
        ("attention[dv128] flow step", "attention", (q, k, v, scale),
         sdpa(q, k, v), [(2 * att_fl, F32_TC)], 4 * q.numel() * 4, rtol,
         None, f"attention[dv128] B{bw} L{lw}"),
        ("attention[dv128+bias] flow step", "attention",
         (q, k, v, scale, mask), sdpa(q, k, v, mask_full),
         [(2 * att_fl, F32_TC)], 4 * q.numel() * 4 + mask.numel() * 4,
         rtol, None, f"attention[dv128+bias] B{bw} L{lw}"),
        ("attention[dv2] flow step", "attention", (qg, kg, vg, scale),
         sdpa(qg, kg, vg), [(glb_fl, F32_TC), (exp_fl, PEAK_F32)],
         (2 * qg.numel() + 2 * vg.numel()) * 4, rtol, None,
         f"attention[dv2] B{bg} L{lg}"),
        ("global_correlation_expectation flow step",
         "global_correlation_expectation", (qg, kg, grid),
         lambda: F.scaled_dot_product_attention(
             qg, kg, grid.expand(bg, lg, 2), scale=scale),
         [(glb_fl, F32_TC), (exp_fl, PEAK_F32)],
         2 * qg.numel() * 4 + grid.numel() * 4 + bg * lg * 2 * 4, rtol,
         None, f"global_correlation_expectation B{bg} L{lg}"),
        ("mlp_fused flow step", "mlp_fused",
         (src, msg, w1, w2, gamma, beta, False), None,
         [(6 * rows * CH * HID, F32_TC)],
         3 * src.numel() * 4 + 3 * CH * HID * 4, rtol, None,
         f"mlp_fused rows{rows}"),
    ]


# the inputs of each wrapper that carry a gradient (ops/kernels.py)
GRAD_ARGS = {"attention": (0, 1, 2), "global_correlation_expectation": (0, 1),
             "mlp_fused": (0, 1, 2, 3, 4, 5)}
# where the JAX package differentiates the plain branch each backward
# kernel's function replaces (it has no Pallas backward)
JAX_GRAD_OF = {"attention": "comfyui_keep_tpu/models/gmflow.py:213",
               "global_correlation_expectation":
                   "comfyui_keep_tpu/models/gmflow.py:394",
               "mlp_fused": "comfyui_keep_tpu/models/gmflow.py:285"}


def backward_work(torch, fn_name, args):
    """[(flops, peak rate)] of the least work of one backward call on
    `args`: K1 five L x L products (Q K^T, dO V^T, dV, dQ, dK), the two
    2-wide ones in FMAs when D_v = 2; K3 the same without dV; K2 a = [src |
    msg] W1^T recomputed (the forward saves the LayerNorm's input, not a)
    and the four products of the backward (dh, d[src | msg], dW1, dW2).
    bf16 inputs at the tensor cores' rate. f32 as the kernels compute it,
    3xTF32 (three TF32 products for each) at the TF32 tensor cores'
    rate."""
    mult, peak = ((1, PEAK_BF16) if args[0].dtype == torch.bfloat16
                  else (3, PEAK_TF32))
    if fn_name == "mlp_fused":
        rows, c = args[0].numel() // args[0].shape[-1], args[0].shape[-1]
        return [(mult * 2 * rows * args[2].shape[0] * (3 * 2 * c + 2 * c),
                 peak)]
    b, l, d = args[0].shape
    sq = 2 * b * l * l
    dv = args[2].shape[-1] if fn_name == "attention" else 2
    narrow = 1 if fn_name == "global_correlation_expectation" else 2
    if dv == d:
        return [(mult * 5 * sq * d, peak)]
    return [(mult * 3 * sq * d, peak), (narrow * sq * dv, PEAK_F32)]


# how each backward form computes its products (csrc/attention_bwd.cu for
# K1 and K3, csrc/mlp.cu for K2), by wrapper and dtype; K1's 2-wide form
# and K3 as _ATTN_BWD_NARROW_PRECISION says (bwd_precision)
_ATTN_BWD_PRECISION = {
    "bfloat16": "bf16 wgmma (two 64-row consumer warpgroups, a TMA "
                "producer; S and dP m64n64k16 with both operands in shared "
                "memory, the products over the 64-row streamed tiles "
                "m64n128k16 with P~ and dS from registers), f32 sums; dS "
                "as bf16 hi + lo",
    "float32": "3xTF32 wgmma (16-row streamed tiles split on chip into hi "
               "and lo, K^T / Q^T / dO^T as transposed tiles; S and dP "
               "m64n16k8 with hi x hi chains of 4 k steps, each tile's dQ "
               "/ dK / dV m64n128k8 from zero, each added in f32; dK / dV "
               "blocks of 64 keys, P^T and dP^T swapped between the "
               "warpgroups)"}
_ATTN_BWD_NARROW_PRECISION = {
    "bfloat16": "bf16 wgmma (S m64n64k16 with both operands in shared "
                "memory, dQ / dK m64n128k16 with dS as bf16 hi + lo from "
                "registers), f32 sums; the 2-wide products in FMAs",
    "float32": "3xTF32 wgmma (16-row streamed tiles split and transposed on "
               "chip; S m64n16k8 with hi x hi chains of 4 k steps, each "
               "tile's dQ / dK m64n128k8 from zero, each added in f32); the "
               "2-wide products in FMAs"}
BWD_PRECISION = {
    "attention": _ATTN_BWD_PRECISION,
    "global_correlation_expectation": _ATTN_BWD_NARROW_PRECISION,
    "mlp_fused": {
        "bfloat16": "bf16 wgmma (64-row warpgroup tiles, operands in shared "
                    "memory; da from registers in d[src | msg]), f32 sums; "
                    "dO' as bf16 hi + lo in dh and dW2, da rounded to bf16 "
                    "once in d[src | msg] and dW1; the weight blocks "
                    "recompute a and dh",
        "float32": "3xTF32 wgmma (three launches of one warp-specialized "
                   "GEMM, two 64-row consumer warpgroups and a TMA "
                   "producer that splits B into hi and lo in shared "
                   "memory, A split in registers; each K step of 4 k "
                   "steps from zero, added in f32): a and dh (m64n64k8), "
                   "then da^T and h^T (H, rows) f32 written for d[src | "
                   "msg] = da W1 and the weight products over 2,048-row "
                   "slices (m64n128k8)"}}


def bwd_precision(fn_name, dname, args):
    """BWD_PRECISION's text of the backward form that `args` reach: K1 at
    D_v = 2 runs the narrow kernel."""
    if fn_name == "attention" and args[2].shape[-1] != args[0].shape[-1]:
        return _ATTN_BWD_NARROW_PRECISION[dname]
    return BWD_PRECISION[fn_name][dname]


def mlp_reference_call(torch, args, up):
    """The unfused autograd backward of mlp_fused_plain at a K2 backward
    call's shape (a reference of its row, not a library yardstick: no
    single PyTorch call computes the function; the port never calls it):
    the forward runs once here, each call is torch.autograd.grad on the
    retained graph, TF32 off as everywhere in this script."""
    from comfyui_keep_torch.ops import kernels as K
    leaves = [a.detach().requires_grad_(True) for a in args[:6]]
    out = K.mlp_fused_plain(*leaves, args[6])
    return lambda: torch.autograd.grad(out, leaves, up, retain_graph=True)


def sdpa_backward_call(torch, fn_name, args, up, backward_only=False):
    """One SDPA forward + backward at the shape of a K1 / K3 backward call
    (the yardstick of its row; the port never calls it): q, k (and v for
    K1) require grad, the mask as phase kernel's rows pass it. With
    backward_only, the forward runs once here and each call is its
    backward alone (torch.autograd.grad on the retained graph)."""
    import torch.nn.functional as F
    q, k = args[0], args[1]
    if fn_name == "attention":
        v, scale, bias = args[2], args[3], args[4]
        mask = (None if bias is None else bias.repeat(
            q.shape[0] // bias.shape[0], 1, 1)[:, None].to(q.dtype))
    else:
        v = args[2].to(q.dtype).expand(q.shape[0], -1, 2)
        scale, mask = 1.0 / math.sqrt(q.shape[-1]), None
    leaves = [q.detach().requires_grad_(True), k.detach().requires_grad_(True),
              v.detach().requires_grad_(fn_name == "attention")]
    want = [x for x in leaves if x.requires_grad]
    g = up[:, None].to(q.dtype)

    def forward():
        return F.scaled_dot_product_attention(*[x[:, None] for x in leaves],
                                              attn_mask=mask, scale=scale)

    if backward_only:
        o = forward()
        return lambda: torch.autograd.grad(o, want, g, retain_graph=True)
    return lambda: torch.autograd.grad(forward(), want, g)


def backward_row(torch, fn_name, args, iters=BWD_ITERS):
    """One backward kernel on a wrapper's `args` (K.LAUNCHERS: the kernel
    forward's saved statistics, one seeded upstream gradient): each
    gradient's max|d| to the float64 autograd of the plain version over
    the float64 gradient's largest, the plain backward's the same on the
    same statistics, and the gate (BWD_RATIO, BWD_FLOOR); two calls
    bitwise equal; the bytes the call allocates at its peak beyond what
    was allocated before it, which must stay below one (B, L, L) f32
    tensor for K1 and K3 and, for K2, one (rows, H) f32 tensor in bf16 and
    MLP_F32_BWD_PEAK_PER_ROW_UNIT a row and hidden unit in f32;
    the backward alone on CUDA events beside the plain backward and, for
    K1 and K3, SDPA's forward + backward and its backward alone, for K2
    the unfused autograd backward of its plain version (TF32 off); the
    least time the card could take, at the rate of the kernel's precision
    scheme (BWD_PRECISION). max_abs_err is the kernel's largest distance
    to the plain backward."""
    from comfyui_keep_torch.ops import kernels as K
    fwd, bwd = K.LAUNCHERS[fn_name]
    diff = GRAD_ARGS[fn_name]
    if fn_name == "attention" and len(args) == 4:
        args = tuple(args) + (None,)
    saved = fwd(*args)   # (out, the statistics its backward reads)
    g = torch.Generator(device="cuda").manual_seed(5)
    up = torch.randn(saved[0].shape, generator=g,
                     device="cuda").to(saved[0].dtype)

    def kernel():
        return bwd(*args, *saved, up)

    def plain():
        return K.PLAIN_BACKWARD[fn_name](*args, *saved, up)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = kernel()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    bitwise = all(torch.equal(x, y) for x, y in zip(got, kernel()))
    want = plain()
    a64 = [a.detach().double().requires_grad_(i in diff)
           if torch.is_tensor(a) else a for i, a in enumerate(args)]
    ref = torch.autograd.grad(K.PLAIN[fn_name](*a64),
                              [a64[i] for i in diff], up.double())
    del a64

    def off(grads):
        return [((x.double() - r).abs().max() / r.abs().max()).item()
                for x, r in zip(grads, ref)]
    k_off, p_off = off(got), off(want)
    lim = [max(BWD_RATIO * p, BWD_FLOOR) for p in p_off]
    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(got, want))
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (*args, *saved, up) if torch.is_tensor(t))
              + sum(x.numel() * x.element_size() for x in got))
    del got, want, ref
    dname = str(args[0].dtype).split(".")[-1]
    if fn_name != "mlp_fused":  # one (B, L, L) f32 tensor
        ll = 4 * args[0].shape[0] * args[0].shape[1] ** 2
    else:  # one (rows, H) f32 tensor in bf16; below the FMA form in f32
        rows_h = args[0].numel() // args[0].shape[-1] * args[2].shape[0]
        ll = (4 * rows_h if dname == "bfloat16"
              else int(MLP_F32_BWD_PEAK_PER_ROW_UNIT * rows_h))
    flops = backward_work(torch, fn_name, args)
    op_s, byte_s = sum(f / p for f, p in flops), nbytes / HBM
    lib = lib_bwd = ref_ms = None
    dev = {}
    ms = time_ms(torch, kernel, iters)
    if fn_name == "mlp_fused":
        ref_call = mlp_reference_call(torch, args, up)
        ref_ms = time_ms(torch, ref_call, iters)
        # the kernels' and the reference's device time, one profiler trace
        pair = paired_device_ms(torch, kernel, ref_call, iters,
                                1e3 * max(op_s, byte_s), ms, ref_ms)
        dev = {"device_ms": pair["kernel"],
               "reference_device_ms": pair["other"],
               "device_kernels": pair["kernels"],
               "device_refused": pair["refused"]}
        del ref_call
        torch.cuda.empty_cache()
    else:
        lib = time_ms(torch, sdpa_backward_call(torch, fn_name, args, up),
                      iters)
        lib_bwd = time_ms(torch, sdpa_backward_call(torch, fn_name, args, up,
                                                    backward_only=True),
                          iters)
        torch.cuda.empty_cache()
    row = {"off_f64": k_off, "plain_off_f64": p_off, "limit": lim,
           "bitwise_repeat": bitwise, "peak_extra_bytes": extra,
           "peak_limit_bytes": ll, "max_abs_err": err,
           "ms": ms, "plain_ms": time_ms(torch, plain, max(1, iters // 4)),
           "library_ms": lib, "library": None if lib is None else
           "SDPA forward + backward", "sdpa_backward_ms": lib_bwd,
           "reference_ms": ref_ms, "reference": None if ref_ms is None else
           "autograd backward of mlp_fused_plain (unfused, TF32 off)",
           "precision": bwd_precision(fn_name, dname, args),
           "bound_ms": 1e3 * max(op_s, byte_s),
           "bound_by": "operations" if op_s >= byte_s else "bytes",
           "differentiates": JAX_GRAD_OF[fn_name], **dev}
    row["ok"] = bool(all(k <= m for k, m in zip(k_off, lim)) and bitwise
                     and extra < ll)
    return row


def bf16_args(torch, fn_name, args):
    """A wrapper's f32 arguments as mixed precision gives them: the
    tensors in bf16 but the mask and the grid (f32 in both), the MLP with
    the tanh gelu (GMFlow's pick in bf16)."""
    keep = {"attention": (4,), "global_correlation_expectation": (2,),
            "mlp_fused": ()}[fn_name]
    out = [a.to(torch.bfloat16) if torch.is_tensor(a) and i not in keep
           else a for i, a in enumerate(args)]
    if fn_name == "mlp_fused":
        out[6] = True
    return tuple(out)


def phase_flow_grads(torch, krows, iters=BWD_ITERS):
    """Phase flow_kernel: every backward kernel at the GMFlow training
    step's shapes (phase kernel's "flow step" rows, whose forwards are
    held there), f32 and once in bf16 on the same values: backward_row's
    checks and times. Returns {(row name, dtype): row}, the names the
    backward counters' ("attention_bwd[dv128] flow step"), each with the
    LAUNCHES_BY_SHAPE key its launches count under."""
    rows = {}
    for name, fn_name, args, *_ in flow_step_cases(torch):
        bname = name.replace(fn_name, f"{fn_name}_bwd", 1)
        key = krows[(name, "float32")]["launch_key"].replace(
            fn_name, f"{fn_name}_bwd", 1)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            a = args if dtype == torch.float32 else bf16_args(torch, fn_name,
                                                              args)
            row = {"name": bname, "dtype": dname, "launch_key": key,
                   **backward_row(torch, fn_name, a, iters)}
            say("flow_kernel", **row)
            rows[(bname, dname)] = row
            del a
            torch.cuda.empty_cache()
        del args
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"flow_kernel: backward kernels off float64 past the plain "
             f"backward's noise, not repeatable or past their peak limit "
             f"((L, L); K2 bf16 (rows, H)): {bad}")
    return rows


def flow_step_grads(torch, pair, dev, dtype, use_plain=False, cudnn=True,
                    tf32=False):
    """One GMFlowTrainer.backward on `pair` (one batch) from flow_opt()'s
    seeded weights on `dev` in `dtype`; with use_plain the kernels' plain
    versions in their place; cudnn False runs ATen's own convolutions;
    tf32 True lets matmuls and cuDNN round to TF32 for this call.
    Returns (loss, {leaf: gradient, float64 on the CPU}, seconds)."""
    from unittest import mock
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training.trainers import build_model
    tr = build_model(flow_opt(), device=dev)
    st = tr.make_state()
    st.model.to(dtype)
    plain = {n: K.PLAIN[n] for n in GRAD_ARGS}
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    a = time.perf_counter()
    try:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        with (mock.patch.multiple(K, **plain) if use_plain
              else contextlib.nullcontext()), \
                torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=tf32):
            logs = tr.backward(st, {k: v.to(dev, dtype)
                                    for k, v in pair.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    grads = {n: p.grad.detach().cpu().double()
             for n, p in st.model.named_parameters()}
    return float(logs["l_flow"]), grads, time.perf_counter() - a


def flow_step_runs(torch, pair):
    """One pair's GMFlow step from the same weights (flow_step_grads) in
    every run the gates read: the card (kernels); the CPU in f32 and
    float64; the card with the plain versions in the kernels' place in f32
    and in float64; the card with the plain versions and ATen's
    convolutions (no cuDNN); the card with TF32 allowed (a control)."""
    cpu, cuda, f32, f64 = "cpu", "cuda", torch.float32, torch.float64
    return {"card": flow_step_grads(torch, pair, cuda, f32),
            "cpu": flow_step_grads(torch, pair, cpu, f32),
            "cpu64": flow_step_grads(torch, pair, cpu, f64),
            "card_plain": flow_step_grads(torch, pair, cuda, f32,
                                          use_plain=True),
            "card_plain64": flow_step_grads(torch, pair, cuda, f64,
                                            use_plain=True),
            "card_no_cudnn": flow_step_grads(torch, pair, cuda, f32,
                                             use_plain=True, cudnn=False),
            "card_tf32": flow_step_grads(torch, pair, cuda, f32, tf32=True)}


def flow_step_gates(res):
    """The gates on flow_step_runs' results (FLOW_F64_RTOL, FLOW_F32_RATIO,
    FLOW_F32_FLOOR, FLOW_NOISE, LOSS_RTOL). Returns (ok, report)."""
    g64 = res["cpu64"][1]
    gm = max(g.abs().max().item() for g in g64.values())
    loss = {k: v[0] for k, v in res.items()}

    def max_rel(got, ref):
        """max|got - ref| over ref's largest, by leaf (FLOW_ZERO_GRAD
        leaves left out)."""
        return {n: ((got[n] - r).abs().max() / r.abs().max()).item()
                for n, r in ref.items() if n not in FLOW_ZERO_GRAD}

    def rel_l2(run):
        """|run - float64| over |float64| (L2), by leaf."""
        got = res[run][1]
        return {n: ((got[n] - r).norm() / r.norm()).item()
                for n, r in g64.items() if n not in FLOW_ZERO_GRAD}

    def worst(d, k=4):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])

    def group(n):
        return n.split(".")[0]
    # the card against the CPU with rounding out of the way (float64)
    exact = max_rel(res["card_plain64"][1], g64)
    # the f32 steps: each f32 witness's distance to float64, the largest
    # on any leaf of a module group being that group's f32 noise
    witnesses = ("cpu", "card_plain", "card_no_cudnn")
    off = {r: rel_l2(r) for r in ("card", "card_tf32") + witnesses}
    env = {}
    for r in witnesses:
        for n, v in off[r].items():
            env[group(n)] = max(env.get(group(n), 0.0), v)
    lim = {n: FLOW_F32_RATIO * env[group(n)] + FLOW_F32_FLOOR
           for n in off["card"]}
    f32_step = {n: v / lim[n] for n, v in off["card"].items()}
    tf32_ctl = {n: v / lim[n] for n, v in off["card_tf32"].items()}
    # the kernels against the plain versions, both f32 on the card
    gk, gp = res["card"][1], res["card_plain"][1]
    kern = {n: ((gk[n] - r).norm() / r.norm()).item() / lim[n]
            for n, r in gp.items() if n not in FLOW_ZERO_GRAD}
    loss_err = {r: abs(loss[r] - loss[ref]) / abs(loss[ref]) for r, ref in (
        ("card", "cpu"), ("card_plain", "card"), ("card_plain64", "cpu64"))}
    zero_noise = max(res[r][1][n].abs().max().item() / (FLOW_NOISE * gm)
                     for r in ("card", "card_plain", "card_plain64", "cpu64")
                     for n in FLOW_ZERO_GRAD)
    ok = bool(loss_err["card"] <= LOSS_RTOL
              and loss_err["card_plain"] <= LOSS_RTOL
              and loss_err["card_plain64"] <= FLOW_F64_RTOL
              and zero_noise <= 1.0 and max(exact.values()) <= FLOW_F64_RTOL
              and max(f32_step.values()) <= 1.0
              and max(kern.values()) <= 1.0
              and max(tf32_ctl.values()) > 1.0)
    return ok, {
        "losses": loss, "loss_rel_err": loss_err, "loss_rtol": LOSS_RTOL,
        "card64_vs_cpu64_max_rel": max(exact.values()),
        "worst_card64_vs_cpu64": worst(exact), "f64_rtol": FLOW_F64_RTOL,
        "f32_noise_by_group": env,
        "card_f32_over_tol": max(f32_step.values()),
        "worst_card_f32": worst(f32_step),
        "tf32_control_over_tol": max(tf32_ctl.values()),
        "worst_tf32_control": worst(tf32_ctl),
        "rel_l2_off_f64_max": {r: max(v.values()) for r, v in off.items()},
        "kernels_vs_plain_over_tol": max(kern.values()),
        "worst_kernels_vs_plain": worst(kern),
        "kernels_vs_plain_max_rel": worst(max_rel(gk, gp)),
        "cpu_f32_max_rel_off_f64": max(max_rel(res["cpu"][1], g64).values()),
        "card_f32_max_rel_off_f64": max(max_rel(res["card"][1],
                                                g64).values()),
        "zero_grad_noise_over_tol": zero_noise,
        "f32_ratio": FLOW_F32_RATIO, "f32_floor": FLOW_F32_FLOOR,
        "noise_of_largest": FLOW_NOISE, "leaves": len(g64)}


def phase_train_flow(torch, card, bwd_rows):
    """GMFlow training at full width (phase train_flow): a synthetic
    FlyingChairs directory (FLOW_PAIRS pairs of 384 x 512 .ppm frames and
    .flo flows), build_train_dataset("chairs"), the loader at B = 8 on
    FLOW_WORKERS threads, its steady s a batch alone, and GMFlowTrainer on
    flow_opt() (tools/torch_train_flow.py's defaults), f32; one warm-up
    step, then
    FLOW_STEPS steps inside one epoch: loss and metrics finite, every
    leaf's gradient non-zero (but FLOW_ZERO_GRAD's, at noise), the LR on
    the one-cycle schedule, K1-K3's launches as one GMFlow forward implies
    and as many of their backward kernels (by counter and by shape), the
    wait for data a step; a step's forward, backward and update ms apart,
    and the backward kernels' ms a step from `bwd_rows` (phase_flow_grads'
    f32 rows); then one pair's step card against CPU; one more epoch
    trained through (s a step, data included); validate_chairs on the
    validation split. Returns the launches of the FLOW_STEPS steps by
    shape key and counter."""
    from comfyui_keep_torch.data.flow_datasets import build_train_dataset
    from comfyui_keep_torch.data.prefetch import CUDAPrefetcher, DataLoader
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training import flow_eval
    from comfyui_keep_torch.training.schedulers import cosine_onecycle
    from comfyui_keep_torch.training.trainers import build_model
    root = tempfile.mkdtemp(prefix="chairs_")
    t0 = time.perf_counter()
    write_chairs(root, FLOW_PAIRS, FLOW_HW)
    write_s = time.perf_counter() - t0
    ds = build_train_dataset("chairs", FLOW_HW, roots={"chairs": root})
    loader = DataLoader(ds, batch_size=FLOW_B, shuffle=True, drop_last=True,
                        num_workers=FLOW_WORKERS, seed=0)
    # the loader alone over one epoch, nothing else running: its steady s a
    # batch from the second batch on (the first is a cold start)
    marks = [time.perf_counter()]
    for _ in loader:
        marks.append(time.perf_counter())
    loader_s = (marks[-1] - marks[1]) / (len(marks) - 2)
    pre = CUDAPrefetcher(loader)
    fopt = flow_opt()
    tr = build_model(fopt)
    state = tr.make_state()
    grads = {}
    names = {id(p): n for n, p in state.model.named_parameters()}

    def hook(opt, args, kwargs):
        for grp in opt.param_groups:
            for p in grp["params"]:
                grads[names[id(p)]] = p.grad.abs().max().item()
    state.optimizer.register_step_pre_hook(hook)

    def batch():
        b = pre.next()
        if b is None:
            fail("train_flow: the epoch ended inside the timed steps")
        return {k: v for k, v in b.items() if torch.is_tensor(v)}

    data_s, step_ms, logs_all, lrs = [], [], [], []
    sched = cosine_onecycle(fopt["train"]["num_steps"] + 10,
                            fopt["train"]["lr"], pct_start=0.05)
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    for i in range(FLOW_STEPS + 1):
        t0 = time.perf_counter()
        b = batch()
        torch.cuda.synchronize()
        data_s.append(time.perf_counter() - t0)
        if i == 1:
            K.reset_launch_counts()
        a = time.perf_counter()
        state, logs = tr.train_step(state, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - a))
        logs_all.append(logs)
        lrs.append((state.optimizer.param_groups[0]["lr"], sched(i)))
    counts = {**K.LAUNCHES, **K.LAUNCHES_BY_SHAPE}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one more step timed by parts: forward + loss, backward, update
    b = batch()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss, metrics = tr.loss_fn(state.model, b)
    ev[1].record()
    loss.backward()
    ev[2].record()
    tr.update(state)
    ev[3].record()
    torch.cuda.synchronize()
    parts = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "update_ms": ev[2].elapsed_time(ev[3])}
    # the reference's two-term loss on that batch: the flow before
    # propagation (bilinear x8, weight gamma) and the final flow, recomputed
    # in float64 from the two flows the forward returns
    with torch.no_grad():
        loss2, _ = tr.loss_fn(state.model, b)
        preds = state.model(b["img1"], b["img2"], tr.attn_splits,
                            tr.corr_radius, tr.prop_radius,
                            return_preds=True)
    gt = b["flow"].double()
    valid = ((b["valid"] >= 0.5) if "valid" in b
             else torch.ones_like(gt[..., 0], dtype=torch.bool))
    valid = (valid & (gt.norm(dim=-1) < 400)).double()
    terms = [float(((p.double() - gt).abs().sum(-1) * valid).sum()
                   / valid.sum().clamp_min(1)) for p in preds]
    want_loss = tr.gamma * terms[0] + terms[1]
    two_term = {"terms": terms, "gamma": tr.gamma, "loss": loss2.item(),
                "float64": want_loss,
                "rel_err": abs(loss2.item() - want_loss) / want_loss,
                "tol_rel": LOSS_RTOL}
    two_term["ok"] = bool(len(preds) == 2 and terms[0] != terms[1]
                          and two_term["rel_err"] <= LOSS_RTOL)
    del preds
    # every forward launch of K1-K3 records a gradient, so the backward
    # launches its kernel once for each, at the same shape
    fwd = gmflow_launches(1)
    want = {k: v * FLOW_STEPS for k, v in fwd.items()}
    want.update(fused_bias_lrelu=0, packed_conv2x2=0)
    fh, fw = FLOW_HW[0] // 8, FLOW_HW[1] // 8
    want_shape = {f"attention[dv128] B{8 * FLOW_B} L{fh * fw // 4}":
                  6 * FLOW_STEPS,
                  f"attention[dv128+bias] B{8 * FLOW_B} L{fh * fw // 4}":
                  6 * FLOW_STEPS,
                  f"attention[dv2] B{FLOW_B} L{fh * fw}": FLOW_STEPS,
                  f"global_correlation_expectation B{FLOW_B} L{fh * fw}":
                  FLOW_STEPS,
                  f"mlp_fused rows{2 * FLOW_B * fh * fw}": 6 * FLOW_STEPS}
    for counter in BWD_COUNTERS:
        fc = counter.replace("_bwd", "", 1)
        want[counter] = want[fc]
        for k, v in list(want_shape.items()):
            if k.split(" ")[0] == fc:
                want_shape[k.replace(fc, counter, 1)] = v
    by_shape = {k: counts.get(k, 0) for k in want_shape}
    finite = all(math.isfinite(v) for lg in logs_all for v in lg.values())
    keys_ok = all({"l_flow", "epe", "1px", "3px", "5px", "l_total"}
                  <= lg.keys() for lg in logs_all)
    gmax = max(grads.values())
    zero_grad = {n: g for n, g in grads.items() if n in FLOW_ZERO_GRAD}
    dead = [n for n, g in grads.items()
            if n not in FLOW_ZERO_GRAD and not g > 0]
    noisy = [n for n, g in zero_grad.items() if g > FLOW_GRAD_ATOL * gmax]
    watch = {n: grads[n] for n in (
        "backbone.conv1.weight", "transformer.layers.0.self_attn.q_proj.weight",
        "transformer.layers.0.self_attn.k_proj.weight",
        "transformer.layers.0.self_attn.v_proj.weight",
        "transformer.layers.5.cross_attn_ffn.merge.weight",
        "transformer.layers.5.cross_attn_ffn.mlp.0.weight",
        "transformer.layers.5.cross_attn_ffn.mlp.2.weight",
        "feature_flow_attn.q_proj.weight", "upsampler.2.weight")}
    lr_ok = all(abs(got - want_lr) <= 1e-9 * want_lr for got, want_lr in lrs)
    launch_ok = ({k: counts[k] for k in want} == want
                 and by_shape == want_shape)
    steady = step_ms[1:]
    # the backward kernels a step runs: each call's ms at its shape (phase
    # flow_kernel), as many as the forward launches (K3's through the
    # pre-propagation term of the loss)
    bwd_kernels = sum(r["ms"] * fwd[r["name"].split(" ")[0].replace(
        "_bwd", "", 1)] for (_, dname), r in bwd_rows.items()
        if dname == "float32")
    ok = bool(finite and keys_ok and not dead and not noisy and lr_ok
              and launch_ok and two_term["ok"])
    say("train_flow", card=card, batch=FLOW_B, hw=list(FLOW_HW),
        ms_per_step=float(np.mean(steady)), ms_steps=step_ms,
        pairs_per_s=1e3 * FLOW_B / float(np.mean(steady)), **parts,
        backward_kernels_ms_per_step=bwd_kernels, peak_gib=peak,
        data_wait_s=data_s, loader_s_per_batch=loader_s,
        loader_workers=FLOW_WORKERS, pairs_written=FLOW_PAIRS,
        write_dataset_s=write_s,
        losses=[lg["l_flow"] for lg in logs_all],
        epe=[lg["epe"] for lg in logs_all], lr=lrs, watched_grads=watch,
        zero_grad_leaves=zero_grad, dead_leaves=dead, launches=counts,
        expected=want, launches_by_shape=by_shape,
        expected_by_shape=want_shape, two_term_loss=two_term, ok=ok)
    if not ok:
        fail("train_flow: the GMFlow steps broke a check (losses, the "
             "two-term loss, gradients, LR or launches)")

    # one mixed-precision step on the same batch (train.mixed_precision:
    # the network on a bf16 copy): K1-K3's bf16 forms and their backward
    # kernels, one backward launch for each forward one, at the same shapes
    mp_opt = copy.deepcopy(fopt)
    mp_opt["train"]["mixed_precision"] = True
    tr_mp = build_model(mp_opt)
    st_mp = tr_mp.make_state()
    K.reset_launch_counts()
    st_mp, mp_logs = tr_mp.train_step(st_mp, b)
    torch.cuda.synchronize()
    mp_counts = {**K.LAUNCHES, **K.LAUNCHES_BY_SHAPE}
    mp_want = {k: v // FLOW_STEPS for k, v in want.items()}
    mp_shape = {k: v // FLOW_STEPS for k, v in want_shape.items()}
    mp_ok = bool(all(math.isfinite(v) for v in mp_logs.values())
                 and {k: mp_counts[k] for k in mp_want} == mp_want
                 and {k: mp_counts.get(k, 0) for k in mp_shape} == mp_shape)
    say("train_flow_bf16", card=card, losses=mp_logs, launches=mp_counts,
        expected=mp_want, expected_by_shape=mp_shape, ok=mp_ok)
    if not mp_ok:
        fail("train_flow_bf16: the mixed-precision GMFlow step broke a "
             "check (losses or launches)")
    del tr_mp, st_mp
    torch.cuda.empty_cache()

    one = {k: v[:1] for k, v in batch().items()}
    res = flow_step_runs(torch, one)
    ok, report = flow_step_gates(res)
    say("train_flow_parity", **report, cpu_s=res["cpu"][2],
        card_s=res["card"][2], ok=ok)
    if not ok:
        fail("train_flow_parity: the card's GMFlow step disagrees with the "
             "CPU's, or the TF32 control passed")
    del res

    # one more epoch trained through: the loader's queue starts empty, so
    # its wall clock a step (data included) shows whether the loader or
    # the step bounds the training rate
    pre.reset()
    marks, waits = [time.perf_counter()], []
    while True:
        t0 = time.perf_counter()
        b = pre.next()
        if b is None:
            break
        waits.append(time.perf_counter() - t0)
        state, _ = tr.train_step(state, {k: v for k, v in b.items()
                                         if torch.is_tensor(v)})
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    say("train_flow_epoch", steps=len(waits), card=card,
        s_per_step=(marks[-1] - marks[1]) / (len(marks) - 2),
        data_wait_s_per_step=float(np.mean(waits[1:])),
        first_batch_s=waits[0], loader_s_per_batch=loader_s,
        timed_step_ms=float(np.mean(steady)))

    # validation on the chairs split's validation pair(s)
    fn = flow_eval.make_flow_fn(state.model)
    fn(*[np.zeros((1,) + FLOW_HW + (3,), np.float32)] * 2)   # warm-up
    a = time.perf_counter()
    val = flow_eval.validate_chairs(fn, root=root, with_speed_metric=True)
    torch.cuda.synchronize()
    n_val = len(flow_eval.fdata.FlyingChairs(split="validation", root=root))
    val_ms = 1e3 * (time.perf_counter() - a) / n_val
    ok = bool(math.isfinite(val["chairs_epe"]))
    say("validate_chairs", pairs=n_val, ms_per_pair=val_ms, card=card,
        **val, ok=ok)
    if not ok:
        fail("validate_chairs: EPE not finite")
    del tr, state, pre, loader
    torch.cuda.empty_cache()

    # the CLI: FLOW_CLI_STEPS steps with a save at the last, then a
    # --resume of the saved .pth, its weights against the file's
    cli = tool("torch_train_flow")
    ckpt = os.path.join(root, "ckpt")
    argv = ["--chairs_root", root, "--num_steps", str(FLOW_CLI_STEPS),
            "--save_freq", str(FLOW_CLI_STEPS), "--summary_freq", "1",
            "--checkpoint_dir", ckpt, "--num_workers", str(FLOW_WORKERS)]
    a = time.perf_counter()
    _, st_cli, run = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - a
    want_file = os.path.join(ckpt, f"gmflow_chairs_{FLOW_CLI_STEPS}.pth")
    saved = torch.load(want_file, map_location="cpu",
                       weights_only=True)["params"]
    live = {k: v.cpu() for k, v in st_cli.model.state_dict().items()}
    _, st_res = cli.setup(cli.parse_args(argv + ["--resume", want_file]))
    resumed = st_res.model.state_dict()
    save_equal = saved.keys() == live.keys() and all(
        torch.equal(saved[k], v) for k, v in live.items())
    resume_equal = saved.keys() == resumed.keys() and all(
        torch.equal(saved[k], v.cpu()) for k, v in resumed.items())
    finite = all(math.isfinite(v) for lg in run["logs"] for v in lg.values())
    ok = bool(run["saved"] == [want_file] and save_equal and resume_equal
              and finite and len(run["logs"]) == FLOW_CLI_STEPS)
    say("train_flow_cli", cli="tools/torch_train_flow.py", card=card,
        steps=len(run["logs"]), s_with_setup=cli_s, saved=run["saved"],
        saved_equal_live=save_equal, resumed_equal_saved=resume_equal,
        losses=[lg["l_flow"] for lg in run["logs"]], ok=ok)
    if not ok:
        fail("train_flow_cli: the CLI's save or --resume broke a check")
    del st_cli, st_res, saved, live, resumed
    torch.cuda.empty_cache()
    return {"float32": counts, "bfloat16": mp_counts}


# phase sr_test: the reference configurations' patch, clip and batch sizes
# (options/train_ESRGAN_x4.yml, train_RealESRGANx4plus.yml of BasicSR /
# Real-ESRGAN, train_BasicVSR_REDS.yml; recalled from those repositories,
# which are not in this one)
SRGAN_SIZE = dict(batch=16, gt=128)        # ESRGAN x4: RRDBNet 64 / 23
REALESRGAN_SIZE = dict(batch=12, gt=256)   # Real-ESRGAN x4plus
BASICVSR_SIZE = dict(batch=4, frames=15, lq=64)   # REDS, x4
TEST_PAIRS = 4
SR_METRIC_RTOL = 1e-3   # test_pipeline's PSNR / SSIM, card against CPU


def write_sr_pairs(root, n, lq, scale=4, seed=0):
    """n smooth random PNG pairs in <root>/gt and <root>/lq (the LQ the GT
    box-averaged by `scale`)."""
    import torch
    from comfyui_keep_torch.utils import png
    g = torch.Generator().manual_seed(seed)
    for sub in ("gt", "lq"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        coarse = torch.rand((1, 3, lq // 4 + 1, lq // 4 + 1), generator=g)
        gt = torch.nn.functional.interpolate(
            coarse, size=(lq * scale, lq * scale), mode="bilinear",
            align_corners=False)
        small = torch.nn.functional.avg_pool2d(gt, scale)
        for sub, img in (("gt", gt), ("lq", small)):
            u8 = (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8)
            png.imwrite_bgr(os.path.join(root, sub, f"{i:04d}.png"),
                            u8.numpy()[:, :, ::-1])
    return os.path.join(root, "lq"), os.path.join(root, "gt")


def write_smooth_pngs(folder, names, size, seed):
    """Smooth random PNG frames (a bilinear upsample of coarse noise) of
    (size, size), one per name."""
    import torch
    from comfyui_keep_torch.utils import png
    os.makedirs(folder, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    for name in names:
        coarse = torch.rand((1, 3, size // 8 + 1, size // 8 + 1), generator=g)
        img = torch.nn.functional.interpolate(
            coarse, size=(size, size), mode="bilinear", align_corners=False)
        u8 = (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8)
        png.imwrite_bgr(os.path.join(folder, name), u8.numpy())


def dataset_batch(torch, opt):
    """The first batch of build_dataset(opt) through build_dataloader (its
    train phase) and CUDAPrefetcher: its tensors, on the card."""
    from comfyui_keep_torch.data import build_dataloader, build_dataset
    from comfyui_keep_torch.data.prefetch import CUDAPrefetcher
    loader = build_dataloader(build_dataset(opt), {**opt, "phase": "train"},
                              seed=0)
    prefetcher = CUDAPrefetcher(loader, device="cuda")
    prefetcher.reset()
    batch = prefetcher.next()
    if batch is None:
        fail(f"sr_test: {opt['type']} gave no batch")
    return {k: v for k, v in batch.items() if torch.is_tensor(v)}


def phase_sr_test(torch, card):
    """options/test_keep.yml through tools/torch_test.py's main
    (test_pipeline) on the card (MSRResNet 64 / 16 x4, TEST_PAIRS
    synthetic 64^2 -> 256^2 PNG pairs, PSNR / SSIM, save_img) against the
    CPU's run; an SRModel through tools/torch_train.py's main
    (train_pipeline) for 2 iterations with a val phase at val_freq 1; then
    one step each of SRGANModel (RRDBNet + VGGStyleDiscriminator + VGG19
    perceptual), RealESRGANModel (RRDBNet + UNetDiscriminatorSN; its batch
    from RealESRGANDataset: 12 synthetic 320^2 PNGs, their blur and sinc
    kernels, through build_dataloader and CUDAPrefetcher, then the feed)
    and VideoRecurrentModel (BasicVSR, fix_flow; its batch from
    REDSRecurrentDataset: a synthetic 15-frame REDS-layout clip, 64^2 LQ
    and 256^2 GT PNGs, through the same loader): losses finite, the
    weights moved (SpyNet's by nothing but its zero-gradient step during
    fix_flow). None of K1-K6 launches."""
    from comfyui_keep_torch.models.vgg import VGGFeatureExtractor
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.training.trainers import build_model
    K.reset_launch_counts()
    root = tempfile.mkdtemp(prefix="sr_")
    lq_dir, gt_dir = write_sr_pairs(os.path.join(root, "pairs"), TEST_PAIRS,
                                    64)
    topt = test_opt()
    g_opt = topt["network_g"]
    net = build_model(topt, device="cpu").init_model()
    pth = os.path.join(root, "net_g.pth")
    torch.save({"params": net.state_dict()}, pth)
    test_cli, train_cli = tool("torch_test"), tool("torch_train")
    argv = ["-opt", yml_path(TEST_YML), "--force_yml",
            f"datasets:test_1:dataroot_lq={lq_dir}",
            f"datasets:test_1:dataroot_gt={gt_dir}",
            f"path:pretrain_network_g={pth}", "val:save_img=true"]
    results = {}
    for dev in ("cpu", "cuda"):
        out = os.path.join(root, f"run_{dev}")
        if dev == "cuda":     # a warm-up run: cuDNN picks its algorithms
            test_cli.main(argv, root_path=out)
        torch.cuda.synchronize()
        a = time.perf_counter()
        results[dev] = test_cli.main(argv + ["--device", dev], root_path=out)
        torch.cuda.synchronize()
        results[dev + "_ms_per_pair"] = 1e3 * (time.perf_counter() - a) \
            / TEST_PAIRS
    card_m, cpu_m = results["cuda"]["demo"], results["cpu"]["demo"]
    saved = sorted(os.listdir(os.path.join(
        root, "run_cuda", "results", topt["name"], "visualization", "demo")))
    ok = bool(all(math.isfinite(v) for v in card_m.values())
              and all(abs(card_m[k] - v) <= SR_METRIC_RTOL * abs(v)
                      for k, v in cpu_m.items())
              and saved == [f"{i:04d}_keep_test.png"
                            for i in range(TEST_PAIRS)])
    say("sr_test", card=card, network=g_opt, pairs=TEST_PAIRS,
        metrics_card=card_m, metrics_cpu=cpu_m, rtol=SR_METRIC_RTOL,
        eval_ms_per_pair=results["cuda_ms_per_pair"],
        cpu_eval_ms_per_pair=results["cpu_ms_per_pair"], saved=saved,
        cli="tools/torch_test.py", ok=ok)
    if not ok:
        fail("sr_test: test_pipeline's metrics or saved images are off")

    # SRModel through tools/torch_train.py (train_pipeline) with validation
    # every iteration
    datasets = {
        "train": {"type": "PairedImageDataset", "dataroot_lq": lq_dir,
                  "dataroot_gt": gt_dir, "scale": 4, "phase": "train",
                  "gt_size": 128, "batch_size_per_gpu": 4},
        "val": {"type": "PairedImageDataset", "name": "pairs",
                "dataroot_lq": lq_dir, "dataroot_gt": gt_dir, "scale": 4}}
    state, logs = train_cli.main(
        ["-opt", yml_path(TEST_YML), "--force_yml", "name=sr_train_val",
         f"datasets={datasets!r}", "train:total_iter=2",
         "train:optim_g={'type': 'Adam', 'lr': 2e-4}", "val:val_freq=1",
         "val:save_img=true",
         "logger={'print_freq': 1, 'save_checkpoint_freq': 100}"],
        root_path=root)
    run = logs["run"]
    ok = bool(sorted(run["val"]) == [1, 2] and math.isfinite(
        logs["val/pairs/psnr"]) and state.iter == 2)
    say("sr_train_val", iters=state.iter, val=run["val"],
        step_s=run["step_s"], val_s=run["val_s"], cli="tools/torch_train.py",
        ok=ok)
    if not ok:
        fail("sr_train_val: train_pipeline's validation did not run")
    del state, run, logs

    vgg = VGGFeatureExtractor(("conv5_4",), vgg_type="vgg19",
                              use_input_norm=True, range_norm=False,
                              device="cuda",
                              generator=torch.Generator().manual_seed(9))
    rrdb = {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3,
            "num_feat": 64, "num_block": 23, "num_grow_ch": 32}
    gen = torch.Generator().manual_seed(4)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    steps = {}

    def one_step(name, opt, batch, feature_fn=None, check=None):
        kw = {} if feature_fn is None else {"feature_fn": feature_fn}
        tr = build_model(opt, **kw)
        st = tr.make_state()
        before = {n: p.detach().clone() for n, p in
                  st.model.named_parameters()}
        if hasattr(tr, "feed_data"):
            batch = tr.feed_data(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = time.perf_counter()
        st, lg = tr.train_step(st, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - a)
        moved = {n: (p.detach() - before[n]).abs().max().item()
                 for n, p in st.model.named_parameters()}
        ok = bool(all(math.isfinite(v) for v in lg.values()) and lg
                  and max(moved.values()) > 0
                  and (check is None or check(moved)))
        steps[name] = {"ms_first_step": ms, "losses": lg,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "ok": ok}
        say("sr_step", model=name, batch={k: list(v.shape)
                                          for k, v in batch.items()},
            **steps[name])
        if not ok:
            fail(f"sr_step ({name}): a loss is not finite or nothing moved")

    n, s = SRGAN_SIZE["batch"], SRGAN_SIZE["gt"]
    one_step("SRGANModel (ESRGAN x4)", {
        "model_type": "SRGANModel", "manual_seed": 0, "network_g": rrdb,
        "network_d": {"type": "VGGStyleDiscriminator", "num_in_ch": 3,
                      "num_feat": 64, "input_size": s},
        "train": {"pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2},
                  "perceptual_opt": {"type": "PerceptualLoss",
                                     "layer_weights": {"conv5_4": 1.0},
                                     "perceptual_weight": 1.0,
                                     "style_weight": 0},
                  "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                              "loss_weight": 5e-3},
                  "optim_g": {"type": "Adam", "lr": 1e-4},
                  "optim_d": {"type": "Adam", "lr": 1e-4}}},
        {"lq": rand(n, s // 4, s // 4, 3), "gt": rand(n, s, s, 3)}, vgg)
    n, s = REALESRGAN_SIZE["batch"], REALESRGAN_SIZE["gt"]
    hq = os.path.join(root, "realesrgan_hq")
    write_smooth_pngs(hq, [f"{i:04d}.png" for i in range(n)], s + 64, 5)
    esrgan_batch = dataset_batch(torch, {
        "type": "RealESRGANDataset", "dataroot_gt": hq, "use_hflip": True,
        "use_rot": False, "batch_size_per_gpu": n, "num_worker_per_gpu": 4})
    one_step("RealESRGANModel (x4plus)", {
        "model_type": "RealESRGANModel", "manual_seed": 0, "scale": 4,
        "gt_size": s, "queue_size": 180,
        "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.15, 1.5],
        "gaussian_noise_prob": 0.5, "noise_range": [1, 30],
        "poisson_scale_range": [0.05, 3], "gray_noise_prob": 0.4,
        "jpeg_range": [30, 95], "second_blur_prob": 0.8,
        "resize_prob2": [0.3, 0.4, 0.3], "resize_range2": [0.3, 1.2],
        "gaussian_noise_prob2": 0.5, "noise_range2": [1, 25],
        "poisson_scale_range2": [0.05, 2.5], "gray_noise_prob2": 0.4,
        "jpeg_range2": [30, 95],
        "network_g": rrdb,
        "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 3,
                      "num_feat": 64, "skip_connection": True},
        "train": {"pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                  "perceptual_opt": {"type": "PerceptualLoss",
                                     "layer_weights": {"conv5_4": 1.0},
                                     "perceptual_weight": 1.0,
                                     "style_weight": 0},
                  "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                              "loss_weight": 1e-1},
                  "optim_g": {"type": "Adam", "lr": 1e-4},
                  "optim_d": {"type": "Adam", "lr": 1e-4}}},
        esrgan_batch, vgg)
    n, t, lq = (BASICVSR_SIZE[k] for k in ("batch", "frames", "lq"))
    reds = os.path.join(root, "reds")
    names = [f"{i:08d}.png" for i in range(t)]
    write_smooth_pngs(os.path.join(reds, "gt", "001"), names, 4 * lq, 6)
    write_smooth_pngs(os.path.join(reds, "lq", "001"), names, lq, 7)
    with open(os.path.join(reds, "meta.txt"), "w") as f:
        f.write(f"001 {t} ({4 * lq},{4 * lq},3)\n")
    reds_batch = dataset_batch(torch, {
        "type": "REDSRecurrentDataset",
        "dataroot_gt": os.path.join(reds, "gt"),
        "dataroot_lq": os.path.join(reds, "lq"),
        "meta_info_file": os.path.join(reds, "meta.txt"), "num_frame": t,
        "gt_size": 4 * lq, "scale": 4, "interval_list": [1],
        "random_reverse": False, "use_hflip": True, "use_rot": True,
        "batch_size_per_gpu": n, "num_worker_per_gpu": 4})
    one_step("VideoRecurrentModel (BasicVSR, REDS)", {
        "model_type": "VideoRecurrentModel", "manual_seed": 0,
        "network_g": {"type": "BasicVSR", "num_feat": 64, "num_block": 30},
        "train": {"pixel_opt": {"type": "CharbonnierLoss",
                                "loss_weight": 1.0},
                  "optim_g": {"type": "Adam", "lr": 2e-4},
                  "flow_lr_mul": 0.125, "fix_flow": 5000}},
        reds_batch,
        check=lambda moved: all(v == 0 for k, v in moved.items()
                                if k.startswith("spynet.")))
    counts = dict(K.LAUNCHES)
    ok = not any(counts.values())
    say("sr_launches", launches=counts, ok=ok)
    if not ok:
        fail(f"sr_test: the SR / video trainers launched a kernel {counts}")
    del vgg
    torch.cuda.empty_cache()
    return steps


PARALLEL_RUNS = 2        # timed 41-face chunk-parallel runs, after a warm-up
PARALLEL_TIMEOUT = 300   # seconds each rank of the two-rank run may take
PAR_SR_BATCH = 8         # the data-parallel SR step's global batch
PAR_STAGING = ("gloo takes CPU tensors: all_gather, send / recv and "
               "all_reduce stage a card tensor through the host")


def free_port():
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_inputs():
    """41 aligned 512^2 faces in [-1, 1] (as phase chunks) and two 40-frame
    clips for the ring (N=2, B=1)."""
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    rng = np.random.default_rng(6)
    faces = np.stack([bgr_u8_to_rgb_pm1(rng.integers(
        0, 256, (512, 512, 3), dtype=np.uint8)) for _ in range(2 * FRAMES + 1)])
    clips = np.stack([faces[:2 * FRAMES][None], faces[1:][None]])
    return faces, clips


def par_sr_opt():
    opt = test_opt()
    opt["train"] = {"pixel_opt": {"type": "L1Loss"},
                    "optim_g": {"type": "Adam", "lr": 2e-4}}
    return opt


def par_sr_batch(torch):
    g = torch.Generator().manual_seed(12)
    return {"lq": torch.rand((PAR_SR_BATCH, 64, 64, 3), generator=g),
            "gt": torch.rand((PAR_SR_BATCH, 256, 256, 3), generator=g)}


def par_sr_step(torch, mesh):
    """Two SR steps (test_keep.yml's MSRResNet, Adam) on par_sr_batch through
    SRTrainer with `mesh`: (ms of the second, this rank's losses of the
    first, the first conv's weight after both)."""
    from comfyui_keep_torch.training.trainers import SRTrainer
    tr = SRTrainer(par_sr_opt(), mesh=mesh)
    st = tr.make_state()
    batch = {k: v.cuda() for k, v in par_sr_batch(torch).items()}
    st, logs = tr.train_step(st, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = tr.train_step(st, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    first = next(iter(st.model.parameters())).detach().float().cpu()
    return ms, logs, first


def parallel_rank(rank, world, port, out):
    """One rank of phase parallel's two-rank run (gloo, both ranks on card
    0): chunk-parallel restore of the 41 faces, the ring over the two
    clips, and the data-parallel SR step; the outputs to `out`, one JSON
    line of timings and launches."""
    import torch
    sys.path.insert(0, ROOT)
    from comfyui_keep_torch import api
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.parallel import (init_distributed, make_mesh,
                                             reduce_loss_dict,
                                             restore_chunks_parallel,
                                             restore_stream_pipeline)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = init_distributed(backend="gloo", world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{port}")
    pack = api.load_models(seed=0).load_device(torch.bfloat16)
    proc = pack.processor(dtype=torch.bfloat16)
    faces, clips = parallel_inputs()
    mesh = make_mesh()
    res = {"rank_world": list(got), "backend": "gloo"}
    restore_chunks_parallel(proc, faces, FRAMES, mesh)   # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    chunks = restore_chunks_parallel(proc, faces, FRAMES, mesh)
    torch.cuda.synchronize()
    res["chunks_ms_per_face"] = 1e3 * (time.perf_counter() - t0) / len(faces)
    res["chunks_launches"] = k1_launches(launch_counts(K))
    t0 = time.perf_counter()
    ring = restore_stream_pipeline(proc, clips, make_mesh(axes=("seq",)))
    torch.cuda.synchronize()
    res["ring_ms_per_face"] = 1e3 * (time.perf_counter() - t0) / (
        clips.shape[0] * clips.shape[2])
    if rank == 0:
        np.save(os.path.join(out, "chunks.npy"), chunks)
        np.save(os.path.join(out, "ring.npy"), ring)
    ms, logs, first = par_sr_step(torch, mesh)
    res.update(sr_ms_per_step=ms, sr_losses=reduce_loss_dict(logs, mesh))
    np.save(os.path.join(out, f"sr_first{rank}.npy"), first.numpy())
    print(json.dumps(res), flush=True)


def two_ranks(out):
    """Start parallel_rank on two processes (this script with the
    --parallel-rank arguments), each with PARALLEL_TIMEOUT; kill both if
    one fails or runs over. Returns their JSON lines."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), "2", str(port), out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    lines, err = [], None
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=PARALLEL_TIMEOUT)
            if p.returncode != 0:
                err = f"rank {r} exited {p.returncode}: {stderr[-3000:]}"
                break
            lines.append(json.loads(stdout.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        err = f"a rank ran over {PARALLEL_TIMEOUT} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if err:
        fail(f"parallel (two ranks): {err}")
    return lines


def phase_parallel(torch, pack, card):
    """The parallel layer (comfyui_keep_torch/parallel/) at the main path's
    width: KEEP + GMFlow 512^2 bf16 from api.load_models(seed=0), 41 faces
    in 20-frame chunks, as phase chunks.

    In a world-1 NCCL group on the card: restore_chunks_parallel (ms a
    face, K1-K4 launches) against the processor's chunk body on the two
    whole chunks and, on the padded tail, against the JAX package's
    semantics (the tail chunk padded with its last face), bit for bit; the
    ring (restore_stream_pipeline) at one rank against carried streaming,
    bit for bit; data-parallel SRTrainer steps (test_keep.yml's MSRResNet, B =
    PAR_SR_BATCH) and a stage-II KEEPTrainer step (train_keep_stage2.yml
    at full width, f32 as configured, K1-K4 launched) on the mesh against
    the meshless ones on the same batch, cuDNN deterministic: the SR
    weights equal, the losses within 1e-6 and every applied KEEP gradient
    within 1e-4 of its leaf's largest (grid_sample's backward adds with
    atomics; the weights after Adam reported). Then one two-rank run on the one
    card (gloo, which NCCL's one-rank-a-card rule leaves; PAR_STAGING):
    its chunk-parallel restore against the world-1 result and its ring
    against carried streaming over two chunks a clip, within one uint8
    level (bit-for-bit equality reported), the SR step's weights equal on
    both ranks and its loss against the one-process step within 1e-5; ms
    a face and ms a step beside the world-1 ones. Returns {"chunks":
    counts, "train": counts}."""
    import torch.distributed as dist
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.parallel import (init_distributed, make_mesh,
                                             restore_chunks_parallel,
                                             restore_stream_pipeline)
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    port = free_port()
    got = init_distributed(backend="nccl", world_size=1, rank=0,
                           init_method=f"tcp://127.0.0.1:{port}")
    mesh = make_mesh()
    proc = pack.processor(dtype=torch.bfloat16)
    faces, clips = parallel_inputs()
    n = len(faces)
    restore_chunks_parallel(proc, faces, FRAMES, mesh)   # warm-up
    runs = []
    for _ in range(PARALLEL_RUNS):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = restore_chunks_parallel(proc, faces, FRAMES, mesh)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / n)
    chunk_counts = launch_counts(K)
    body = np.concatenate([proc.restore_clip(faces[s:s + FRAMES])
                           for s in (0, FRAMES)])
    tail = proc.restore_clip(faces[[n - 1] * FRAMES])[:1]
    chunks_ok = bool(np.array_equal(out[:2 * FRAMES], body)
                     and np.array_equal(out[2 * FRAMES:], tail))
    want = gmflow_launches(3)
    t0 = time.perf_counter()
    ring = restore_stream_pipeline(proc, clips, make_mesh(axes=("seq",)))
    torch.cuda.synchronize()
    ring_ms = 1e3 * (time.perf_counter() - t0) / (clips.shape[0]
                                                   * clips.shape[2])

    def carried(k):
        """Each clip through the processor's carried loop, k chunks."""
        res = []
        for clip in clips[:, 0]:
            tc = clip.shape[0] // k
            o, carry = proc.restore_clip(clip[:tc], return_carry=True)
            parts = [o]
            for d in range(1, k):
                o, carry = proc.restore_clip(clip[d * tc:(d + 1) * tc], carry,
                                             clip[d * tc - 1],
                                             return_carry=True)
                parts.append(o)
            res.append(np.concatenate(parts)[None])
        return np.stack(res)
    ring_ok = bool(np.array_equal(ring, carried(1)))
    ok = chunks_ok and ring_ok and k1_launches(chunk_counts) == want
    say("parallel", world=got[1], backend="nccl", faces=n,
        ms_per_face=float(np.median(runs)), ms_per_face_runs=runs,
        launches=k1_launches(chunk_counts), expected_launches=want,
        whole_chunks_equal_chunk_body=chunks_ok, ring_ms_per_face=ring_ms,
        ring_equals_carried_streaming=ring_ok, card=card, ok=ok)
    if not ok:
        fail("parallel: chunk-parallel restore or the ring differs from the "
             "processor, or the launches are off")

    # the trainers on the world-1 mesh against the meshless step
    torch.backends.cudnn.deterministic = True
    try:
        sr_ms, sr_logs, sr_first = par_sr_step(torch, mesh)
        sr0_ms, sr0_logs, sr0_first = par_sr_step(torch, None)
    finally:
        torch.backends.cudnn.deterministic = False
    yml = train_opt()
    data = yml["datasets"]["train"]
    b, t = data["batch_size_per_gpu"], data["num_frame"]
    hq = VQHQEncoder(**{k: v for k, v in yml["network_g"].items()
                        if k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    g = torch.Generator(device="cuda").manual_seed(3)
    size = yml["network_g"]["img_size"]
    batch = {k: torch.rand((b, t, size, size, 3), generator=g,
                           device="cuda") * 2 - 1 for k in ("lq", "gt")}
    steps = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, m in (("mesh", mesh), ("meshless", None)):
            tr = KEEPTrainer(copy.deepcopy(yml),
                             hq_vqgan=copy.deepcopy(hq),
                             gmflow=copy.deepcopy(gm), mesh=m)
            grads = {}
            tr.before_step = lambda st: grads.update(
                (k, p.grad.detach().clone())
                for k, p in st.model.named_parameters() if p.grad is not None)
            st = tr.make_state()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            st, logs = tr.train_step(st, batch)
            torch.cuda.synchronize()
            steps[name] = {"ms": 1e3 * (time.perf_counter() - t0),
                           "logs": logs, "grads": grads,
                           "counts": launch_counts(K),
                           "params": {k: p.detach() for k, p in
                                      st.model.named_parameters()}}
            del tr, st
    finally:
        torch.backends.cudnn.deterministic = False
    a, z = steps["mesh"], steps["meshless"]
    loss_err = max(abs(a["logs"][k] - v) / max(abs(v), 1e-12)
                   for k, v in z["logs"].items())
    grad_err = max(((a["grads"][k] - v).abs().max()
                    / v.abs().max().clamp_min(1e-30)).item()
                   for k, v in z["grads"].items())
    param_err = max((a["params"][k] - v).abs().max().item()
                    for k, v in z["params"].items())
    train_counts = a["counts"]
    want_train = {"attention[dv128]": 12, "attention[dv128+bias]": 12,
                  "attention[dv2]": 2, "global_correlation_expectation": 2,
                  "mlp_fused": 12, "vq_nearest_indices": 1}
    sr_err = max(abs(sr_logs[k] - v) / max(abs(v), 1e-12)
                 for k, v in sr0_logs.items())
    ok = bool(loss_err <= 1e-6 and grad_err <= 1e-4 and sr_err <= 1e-6
              and torch.equal(sr_first, sr0_first)
              and k1_launches(train_counts) == want_train
              and a["grads"].keys() == z["grads"].keys())
    say("parallel_train", world=1, sr_ms_per_step=sr_ms,
        sr_meshless_ms_per_step=sr0_ms, sr_loss_rel_err=sr_err,
        sr_first_weight_equal=bool(torch.equal(sr_first, sr0_first)),
        keep_stage2_ms_per_step=a["ms"],
        keep_stage2_meshless_ms_per_step=z["ms"],
        keep_losses=a["logs"], keep_loss_rel_err=loss_err,
        keep_grad_rel_err=grad_err, keep_param_max_abs_diff=param_err,
        launches=k1_launches(train_counts), expected_launches=want_train,
        precision="f32", batch=b, frames=t, ok=ok)
    if not ok:
        fail("parallel_train: a step on the world-1 mesh differs from the "
             "meshless one, or its launches are off")
    del steps, a, z, batch
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # two gloo ranks on this card
    tmp = tempfile.mkdtemp(prefix="par_")
    lines = two_ranks(tmp)
    chunks2 = np.load(os.path.join(tmp, "chunks.npy"))
    ring2 = np.load(os.path.join(tmp, "ring.npy"))
    ring_ref = carried(2)
    firsts = [np.load(os.path.join(tmp, f"sr_first{r}.npy")) for r in (0, 1)]
    sr2_err = max(abs(lines[0]["sr_losses"][k] - v) / max(abs(v), 1e-12)
                  for k, v in sr0_logs.items())
    chunks_d = float(np.abs(chunks2 - out).max())
    ring_d = float(np.abs(ring2 - ring_ref).max())
    ok = bool(np.array_equal(chunks2, out)
              and np.array_equal(ring2, ring_ref)
              and np.array_equal(firsts[0], firsts[1]) and sr2_err <= 1e-5
              and sorted(ln["rank_world"][0] for ln in lines) == [0, 1]
              and all(k1_launches({**dict.fromkeys(K1_K4, 0),
                                   **ln["chunks_launches"]})
                      == gmflow_launches(2) for ln in lines))
    say("parallel_two_ranks", world=2, backend="gloo", staging=PAR_STAGING,
        card=card, chunks_ms_per_face=[ln["chunks_ms_per_face"]
                                       for ln in lines],
        ring_ms_per_face=[ln["ring_ms_per_face"] for ln in lines],
        sr_ms_per_step=[ln["sr_ms_per_step"] for ln in lines],
        chunks_launches=[ln["chunks_launches"] for ln in lines],
        chunks_vs_world1_max_abs=chunks_d,
        chunks_bitwise=bool(np.array_equal(chunks2, out)),
        ring_vs_carried_max_abs=ring_d,
        ring_bitwise=bool(np.array_equal(ring2, ring_ref)),
        sr_weights_equal_across_ranks=bool(np.array_equal(*firsts)),
        sr_loss_rel_err_vs_one_process=sr2_err, ok=ok)
    if not ok:
        fail("parallel_two_ranks: the two-rank results are off")
    del proc
    torch.cuda.empty_cache()
    return {"chunks": chunk_counts, "train": train_counts}


# slice 12's phases: the profiler, the bf16-fidelity twin, the IO threads
# and video, the synthetic zoo
PROFILE_FRAMES, PROFILE_ITERS = 20, 5
TIME_FN_RTOL = 0.1      # time_fn's median against CUDA events, same calls
TIME_FN_ITERS = 10
# the fidelity report's gates (random weights, 20 frames, unpacked), set
# from the first card run (0.9467 and 36.16 dB; PERF.md section 6): the
# forced bf16 run's own picks against the f32 run's, and its uint8 PSNR
# against the f32 output
FIDELITY_MIN_AGREEMENT, FIDELITY_MIN_PSNR_FORCED = 0.9, 32.0
IO_FRAMES = 20
VIDEO_PSNR_DB = 30.0    # libx264 -crf 18 on smooth 720p frames, uint8 PSNR


def phase_profiler(torch, card):
    """utils/profiler.py on the card: keep_latency_benchmark (KEEP at full
    width, 20 frames, bf16: ms a frame); trace() around one 2-frame KEEP
    forward, its Chrome trace non-empty with device kernels in it; time_fn
    on a chain of bf16 GEMMs against CUDA events recorded around the GEMMs
    of the same calls, the card's own clock (medians within
    TIME_FN_RTOL)."""
    from comfyui_keep_torch.models.keep import KEEP
    from comfyui_keep_torch.utils import profiler
    med = profiler.keep_latency_benchmark(PROFILE_FRAMES, PROFILE_ITERS,
                                          "bf16")
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(0))
    net = net.to("cuda", torch.bfloat16)
    x = (torch.randn((1, 2, 512, 512, 3), generator=torch.Generator()
                     .manual_seed(1)) * 0.3).to("cuda", torch.bfloat16)
    work = tempfile.mkdtemp(prefix="trace_")
    try:
        net.apply(x)
        torch.cuda.synchronize()
        with profiler.trace(work):
            net.apply(x)
            torch.cuda.synchronize()
        path = os.path.join(work, profiler.TRACE_FILE)
        trace_bytes = os.path.getsize(path) if os.path.exists(path) else 0
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del net, x
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    marks = []

    def gemms(m):
        """8 bf16 GEMMs of 4096^2 between two CUDA events."""
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(8):
            m = (m @ a) * 1e-2
        end.record()
        marks.append((start, end))
        return m
    # the same calls on two clocks: time_fn's host clock and the card's
    # own (CUDA events around each call's GEMMs)
    fn_med, _ = profiler.time_fn(gemms, a, iters=TIME_FN_ITERS, warmup=1)
    torch.cuda.synchronize()
    on_card = [s.elapsed_time(e) / 1e3 for s, e in marks[-TIME_FN_ITERS:]]
    own_med = float(np.median(on_card))
    agree = abs(fn_med - own_med) / own_med
    del a
    torch.cuda.empty_cache()
    ok = bool(math.isfinite(med) and med > 0 and trace_bytes > 0
              and kernels > 0 and agree <= TIME_FN_RTOL)
    say("profiler", card=card, frames=PROFILE_FRAMES, dtype="bf16",
        keep_forward_ms=1e3 * med,
        ms_per_frame=1e3 * med / PROFILE_FRAMES,
        faces_per_s=PROFILE_FRAMES / med, trace_bytes=trace_bytes,
        trace_kernel_events=kernels, time_fn_ms=1e3 * fn_med,
        cuda_events_ms=1e3 * own_med, time_fn_rel_diff=agree,
        rtol=TIME_FN_RTOL, ok=ok)
    if not ok:
        fail("profiler: the latency benchmark, the trace or time_fn is off")


def phase_fidelity(torch, card):
    """tools/torch_bf16_fidelity.py's report at 20 frames, unpacked: K1-K3
    launched as three GMFlow passes imply, the forced run's pick agreement
    and PSNR above their limits, every number finite."""
    from comfyui_keep_torch.ops import kernels as K
    fid = tool("torch_bf16_fidelity")
    K.reset_launch_counts()
    a = time.perf_counter()
    report = fid.fidelity(FRAMES, "bf16", phase512=False)
    seconds = time.perf_counter() - a
    counts = {k: launch_counts(K).get(k, 0) for k in K1_K4}
    want = {**gmflow_launches(3), "vq_nearest_indices": 0}
    nums = [v for k, v in report.items() if isinstance(v, float)]
    ok = bool(all(math.isfinite(v) for v in nums if v != report["psnr_db"])
              and report["index_agreement"] >= FIDELITY_MIN_AGREEMENT
              and report["psnr_db_forced"] >= FIDELITY_MIN_PSNR_FORCED
              and counts == want)
    say("fidelity", card=card, **report, seconds=seconds, launches=counts,
        expected=want, min_agreement=FIDELITY_MIN_AGREEMENT,
        min_psnr_forced=FIDELITY_MIN_PSNR_FORCED, ok=ok)
    if not ok:
        fail(f"fidelity: {report}, launches {counts} (want {want})")


def smooth_video(n, hw, seed=0):
    """n smooth moving uint8 BGR frames of hw (no grain: what a video codec
    keeps well)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    waves = np.random.default_rng(seed).uniform(0.5, 3.0, (3, 2))
    return [((np.stack([np.sin(2 * np.pi * (a * xx + b * yy) + 0.2 * i + c)
                        for c, (a, b) in enumerate(waves)], -1) + 1)
             * 127.5).astype(np.uint8) for i in range(n)]


def phase_io(torch, card):
    """The IO threads and video: IO_FRAMES 720p frames written by
    IOConsumer and read back by PrefetchReader (utils/png.py) bit for bit;
    VideoWriter -> VideoReader on IO_FRAMES smooth 720p frames within
    VIDEO_PSNR_DB when ffmpeg and ffprobe are on the machine, else both
    classes raising for want of them."""
    import queue
    from comfyui_keep_torch.metrics.psnr_ssim import calculate_psnr
    from comfyui_keep_torch.pipeline.realesrganer import (IOConsumer,
                                                          PrefetchReader)
    from comfyui_keep_torch.utils.video import VideoReader, VideoWriter
    frames = whole_frames(IO_FRAMES, seed=5)
    work = tempfile.mkdtemp(prefix="io_")
    try:
        paths = [os.path.join(work, f"{i:04d}.png") for i in range(IO_FRAMES)]
        que = queue.Queue()
        writer = IOConsumer({}, que, 0)
        a = time.perf_counter()
        writer.start()
        for f, path in zip(frames, paths):
            que.put({"output": f, "save_path": path})
        que.put("quit")
        writer.join()
        write_s = time.perf_counter() - a
        a = time.perf_counter()
        reader = PrefetchReader(paths, 4)
        reader.start()
        got = list(reader)
        reader.join()
        read_s = time.perf_counter() - a
        png_equal = len(got) == IO_FRAMES and all(
            np.array_equal(g, f) for g, f in zip(got, frames))
        video = os.path.join(work, "clip.mp4")
        have = bool(shutil.which("ffmpeg") and shutil.which("ffprobe"))
        if have:
            clip = smooth_video(IO_FRAMES, WHOLE_HW)
            vw = VideoWriter(video, WHOLE_HW[0], WHOLE_HW[1], fps=25)
            for f in clip:
                vw.write_frame(f)
            vw.close()
            vr = VideoReader(video)
            back = []
            while (f := vr.get_frame()) is not None:
                back.append(f)
            vr.close()
            psnrs = [float(calculate_psnr(b, f, crop_border=0))
                     for b, f in zip(back, clip)]
            video_ok = len(back) == IO_FRAMES and min(psnrs) >= VIDEO_PSNR_DB
            video_rep = {"ffmpeg": "present", "frames_back": len(back),
                         "psnr_db_min": min(psnrs, default=None),
                         "psnr_db_mean": float(np.mean(psnrs)) if psnrs
                         else None, "fps": vr.get_fps(),
                         "psnr_limit_db": VIDEO_PSNR_DB}
        else:
            raised = []
            for make in (lambda: VideoWriter(video, 16, 16),
                         lambda: VideoReader(video)):
                try:
                    make()
                except RuntimeError as e:
                    raised.append("ffmpeg" in str(e) or "ffprobe" in str(e))
            video_ok = raised == [True, True]
            video_rep = {"ffmpeg": "absent", "both_raise": video_ok}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = bool(png_equal and video_ok)
    say("io", card=card, frames=IO_FRAMES, hw=list(WHOLE_HW),
        png_round_trip_equal=png_equal, write_s=write_s, read_s=read_s,
        **video_rep, ok=ok)
    if not ok:
        fail(f"io: PNG round trip {png_equal}, video {video_rep}")


def phase_zoo(torch, card):
    """tools/torch_synth_zoo.py writes the five-file zoo at full width; the
    port loads it: api.load_models(keep_ckpt=...) with KEEP's and GMFlow's
    weights equal to the file's, the RetinaFace and ParseNet factories from
    model_rootpath on the card (the detector finds 1-50 faces at conf 0.97
    and eye distance 5 on the synthetic 640^2 image, the parser's logits
    finite), and each RRDBNet x2 through factory.load_reference into a
    tiled upscaler."""
    from comfyui_keep_torch import api
    from comfyui_keep_torch.facelib import factory
    from comfyui_keep_torch.models.sr_basic import RRDBNet
    from comfyui_keep_torch.pipeline.tiled import make_upscaler_fn
    from comfyui_keep_torch.utils.convert import (read_pth,
                                                  split_keep_checkpoint)
    zoo = tool("torch_synth_zoo")
    work = tempfile.mkdtemp(prefix="zoo_")
    try:
        a = time.perf_counter()
        made = zoo.synth_all(work, seed=0)
        write_s = time.perf_counter() - a
        mb = {f: os.path.getsize(p) / 1e6 for f, p in made.items()}
        a = time.perf_counter()
        pack = api.load_models(keep_ckpt=made["KEEP-b76feb75.pth"])
        load_s = time.perf_counter() - a
        keep_sd, flow_sd = split_keep_checkpoint(
            read_pth(made["KEEP-b76feb75.pth"]))

        def same(module, sd):
            live = module.state_dict()
            return live.keys() == sd.keys() and all(
                torch.equal(live[k], v) for k, v in sd.items())
        keep_equal = same(pack.keep, keep_sd)
        flow_equal = pack.gmflow is not None and same(pack.gmflow, flow_sd)
        del pack, keep_sd, flow_sd
        root = os.path.join(work, "facedetection")
        det = factory.init_detection_model("retinaface_resnet50",
                                           model_rootpath=root)
        img = zoo.synth_image(np.random.default_rng(0), 640, 640)
        rows = det(img, zoo.DETECT_CONF)
        eye = np.linalg.norm(rows[:, 5:7] - rows[:, 7:9], axis=1)
        n_faces = int((eye >= zoo.DETECT_EYE).sum())
        par = factory.init_parsing_model("parsenet", model_rootpath=root)
        face = np.random.default_rng(1).uniform(-1, 1, (1, 512, 512, 3)
                                                ).astype(np.float32)
        logits = par(face)
        parse_ok = bool(tuple(logits.shape) == (1, 512, 512, 19)
                        and torch.isfinite(logits).all())
        up_shapes = {}
        for name in ("RealESRGAN_x2_bg.pth", "RealESRGAN_x2_face.pth"):
            net = factory.load_reference(
                RRDBNet(scale=2, num_feat=32, num_block=2, device="cuda"),
                made[name])
            up_shapes[name] = list(make_upscaler_fn(net, 2)(img).shape)
        del det, par, logits
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    ok = bool(sorted(made) == sorted(zoo.ZOO) and keep_equal and flow_equal
              and 1 <= n_faces <= 50 and parse_ok
              and all(v == [1280, 1280, 3] for v in up_shapes.values()))
    say("zoo", card=card, files_mb=mb, write_s=write_s, keep_load_s=load_s,
        keep_weights_equal=keep_equal, gmflow_weights_equal=flow_equal,
        detections=len(rows), faces_past_eye_filter=n_faces,
        parser_ok=parse_ok, upscaled_shapes=up_shapes, ok=ok)
    if not ok:
        fail("zoo: a synthetic checkpoint did not load or run")


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
    keep_k6, keep_ref = phase_keep(torch, x, flows)
    counts, proc, faces, pack = phase_main(torch,
                                           k6_rows[(K6_OWN, "bfloat16")])
    phase_stream(torch, proc, faces)
    del proc
    level_rows = phase_k6_levels(torch)
    level_shapes = phase_packing_levels(torch, keep_ref, pack, faces)
    del keep_ref
    gm_shapes = phase_gmflow_packed(torch, x)
    phase_int8_acts(torch, pack, faces)
    phase_api(torch, pack)
    chunk_counts = phase_chunks(torch, pack)
    par_counts = phase_parallel(torch, pack, card)
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
    gan_counts = phase_train_gan(torch, card)
    bwd_rows = phase_flow_grads(torch, krows)
    flow_counts = phase_train_flow(torch, card, bwd_rows)
    phase_sr_test(torch, card)
    k5_rows = phase_k5(torch)
    phase_stylegan2_parity(torch)
    sample_counts = phase_stylegan2_sample(torch)
    sg2_train_counts = phase_stylegan2_train(torch)
    refine_counts = phase_gmflow_refine(torch)
    vqgan_counts = phase_vqgan(torch)
    phase_native(torch)
    phase_archs(torch, card)
    phase_metrics(torch, card)
    phase_profiler(torch, card)
    phase_fidelity(torch, card)
    phase_io(torch, card)
    phase_zoo(torch, card)

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

    def parallel(key, dname):
        """Launches at counter `key` in phase parallel: the world-1
        chunk-parallel 41-face run (bf16 rows) and the stage-II step on the
        world-1 mesh (f32 rows)."""
        return {"launches_parallel_chunks":
                par_counts["chunks"].get(key, 0) if dname == "bfloat16"
                else None,
                "launches_parallel_train_step":
                par_counts["train"].get(key, 0) if dname == "float32"
                else None}

    def stage3(key, dname):
        """Launches at counter `key` in one stage-III alternation (phase
        train_gan's resumed run, f32), on the f32 rows."""
        return {"launches_train_gan_per_alternation":
                gan_counts.get(key, 0) if dname == "float32" else None}

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
        elif at == "flow step" and dname == "float32":
            # K1-K3 (f32) at the GMFlow training step's shapes: launches at
            # each shape over the FLOW_STEPS timed steps of phase train_flow
            launches = flow_counts["float32"].get(key, 0)
            extra = {"launches_per_step": launches / FLOW_STEPS,
                     "launches_at": key,
                     "launches_of": f"{FLOW_STEPS} GMFlow training steps "
                                    f"(B = {FLOW_B}, "
                                    f"{FLOW_HW[0]}x{FLOW_HW[1]})"}
        elif at == "flow step":
            # K1's window forms and K2 (bf16) at the step's shapes: launches
            # at each shape in phase train_flow_bf16's mixed-precision step
            launches = flow_counts["bfloat16"].get(key, 0)
            extra = {"launches_per_step": launches, "launches_at": key,
                     "launches_of": "one mixed-precision GMFlow step "
                                    f"(B = {FLOW_B}, "
                                    f"{FLOW_HW[0]}x{FLOW_HW[1]})"}
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
                     **slice7(counter, dname), **parallel(counter, dname)}
            launches = counts[name]
        if "unfused_ms" in r:
            extra["unfused_ms"] = r["unfused_ms"]
        for opt in ("vs_library", "fma_bound_ms"):
            if opt in r:
                extra[opt] = r[opt]
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": dname, "status": "ported", **extra,
            **({} if at == "flow step" else stage3(counter, dname))})
    # the backward kernels at the GMFlow step's shapes: f32 with their
    # launches over phase train_flow's f32 steps, bf16 with those of its
    # mixed-precision step
    for (name, dname), r in bwd_rows.items():
        fn = name.split(" ")[0].split("[")[0].replace("_bwd", "")
        key = r["launch_key"]
        f32 = dname == "float32"
        n = flow_counts[dname].get(key, 0)
        table.append({
            "name": name, "route": "cuda",
            "source": ("comfyui_keep_torch/csrc/mlp.cu" if fn == "mlp_fused"
                       else "comfyui_keep_torch/csrc/attention_bwd.cu"),
            "replaces": srcs[fn][1], "differentiates": r["differentiates"],
            "launches": n,
            "launches_per_step": n / FLOW_STEPS if f32 else n,
            "launches_at": key,
            "launches_of": (f"{FLOW_STEPS} GMFlow training steps" if f32
                            else "one mixed-precision GMFlow step")
            + f" (B = {FLOW_B}, {FLOW_HW[0]}x{FLOW_HW[1]})",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r["library"], "off_f64": r["off_f64"],
            "plain_off_f64": r["plain_off_f64"],
            "peak_extra_bytes": r["peak_extra_bytes"],
            "peak_limit_bytes": r["peak_limit_bytes"],
            "precision": r["precision"], "reference_ms": r["reference_ms"],
            "reference": r["reference"],
            **{k: r[k] for k in ("device_ms", "reference_device_ms",
                                 "device_kernels", "device_refused")
               if k in r},
            "dtype": dname, "status": "ported"})
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
            "device_kernels": r["device_kernels"],
            "device_refused": r["device_refused"],
            "dtype": dname, "status": "ported", **slice7(name, dname),
            **stage3(name, dname), **parallel(name, dname)})
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
        "unfused_ms": r["unfused_ms"], "fma_bound_ms": r["fma_bound_ms"],
        "dtype": "float32",
        "status": "ported", **slice7("mlp_fused", "float32"),
        **stage3("mlp_fused", "float32"), **parallel("mlp_fused", "float32"),
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
            "status": "ported", **k6_extra(r)})
    # K6 at the new shapes of slice 13's forms: launches at the row's shape
    # (any batch) over phase packing_levels' f32 checks or the last round
    # of its bf16 chunks, and phase gmflow_packed's calls, in its dtype
    for (label, dname), r in level_rows.items():
        src, replaces = srcs["packed_conv2x2"]
        key = r["shape_key"]
        table.append({
            "name": "packed_conv2x2", "case": label, "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": (level_shapes[dname].get(key, 0)
                         + gm_shapes[dname].get(key, 0)),
            "launches_at": key,
            "launches_of": ("packing_levels' f32 checks and gmflow_packed's "
                            "f32 call" if dname == "float32" else
                            "packing_levels' last bf16 round (8 chunks) and "
                            "gmflow_packed's 4 bf16 calls"),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": dname, "status": "ported", **k6_extra(r)})
    idle = [(t["name"], t.get("case"), t["dtype"]) for t in table
            if not t["launches"]]
    if idle:
        fail(f"kernels with no launch on their path's run: {idle}")
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                      sys.argv[5])
    else:
        main()
