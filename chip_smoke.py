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
              ms as a yardstick (the port never calls it), and the bound
  4. gmflow   flow_from_clip on a 2-frame 512x512 clip, f32: card (kernels)
              against CPU (plain versions), max|d| in pixels
  5. keep     KEEP.apply on the same clip and flows, f32: card against CPU,
              code picks teacher-forced from the CPU run; outputs and logits
  6. main     api.load_models(seed=0) -> load_device(bf16) ->
              processor(bf16).restore_face_stream(21 faces, 20 per chunk):
              faces/s, ms per 20-frame chunk and the kernel launch counts
The script exits non-zero, printing no verdict, if there is no CUDA device,
if a kernel does not build or disagrees, or if any phase fails. TF32 is off
for matmuls and convolutions, so f32 means f32.
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
KERNEL_ITERS = 20    # timed launches per kernel (a quarter for plain versions)


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
    rtol) at the shapes one 20-frame 512x512 chunk gives each kernel."""
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
    w1a, w1b = rnd(CH, HID, scale=0.05), rnd(CH, HID, scale=0.05)
    w2 = rnd(HID, CH, scale=0.05)
    gamma, beta = rnd(CH), rnd(CH)

    def sdpa(a, b_, c, m=None):
        return lambda: F.scaled_dot_product_attention(
            a[:, None], b_[:, None], c[:, None], attn_mask=m, scale=scale)

    att_fl = 2 * bw * lw * lw * CH
    glb_fl = 2 * bg * lg * lg * CH
    rows = bw * lw
    rtol = KERNEL_RTOL[dname]
    return [
        ("attention[dv128]", "attention", (q, k, v, scale),
         sdpa(q, k, v), [(2 * att_fl, peak)], 4 * q.numel() * isz, rtol),
        ("attention[dv128+bias]", "attention", (q, k, v, scale, mask),
         sdpa(q, k, v, mask_full), [(2 * att_fl, peak)],
         4 * q.numel() * isz + mask.numel() * 4, rtol),
        ("attention[dv2]", "attention", (qg, kg, vg, scale),
         sdpa(qg, kg, vg), [(glb_fl + 2 * bg * lg * lg * 2, peak)],
         (2 * qg.numel() + 2 * vg.numel()) * isz, rtol),
        # softmax and expectation stay f32 in both dtypes: f32 tolerance
        ("global_correlation_expectation", "global_correlation_expectation",
         (qg, kg, grid),
         lambda: F.scaled_dot_product_attention(qg, kg, grid_b, scale=scale),
         [(glb_fl, peak), (2 * bg * lg * lg * 2, PEAK_F32)],
         2 * qg.numel() * isz + grid.numel() * 4 + bg * lg * 2 * 4,
         KERNEL_RTOL["float32"]),
        ("mlp_fused", "mlp_fused",
         (src, msg, w1a, w1b, w2, gamma, beta, dtype == torch.bfloat16),
         None, [(6 * rows * CH * HID, peak)],
         3 * src.numel() * isz + 3 * CH * HID * isz, rtol),
    ]


def phase_kernels(torch, iters=KERNEL_ITERS):
    from comfyui_keep_torch.ops import kernels as K
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, fn_name, args, lib, flops, nbytes, rtol in kernel_cases(
                torch, dtype):
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
            say("kernel", **row)
            rows[(name, dname)] = row
            del got, ref
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
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
    from comfyui_keep_torch.models.keep import KEEP
    gen = torch.Generator().manual_seed(2)
    net = KEEP(device="cpu", generator=gen)
    net_cuda = copy.deepcopy(net).cuda()
    with torch.no_grad():
        out_c, aux_c = net.apply(x, flows=flows, return_aux=True)
        picks = aux_c["logits"].argmax(-1).reshape(1, x.shape[1], -1)
        out_g, aux_g = net_cuda.apply(
            x.cuda(), flows=tuple(f.cuda() for f in flows), return_aux=True,
            force_indices=picks.cuda())
    d = (out_g.cpu() - out_c).abs()
    lim = KEEP_ATOL + KEEP_RTOL * out_c.abs()
    dl = (aux_g["logits"].cpu() - aux_c["logits"]).abs()
    llim = KEEP_ATOL + KEEP_RTOL * aux_c["logits"].abs()
    ok = bool((d <= lim).all() and (dl <= llim).all())
    say("keep", max_abs_err=d.max().item(), logits_max_abs_err=dl.max().item(),
        atol=KEEP_ATOL, rtol=KEEP_RTOL, ok=ok)
    if not ok:
        fail("KEEP card vs CPU outside atol/rtol")


def phase_main(torch):
    from comfyui_keep_torch import api
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.utils.image import bgr_u8_to_rgb_pm1
    pack = api.load_models(seed=0).load_device(torch.bfloat16)
    proc = pack.processor(dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    faces = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
             for _ in range(FRAMES + 1)]
    proc.restore_face_stream(faces[:FRAMES], max_clip_length=FRAMES)  # warm
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc.restore_face_stream(faces[:FRAMES], max_clip_length=FRAMES)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    chunk_ms = float(np.median(runs))

    K.reset_launch_counts()
    outs = proc.restore_face_stream(faces, max_clip_length=FRAMES)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    shapes_ok = (len(outs) == FRAMES + 1 and all(
        o.dtype == np.uint8 and o.shape == (512, 512, 3) for o in outs))
    # uint8 hides NaN (clip + round), so the network's float output of a
    # full chunk is checked for finiteness too, after the counts are read
    x20 = np.stack([bgr_u8_to_rgb_pm1(f) for f in faces[:FRAMES]])
    finite = bool(np.isfinite(proc.restore_clip(x20)).all())
    # per chunk that runs GMFlow: K1 13 (6 windows, 6 shifted windows with
    # the mask, 1 global flow attention), K2 6, K3 1; 2 such chunks here
    want = {"attention[dv128]": 12, "attention[dv128+bias]": 12,
            "attention[dv2]": 2, "mlp_fused": 12,
            "global_correlation_expectation": 2}
    ok = shapes_ok and finite and counts == want
    say("main", faces=len(outs), chunk_ms=chunk_ms, chunk_ms_runs=runs,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        faces_per_s=FRAMES / (chunk_ms / 1e3), launches=counts,
        expected_launches=want, outputs_uint8_512=shapes_ok, finite=finite,
        ok=ok)
    if not ok:
        fail(f"main path: launches {counts} (want {want}), shapes "
             f"{shapes_ok}, finite {finite}")
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
    x, flows = phase_gmflow(torch)
    phase_keep(torch, x, flows)
    counts = phase_main(torch)

    srcs = {"attention": ("comfyui_keep_torch/csrc/attention.cu",
                          "comfyui_keep_tpu/ops/pallas_kernels.py:210"),
            "global_correlation_expectation": (
                "comfyui_keep_torch/csrc/attention.cu",
                "comfyui_keep_tpu/ops/pallas_kernels.py:142"),
            "mlp_fused": ("comfyui_keep_torch/csrc/mlp.cu",
                          "comfyui_keep_tpu/ops/pallas_kernels.py:296")}
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
            "dtype": dname, "status": "ported"})
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
