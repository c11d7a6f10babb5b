#!/usr/bin/env python3
"""K1's dense bf16 forward (`flash_attention_bf16_kernel`, csrc/attention.cu)
and K2's bf16 forward (`mlp_fused_bf16_kernel`, csrc/mlp.cu) of the PyTorch
port on one NVIDIA GPU: a short check for a changed forward kernel, and
their times at every shape of the path.

    python3 tools/torch_forward_check.py [--root DIR] [--no-check]
                                         [--iters 50]

Builds the kernels (`comfyui_keep_torch/ops/_build.py`) and prints the card's
name and power limit and the ptxas registers, spills and warnings of the
two kernels. Unless --no-check, it then holds both against their plain
versions at the tiles' edges (K1: L from 16 to 1024 across the 64-, 128-
and 192-row and 128-key edges, unmasked, under a (4, L, L) 0 / -100 mask,
a per-batch bias and a bias at an address off the 16-byte grid, random
and peaked keys; its lse against attention_stats_plain's; K2: rows across
the 64- and 128-row edges, H = 64, 128 and 1024, both gelus) and checks
that two launches are bitwise equal. Tolerances are chip_smoke.py's: bf16
1.6e-2 of max(1, max|plain|), lse 1e-4 of max(1, max|lse|). Last, it
times each form at the path's shapes (CUDA events, --iters launches after
a warm-up): K1 unmasked and masked at one 20-frame chunk (B = 152, L =
1024), a group of two (B = 304), the refinement's fine scale (B = 256, L =
256) and the mixed-precision GMFlow step (B = 64, L = 768), beside SDPA
on the same inputs (a yardstick the port never calls) and the bound; K2
at the chunk's 155,648 rows, the group's 311,296 and the step's 49,152.
--root times another checkout's comfyui_keep_torch (e.g. a parent commit
unpacked by git archive under build/), so two commits compare in one call
to the card. Prints one JSON line per row; exits 1 if a check fails.
"""
import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
HBM = 3.35e12        # H100 SXM device memory bytes/s
RTOL, LSE_RTOL = 1.6e-2, 1e-4
EDGES = (16, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256, 257, 383,
         384, 385, 1000, 1024)
MLP_ROWS = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1000)
# (name, B, L, the shifted-window mask's (feature h, w, split)) of the path
ATTN_SHAPES = (("chunk", 152, 1024, (64, 64, 2)),
               ("G2", 304, 1024, (64, 64, 2)),
               ("L256", 256, 256, (128, 128, 8)),
               ("step", 64, 768, (48, 64, 2)))
MLP_SHAPES = (("chunk", 155648), ("G2", 311296), ("step", 49152))


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1.0)).item()


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
    """chip_smoke.py's peaked keys: key perm[i] = strength * q[i] + noise."""
    perm = torch.randperm(q.shape[1], generator=g, device=q.device)
    k = torch.empty_like(q)
    k[:, perm] = (strength * q.float() + torch.randn(
        q.shape, generator=g, device=q.device)).to(q.dtype)
    return k


def checks(torch, K):
    """[(what, error, tolerance)] at the tiles' edges."""
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    out = []

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    for l in EDGES:
        b = 8
        q, v = rnd(b, l, 128), rnd(b, l, 128, scale=4.0)
        k = matched_keys(torch, q, 0.8, g) if l % 2 else rnd(b, l, 128)
        mask = torch.where(torch.rand(4, l, l, generator=g, device=dev)
                           > 0.5, 0.0, -100.0)
        per_batch = torch.randn(b, l, l, generator=g, device=dev) * 3.0
        off = torch.empty(4 * l * l + 1, device=dev)[1:].view(4, l, l)
        off.copy_(mask)
        for what, m in (("none", None), ("mask", mask),
                        ("per_batch", per_batch), ("off_grid", off)):
            got = K.attention(q, k, v, 0.088, m)
            again = K.attention(q, k, v, 0.088, m)
            torch.cuda.synchronize()
            ref = K.attention_plain(q, k, v, 0.088, m)
            out.append((f"attention L={l} bias={what}", rel_err(got, ref),
                        RTOL))
            out.append((f"attention L={l} bias={what} repeat",
                        0.0 if torch.equal(got, again) else 1.0, 0.0))
        o2, lse = K._attention_stats_launch(q, k, v, 0.088, mask)
        torch.cuda.synchronize()
        ro, rl = K.attention_stats_plain(q, k, v, 0.088, mask)
        out.append((f"attention stats L={l} out", rel_err(o2, ro), RTOL))
        out.append((f"attention stats L={l} lse", rel_err(lse, rl),
                    LSE_RTOL))
    for h in (64, 128, 1024):
        for rows in MLP_ROWS:
            args = (rnd(1, rows, 128), rnd(1, rows, 128),
                    rnd(h, 256, scale=0.05), rnd(128, h, scale=0.05),
                    rnd(128), rnd(128))
            for tanh in (True, False):
                got = K.mlp_fused(*args, tanh)
                again = K.mlp_fused(*args, tanh)
                torch.cuda.synchronize()
                out.append((f"mlp rows={rows} H={h} tanh={tanh}",
                            rel_err(got, K.mlp_fused_plain(*args, tanh)),
                            RTOL))
                out.append((f"mlp rows={rows} H={h} tanh={tanh} repeat",
                            0.0 if torch.equal(got, again) else 1.0, 0.0))
    return out


def times(torch, K, iters):
    """One JSON-able row per form at the path's shapes."""
    import torch.nn.functional as F
    from comfyui_keep_torch.models.gmflow import shifted_window_mask
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, b, l, (fh, fw, split) in ATTN_SHAPES:
        q = torch.randn(b, l, 128, generator=g, device=dev).to(bf)
        v = torch.randn(b, l, 128, generator=g, device=dev).to(bf)
        k = matched_keys(torch, q, 0.7, g)
        mask = torch.as_tensor(shifted_window_mask(fh, fw, split),
                               device=dev)
        scale = 1.0 / math.sqrt(128)
        flops = 4 * b * l * l * 128
        for m in (None, mask):
            full = None if m is None else m.repeat(b // m.shape[0], 1,
                                                   1)[:, None].to(bf)
            ms = time_ms(torch, lambda: K.attention(q, k, v, scale, m), iters)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=full,
                scale=scale), iters)
            nbytes = 4 * q.numel() * 2 + (0 if m is None else m.numel() * 4)
            rows.append({
                "name": f"attention[dv128{'' if m is None else '+bias'}] "
                        f"{name}", "B": b, "L": l, "ms": ms,
                "library_ms": lib, "vs_library": ms / lib,
                "bound_ms": 1e3 * max(flops / PEAK_BF16, nbytes / HBM),
                "bias_l2_bytes": 0 if m is None else b * l * l * 4})
            del full
    for name, n in MLP_SHAPES:
        src = torch.randn(1, n, 128, generator=g, device=dev).to(bf)
        msg = torch.randn(1, n, 128, generator=g, device=dev).to(bf)
        w1 = (torch.randn(1024, 256, generator=g, device=dev) * 0.05).to(bf)
        w2 = (torch.randn(128, 1024, generator=g, device=dev) * 0.05).to(bf)
        gm = torch.randn(128, generator=g, device=dev).to(bf)
        bt = torch.randn(128, generator=g, device=dev).to(bf)
        ms = time_ms(torch, lambda: K.mlp_fused(src, msg, w1, w2, gm, bt,
                                                True), iters)
        flops, nbytes = 6 * n * 128 * 1024, 3 * n * 128 * 2
        rows.append({"name": f"mlp_fused {name}", "rows": n, "ms": ms,
                     "bound_ms": 1e3 * max(flops / PEAK_BF16,
                                           (nbytes + 3 * 128 * 1024 * 2)
                                           / HBM)})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose port is timed")
    ap.add_argument("--no-check", action="store_true",
                    help="times only")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script checks the kernels on a GPU")
    import comfyui_keep_torch
    from comfyui_keep_torch.ops import _build, kernels as K
    if not comfyui_keep_torch.__file__.startswith(root):
        raise RuntimeError(f"comfyui_keep_torch came from "
                           f"{comfyui_keep_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": card}), flush=True)
    _build.build_all()
    for src in ("attention", "mlp"):
        log = _build.build_log.get(src, "").splitlines()
        for i, ln in enumerate(log):
            if "Compiling entry function" in ln and (
                    "flash_attention_bf16" in ln or "mlp_fused_bf16" in ln):
                stats = [x.strip() for x in log[i + 1:i + 4]
                         if "spill" in x or "registers" in x]
                print(json.dumps({"kernel": ln.split("'")[1],
                                  "ptxas": stats}), flush=True)
        warn = [x for x in log if "arning" in x]
        if warn:
            print(json.dumps({"source": src, "warnings": warn[:20]}),
                  flush=True)
    bad = []
    if not args.no_check:
        for what, err, tol in checks(torch, K):
            if not err <= tol:
                bad.append(what)
                print(json.dumps({"check": what, "err": err, "tol": tol}),
                      flush=True)
        print(json.dumps({"checks_failed": len(bad)}), flush=True)
    for row in times(torch, K, args.iters):
        print(json.dumps({"card": card, **row}), flush=True)
    print(json.dumps({"ok": not bad, "disagree": bad}))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
