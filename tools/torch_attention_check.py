#!/usr/bin/env python3
"""K1 (attention) and K3 (global correlation expectation) of the PyTorch
port on one NVIDIA GPU: a short check for a changed attention kernel.

    python3 tools/torch_attention_check.py [--root DIR] [--backward-only]

Builds the kernels (`comfyui_keep_torch/ops/_build.py`) and prints the
ptxas registers and spills of every attention kernel. It then holds every
K1/K3 form against its plain version, in f32 and bf16, at the kernels'
tile edges (L from 16 to 4096) with random keys and with keys near the
queries (`chip_smoke.matched_keys`: a peaked softmax). The tolerances are
chip_smoke.py's: f32 1e-4 and bf16 1.6e-2 of max(1, max|plain|), and 1e-4
for K3 in both dtypes. Then it times each form at the shapes of one
20-frame chunk, as phase `kernel` of chip_smoke.py does, beside SDPA
(a yardstick the port never calls) and the bound, and names the device
kernels of each f32 SDPA call. Last, the backward kernels of K1 and K3 at
the GMFlow training step's shapes, f32 and bf16, through
chip_smoke.backward_row: off float64 against the plain backward's own
distance, bitwise repeat, peak bytes, ms beside the plain backward's and
SDPA's forward + backward and backward alone (TF32 off) and the bound.
--backward-only skips the forward rows. --root checks and times another
checkout's comfyui_keep_torch (e.g. a parent commit unpacked by git
archive under build/) with this checkout's chip_smoke.py as the harness,
so two commits' backward kernels compare in one call to the card. Prints
the card's name and power limit first; exits 1 if any form disagrees.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RTOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
LENGTHS = (16, 63, 64, 65, 127, 128, 129, 200, 1000, 1024, 4096)


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1.0)).item()


def edge_cases(torch, K, cs):
    """[(what, rel. error, tolerance)] over the tile edges, both dtypes."""
    dev = "cuda"
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for l in LENGTHS:
            for peaked in (False, True):
                for dv, bias in ((128, False), (128, True), (2, False)):
                    if dv == 128 and l == 4096:
                        continue
                    q = rnd(3, l, 128)
                    k = cs.matched_keys(torch, q, 0.8, g) if peaked \
                        else rnd(3, l, 128)
                    v = rnd(3, l, dv)
                    m = None
                    if bias:
                        m = torch.where(torch.rand(1, l, l, generator=g,
                                                   device=dev) > 0.5,
                                        0.0, -100.0)
                    got = K.attention(q, k, v, 0.088, m)
                    torch.cuda.synchronize()
                    out.append((f"attention {dname} L={l} dv={dv} "
                                f"bias={bias} peaked={peaked}",
                                rel_err(got, K.attention_plain(q, k, v,
                                                               0.088, m)),
                                RTOL[dname]))
                f0 = rnd(2, l, 128)
                f1 = cs.matched_keys(torch, f0, 0.8, g) if peaked \
                    else rnd(2, l, 128)
                grid = torch.rand(l, 2, generator=g, device=dev) * 63
                got = K.global_correlation_expectation(f0, f1, grid)
                torch.cuda.synchronize()
                out.append((f"correlation {dname} L={l} peaked={peaked}",
                            rel_err(got, K.global_correlation_expectation_plain(
                                f0, f1, grid)), RTOL["float32"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose port is checked and timed")
    ap.add_argument("--backward-only", action="store_true",
                    help="only the backward kernels' rows")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script checks the kernels on a GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
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
    for src in ("attention", "attention_bwd"):
        log = _build.build_log.get(src, "").splitlines()
        for i, ln in enumerate(log):
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
                stats = [x.strip() for x in log[i + 1:i + 4]
                         if "spill" in x or "registers" in x]
                print(json.dumps({"kernel": name, "ptxas": stats}))

    bad = []
    for what, err, tol in ([] if args.backward_only
                           else edge_cases(torch, K, cs)):
        print(f"{what}: {err:.3g} (tol {tol:g})", flush=True)
        if not err <= tol:
            bad.append(what)

    for dtype in (() if args.backward_only
                  else (torch.bfloat16, torch.float32)):
        dname = str(dtype).split(".")[-1]
        for name, fn_name, args, lib, flops, nbytes, rtol, *_ in \
                cs.kernel_cases(torch, dtype):
            if fn_name == "mlp_fused":
                continue
            fn = getattr(K, fn_name)
            got = fn(*args)
            torch.cuda.synchronize()
            ref = K.PLAIN[fn_name](*args).float()
            err = (got.float() - ref).abs().max().item()
            tol = rtol * (ref - ref.mean()).abs().max().item()
            row = {"name": name, "dtype": dname, "max_abs_err": err,
                   "tol": tol, "ms": cs.time_ms(torch, lambda: fn(*args), 20),
                   "library_ms": cs.time_ms(torch, lib, 20),
                   "bound_ms": 1e3 * max(cs.op_seconds(flops),
                                         nbytes / cs.HBM)}
            if dtype == torch.float32:
                row["library_kernels"] = cs.kernel_names(torch, lib)
            print(json.dumps(row), flush=True)
            if not err <= tol:
                bad.append(f"{name} {dname} at the path's shape")
    for name, fn_name, args, *_ in cs.flow_step_cases(torch):
        if fn_name == "mlp_fused":
            continue
        for dtype in (torch.float32, torch.bfloat16):
            a = (args if dtype == torch.float32
                 else cs.bf16_args(torch, fn_name, args))
            row = {"name": name.replace(fn_name, f"{fn_name}_bwd", 1),
                   "dtype": str(dtype).split(".")[-1],
                   **cs.backward_row(torch, fn_name, a)}
            print(json.dumps({"card": card, **row}), flush=True)
            if not row["ok"]:
                bad.append(f"{row['name']} {row['dtype']}")
    print(json.dumps({"ok": not bad, "disagree": bad}))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
