#!/usr/bin/env python3
"""K6 (the phase-packed convolution, `packed_conv2x2`) of the PyTorch port on
one NVIDIA GPU: its bf16 (or, with --dtype float32, f32) form at every shape
of chip_smoke.py's K6_CASES and K6_LEVEL_CASES, timed in turns against
cuDNN and, with --root, against another checkout's kernel.

    python3 tools/torch_k6_check.py [--root DIR] [--dtype float32]
                                    [--rounds N] [--iters N] [--only TEXT]
                                    [--tiles] [--host] [--out FILE]

Builds this checkout's kernels and prints the ptxas lines of every
packed_conv.cu kernel. With --root it also builds DIR's kernels (e.g. a
parent commit unpacked by `git archive` under build/) into DIR/build/kernels
and loads DIR's ops/kernels.py beside this checkout's. At each shape (--only
keeps the labels that contain TEXT) it holds this kernel's output, and
DIR's, against the plain version within chip_smoke.py's KERNEL_RTOL x the
plain output's spread; then runs `rounds` rounds, each timing this kernel,
DIR's and cuDNN's conv2d on the same packed tensor (channels-last, as
chip_smoke.py's rows time it) by CUDA events over `iters` launches, in an
order that turns each round; and prints the medians beside the bound,
this checkout's plan (`packed_conv_plan`) and the profiler's device time
of this kernel, of DIR's and of cuDNN (chip_smoke.py's paired_device_ms:
each kernel beside cuDNN in one trace, its device kernels apart, their
least and largest share of a call in the summary; the events time the
host too where it is the slower). f32 runs cuDNN with TF32 off (the
plain version's precision) and gives the bound at 3xTF32 (chip_smoke.py's F32_TC) with the FMA pipe's
beside it. With --tiles, each tile of PACKED_CONV_TILES (f32:
PACKED_CONV_F32_TILES), forced through the plan, is timed too (device and
event ms). With --host, the host's
time a call (the best of 5 runs of 300 calls at a small shape, the card
idle between them) of this wrapper, DIR's and cuDNN's conv2d comes first.
Last, over the shapes the TMA kernels
take (bf16: Cin and Cout multiples of 8; f32: every shape), the geometric
mean and the
largest of kernel / cuDNN, K6's own shape's ratio, and the same over the
rest. Prints the card's name and power limit first; each row also goes to
--out (default chiprun_out/k6_check.jsonl); exits 1 if a kernel disagrees
with its plain version.
"""
import argparse
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_kernels(root):
    """DIR's ops/kernels.py as a module of its own, bound to DIR's _build
    (which builds DIR's csrc into DIR/build/kernels): the import of
    comfyui_keep_torch.ops._build resolves to DIR's while it loads."""
    ops = os.path.join(root, "comfyui_keep_torch", "ops")
    build = load_module("k6_other_build", os.path.join(ops, "_build.py"))
    key = "comfyui_keep_torch.ops._build"
    mine = sys.modules[key]
    sys.modules[key] = build
    try:
        return build, load_module("k6_other_kernels",
                                  os.path.join(ops, "kernels.py"))
    finally:
        sys.modules[key] = mine


def ptxas_lines(build_log):
    out = []
    log = build_log.get("packed_conv", "").splitlines()
    for i, ln in enumerate(log):
        if "Compiling entry function" in ln:
            stats = [x.strip() for x in log[i + 1:i + 4]
                     if "spill" in x or "registers" in x]
            out.append({"kernel": ln.split("'")[1], "ptxas": stats})
    return out


def cases(cs):
    """(label, B, Hi, Cin, Cout, kh, kw, pads) of both case lists."""
    for label, b, hi, cin, cout, pads, _ in cs.K6_CASES:
        yield label, b, hi, cin, cout, 2, 2, pads
    yield from cs.K6_LEVEL_CASES


def tile_times(torch, cs, K, x, w, pads, iters):
    """{"BMxBN": [device ms, event ms]} of every TMA tile of x's dtype,
    each forced through the plan (the same persistent grid and ring depth
    rule)."""
    real, real_call = K.packed_conv_plan, K._packed_conv_call
    b, hi, wi, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pads
    m = b * (hi + pt + pb - kh + 1) * (wi + pl + pr - kw + 1)
    out = {}
    try:
        f32 = x.dtype == torch.float32
        for bm, bn in (K.PACKED_CONV_F32_TILES if f32 else K.PACKED_CONV_TILES):
            plan = K._tma_plan(m, cout, bm, bn, K.H100_SMS, x.dtype)
            K.packed_conv_plan = lambda *a, **k: plan
            # the wrapper caches its arguments a geometry: a fresh cache
            K._packed_conv_call = functools.lru_cache()(real_call.__wrapped__)
            fn = lambda: K.packed_conv2x2(x, w, pads)
            out[f"{bm}x{bn}"] = [cs.device_ms(torch, fn, iters),
                                 cs.time_ms(torch, fn, iters)]
    finally:
        K.packed_conv_plan, K._packed_conv_call = real, real_call
    return out


def host_times(torch, F, K, other, g):
    """Host us a call at the generator's 65^2 res conv1 (B = 1, (65, 65,
    512) VALID 2x2 -> 512: the card takes ~16 us), the best of 5 runs of
    300 calls, the card idle before each run."""
    import time
    x = torch.randn(1, 65, 65, 512, generator=g, device="cuda").bfloat16()
    w = (torch.randn(2, 2, 512, 512, generator=g, device="cuda")
         * 0.02).bfloat16()
    xl = x.permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    valid = ((0, 0), (0, 0))
    fns = {"kernel": lambda: K.packed_conv2x2(x, w, valid),
           "cudnn": lambda: F.conv2d(xl, wl)}
    if other is not None:
        fns["root"] = lambda: other.packed_conv2x2(x, w, valid)
    out = {}
    for name, fn in fns.items():
        for _ in range(30):
            fn()
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(300):
                fn()
            best = min(best, (time.perf_counter() - t) / 300 * 1e6)
        torch.cuda.synchronize()
        out[name] = best
    return out


def geomean(xs):
    return math.exp(sum(math.log(v) for v in xs) / len(xs)) if xs else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout whose kernel is timed in turns")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default=None)
    ap.add_argument("--tiles", action="store_true",
                    help="also time every tile at each shape")
    ap.add_argument("--host", action="store_true",
                    help="first the host's time a call at a small shape")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "k6_check.jsonl"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script checks the kernel on a GPU")
    dt = getattr(torch, args.dtype)
    # f32: cuDNN and the plain version in full f32, as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = load_module("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    from comfyui_keep_torch.ops import _build, kernels as K
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sink = open(args.out, "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    emit({"card": card, "root": args.root, "dtype": args.dtype})
    _build.build_all()
    for row in ptxas_lines(_build.build_log):
        emit(row)
    other = None
    if args.root:
        obuild, other = other_kernels(os.path.abspath(args.root))
        obuild.build_all()
        for row in ptxas_lines(obuild.build_log):
            emit({"root": args.root, **row})

    g = torch.Generator(device="cuda").manual_seed(25)
    if args.host:
        emit({"host_us_a_call": host_times(torch, F, K, other, g),
              "card": card})
    bad, rows = [], []
    for label, b, hi, cin, cout, kh, kw, pads in cases(cs):
        if args.only and args.only not in label:
            continue
        x = torch.randn(b, hi, hi, cin, generator=g,
                        device="cuda").to(dt)
        w = (torch.randn(kh, kw, cin, cout, generator=g, device="cuda")
             / math.sqrt(kh * kw * cin)).to(dt)
        ref = K.packed_conv2x2_plain(x, w, pads).float()
        tol = cs.KERNEL_RTOL[args.dtype] * (ref - ref.mean()).abs().max()
        fns = {"kernel": lambda: K.packed_conv2x2(x, w, pads)}
        if other is not None:
            fns["root"] = lambda: other.packed_conv2x2(x, w, pads)
        errs = {}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            errs[name] = (got.float() - ref).abs().max().item()
            if not errs[name] <= tol.item():
                bad.append(f"{label} ({name})")
            del got
        (pt, pb), (pl, pr) = pads
        xl = x.permute(0, 3, 1, 2)
        sym = pt
        if pt != pb or pl != pr:
            xl, sym = F.pad(xl, (pl, pr, pt, pb)), 0
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        fns["cudnn"] = lambda: F.conv2d(xl, wl, padding=sym)
        times = {k: [] for k in fns}
        for r in range(args.rounds):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[k].append(cs.time_ms(torch, fns[k], args.iters))
        ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        ho, wo = hi + pt + pb - kh + 1, hi + pl + pr - kw + 1
        out_n = b * ho * wo * cout
        flops = 2 * out_n * kh * kw * cin
        op_s = (flops / cs.PEAK_BF16 if dt == torch.bfloat16
                else cs.op_seconds([(flops, cs.F32_TC)]))
        byte_s = x.element_size() * (x.numel() + w.numel() + out_n) / cs.HBM
        # each kernel beside cuDNN in one profiler trace, its device
        # kernels apart (paired_device_ms)
        dev = {k: cs.paired_device_ms(
            torch, fns[k], fns["cudnn"], args.iters, 1e3 * max(op_s, byte_s),
            ms[k], ms["cudnn"]) for k in fns if k != "cudnn"}
        plan = K.packed_conv_plan(b, hi, hi, cin, cout, kh, kw,
                                  ((pt, pb), (pl, pr)), dt)
        row = {"case": label, "x": [b, hi, hi, cin], "w": [kh, kw, cin, cout],
               "pads": pads, "route": plan.route, "tile": [plan.bm, plan.bn],
               "stages": plan.stages, "tiles": plan.m_tiles * plan.n_tiles,
               "max_abs_err": errs, "tol": tol.item(),
               "ms": ms["kernel"], "root_ms": ms.get("root"),
               "cudnn_ms": ms["cudnn"], "device_ms": dev["kernel"]["kernel"],
               "cudnn_device_ms": dev["kernel"]["other"],
               "device_kernels": dev["kernel"]["kernels"],
               "device_refused": dev["kernel"]["refused"],
               "root_device_ms": dev["root"]["kernel"] if "root" in dev
               else None,
               "root_device_kernels": dev["root"]["kernels"] if "root" in dev
               else None,
               "root_device_refused": dev["root"]["refused"] if "root" in dev
               else None,
               "bound_ms": 1e3 * max(op_s, byte_s),
               "fma_bound_ms": None if dt == torch.bfloat16 else 1e3 * max(
                   cs.op_seconds([(flops, cs.F32_TC)], fma=True), byte_s),
               "over_cudnn": ms["kernel"] / ms["cudnn"],
               "over_root": (ms["kernel"] / ms["root"]) if "root" in ms
               else None, "runs": times, "card": card}
        if args.tiles and plan.route in ("tma", "tf32"):
            row["tiles_ms"] = tile_times(torch, cs, K, x, w, pads, args.iters)
        emit(row)
        rows.append(row)
        del x, w, ref, xl, wl
        torch.cuda.empty_cache()

    def shares(sel, key):
        """{device kernel: [least, largest] share of its call's device
        time} over the rows"""
        out = {}
        for x in sel:
            per = x[key] or {}
            for name, t in per.items():
                f = t / sum(per.values())
                lo, hi = out.get(name, [f, f])
                out[name] = [min(lo, f), max(hi, f)]
        return out

    def summary(sel):
        r = [x["over_cudnn"] for x in sel]
        return {"rows": len(r), "geomean_over_cudnn": geomean(r),
                "max_over_cudnn": max(r) if r else None,
                "geomean_over_root": geomean([x["over_root"] for x in sel
                                              if x["over_root"]]),
                "kernel_shares": shares(sel, "device_kernels"),
                "root_kernel_shares": shares(sel, "root_device_kernels")}
    tma = [x for x in rows if x["route"] in ("tma", "tf32")]
    own = [x for x in rows if x["case"] == cs.K6_OWN]
    emit({"tma_rows": summary(tma),
          "other_rows": summary([x for x in rows
                                 if x["route"] not in ("tma", "tf32")]),
          "k6_own_over_cudnn": own[0]["over_cudnn"] if own else None,
          "ok": not bad, "disagree": bad, "card": card})
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
