#!/usr/bin/env python3
"""The design choices of K1 / K3's f32 backward (csrc/attention_bwd.cu,
3xTF32 on the tensor cores), measured against their alternatives on one
NVIDIA GPU.

    python3 tools/torch_attention_bwd_variants.py [--rounds 2]

Builds the port's kernels, then each variant of attention_bwd.cu from a
patched copy of csrc/ under build/bwd_variants/<name>/ (one nvcc per
variant, all at once):
  * chains_1: every hi x hi chain of S = Q K^T and dP = dO V^T one k step
    (8 terms) long before its f32 add (the source: 2, 4, 4 for the 2-wide
    forms' S);
  * chains_16: the hi x hi chains over the whole 128-deep row, each sum
    carried through every mma of the product;
  * split_cvt: the TF32 split's hi by cvt.rna.tf32.f32;
  * split_trunc: hi by the truncating mask alone;
  * split_fp: hi by Veltkamp's split on the FP32 pipe.
Each variant's f32 backward, and the source's f32 and bf16 ones, then runs
on the GMFlow training step's shapes (chip_smoke.flow_step_cases: windows
of 768 tokens ± the shifted mask, B = 64; the global flow attention and
the correlation, B = 8, L = 3072) and on small ragged shapes with a random
0 / -100 mask (as tests/test_torch_kernels_cuda.py's): each gradient's
distance to the float64 autograd of the plain version over the plain
backward's own distance (chip_smoke.BWD_RATIO = 3 is the gate), two calls
bitwise equal, and ms a call on CUDA events (--rounds rounds, variants in
turns). One JSON line a row, also into chiprun_out/bwd_variants.jsonl;
the card's name and power limit first.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "comfyui_keep_torch", "csrc")
CHAINS = "constexpr int kSChain = 2, kDpChain = 4, kSChainNarrow = 4;"
SPLIT = "  hi = (x + 0x1000u) & 0xffffe000u;\n"
# name: [(file, text in the source, its replacement)]
VARIANTS = {
    "chains_1": [("attention_bwd.cu", CHAINS, CHAINS.replace("2, kDpChain = 4",
                                                             "1, kDpChain = 1")
                  .replace("Narrow = 4", "Narrow = 1"))],
    "chains_16": [("attention_bwd.cu", CHAINS,
                   "constexpr int kSChain = 16, kDpChain = 16, "
                   "kSChainNarrow = 16;")],
    "split_cvt": [("sm90.cuh", SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;\\n" '
                   ': "=r"(hi) : "f"(__uint_as_float(x)));\n')],
    "split_trunc": [("sm90.cuh", SPLIT, "  hi = x & 0xffffe000u;\n")],
    "split_fp": [("sm90.cuh", SPLIT,
                  "  {\n    const float xf = __uint_as_float(x);\n"
                  "    const float g = __fmul_rn(xf, 8193.f);\n"
                  "    hi = __float_as_uint(__fadd_rn(g, __fsub_rn(xf, g)));"
                  "\n  }\n")],
}
# (B, L, form) of the ragged rows
RAGGED = [(4, 200, "window+bias"), (2, 129, "window+bias"),
          (4, 256, "window+bias"), (4, 1000, "window+bias"),
          (4, 200, "window"), (2, 16, "window"), (2, 16, "global"),
          (2, 129, "global"), (2, 129, "corr")]


def build_variants(_build):
    """{name: (Popen, library path)}: each variant's nvcc, started."""
    procs = {}
    for name, patches in VARIANTS.items():
        d = os.path.join(ROOT, "build", "bwd_variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        for fn, old, new in patches:
            path = os.path.join(d, fn)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        out = os.path.join(d, "libattention_bwd.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(d, "attention_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    return procs


def load(_build, path):
    lib = ctypes.CDLL(path)
    for fn, argtypes in _build._SIGNATURES["attention_bwd"].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def ragged_case(torch, form, b, l):
    """A wrapper's arguments at (b, l) as the card test makes them."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device="cuda")

    if form == "corr":
        grid = torch.rand(l, 2, generator=g, device="cuda") * 16
        return "global_correlation_expectation", (r(b, l, 128), r(b, l, 128),
                                                  grid)
    dv = 2 if form == "global" else 128
    bias = (torch.where(torch.rand(2, l, l, generator=g, device="cuda") < 0.3,
                        -100.0, 0.0) if form == "window+bias" else None)
    return "attention", (r(b, l, 128), r(b, l, 128), r(b, l, dv), 0.088, bias)


def prepare(torch, cs, K, fn_name, args):
    """(args, saved statistics, upstream gradient, float64 reference
    gradients on the host, the plain backward's distances to them)."""
    if fn_name == "attention" and len(args) == 4:
        args = tuple(args) + (None,)
    fwd = K.LAUNCHERS[fn_name][0]
    saved = fwd(*args)
    g = torch.Generator(device="cuda").manual_seed(5)
    up = torch.randn(saved[0].shape, generator=g,
                     device="cuda").to(saved[0].dtype)
    diff = cs.GRAD_ARGS[fn_name]
    a64 = [x.detach().double().requires_grad_(i in diff)
           if torch.is_tensor(x) else x for i, x in enumerate(args)]
    ref = [r.cpu() for r in torch.autograd.grad(
        K.PLAIN[fn_name](*a64), [a64[i] for i in diff], up.double())]
    del a64
    want = K.PLAIN_BACKWARD[fn_name](*args, *saved, up)
    p_off = [off(x, r) for x, r in zip(want, ref)]
    del want
    torch.cuda.empty_cache()
    return args, saved, up, ref, p_off


def off(x, r):
    return ((x.double().cpu() - r).abs().max() / r.abs().max()).item()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures kernels on a GPU")
    import chip_smoke as cs
    from comfyui_keep_torch.ops import _build, kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_path = os.path.join(ROOT, "chiprun_out", "bwd_variants.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    sink = open(out_path, "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        sink.write(line + "\n")

    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()})
    procs = build_variants(_build)
    libs = {"source": _build.library("attention_bwd")}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = load(_build, path)
        emit({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill stores" in ln]})

    steps = []
    for name, fn_name, args, *_ in cs.flow_step_cases(torch):
        if fn_name == "mlp_fused":
            continue
        for dtype in (torch.float32, torch.bfloat16):
            a = (args if dtype == torch.float32
                 else cs.bf16_args(torch, fn_name, args))
            steps.append((name, str(dtype).split(".")[-1], fn_name,
                          *prepare(torch, cs, K, fn_name, a)))
    ragged = [(f"{form} B{b} L{l}", "float32", fn_name,
               *prepare(torch, cs, K, fn_name, args))
              for b, l, form in RAGGED
              for fn_name, args in [ragged_case(torch, form, b, l)]]
    try:
        for rnd in range(opts.rounds):
            for vname, lib in libs.items():
                _build._libs["attention_bwd"] = lib
                cases = [(True, c) for c in steps]
                if rnd == 0:
                    cases += [(False, c) for c in ragged]
                for timed, case in cases:
                    name, dname, fn_name, args, saved, up, ref, p_off = case
                    if dname == "bfloat16" and vname != "source":
                        continue
                    bwd = K.LAUNCHERS[fn_name][1]
                    got = bwd(*args, *saved, up)
                    again = bwd(*args, *saved, up)
                    torch.cuda.synchronize()
                    ratio = [off(x, r) / p for x, r, p in
                             zip(got, ref, p_off)]
                    bitwise = all(torch.equal(x, y)
                                  for x, y in zip(got, again))
                    k_off = [q * p for q, p in zip(ratio, p_off)]
                    del got, again
                    row = {"round": rnd, "variant": vname, "case": name,
                           "dtype": dname, "ratio": ratio,
                           "ok": bitwise and all(
                               k <= max(cs.BWD_RATIO * p, cs.BWD_FLOOR)
                               for k, p in zip(k_off, p_off))}
                    if timed:
                        row["ms"] = cs.time_ms(
                            torch, lambda: bwd(*args, *saved, up), 20)
                    emit(row)
    finally:
        _build._libs["attention_bwd"] = libs["source"]
        sink.close()


if __name__ == "__main__":
    main()
