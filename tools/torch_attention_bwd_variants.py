#!/usr/bin/env python3
"""The design choices of K1 / K3's backward (csrc/attention_bwd.cu),
measured against their alternatives on one NVIDIA GPU.

    python3 tools/torch_attention_bwd_variants.py [--rounds 2] [--only a,b]

Builds the port's kernels, then each variant of attention_bwd.cu from a
patched copy of csrc/ under build/bwd_variants/<name>/ (one nvcc per
variant, all at once). Every form runs on wgmma (`attn_bwd_kernel`):
  * fchain_2, fchain_16: the f32 wgmma kernel's hi x hi chains of S = Q
    K^T and dP = dO V^T (bwf_scores, the source: kFChain = 4 k steps of 8
    terms) 2 or 16 k steps (the whole 128-deep row) long before each f32
    add;
  * fsets_2: two sets of A fragment registers in bwf_scores, one k step
    in flight while the next one's fragments load (the source: three
    sets, two k steps in flight);
  * split_cvt, split_trunc, split_fp: the TF32 split's hi (split_tf32:
    the f32 producer's split of the streamed tiles) by cvt.rna.tf32.f32,
    by the truncating mask alone, or by Veltkamp's split on the FP32 pipe;
  * bf16_stages2: the bf16 wgmma kernel without a mask in two stages of
    its streamed tiles (the source: three);
  * bf16_regs_240: the bf16 warpgroups' registers at 24 / 240 (producer /
    consumers; the source: 40 / 232);
  * f32_consumers_alone: a diagnostic, times only (its gradients are
    wrong): the f32 producer loads and splits the first two tiles and then
    hands their stages out again, so the consumers run without waiting
    for TMA or the split;
  * f32_dq_alone, f32_dkdv_alone, bf16_dq_alone, bf16_dkdv_alone:
    diagnostics, times only: the kernel's blocks of the other side return
    at once.
The variants that patched the earlier mma.sync kernel went with that code.
Each variant's backward (f32, and bf16 where it changes bf16), and the
source's in both dtypes, then runs on the
GMFlow training step's shapes (chip_smoke.flow_step_cases: windows of 768
tokens +- the shifted mask, B = 64; the global flow attention and the
correlation, B = 8, L = 3072) and on small ragged shapes with a random 0 /
-100 mask (as tests/test_torch_kernels_cuda.py's): each gradient's
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
FCHAIN = "constexpr int kFChain = 4, kFSets = 3;"
SPLIT = "  hi = (x + 0x1000u) & 0xffffe000u;\n"
STAGES = "  static constexpr int stages = F::BIAS ? 2 : 3;\n"
PRODUCER_TOP = "    unsigned char* st = smem + S::st0 + s * S::stage;\n"
TMA_NEXT = "      if (p == 0) issue(j + 1);\n"
F32_BLOCK = "    using S = BwF<F, false>;\n"
BF16_BLOCK = "    using S = BwW<F>;\n"
BF16_PRODUCER = ("    if (tid >= 256) {\n      sm90::setmaxnreg_dec<40>();\n"
                 "      if (kv)\n        bw_produce<")
BF16_CONSUMER = "    sm90::setmaxnreg_inc<232>();\n    if (kv)\n      bw_consume<"
# name: ([(file, text in the source, its replacement)], dtypes it changes)
VARIANTS = {
    "fchain_2": ([("attention_bwd.cu", FCHAIN,
                   FCHAIN.replace("kFChain = 4", "kFChain = 2"))],
                 ("float32",)),
    "fchain_16": ([("attention_bwd.cu", FCHAIN,
                    FCHAIN.replace("kFChain = 4", "kFChain = 16"))],
                  ("float32",)),
    "fsets_2": ([("attention_bwd.cu", FCHAIN,
                  FCHAIN.replace("kFSets = 3", "kFSets = 2"))],
                ("float32",)),
    "split_cvt": ([("sm90.cuh", SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;\\n" '
                    ': "=r"(hi) : "f"(__uint_as_float(x)));\n')],
                  ("float32",)),
    "split_trunc": ([("sm90.cuh", SPLIT, "  hi = x & 0xffffe000u;\n")],
                    ("float32",)),
    "split_fp": ([("sm90.cuh", SPLIT,
                   "  {\n    const float xf = __uint_as_float(x);\n"
                   "    const float g = __fmul_rn(xf, 8193.f);\n"
                   "    hi = __float_as_uint(__fadd_rn(g, __fsub_rn(xf, g)));"
                   "\n  }\n")], ("float32",)),
    "bf16_stages2": ([("attention_bwd.cu", STAGES,
                       STAGES.replace("3", "2"))], ("bfloat16",)),
    "f32_consumers_alone": ([
        ("attention_bwd.cu", PRODUCER_TOP, PRODUCER_TOP +
         "    if (j >= NS) {\n"
         "      sm90::mbar_wait(bar(S::empty + s), (j / NS - 1) & 1);\n"
         "      sm90::mbar_arrive(bar(S::full + s));\n"
         "      continue;\n    }\n"),
        ("attention_bwd.cu", TMA_NEXT,
         TMA_NEXT.replace("p == 0", "p == 0 && j + 1 < NS"))],
        ("float32",)),
    "f32_dq_alone": ([("attention_bwd.cu", F32_BLOCK,
                       "    if (kv) return;\n" + F32_BLOCK)], ("float32",)),
    "f32_dkdv_alone": ([("attention_bwd.cu", F32_BLOCK,
                         "    if (!kv) return;\n" + F32_BLOCK)],
                       ("float32",)),
    "bf16_dq_alone": ([("attention_bwd.cu", BF16_BLOCK,
                        "    if (kv) return;\n" + BF16_BLOCK)],
                      ("bfloat16",)),
    "bf16_dkdv_alone": ([("attention_bwd.cu", BF16_BLOCK,
                          "    if (!kv) return;\n" + BF16_BLOCK)],
                        ("bfloat16",)),
    "bf16_regs_240": ([("attention_bwd.cu", BF16_PRODUCER,
                        BF16_PRODUCER.replace("<40>", "<24>")),
                       ("attention_bwd.cu", BF16_CONSUMER,
                        BF16_CONSUMER.replace("<232>", "<240>"))],
                      ("bfloat16",)),
}
# (B, L, form) of the ragged rows
RAGGED = [(4, 200, "window+bias"), (2, 129, "window+bias"),
          (4, 256, "window+bias"), (4, 1000, "window+bias"),
          (4, 200, "window"), (2, 16, "window"), (2, 16, "global"),
          (2, 129, "global"), (2, 129, "corr")]


def build_variants(_build, names):
    """{name: (Popen, library path)}: each named variant's nvcc, started."""
    procs = {}
    for name in names:
        patches = VARIANTS[name][0]
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
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="the variants to build and run, comma-separated")
    opts = ap.parse_args()
    names = [n for n in opts.only.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
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
    procs = build_variants(_build, names)
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
                    if vname != "source" and dname not in VARIANTS[vname][1]:
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
