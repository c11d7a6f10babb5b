#!/usr/bin/env python3
"""The design choices of K2's backward (csrc/mlp.cu: the LayerNorm's
backward; bf16, row blocks for d[src | msg] and weight blocks for dW1 /
dW2 in one grid; f32, the AH, DX and W launches of mlp_bwd_gemm_kernel; a
fixed-order reduce), measured against their alternatives on one NVIDIA
GPU.

    python3 tools/torch_mlp_bwd_variants.py [--rounds 2] [--only a,b]

Builds mlp.cu as it is and each variant of it from a patched copy of csrc/
under build/mlp_variants/<name>/ (one nvcc each, all at once; the wrapper
sizes its scratch by the loaded library's keep_mlp_fused_bwd_scratch, so
a variant's tiling needs no change in ops/kernels.py):
  * slice_1024, slice_4096: a weight product sums over slices of 1,024 or
    4,096 rows (the source: 2,048);
  * f32_bn64: the f32 DX and W launches in 64-wide tiles (the source:
    128; AH is 64 wide in both, as it holds two accumulators);
  * f32_ring_3: every f32 launch's ring holds 3 K steps (the source: AH
    5, DX and W 4);
  * uncached: the f32 launcher encodes its 14 tensor maps and sets its
    kernels' shared-memory attribute at every call (the source: from
    sm90.cuh's TmaMapCache, once a device): the host's us a call;
  * ln_rows_32: the LayerNorm's backward takes 32 rows a block (the
    source: 128);
  * rows_only, weights_only: the bf16 grid's row blocks, or its weight
    blocks, alone (timing only: their gradients are not whole).
Each variant's backward then runs at the GMFlow training step's shape
(49,152 rows, C = 128, H = 1024: bf16 with the tanh gelu, f32 with erf, on
chip_smoke.flow_step_cases' values) and at small ragged shapes: each
gradient's distance to the float64 autograd of the plain version over the
plain backward's own (chip_smoke.BWD_RATIO = 3 is the gate), two calls
bitwise equal, the bytes a call allocates at its peak, ms a call on CUDA
events (--rounds rounds, variants in turns) and each device kernel's
time in one call (torch.profiler: f32's AH, DX and W launches apart) and
the host's us a call (the wrapper, its tensor maps and launches).
One JSON line a row, also into
chiprun_out/mlp_bwd_variants.jsonl; the card's name and power limit first.
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
GRID = "  kb<<<nwb + nrb, kGThreads, S::launch_bytes, stream>>>(a);\n"
GMAP = ("  return sm90::tma_maps<128>().get(\n"
        "      {(long long)base, d, rows, box_rows, ld, 0, 0, 0}, m,\n"
        "      [&](CUtensorMap* mm) {\n"
        "        return sm90::tma_map_f32(mm, base, d, rows, 1, box_rows, "
        "ld);\n"
        "      });\n")
# name: [(file, text in the source, its replacement)]
VARIANTS = {
    "slice_1024": [("mlp.cu", "constexpr int kSlice = 2048;",
                    "constexpr int kSlice = 1024;")],
    "slice_4096": [("mlp.cu", "constexpr int kSlice = 2048;",
                    "constexpr int kSlice = 4096;")],
    "f32_bn64": [("mlp.cu", "static constexpr int BN = MODE == kModeAH ? 64 "
                  ": 128;", "static constexpr int BN = 64;")],
    "f32_ring_3": [("mlp.cu", "static constexpr int stages = MODE == kModeAH "
                    "? 5 : 4;", "static constexpr int stages = 3;")],
    "uncached": [("mlp.cu", GMAP, "  return sm90::tma_map_f32(m, base, d, "
                  "rows, 1, box_rows, ld);\n"),
                 ("mlp.cu", "  if (sm_count[dev] == 0) {", "  {")],
    "ln_rows_32": [("mlp.cu", "constexpr int kLnRows = 128;",
                    "constexpr int kLnRows = 32;")],
    "rows_only": [("mlp.cu", GRID, "  a.nwb = 0;\n  kb<<<nrb, kGThreads, "
                   "S::launch_bytes, stream>>>(a);\n")],
    "weights_only": [("mlp.cu", GRID, "  kb<<<nwb, kGThreads, "
                      "S::launch_bytes, stream>>>(a);\n")],
}
DIAGNOSTIC = ("rows_only", "weights_only")
# (rows, H, gelu) of the ragged rows, in both dtypes
RAGGED = [(1, 64, True), (1, 512, False), (1, 1024, True), (3, 512, True),
          (129, 1024, False), (5000, 512, True)]


def build_variants(_build, names):
    """{name: (Popen, library path)}: each variant's nvcc, started."""
    procs = {}
    for name in names:
        d = os.path.join(ROOT, "build", "mlp_variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        for fn, old, new in VARIANTS.get(name, []):
            path = os.path.join(d, fn)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        out = os.path.join(d, "libmlp.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(d, "mlp.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    return procs


def load(_build, path):
    lib = ctypes.CDLL(path)
    for fn, argtypes in _build._SIGNATURES["mlp"].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def ptxas(log):
    """The backward kernels' registers and spills from nvcc's report."""
    keep, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and ("bwd" in name or "gemm" in name) and (
                "registers" in ln or "spill" in ln):
            keep.append(f"{name}: {ln.strip()}")
    return keep


def cases(torch, cs):
    """[(name, dtype name, args)]: the step's shape (chip_smoke's values)
    in both dtypes, then the ragged ones."""
    out = []
    for name, fn_name, args, *_ in cs.flow_step_cases(torch):
        if fn_name == "mlp_fused":
            out.append(("step", "float32", args))
            out.append(("step", "bfloat16", cs.bf16_args(torch, fn_name,
                                                         args)))
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows, h, tanh in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            def r(*s, scale=1.0):
                return (torch.randn(s, generator=g, device="cuda")
                        * scale).to(dtype)
            out.append((f"rows{rows} H{h}", str(dtype).split(".")[-1],
                        (r(1, rows, 128), r(1, rows, 128),
                         r(h, 256, scale=0.05), r(128, h, scale=0.05),
                         r(128), r(128), tanh)))
    return out


def prepare(torch, K, args):
    """(saved statistics, upstream gradient, float64 reference gradients on
    the host, the plain backward's distances to them)."""
    fwd = K.LAUNCHERS["mlp_fused"][0]
    saved = fwd(*args)
    g = torch.Generator(device="cuda").manual_seed(5)
    up = torch.randn(saved[0].shape, generator=g,
                     device="cuda").to(saved[0].dtype)
    a64 = [x.detach().double().requires_grad_(True)
           if torch.is_tensor(x) else x for x in args]
    ref = [r.cpu() for r in torch.autograd.grad(
        K.PLAIN["mlp_fused"](*a64), a64[:6], up.double())]
    del a64
    want = K.PLAIN_BACKWARD["mlp_fused"](*args, *saved, up)
    p_off = [off(x, r) for x, r in zip(want, ref)]
    del want
    torch.cuda.empty_cache()
    return saved, up, ref, p_off


def off(x, r):
    return ((x.double().cpu() - r).abs().max() / r.abs().max()).item()


def kernel_times(torch, fn):
    """[(kernel name, device us)] of one call, in launch order."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: e.time_range.start)
    return [(e.name.split("<")[0].split("(")[0][-40:],
             round(e.device_time if hasattr(e, "device_time")
                   else e.cuda_time, 2)) for e in ev]


def host_us(torch, fn, calls=20):
    """Host us a call: the best of 5 runs of `calls` calls queued without a
    wait (the card is slower at the step's shape, so the runs time the
    wrapper and its launches alone)."""
    import time
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures kernels on a GPU")
    import chip_smoke as cs
    from comfyui_keep_torch.ops import _build, kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_path = os.path.join(ROOT, "chiprun_out", "mlp_bwd_variants.jsonl")
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
    names = [n for n in VARIANTS if not opts.only
             or n in opts.only.split(",")]
    procs = build_variants(_build, ["source"] + names)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = load(_build, path)
        emit({"variant": name, "ptxas": ptxas(log)})

    prepared = [(n, d, a, *prepare(torch, K, a)) for n, d, a in
                cases(torch, cs)]
    bwd = K.LAUNCHERS["mlp_fused"][1]
    try:
        for rnd in range(opts.rounds):
            for vname, lib in libs.items():
                _build._libs["mlp"] = lib
                for name, dname, args, saved, up, ref, p_off in prepared:
                    step = name == "step"
                    if rnd and not step:
                        continue
                    if vname in DIAGNOSTIC and dname == "float32":
                        continue
                    call = lambda: bwd(*args, *saved, up)  # noqa: E731
                    torch.cuda.synchronize()
                    before = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    got = call()
                    torch.cuda.synchronize()
                    extra = torch.cuda.max_memory_allocated() - before
                    again = call()
                    torch.cuda.synchronize()
                    k_off = [off(x, r) for x, r in zip(got, ref)]
                    bitwise = all(torch.equal(x, y)
                                  for x, y in zip(got, again))
                    del got, again
                    row = {"round": rnd, "variant": vname, "case": name,
                           "dtype": dname,
                           "ratio": [k / max(p, cs.BWD_FLOOR)
                                     for k, p in zip(k_off, p_off)],
                           "peak_extra_bytes": extra,
                           "ok": vname in DIAGNOSTIC or bitwise and all(
                               k <= max(cs.BWD_RATIO * p, cs.BWD_FLOOR)
                               for k, p in zip(k_off, p_off))}
                    if step:
                        row["ms"] = cs.time_ms(torch, call, 20)
                        if rnd == 0:
                            row["kernels_us"] = kernel_times(torch, call)
                            row["host_us"] = host_us(torch, call)
                    emit(row)
                    torch.cuda.empty_cache()
    finally:
        _build._libs.pop("mlp", None)
        sink.close()


if __name__ == "__main__":
    main()
