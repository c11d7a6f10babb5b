#!/usr/bin/env python3
"""The design choices of K1's dense bf16 forward (csrc/attention.cu:
flash_attention_bf16_kernel) and K2's bf16 forward (csrc/mlp.cu:
mlp_fused_bf16_kernel), measured against their alternatives on one NVIDIA
GPU.

    python3 tools/torch_forward_variants.py [--rounds 2] [--only a,b]

Copies comfyui_keep_torch/ as it is ("source") and once per variant, with
csrc/ patched, under build/forward_variants/<name>/; each copy builds its
own kernels in a process of its own:
  * two_stages: K1 unmasked with a ring of two K and two V buffers (the
    source: three);
  * pingpong: the two consumer warpgroups take turns to issue their
    products (named barriers, as FlashAttention-3 orders them); the source
    lets them run free;
  * bias_once: K1 masked loads each warp's bias rows for the first key
    tile only (timing only: the output is wrong), what the bias loads cost;
  * mlp_hidden_ss: K2's hidden product with [src | msg] read from shared
    memory (wgmma's SS form; the source holds it in registers);
  * gelu_5op: K2's tanh gelu in five FP32 operations and one tanh.approx
    (the source calls gelu_tanh_fast, which the backward's recompute
    shares).
Each copy then times K1 unmasked and masked at one 20-frame chunk's shape
(B = 152, L = 1024, the (4, L, L) shifted-window mask) and K2 at its
155,648 rows (tanh gelu) on CUDA events, --rounds rounds with the copies
in turns, and gives each output's max |kernel - plain| over chip_smoke.py's
tolerance (bf16 1.6e-2 of the plain output's spread). One JSON line a row,
also into chiprun_out/forward_variants.jsonl; the card's name and power
limit first.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "comfyui_keep_torch")
PP_ISSUE = """      sm90::wg_commit();
      sm90::wg_wait<1>();  // S landed; P V still runs
    } else {
      sm90::wg_wait<0>();
    }
"""
PP_SYNC = "    sm90::mbar_wait(bar(S::k_full + kb), (it / NS) & 1);\n"
PP_LOOP = "  for (int it = 0; it < n_tiles; ++it) {\n    // this tile's buffer"
BIAS_NEXT = ("      if (it + 1 < n_tiles) {\n"
             "        wa_load_bias(sb, biasb, q0 + rw, k0 + kWaKeys, L, wide,"
             " lane);")
HIDDEN = "    sm90::WgRS<64, 0>::mma(d, xa[ks], desc_k(w1t, kMHc, 0, ks), ks > 0);"
WGRS = "// d (64 x N f32) += A (64 x 16 bf16 in registers"
SS64 = r"""template <>
struct WgSS<64, 0, 0> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

"""
GELU = ("      v[e] = TANH ? gelu_tanh_fast(a[4 * n + e]) : gelu_erf(a[4 * n "
        "+ e]);")
GELU5 = ("      v[e] = TANH ? fmaf(0.5f * a[4 * n + e], tanh_approx(a[4 * n + e]"
         " * fmaf(0.0356774081f, a[4 * n + e] * a[4 * n + e], "
         "0.7978845608f)), 0.5f * a[4 * n + e]) : gelu_erf(a[4 * n + e]);")
# name: [(file, text in the source, its replacement)]
VARIANTS = {
    "two_stages": [("attention.cu", "static constexpr int stages = BIAS ? 2 : 3;",
                    "static constexpr int stages = BIAS ? 2 : 2;")],
    "pingpong": [
        ("attention.cu", PP_ISSUE,
         "      sm90::wg_commit();\n    }\n    if (wg == 0 || it + 1 < n_tiles)"
         "\n      asm volatile(\"bar.arrive %0, 256;\" ::\"r\"(2 - wg));\n"
         "    if (it > 0) sm90::wg_wait<1>(); else sm90::wg_wait<0>();\n"),
        ("attention.cu", PP_SYNC,
         PP_SYNC + "    asm volatile(\"bar.sync %0, 256;\" ::\"r\"(1 + wg));\n"),
        ("attention.cu", PP_LOOP,
         "  if (wg == 1) asm volatile(\"bar.arrive 1, 256;\");\n" + PP_LOOP)],
    "bias_once": [("attention.cu", BIAS_NEXT,
                   BIAS_NEXT.replace("it + 1 < n_tiles", "false"))],
    "mlp_hidden_ss": [
        ("sm90.cuh", WGRS, SS64 + WGRS),
        ("mlp.cu", HIDDEN,
         "    sm90::WgSS<64, 0, 0>::mma(d, desc_k(s0_ + kMX, kMRows, 64 * "
         "(threadIdx.x >> 7), ks), desc_k(w1t, kMHc, 0, ks), ks > 0);"),
        ("mlp.cu", "  sm90::wg_fence();\n#pragma unroll\n  for (int ks = 0; "
         "ks < 16; ++ks)\n    sm90::WgSS<64",
         "  extern __shared__ unsigned char smem_raw[];\n"
         "  const uint32_t s0_ = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;\n"
         "  sm90::wg_fence();\n#pragma unroll\n  for (int ks = 0; ks < 16; "
         "++ks)\n    sm90::WgSS<64")],
    "gelu_5op": [("mlp.cu", GELU, GELU5)],
}
TIMING_ONLY = ("bias_once",)
RUN = r'''
import json, math, sys, torch
sys.path.insert(0, sys.argv[1])
import comfyui_keep_torch
from comfyui_keep_torch.ops import _build, kernels as K
from comfyui_keep_torch.models.gmflow import shifted_window_mask
assert comfyui_keep_torch.__file__.startswith(sys.argv[1])
_build.build_all()
def tm(fn, it=30):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(it): fn()
    b.record(); torch.cuda.synchronize(); return a.elapsed_time(b) / it
def off(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / (1.6e-2 * (ref - ref.mean()).abs().max())).item()
g = torch.Generator(device="cuda").manual_seed(0)
bf = torch.bfloat16
q, k, v = (torch.randn(152, 1024, 128, generator=g, device="cuda").to(bf) for _ in range(3))
m = torch.as_tensor(shifted_window_mask(64, 64, 2), device="cuda")
s = 1 / math.sqrt(128)
n = 155648
x, y = (torch.randn(1, n, 128, generator=g, device="cuda").to(bf) for _ in range(2))
w1 = (torch.randn(1024, 256, generator=g, device="cuda") * .05).to(bf)
w2 = (torch.randn(128, 1024, generator=g, device="cuda") * .05).to(bf)
gm, bt = (torch.randn(128, generator=g, device="cuda").to(bf) for _ in range(2))
out = {}
for name, fn, plain in (
        ("k1_ms", lambda: K.attention(q, k, v, s), lambda: K.attention_plain(q[:8], k[:8], v[:8], s)),
        ("k1_masked_ms", lambda: K.attention(q, k, v, s, m), lambda: K.attention_plain(q[:8], k[:8], v[:8], s, m)),
        ("k2_ms", lambda: K.mlp_fused(x, y, w1, w2, gm, bt, True), lambda: K.mlp_fused_plain(x[:, :8192], y[:, :8192], w1, w2, gm, bt, True))):
    out[name] = tm(fn)
    got = fn()
    out[name.replace("_ms", "_off_tol")] = off(got[:8] if name.startswith("k1") else got[:, :8192], plain())
print(json.dumps(out))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    names = ["source"] + [n for n in VARIANTS
                          if not args.only or n in args.only.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    roots = {}
    for name in names:
        root = os.path.join(ROOT, "build", "forward_variants", name)
        shutil.rmtree(root, ignore_errors=True)
        dst = os.path.join(root, "comfyui_keep_torch")
        shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
            "__pycache__"))
        for fn, old, new in VARIANTS.get(name, []):
            path = os.path.join(dst, "csrc", fn)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        roots[name] = root
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "forward_variants.jsonl"),
              "w") as log:
        for rnd in range(args.rounds):
            for name in names:
                r = subprocess.run([sys.executable, "-c", RUN, roots[name]],
                                   capture_output=True, text=True,
                                   timeout=600)
                if r.returncode != 0:
                    raise SystemExit(f"{name}: {r.stderr[-3000:]}")
                row = {"variant": name, "round": rnd, "card": card,
                       "timing_only": name in TIMING_ONLY,
                       **json.loads(r.stdout.strip().splitlines()[-1])}
                print(json.dumps(row), flush=True)
                log.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
