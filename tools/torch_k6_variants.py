#!/usr/bin/env python3
"""Where the time of K6's bf16 TMA kernel (csrc/packed_conv.cu:
packed_conv_wgmma_kernel) goes, from variants of its source measured
against it on one NVIDIA GPU.

    python3 tools/torch_k6_variants.py [--rounds 2] [--only a,b]

Copies comfyui_keep_torch/ as it is ("source") and once per variant, with
csrc/packed_conv.cu patched, under build/k6_variants/<name>/; each copy
builds its packed_conv library in a process of its own (all at once):
  * no_epilogue: no epilogue at all (timing only: nothing is stored);
  * no_store: the epilogue fills its staging tiles but stores nothing by
    TMA (timing only);
  * channels_inner: the K steps walk the 64-channel blocks of a tap
    before the next tap (the source: the taps of a block before the next
    block);
  * a_first_block: the producer loads the input patch of the first
    channel block's K steps only and the later steps multiply stale
    patches (timing only): what the im2col loads cost;
  * b_first_block: the same for the weight slices (timing only);
  * checksum: the epilogue reads every accumulator into one sum a thread
    and stores that to shared memory (timing only): the products without
    the epilogue's stores (no_epilogue leaves the accumulators unread,
    which lets ptxas drop products);
  * wait0: each warpgroup waits for a K step's products before it issues
    the next step's (the source keeps one step in flight);
  * b_k_major: the weight slices read by wgmma as K-major 128-byte rows
    (timing only: the bytes stay N-major), against the source's N-major
    (transposed) B operand;
  * no_read_wait: a staging pass does not wait for the TMA store two
    passes back to have read its staging tile (timing only: a race);
  * no_proxy_fence: no fence between the staging writes and the TMA store
    that reads them (timing only: a race).
Each copy then times K6 (`packed_conv2x2`, its plan) at K6's own shape,
the LQ encoder's batch of 20, the encoder's level-2 res conv2 at a batch
of 20 and the generator's level-3 65^2 res conv1, by CUDA events and by
the profiler's device time, --rounds rounds with the copies in turns, and
gives each output's max |kernel - plain| over chip_smoke.py's bf16
tolerance (1.6e-2 of the plain output's spread). One JSON line a row,
also into chiprun_out/k6_variants.jsonl; the card's name and power limit
first.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "comfyui_keep_torch")
EPI = ("#pragma unroll\n    for (int mi = 0; mi < MI; ++mi) {\n"
       "      const long long r0")
STORE = ("          sm90::tma_store_3d(&to, stage_out_s + buf * 8192, n0 + 64 "
         "* sub,\n                             (int)r0, 0);")
ORDER = "          const int tap = s % taps, c0 = (s / taps) * kWgK;"
EXPECT = "          sm90::mbar_expect_tx(full, T::stage);"
A_LOAD = "          sm90::tma_load_im2col_4d(sa, &tx, c0, w0, h0, img,"
B_LOOP = "#pragma unroll\n          for (int b = 0; b < BN / 64; ++b)\n"
CHECKSUM = ("    {\n      float sum = 0.f;\n#pragma unroll\n      for (int i "
            "= 0; i < MI; ++i)\n#pragma unroll\n        for (int k = 0; k < "
            "BN / 2; ++k) sum += acc[i][k];\n      reinterpret_cast<float*>("
            "stage_out)[wtid] = sum;\n    }\n")
WAIT = "      sm90::wg_wait<1>();\n      if (s > 0) release(prev);"
B_DESC = ("              sm90::desc_sw128(sa + T::a_bytes + 16 * 128 * k, kWgK * "
          "128,\n                               1024),")
W256 = '"%127}, %128, %129, p, 1, 1, 0, 1;\\n}\\n"'
READ_WAIT = ("        if (passes >= 2) {  // the store two passes back has read "
             "this tile\n          if (wtid == 0) sm90::bulk_wait_read<1>();\n"
             "          sm90::named_sync(1 + wg, 128);\n        }\n")
FENCE = ("        sm90::fence_async_smem();\n"
         "        sm90::named_sync(1 + wg, 128);")
W128 = '"%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "\n        "1, 0, 1;\\n}\\n"'
# name: [(text in packed_conv.cu, its replacement)], or (file, text, its
# replacement) for another file of csrc/
VARIANTS = {
    "no_epilogue": [(EPI, EPI.replace("mi < MI", "mi < 0"))],
    "no_store": [(STORE, "")],
    "channels_inner": [(ORDER, "          const int cb = ksteps / taps, "
                        "tap = s / cb, c0 = (s % cb) * kWgK;")],
    "a_first_block": [(EXPECT, "          sm90::mbar_expect_tx(full, s < "
                       "taps ? T::stage : T::b_bytes);"),
                      (A_LOAD, "          if (s < taps)\n" + A_LOAD)],
    "b_first_block": [(EXPECT, "          sm90::mbar_expect_tx(full, s < "
                       "taps ? T::stage : T::a_bytes);"),
                      (B_LOOP, "#pragma unroll\n          for (int b = 0; b <"
                       " (s < taps ? BN / 64 : 0); ++b)\n")],
    "checksum": [(EPI, CHECKSUM + EPI.replace("mi < MI", "mi < 0"))],
    "wait0": [(WAIT, WAIT.replace("<1>", "<0>"))],
    "b_k_major": [(B_DESC, "              sm90::desc_sw128(sa + T::a_bytes + 32 "
                   "* k, 16, 1024),"),
                  ("sm90.cuh", W256, W256.replace("0, 1;", "0, 0;")),
                  ("sm90.cuh", W128, W128.replace("0, 1;", "0, 0;"))],
    "no_read_wait": [(READ_WAIT, "")],
    "no_proxy_fence": [(FENCE, "        sm90::named_sync(1 + wg, 128);")],
}
TIMING_ONLY = ("no_epilogue", "no_store", "a_first_block", "b_first_block",
               "checksum", "b_k_major", "no_read_wait", "no_proxy_fence")
BUILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
from comfyui_keep_torch.ops import _build
_build.SOURCES = ("packed_conv",)
_build.build_all()
print("\n".join(l for l in _build.build_log.get("packed_conv", "").splitlines()
                if "spill" in l or "registers" in l))
'''
RUN = r'''
import json, math, sys, torch
sys.path.insert(0, sys.argv[1])
import comfyui_keep_torch
from comfyui_keep_torch.ops import _build, kernels as K
assert comfyui_keep_torch.__file__.startswith(sys.argv[1])
_build.SOURCES = ("packed_conv",)
def tm(fn, it=10):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(it): fn()
    b.record(); torch.cuda.synchronize(); return a.elapsed_time(b) / it
def dev(fn, it=10):
    fn(); torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        for _ in range(it): fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / it
g = torch.Generator(device="cuda").manual_seed(0)
valid, same = ((0, 0), (0, 0)), ((1, 1), (1, 1))
out = {}
for name, b, hi, cin, cout, pads in (
        ("own", 1, 257, 256, 256, valid), ("lq20", 20, 257, 256, 256, valid),
        ("enc_l2_conv2", 20, 129, 512, 512, valid),
        ("gen_l3_conv1", 1, 65, 512, 512, valid)):
    x = torch.randn(b, hi, hi, cin, generator=g, device="cuda").bfloat16()
    w = (torch.randn(2, 2, cin, cout, generator=g, device="cuda")
         / math.sqrt(4 * cin)).bfloat16()
    fn = lambda: K.packed_conv2x2(x, w, pads)
    got = fn(); torch.cuda.synchronize()
    ref = K.packed_conv2x2_plain(x[:1], w, pads).float()
    out[name + "_off_tol"] = ((got[:1].float() - ref).abs().max()
                             / (1.6e-2 * (ref - ref.mean()).abs().max())).item()
    out[name + "_ms"] = tm(fn)
    out[name + "_device_ms"] = dev(fn)
    del x, w, got, ref
    torch.cuda.empty_cache()
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
        root = os.path.join(ROOT, "build", "k6_variants", name)
        shutil.rmtree(root, ignore_errors=True)
        dst = os.path.join(root, "comfyui_keep_torch")
        shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
            "__pycache__"))
        for patch in VARIANTS.get(name, []):
            fn, old, new = patch if len(patch) == 3 else ("packed_conv.cu",
                                                           *patch)
            path = os.path.join(dst, "csrc", fn)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
        roots[name] = root
    builds = {n: subprocess.Popen([sys.executable, "-c", BUILD, r],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for n, r in roots.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed\n{log[-3000:]}")
        print(json.dumps({"variant": name, "ptxas": log.splitlines()}),
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k6_variants.jsonl"),
              "w") as log:
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
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
