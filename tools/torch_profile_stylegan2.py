#!/usr/bin/env python3
"""Where the time of StyleGAN2 in the PyTorch port goes, on one NVIDIA GPU.

    python3 tools/torch_profile_stylegan2.py [--out build/profile_stylegan2.txt]

Two runs, at chip_smoke.py's shapes:
  * sampling: StyleGAN2Generator config-f at 1024x1024, B=4 codes, bf16
    and f32, one forward after a warm-up;
  * training: StyleGAN2Model at 256x256 (channel multiplier 2, G and D),
    B=4 random real images, f32, after a warm-up alternation: the host time
    of a plain alternation (iteration 1), a path alternation (4) and the R1
    + path alternation (16), so that the path and R1 updates' costs are the
    differences, then iteration 16 profiled.
Each profiled run reports the device's busy time (the union of the
device-side events' intervals), its idle share against the wall time (an
upper bound: the profiler's host overhead lengthens the wall), the K5
kernel's summed time and the kernels with the most device time. Prints one
JSON line with the card's name and power limit; the full kernel tables
(device ms, calls, name) go to --out. TF32 is off.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled(torch, fn, top):
    """(wall ms, busy ms, device events by name) of fn() under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, reach = 0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            busy_us += b - a
            reach = b
        elif b > reach:
            busy_us += b - reach
            reach = b
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    summary = {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_events": sum(n for n, _ in by_name.values()),
        "k5": [{"name": k[:60], "calls": n, "device_ms": ms}
               for k, (n, ms) in rows if "fused_act" in k],
        "top": [{"name": k[:90], "calls": n, "device_ms": ms}
                for k, (n, ms) in rows[:top]]}
    return summary, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_stylegan2.txt"))
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script profiles the port on a GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from comfyui_keep_torch.models.stylegan2 import StyleGAN2Generator
    from comfyui_keep_torch.training.trainers import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = chip_smoke.SG2_BATCH
    report, tables = {}, {}

    g32 = StyleGAN2Generator(**chip_smoke.SG2_SAMPLE, device="cuda",
                             generator=torch.Generator().manual_seed(11))
    for dtype in (torch.bfloat16, torch.float32):
        name = f"sample_{str(dtype).split('.')[-1]}"
        net = g32.to(dtype) if dtype == torch.float32 else \
            StyleGAN2Generator(**chip_smoke.SG2_SAMPLE, device="cuda",
                               dtype=dtype,
                               generator=torch.Generator().manual_seed(11))
        z = torch.randn(b, chip_smoke.SG2_SAMPLE["num_style_feat"],
                        device="cuda", dtype=dtype)
        with torch.no_grad():
            net([z])
            report[name], tables[name] = profiled(
                torch, lambda: net([z]), args.top)
        del net
    del g32
    torch.cuda.empty_cache()

    size = chip_smoke.SG2_TRAIN_SIZE
    opt = chip_smoke.sg2_opt()
    opt["network_g"] = {"out_size": size, "num_style_feat": 512,
                        "num_mlp": 8, "channel_multiplier": 2}
    opt["network_d"] = {"out_size": size, "channel_multiplier": 2}
    tr = build_model(opt)
    state = tr.make_state()
    g = torch.Generator(device="cuda").manual_seed(13)
    batch = {"gt": torch.rand((b, 3, size, size), generator=g,
                              device="cuda") * 2 - 1}
    state, _ = tr.gan_train_step(state, batch, 16)   # warm-up
    host = {}
    for it in (1, 4, 16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = tr.gan_train_step(state, batch, it)
        torch.cuda.synchronize()
        host[it] = 1e3 * (time.perf_counter() - t0)
    report["train_host_ms"] = {
        "plain": host[1], "path": host[4], "r1_and_path": host[16],
        "path_update": host[4] - host[1], "r1_update": host[16] - host[4]}
    report["train_r1_and_path"], tables["train_r1_and_path"] = profiled(
        torch, lambda: tr.gan_train_step(state, batch, 16), args.top)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for run, rows in tables.items():
            f.write(f"== {run}\n")
            for name, (n, ms) in rows:
                f.write(f"{ms:10.3f} ms {n:7d}  {name}\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, **report}))


if __name__ == "__main__":
    main()
