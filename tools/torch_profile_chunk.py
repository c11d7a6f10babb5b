#!/usr/bin/env python3
"""Where the time of one main-path chunk of the PyTorch port goes, on one
NVIDIA GPU.

    python3 tools/torch_profile_chunk.py [--unpacked] [--out chiprun_out/profile.txt]

Runs api.load_models(seed=0) -> load_device(bf16) -> processor(bf16)
.restore_face_stream on 20 random aligned 512x512 faces (one chunk) once to
warm up, then once under torch.profiler. The processor runs KEEP's 512
level phase-packed (phase512=True); --unpacked profiles the processor's
default, phase512=False. Prints one JSON line: the wall time,
the device's busy time (the summed durations of the device-side events,
which never overlap on one stream) and idle share, and the kernels with the
most device time, beside the card's name and power limit. The profiler's own
host overhead lengthens the wall time, so the idle share is an upper bound.
The full table (device ms, calls, name) goes to --out.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 20


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile.txt"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--unpacked", action="store_true",
                    help="KEEP's 512-level convolutions unpacked")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script profiles the port on a GPU")
    sys.path.insert(0, ROOT)
    from comfyui_keep_torch import api
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    pack = api.load_models(seed=0).load_device(torch.bfloat16)
    proc = pack.processor(dtype=torch.bfloat16, phase512=not args.unpacked)
    rng = np.random.default_rng(3)
    faces = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
             for _ in range(FRAMES)]
    proc.restore_face_stream(faces, max_clip_length=FRAMES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.restore_face_stream(faces, max_clip_length=FRAMES)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(ms for _, ms in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for name, (n, ms) in rows:
            f.write(f"{ms:10.3f} ms {n:7d}  {name}\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "phase512": not args.unpacked, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": sum(n for n, _ in by_name.values()),
        "top": [{"name": k[:90], "calls": n, "device_ms": ms}
                for k, (n, ms) in rows[:args.top]]}))


if __name__ == "__main__":
    main()
