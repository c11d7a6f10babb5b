#!/usr/bin/env python3
"""Device time of the PyTorch port's GMFlow training step, on one NVIDIA
GPU.

    python3 tools/torch_profile_flow_step.py [--root DIR] [--steps 5]
                                             [--mixed]

GMFlowTrainer on chip_smoke.py's flow_opt() (tools/torch_train_flow.py's
defaults: GMFlow 128 channels, 6 layers, f32, TF32 off; with --mixed
train.mixed_precision, the network run on a bf16 copy: K1-K3's bf16 forms
and their bf16 backward kernels) and one synthetic
batch of chip_smoke.py's FLOW_B pairs at FLOW_HW (random frames and flows,
every pixel valid): three warm-up steps, then --steps steps timed with
CUDA events and --steps more under torch.profiler, which gives the summed
device time of the step's kernels and their number, and the peak device
memory of the profiled steps (max_memory_allocated). --root runs another
checkout's chip_smoke.py and comfyui_keep_torch (e.g. a parent commit
unpacked by git archive), so that two commits compare in one call to the
card. Prints one JSON line with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose port is timed")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mixed", action="store_true",
                    help="train.mixed_precision (bf16 compute)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    import comfyui_keep_torch
    from comfyui_keep_torch.ops import _build
    from comfyui_keep_torch.training.trainers import build_model
    if not comfyui_keep_torch.__file__.startswith(root):
        raise RuntimeError(f"comfyui_keep_torch came from "
                           f"{comfyui_keep_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    n, (h, w) = cs.FLOW_B, cs.FLOW_HW
    batch = {"img1": torch.rand((n, h, w, 3), device="cuda",
                                generator=g) * 255,
             "img2": torch.rand((n, h, w, 3), device="cuda",
                                generator=g) * 255,
             "flow": torch.randn((n, h, w, 2), device="cuda",
                                 generator=g) * 4,
             "valid": torch.ones((n, h, w), device="cuda")}
    opt = cs.flow_opt()
    opt["train"]["mixed_precision"] = args.mixed
    tr = build_model(opt)
    state = tr.make_state()
    for _ in range(3):
        state, _ = tr.train_step(state, batch)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(args.steps):
        state, _ = tr.train_step(state, batch)
    ev[1].record()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(args.steps):
            state, _ = tr.train_step(state, batch)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time if hasattr(e, "device_time") else e.cuda_time
                  for e in device)
    print(json.dumps({
        "card": card, "root": root, "batch": n, "hw": [h, w],
        "precision": "bf16 mixed" if args.mixed else "f32",
        "steps": args.steps,
        "event_ms_per_step": ev[0].elapsed_time(ev[1]) / args.steps,
        "device_ms_per_step": busy_us / 1e3 / args.steps,
        "device_events_per_step": len(device) / args.steps,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
        flush=True)


if __name__ == "__main__":
    main()
