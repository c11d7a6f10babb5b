#!/usr/bin/env python3
"""Where the time of one KEEP stage-II training step of the PyTorch port
goes, on one NVIDIA GPU.

    python3 tools/torch_profile_train.py [--mixed] [--out build/profile_train.txt]

Builds the step of options/train_keep_stage2.yml at full width as
chip_smoke.py's `train` phase does (KEEP 512x512, VQHQEncoder, GMFlow,
random weights, B=2 x 8 random frames; f32, or bf16 mixed precision with
--mixed), takes one warm-up step, then:
  * times the step's stages on the host clock, each ending in
    torch.cuda.synchronize(): the two flow_from_clip calls, the
    ground-truth codes, the forward with the losses, the backward and the
    optimizer update with the EMA;
  * runs one step under torch.profiler: the device's busy time (the union
    of the device-side events' intervals: cuDNN's f32 FFT convolutions run
    kernels on streams of their own, so summed durations can exceed the
    wall), its idle share against the wall time (an upper bound: the
    profiler's host overhead lengthens the wall), the summed time of the
    port's own kernels, and the kernels with the most device time.
Prints one JSON line with the card's name and power limit; the full kernel
table (device ms, calls, name) goes to --out.
"""
import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mixed", action="store_true",
                    help="bf16 mixed precision instead of the config's f32")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_train.txt"))
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script profiles the port on a GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.vqgan import VQHQEncoder
    from comfyui_keep_torch.training.state import cast_parameters, ema_update
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    opt = copy.deepcopy(chip_smoke.TRAIN_OPT)
    opt["train"]["mixed_precision"] = args.mixed
    net_g = opt["network_g"]
    hq = VQHQEncoder(**{k: v for k, v in net_g.items()
                        if k in chip_smoke.HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    tr = KEEPTrainer(opt, hq_vqgan=hq, gmflow=gm)
    state = tr.make_state()
    data = opt["datasets"]["train"]
    size = tr.cfg["img_size"]
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {k: torch.rand((data["batch_size_per_gpu"], data["num_frame"],
                            size, size, 3), generator=g, device="cuda") * 2 - 1
             for k in ("lq", "gt")}
    state, _ = tr.train_step(state, batch)   # warm-up

    def timed(fn):
        """ms of fn() to a synchronised end; fn's result is dropped, so a
        forward's graph is freed before the next stage."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    cbatch = tr._cast_batch(batch)
    ctx = (cast_parameters(state.model, tr.compute_dtype) if tr.compute_dtype
           else contextlib.nullcontext())
    stages = {}
    with torch.no_grad():
        stages["flows_lq_and_gt_ms"] = (timed(lambda: tr._flows(cbatch["lq"]))
                                        + timed(lambda: tr._flows(cbatch["gt"])))
        stages["gt_codes_ms"] = timed(lambda: tr._gt_indices(cbatch["gt"]))
    with ctx:
        fwd_ms = timed(lambda: tr.loss_fn(state.model, cbatch))
    stages["forward_and_losses_ms"] = (fwd_ms - stages["flows_lq_and_gt_ms"]
                                       - stages["gt_codes_ms"])
    step_ms = timed(lambda: tr.backward(state, batch))
    stages["backward_ms"] = step_ms - fwd_ms

    def update():
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        ema_update(state.ema, state.model, tr.ema_decay)
    stages["optimizer_and_ema_ms"] = timed(update)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = timed(lambda: tr.train_step(state, batch))
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
    busy_ms = busy_us / 1e3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for name, (n, ms) in rows:
            f.write(f"{ms:10.3f} ms {n:7d}  {name}\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "precision": "bf16 mixed" if args.mixed else "f32",
        "stages": stages, "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": sum(n for n, _ in by_name.values()),
        "summed_event_ms": sum(ms for _, ms in by_name.values()),
        "port_kernels": [{"name": k, "calls": n, "device_ms": ms}
                         for k, (n, ms) in rows if k.startswith("void keep::")],
        "top": [{"name": k[:90], "calls": n, "device_ms": ms}
                for k, (n, ms) in rows[:args.top]]}))


if __name__ == "__main__":
    main()
