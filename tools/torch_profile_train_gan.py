#!/usr/bin/env python3
"""Where the time of one KEEP stage-III alternation of the PyTorch port goes,
beside the stage-II step it grows from, on one NVIDIA GPU.

    python3 tools/torch_profile_train_gan.py [--out chiprun_out/profile_train_gan.txt]

Full width, f32 as both ymls configure, random weights, TF32 off. Each case
takes one warm-up call, then one call under torch.profiler:
  * `stage2_b2`: options/train_keep_stage2.yml's step (chip_smoke.train_opt()),
    B = 2 x 8 random frames, as chip_smoke.py's `train` phase runs it;
  * `stage2_b1`: the same step at B = 1 x 8;
  * `stage3_alternation`: options/train_keep_stage3_gan.yml's g/d
    alternation (chip_smoke.stage3_opt(), KEEPGANTrainer with
    Discriminator3D), B = 1 x 8 random frames;
  * `stage3_iteration`: one iteration of the train loop as train_pipeline
    runs it: the prefetcher's next() (which makes the following item of a
    synthetic 12-frame 512^2 PNG clip on the host: decode, blur, noise,
    resizes, JPEG) and the alternation.
For each: the wall time (host clock to a synchronised end), the device's
busy time (the union of the device events' intervals), its idle share
(an upper bound: the profiler's host overhead lengthens the wall), and
the device ms by kernel. Prints one JSON line with the card's name and
power limit; each case's kernel table goes to --out.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled(torch, fn):
    """(wall ms, device busy ms, {kernel: (calls, device ms)}) of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    busy, reach = 0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            busy, reach = busy + b - a, b
        elif b > reach:
            busy, reach = busy + b - reach, b
    return wall, busy / 1e3, by_name


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "profile_train_gan.txt"))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script profiles the port on a GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from comfyui_keep_torch.data.prefetch import CUDAPrefetcher
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    from comfyui_keep_torch.training.train import create_train_val_loaders
    from comfyui_keep_torch.training.trainers import build_model
    from comfyui_keep_torch.utils.logger import get_root_logger
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    net_g = chip_smoke.train_opt()["network_g"]
    hq = VQHQEncoder(**{k: v for k, v in net_g.items()
                        if k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    g = torch.Generator(device="cuda").manual_seed(3)

    def batch(b):
        return {k: torch.rand((b, 8, 512, 512, 3), generator=g,
                              device="cuda") * 2 - 1 for k in ("lq", "gt")}

    cases, tables = {}, {}

    def record(name, fn, **extra):
        wall, busy, by_name = profiled(torch, fn)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        tables[name] = rows
        cases[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "device_events": sum(n for n, _ in by_name.values()),
            "top": [{"name": k[:90], "calls": n, "device_ms": ms}
                    for k, (n, ms) in rows[:args.top]], **extra}

    for name, b in (("stage2_b2", 2), ("stage2_b1", 1)):
        opt = chip_smoke.train_opt()
        opt["datasets"]["train"]["batch_size_per_gpu"] = b
        tr = build_model(opt, hq_vqgan=hq, gmflow=gm)
        state = tr.make_state()
        x = batch(b)
        tr.train_step(state, x)                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        record(name, lambda: tr.train_step(state, x), batch=[b, 8])
        cases[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del tr, state, x
        torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="profile_gan_")
    try:
        gt_root, meta = chip_smoke.write_vfhq_clip(
            work, chip_smoke.GAN_CLIP_FRAMES, 512)
        opt = chip_smoke.stage3_opt()
        opt["datasets"]["train"].update(dataroot_gt=gt_root,
                                        meta_info_file=meta)
        tr = build_model(opt, hq_vqgan=hq, gmflow=gm)
        state = tr.make_state()
        x = batch(1)
        tr.train_step(state, x)                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        record("stage3_alternation", lambda: tr.train_step(state, x),
               batch=[1, 8])
        cases["stage3_alternation"]["peak_gib"] = (
            torch.cuda.max_memory_allocated() / 2 ** 30)

        loader, _ = create_train_val_loaders(opt, get_root_logger())
        prefetcher = CUDAPrefetcher(loader, device=tr.device)
        prefetcher.reset()
        held = {}

        def feed():
            t0 = time.perf_counter()
            held["batch"] = {k: v for k, v in prefetcher.next().items()
                             if torch.is_tensor(v)}
            held["next_ms"] = 1e3 * (time.perf_counter() - t0)

        def iteration():
            feed()
            tr.train_step(state, held["batch"])

        feed()                                        # warm-up
        record("stage3_iteration", iteration)
        cases["stage3_iteration"]["next_item_ms"] = held["next_ms"]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for name, rows in tables.items():
            f.write(f"== {name}: {cases[name]['wall_ms']:.1f} ms wall\n")
            for k, (n, ms) in rows:
                f.write(f"{ms:10.3f} ms {n:7d}  {k}\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "precision": "f32", "cases": cases}))


if __name__ == "__main__":
    main()
