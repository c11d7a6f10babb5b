"""Tracing and timing (ported from comfyui_keep_tpu/utils/profiler.py):
a torch.profiler trace written as a Chrome trace, a median timer that waits
for the card, and KEEP's per-frame latency benchmark (the reference's
keep_arch __main__ micro-benchmark, keep_arch.py:1196-1203, as a CLI):

  python -m comfyui_keep_torch.utils.profiler [--frames 20] [--iters 5] \
      [--dtype bf16|f32] [--trace-dir DIR] [--variant KEEP] [--device cuda]
"""
import argparse
import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler over the block (the host, and the card when there
    is one), written to <logdir>/trace.json as a Chrome trace (open it in
    chrome://tracing or Perfetto). Yields the profiler, or None without a
    logdir, when nothing is traced."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _wait(out):
    """Wait for the card when fn's first tensor output lies on it."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1):
    """(median, samples) of fn(*args)'s wall time in seconds, each call
    ended by a torch.cuda.synchronize when its output is on the card."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def keep_latency_benchmark(t: int = 20, iters: int = 5, dtype="bf16",
                           logdir: Optional[str] = None, variant="KEEP",
                           device="cuda"):
    """KEEP's forward at full width (random weights from seed 0) on a
    (1, t, 512, 512, 3) clip (seed 1), zero flows, in bf16 or f32 on
    `device`: prints the parameter count and the ms a frame and faces/s
    of the median forward, and returns that median in seconds. With
    logdir, the timed calls are traced there (trace)."""
    from comfyui_keep_torch.models.keep import KEEP, count_parameters
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    net = KEEP(variant, device="cpu",
               generator=torch.Generator().manual_seed(0))
    print(f"Total parameters: {count_parameters(net) / 1e6:.2f} M")
    net = net.to(device, dt).eval()
    x = torch.randn((1, t, 512, 512, 3),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    x = x.to(device, dt)
    with torch.no_grad(), trace(logdir):
        med, _ = time_fn(net.apply, x, iters=iters)
    print(f"Forward pass time: {med / t * 1000:.2f} ms/frame "
          f"({t / med:.2f} faces/sec)")
    return med


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--variant", default="KEEP")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    from comfyui_keep_torch.utils.options import check_device
    check_device(a.device)
    keep_latency_benchmark(a.frames, a.iters, a.dtype, a.trace_dir,
                           a.variant, a.device)
