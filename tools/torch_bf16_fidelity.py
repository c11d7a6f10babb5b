#!/usr/bin/env python3
"""bf16 serving fidelity of the PyTorch port (the counterpart of
tools/bf16_fidelity.py).

The same 20-frame 512x512 clip goes through GMFlow (flow_from_clip) and
KEEP.apply at full width (random weights: KEEP from seed 0, GMFlow from 2,
the clip from 1) three times on the card:
  1. in f32 with TF32 off for matmuls and convolutions (the counterpart of
     the JAX tool's "highest" matmul precision);
  2. in bf16;
  3. in bf16 with run 1's code picks forced (force_indices).
With random weights the raw PSNR is bounded by codebook-argmax flips (one
flip swaps a decoded 16x16 patch), so the report holds:
  psnr_db                  run 2 against run 1, uint8 PSNR (metrics/)
  psnr_db_forced           run 3 against run 1: the continuous path's cost
  index_agreement          share of run 3's own argmax picks equal to run
                           1's (each step given the f32 trajectory)
  index_agreement_free_run share of run 2's picks equal to run 1's
  max_abs_err_u8_forced    largest uint8 difference, run 3 against run 1
  frac_pixels_exact_u8     share of run 2's uint8 values equal to run 1's

  python tools/torch_bf16_fidelity.py [--frames 20] [--phase512] \
      [--out bf16_fidelity.json] [--device cuda]

--phase512 serves the bf16 runs phase-packed (KEEP.prepare_phase512, K6),
where the JAX tool packs unless KEEP_TPU_NO_PHASE512 is set; by default
the runs are unpacked (K1-K3 in GMFlow). The JAX tool's int8 option is
not ported. Prints one JSON line and writes it to --out.
"""
import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


@contextlib.contextmanager
def no_tf32():
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build(frames, device="cuda", cfg_overrides=None):
    """(KEEP, GMFlow, clip (1, frames, S, S, 3)) in f32 on `device`, S the
    config's img_size."""
    import torch
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.keep import KEEP
    keep = KEEP(device="cpu",
                generator=torch.Generator().manual_seed(0),
                **(cfg_overrides or {}))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(2))
    size = keep.cfg["img_size"]
    x = torch.randn((1, frames, size, size, 3),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    return keep.to(device), gm.to(device), x.to(device)


def run(keep, gm, x, dtype, force_idx=None, phase512=False):
    """(output as f32 numpy, the natural top-1 picks (B, T, L) int32) of
    one GMFlow + KEEP.apply pass in `dtype` ("f32": TF32 off)."""
    import torch
    from comfyui_keep_torch.models.gmflow import flow_from_clip
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    keep, gm, x = keep.to(dtype=dt), gm.to(dtype=dt), x.to(dt)
    if phase512:
        keep = keep.prepare_phase512()
    fi = None if force_idx is None else torch.as_tensor(
        force_idx, dtype=torch.long, device=x.device)
    ctx = no_tf32() if dtype == "f32" else contextlib.nullcontext()
    with ctx, torch.no_grad():
        out, aux = keep.apply(x, flows=flow_from_clip(gm, x),
                              force_indices=fi, return_aux=True)
    b, t = x.shape[:2]
    idx = aux["logits"].argmax(-1).reshape(b, t, -1)
    return (out.float().cpu().numpy(),
            idx.cpu().numpy().astype(np.int32))


def to_u8(out):
    return np.round(np.clip((out + 1) / 2, 0, 1) * 255.0)


def psnr_u8(a8, b8):
    from comfyui_keep_torch.metrics.psnr_ssim import calculate_psnr
    w = a8.shape[-2]
    return float(calculate_psnr(a8.reshape(-1, w, 3), b8.reshape(-1, w, 3),
                                crop_border=0))


def report(reference, serving, forced):
    """The report's numbers (module docstring) from the three runs'
    (output, picks): the f32 reference, the free serving run and the
    serving run with the reference's picks forced."""
    (out_ref, idx_ref), (out_srv, idx_srv), (out_forced, idx_forced) = (
        reference, serving, forced)
    a8, b8, c8 = to_u8(out_srv), to_u8(out_ref), to_u8(out_forced)
    return {
        "psnr_db": psnr_u8(a8, b8),
        "psnr_db_forced": psnr_u8(c8, b8),
        "index_agreement": float(np.mean(idx_forced == idx_ref)),
        "index_agreement_free_run": float(np.mean(idx_srv == idx_ref)),
        "max_abs_err_u8_forced": float(np.max(np.abs(c8 - b8))),
        "frac_pixels_exact_u8": float(np.mean(a8 == b8)),
    }


def fidelity(frames=20, serving="bf16", phase512=False, device="cuda",
             cfg_overrides=None, runs=None):
    """The report of runs 1-3 (module docstring) with runs 2-3 in `serving`
    ("bf16"; "f32" holds the tool to itself). `runs`, if given, is a dict
    that receives each run's (output, picks)."""
    import torch
    keep, gm, x = build(frames, device, cfg_overrides)
    reference = run(keep, gm, x, "f32")
    free = run(keep, gm, x, serving, phase512=phase512)
    forced = run(keep, gm, x, serving, force_idx=reference[1],
                 phase512=phase512)
    if runs is not None:
        runs.update(reference=reference, serving=free, forced=forced)
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    return {
        "metric": f"PSNR({serving} serving output vs f32 output, TF32 "
                  "off), dB",
        "frames": frames, "device": name, "phase512": phase512,
        **report(reference, free, forced),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--out", default="bf16_fidelity.json")
    p.add_argument("--phase512", action="store_true",
                   help="serve the bf16 runs phase-packed (K6)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from comfyui_keep_torch.utils.options import check_device
    check_device(args.device)
    report = fidelity(args.frames, "bf16", args.phase512, args.device)
    print(json.dumps(report))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
