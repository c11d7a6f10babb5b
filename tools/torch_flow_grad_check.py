#!/usr/bin/env python3
"""Where the GMFlow training step's gradient differs between the card and
the CPU: one pair (384x512, B = 1, GMFlowTrainer on chip_smoke.flow_opt(),
the same seeded weights and a synthetic FlyingChairs pair) through
chip_smoke.flow_step_runs, the runs phase train_flow's gates read:

    card                the card: the kernels' forwards and their
                        backward kernels, cuDNN
    cpu, cpu64          the CPU in float32 and in float64 (the plain
                        versions too)
    card_plain          the card with the plain versions in the kernels'
                        place; card_plain64 the same in float64
    card_no_cudnn       the card with the plain versions and ATen's own
                        convolutions
    card_tf32           the card with TF32 allowed (a control)

    python3 tools/torch_flow_grad_check.py [--items 0 1 ...] [--out f.json]
    python3 tools/torch_flow_grad_check.py --relu [--items 0 1 ...]

For each pair (the synthetic dataset's items) it prints each run's loss
and the four leaves furthest off float64 (cpu64), by max|d| over the
leaf's largest and by relative L2 (the three leaves whose true gradient
is zero left out: chip_smoke.FLOW_ZERO_GRAD), then chip_smoke's
flow_step_gates verdict. --out writes every leaf's two distances for
every run. Prints the card's name and power limit first. TF32 is off but
in the control.

--relu traces the upsampler's gradient jumps: the same pairs' forward in
float64 and in f32 on the CPU, and in f32 on the card where there is one
(none needed), from the same weights; the input of the convex upsampler's
ReLU (its first convolution's output) is compared with float64's by sign,
position by position. A position whose sign differs passes the gradient
of the first convolution (upsampler.0) in one run and not in the other.
The pairs are the dataset's draws in the order given, so --items 3 4 5
gives the pairs a gradient run with --items 3 4 5 got.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    import chip_smoke as cs
    from comfyui_keep_torch.data.flow_datasets import build_train_dataset
    from comfyui_keep_torch.ops import _build
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--items", type=int, nargs="+", default=[0],
                    help="dataset items (pairs) to run")
    ap.add_argument("--out", help="write every leaf's distances here")
    ap.add_argument("--relu", action="store_true",
                    help="the upsampler ReLU's sign flips, f32 against "
                         "float64 on the CPU")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.relu:
        relu_flips(torch, cs, args.items)
        return
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    root = tempfile.mkdtemp(prefix="chairs_")
    cs.write_chairs(root, 10, cs.FLOW_HW)
    ds = build_train_dataset("chairs", cs.FLOW_HW, roots={"chairs": root})
    ds.seed_streams(0)
    leaves = {}
    for item in args.items:
        pair = {k: torch.as_tensor(v)[None] for k, v in ds[item].items()}
        res = cs.flow_step_runs(torch, pair)
        want = res["cpu64"][1]
        for name, (loss, got, _) in res.items():
            dist = {n: (((got[n] - w).abs().max() / w.abs().max()).item(),
                        ((got[n] - w).norm() / w.norm()).item())
                    for n, w in want.items() if n not in cs.FLOW_ZERO_GRAD}
            leaves[f"item {item}: {name}"] = dist
            rows = sorted(((a, b, n) for n, (a, b) in dist.items()),
                          reverse=True)
            print(json.dumps({"item": item, "run": name, "loss": loss,
                              "max_rel": rows[0][0],
                              "worst": [{"leaf": n, "max_rel": a,
                                         "rel_l2": b}
                                        for a, b, n in rows[:4]]}),
                  flush=True)
        ok, report = cs.flow_step_gates(res)
        print(json.dumps({"item": item, "gates_ok": ok, **report}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(leaves, f)


def relu_flips(torch, cs, items):
    """For each item: GMFlowTrainer's forward (loss_fn) from flow_opt()'s
    seeded weights on the CPU in float64 and in f32, and on the card in
    f32 where there is one (kernels, cuDNN); at the convex upsampler's
    ReLU, the positions whose input has another sign than float64's, and
    the smallest |float64 input| over its largest."""
    from comfyui_keep_torch.data.flow_datasets import build_train_dataset
    from comfyui_keep_torch.models import gmflow as tgm
    from comfyui_keep_torch.training.trainers import build_model
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    root = tempfile.mkdtemp(prefix="chairs_")
    cs.write_chairs(root, 10, cs.FLOW_HW)
    ds = build_train_dataset("chairs", cs.FLOW_HW, roots={"chairs": root})
    ds.seed_streams(0)
    seen = []
    convex = tgm.upsample_flow_convex

    def traced(upsampler, flow, feature, factor=8):
        x = torch.cat([flow, feature], dim=-1).permute(0, 3, 1, 2)
        c0 = upsampler[0]
        seen.append(torch.nn.functional.conv2d(x, c0.weight, c0.bias,
                                               padding=1).detach())
        return convex(upsampler, flow, feature, factor)
    runs = [("cpu", torch.float64), ("cpu", torch.float32)]
    if torch.cuda.is_available():
        runs.append(("cuda", torch.float32))
    tgm.upsample_flow_convex = traced
    try:
        for item in items:
            pre, pair = {}, ds[item]   # one draw of the item's augmentation
            for dev, dtype in runs:
                tr = build_model(cs.flow_opt(), device=dev)
                st = tr.make_state()
                st.model.to(dtype)
                batch = {k: torch.as_tensor(v)[None].to(dev, dtype)
                         for k, v in pair.items()}
                seen.clear()
                with torch.no_grad():
                    tr.loss_fn(st.model, batch)
                pre[dev, dtype] = seen[-1].double().cpu()
            b = pre.pop(("cpu", torch.float64))
            for (dev, _), a in pre.items():
                flips = (a > 0) != (b > 0)
                print(json.dumps({
                    "item": item, "run": f"{dev} f32",
                    "relu_inputs": b.numel(), "sign_flips": int(flips.sum()),
                    "flip_f64_values": b[flips].tolist()[:8],
                    "least_abs_over_max": (b.abs().min()
                                           / b.abs().max()).item(),
                    "f32_max_rel_err": ((a - b).abs().max()
                                        / b.abs().max()).item()}),
                      flush=True)
    finally:
        tgm.upsample_flow_convex = convex


if __name__ == "__main__":
    main()
