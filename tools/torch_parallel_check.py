#!/usr/bin/env python3
"""comfyui_keep_torch/parallel/ across ranks: one process a card under
NCCL, each rank checked against one process and timed.

    python3 -m torch.distributed.run --nproc_per_node=4 \
        tools/torch_parallel_check.py [--out chiprun_out/parallel4.json]
    python3 -m torch.distributed.run --nproc_per_node=4 \
        tools/torch_parallel_check.py --cpu      # gloo, a tiny KEEP

On the cards: KEEP + GMFlow 512^2 bf16 from api.load_models(seed=0)
(20-frame chunks), the stage-II yml's step at full width (f32), test_keep.yml's
MSRResNet; with --cpu the same checks on CPU ranks at a tiny width (f32,
4-frame chunks), as a rehearsal. World W (torchrun's WORLD_SIZE; 4 for the
data x tensor mesh):
  chunks    restore_chunks_parallel of 4 chunks less 3 faces (the last
            chunk ragged) over W ranks: ms a face on the slowest rank,
            every rank's result bit for bit against rank 0 restoring all
            chunks alone (the chunk body, padded tail), and that one
            process's ms a face;
  ring      restore_stream_pipeline of 2 clips of W chunks over W ranks
            (the carry by NCCL send / recv): ms a face, bit for bit
            against carried streaming on one process, and its ms a face;
  sr        the data-parallel SR step (B = 8 over W ranks) against the
            one-process step on the whole batch: the losses (mean over
            ranks) and the first conv's weight after the step, every
            rank's weights equal; ms of a first step (after one trainer's
            warm-up), beside the one process's;
  tp        the stage-II KEEPTrainer step on a (W / 2, 2) data x model
            mesh against the unsharded step on the whole batch on each
            rank, cuDNN deterministic: the losses and the split weights
            after Adam as worst allclose violations at 2e-4 / 2e-5, every
            applied gradient (this rank's slice) leaf by leaf in
            allclose's L2 form (<= 0 passes), the elementwise violation
            reported; beside them a second unsharded step's gradients
            against the first (the card's own run-to-run difference); ms
            of each trainer's first step (the unsharded one beside it).
            Then both steps again in float64 (the kernels' plain versions
            in their place), where rounding is out of the way: the
            losses and every applied gradient held elementwise at 2e-4 /
            2e-5, each f32 step's gradients against the float64 unsharded
            ones, and each rank's f32 element furthest past the
            elementwise limit with its reading in all five steps.
Rank 0 prints one JSON line a phase and the card's name and power limit,
and writes them all to --out. Exits non-zero if a check fails.
"""
import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_TOL = dict(rtol=2e-4, atol=2e-5)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2), res_blocks=1,
            attn_resolutions=(32,), codebook_size=32, emb_dim=32,
            dim_embd=32, n_head=4, n_layers=1, latent_size=1024,
            cft_list=("64",), cfa_list=("32",), cfa_nhead=2, cfa_dim=8,
            kalman_attn_head_dim=8, num_uncertainty_layers=1,
            temp_reg_list=())


def violation(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


class Rank:
    """This rank's device, models and timer."""

    def __init__(self, torch, cpu: bool):
        from comfyui_keep_torch.parallel import get_dist_info
        self.torch, self.cpu = torch, cpu
        self.rank, self.world = get_dist_info()
        self.device = torch.device("cpu") if cpu else torch.device(
            "cuda", torch.cuda.current_device())
        self.frames = 4 if cpu else 20
        self.size = 64 if cpu else 512

    def sync(self):
        if not self.cpu:
            self.torch.cuda.synchronize()

    def timed(self, fn):
        """(fn(), its wall ms, ending in a synchronise)."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, 1e3 * (time.perf_counter() - t0)

    def rank_max(self, ms):
        """The largest of every rank's value."""
        import torch.distributed as dist
        from comfyui_keep_torch.parallel.mesh import comm_device
        t = self.torch.tensor([ms], dtype=self.torch.float64,
                              device=comm_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def processor(self):
        torch = self.torch
        if self.cpu:
            from comfyui_keep_torch.models.gmflow import GMFlow
            from comfyui_keep_torch.models.keep import KEEP
            from comfyui_keep_torch.pipeline.processor import \
                KEEPFaceProcessor
            return KEEPFaceProcessor(
                KEEP(device="cpu", generator=torch.Generator().manual_seed(0),
                     **TINY),
                GMFlow(num_layers=1, device="cpu",
                       generator=torch.Generator().manual_seed(1)),
                device="cpu")
        from comfyui_keep_torch import api
        return api.load_models(seed=0).load_device(torch.bfloat16).processor(
            torch.bfloat16, device=self.device)

    def faces(self, n, seed):
        return (np.random.default_rng(seed).random(
            (n, self.size, self.size, 3), np.float32) * 2 - 1)


def phase_chunks(r, proc):
    from comfyui_keep_torch.parallel import (make_mesh,
                                             restore_chunks_parallel)
    length, mesh = r.frames, make_mesh()
    faces = r.faces(4 * length - 3, 0)
    restore_chunks_parallel(proc, faces, length, mesh)       # warm-up
    out, ms = r.timed(lambda: restore_chunks_parallel(proc, faces, length,
                                                      mesh))
    res = {"faces": len(faces), "ms_per_face": r.rank_max(ms) / len(faces)}
    if r.rank == 0:
        def alone():
            idx = np.minimum(np.arange(4 * length), len(faces) - 1)
            x = faces[idx].reshape((4, length) + faces.shape[1:])
            return np.concatenate([proc.restore_clip(c) for c in x])
        ref, ms1 = r.timed(alone)
        res.update(one_process_ms_per_face=ms1 / len(faces),
                   bitwise=bool(np.array_equal(out, ref[:len(faces)])))
    return res


def carried(proc, clips, n):
    res = []
    for clip in clips[:, 0]:
        tc = clip.shape[0] // n
        o, carry = proc.restore_clip(clip[:tc], return_carry=True)
        parts = [o]
        for d in range(1, n):
            o, carry = proc.restore_clip(clip[d * tc:(d + 1) * tc], carry,
                                         clip[d * tc - 1], return_carry=True)
            parts.append(o)
        res.append(np.concatenate(parts)[None])
    return np.stack(res)


def phase_ring(r, proc):
    from comfyui_keep_torch.parallel import (make_mesh,
                                             restore_stream_pipeline)
    mesh = make_mesh(axes=("seq",))
    clips = r.faces(2 * r.world * r.frames, 1).reshape(
        (2, 1, r.world * r.frames, r.size, r.size, 3))
    restore_stream_pipeline(proc, clips[:1], mesh)         # warm-up
    out, ms = r.timed(lambda: restore_stream_pipeline(proc, clips, mesh))
    n = clips.shape[0] * clips.shape[2]
    res = {"clips": list(clips.shape[:3]),
           "ms_per_face": r.rank_max(ms) / n}
    if r.rank == 0:
        ref, ms1 = r.timed(lambda: carried(proc, clips, r.world))
        res.update(one_process_ms_per_face=ms1 / n,
                   bitwise=bool(np.array_equal(out, ref)))
    return res


def sr_opt():
    import chip_smoke
    opt = chip_smoke.test_opt()
    opt["train"] = {"pixel_opt": {"type": "L1Loss"},
                    "optim_g": {"type": "Adam", "lr": 2e-4}}
    return opt


def phase_sr(r):
    import torch.distributed as dist
    from comfyui_keep_torch.parallel import make_mesh, reduce_loss_dict
    from comfyui_keep_torch.parallel.mesh import all_gather_cat
    from comfyui_keep_torch.training.trainers import SRTrainer
    torch = r.torch
    g = torch.Generator().manual_seed(12)
    batch = {"lq": torch.rand((8, 64, 64, 3), generator=g),
             "gt": torch.rand((8, 256, 256, 3), generator=g)}
    batch = {k: v.to(r.device) for k, v in batch.items()}

    def step(mesh):
        """A trainer, then its first step timed alone."""
        tr = SRTrainer(sr_opt(), device=r.device, mesh=mesh)
        st = tr.make_state()
        (st, logs), ms = r.timed(lambda: tr.train_step(st, batch))
        return st, logs, ms
    mesh = make_mesh()
    step(mesh)                                              # warm-up
    st, logs, ms = step(mesh)
    logs = reduce_loss_dict(logs, mesh)
    first = next(iter(st.model.parameters())).detach().float()
    every = all_gather_cat(first.reshape(1, -1).contiguous())
    st0, logs0, ms0 = step(None)
    first0 = next(iter(st0.model.parameters())).detach().float()
    dist.barrier()
    return {"ms_per_step": r.rank_max(ms), "one_process_ms_per_step": ms0,
            "loss_rel_err": max(abs(logs[k] - v) / max(abs(v), 1e-12)
                                for k, v in logs0.items()),
            "first_weight_max_abs_vs_one_process":
                (first - first0).abs().max().item(),
            "weights_equal_across_ranks": bool(
                (every == every[:1]).all().item())}


def phase_tp(r):
    import contextlib
    from unittest import mock
    import torch.distributed as dist
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.vqgan import HQ_KEYS, VQHQEncoder
    from comfyui_keep_torch.ops import kernels as K
    from comfyui_keep_torch.parallel import make_mesh, reduce_loss_dict
    from comfyui_keep_torch.parallel.tensor import (shard_params,
                                                    tp_param_specs)
    from comfyui_keep_torch.training.trainers import KEEPTrainer
    import chip_smoke
    torch = r.torch
    opt = chip_smoke.train_opt()
    if r.cpu:
        opt["network_g"] = {"type": "KEEP", **TINY,
                            "fix_modules": ["quantize", "generator"]}
    net = opt["network_g"]
    hq = VQHQEncoder(**{k: v for k, v in net.items()
                        if k in HQ_KEYS}, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    gm = GMFlow(num_layers=1 if r.cpu else 6, device="cpu",
                generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    size, t = net["img_size"], 2 if r.cpu else 8
    batch = {k: torch.rand((2, t, size, size, 3), generator=g) * 2 - 1
             for k in ("lq", "gt")}

    def step(mesh, dtype=torch.float32):
        """One step from the same weights: (losses, {leaf: the applied
        gradient on the CPU}, {leaf: the weight after Adam on the CPU},
        ms). float64 runs the kernels' plain versions in their place (the
        kernels take f32 and bf16)."""
        tr = KEEPTrainer(copy.deepcopy(opt),
                         hq_vqgan=copy.deepcopy(hq).to(dtype),
                         gmflow=copy.deepcopy(gm).to(dtype),
                         device=r.device, mesh=mesh)
        grads = {}
        tr.before_step = lambda st: grads.update(
            (n, p.grad.detach().cpu()) for n, p in
            st.model.named_parameters() if p.grad is not None)
        st = tr.make_state(tr.init_model().to(dtype))
        fed = {k: v.to(r.device, dtype) for k, v in batch.items()}
        with (mock.patch.multiple(K, **K.PLAIN) if dtype == torch.float64
              else contextlib.nullcontext()):
            (st, logs), ms = r.timed(lambda: tr.train_step(st, fed))
        params = {n: p.detach().cpu() for n, p in
                  st.model.named_parameters()}
        del tr, st, fed
        if not r.cpu:
            torch.cuda.empty_cache()
        return reduce_loss_dict(logs, mesh), grads, params, ms
    mesh = make_mesh(("data", "model"), (r.world // 2, 2))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        logs, grads, got, ms = step(mesh)
        logs0, grads0, params0, ms0 = step(None)
        grads0b = step(None)[1]
        logs64, grads64, _, ms64 = step(mesh, torch.float64)
        logs064, grads064, _, ms064 = step(None, torch.float64)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    skeleton = KEEPTrainer(copy.deepcopy(opt), hq_vqgan=hq, gmflow=gm,
                           device="cpu").init_model()
    split = sorted(k for k, d in tp_param_specs(skeleton, 2).items()
                   if d is not None)

    def sliced(tensors):
        """This rank's slices of whole-model tensors (shard_params on a
        CPU copy; it only slices)."""
        dtype = next(iter(tensors.values())).dtype
        model = copy.deepcopy(skeleton).to(dtype)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in tensors:
                    p.copy_(tensors[n])
        return {n: p.detach() for n, p in
                shard_params(model, mesh).named_parameters()}
    want_g, want_g64 = sliced(grads0), sliced(grads064)
    want_p = sliced(params0)

    def grad_gap(gs, ref):
        """Over the leaves: the worst elementwise allclose violation, and
        the worst of allclose's L2 form, ||d|| - (rtol ||ref|| + atol
        sqrt(n)), which a sum with cancelling terms does not defeat; each
        with its leaf (this rank's)."""
        viol = {n: violation(g.numpy(), ref[n].numpy(), **TP_TOL)
                for n, g in gs.items()}
        l2 = {n: ((g - ref[n]).double().norm()
                  - TP_TOL["rtol"] * ref[n].double().norm()
                  - TP_TOL["atol"] * g.numel() ** 0.5).item()
              for n, g in gs.items()}
        worst_v, worst_l = max(viol, key=viol.get), max(l2, key=l2.get)
        return {"violation": r.rank_max(viol[worst_v]),
                "l2_violation": r.rank_max(l2[worst_l]),
                "worst_violation_leaf": [worst_v, viol[worst_v]],
                "worst_l2_leaf": [worst_l, l2[worst_l]]}

    def worst_element():
        """This rank's element furthest past the f32 elementwise limit,
        with each run's reading of it: the unsharded and sharded f32
        steps, the unsharded rerun, and the float64 unsharded and
        sharded steps (the reference with rounding out of the way)."""
        want_b = sliced(grads0b)
        best = None
        for n, g in grads.items():
            ref = want_g[n].double()
            v = (g.double() - ref).abs() - (TP_TOL["atol"]
                                            + TP_TOL["rtol"] * ref.abs())
            i = int(v.flatten().argmax())
            if best is None or v.flatten()[i] > best[2]:
                best = (n, i, float(v.flatten()[i]))
        n, i, v = best
        at = {k: float(t[n].flatten()[i]) for k, t in (
            ("f32_unsharded", want_g), ("f32_sharded", grads),
            ("f32_unsharded_rerun", want_b), ("f64_unsharded", want_g64),
            ("f64_sharded", grads64))}
        return {"rank": r.rank, "leaf": n, "index": i, "violation": v,
                "leaf_max_abs_f64": float(want_g64[n].abs().max()),
                "leaf_numel": want_g64[n].numel(), **at}
    element = worst_element()
    elements = [None] * r.world
    dist.all_gather_object(elements, element)
    return {"mesh": mesh.shape, "ms_per_step": r.rank_max(ms),
            "unsharded_ms_per_step": ms0, "losses": logs,
            "split_leaves": len(split),
            "loss_violation": r.rank_max(max(
                violation(logs[k], v, **TP_TOL) for k, v in logs0.items())),
            "grads": grad_gap(grads, want_g),
            "rerun_grads": grad_gap(grads0b, grads0),
            "split_weight_violation": r.rank_max(max(
                violation(got[k].numpy(), want_p[k].numpy(), **TP_TOL)
                for k in split)),
            "f64": {"ms_per_step": r.rank_max(ms64),
                    "unsharded_ms_per_step": ms064,
                    "loss_violation": r.rank_max(max(
                        violation(logs64[k], v, **TP_TOL)
                        for k, v in logs064.items())),
                    "grads": grad_gap(grads64, want_g64),
                    "f32_unsharded_grads": grad_gap(
                        {n: g.double() for n, g in sliced(grads0).items()},
                        want_g64),
                    "f32_sharded_grads": grad_gap(
                        {n: g.double() for n, g in grads.items()},
                        want_g64)},
            "worst_f32_elements": elements}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo CPU ranks at a tiny width (a rehearsal)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "parallel_check.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from comfyui_keep_torch.parallel import init_distributed
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("no CUDA device (use --cpu for the CPU rehearsal)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu:
        torch.set_num_threads(1)
    rank, world = init_distributed(device="cpu" if args.cpu else None)
    if world < 2 or world % 2:
        sys.exit(f"needs an even world of 2 or more ranks, got {world}")
    if not args.cpu:
        from comfyui_keep_torch.ops import _build
        if rank == 0:
            _build.build_all()
        dist.barrier()
        _build.build_all()
    r = Rank(torch, args.cpu)
    results = {"world": world, "backend": dist.get_backend()}
    if rank == 0 and not args.cpu:
        results["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    proc = r.processor()
    with torch.no_grad():
        results["chunks"] = phase_chunks(r, proc)
        results["ring"] = phase_ring(r, proc)
    del proc
    results["sr"] = phase_sr(r)
    results["tp"] = phase_tp(r)
    if not args.cpu:
        torch.cuda.empty_cache()
    ok = (r.rank != 0 or (results["chunks"]["bitwise"]
                          and results["ring"]["bitwise"]))
    ok = ok and results["sr"]["weights_equal_across_ranks"] \
        and results["sr"]["loss_rel_err"] <= 1e-5 \
        and max(results["tp"]["loss_violation"],
                results["tp"]["grads"]["l2_violation"],
                results["tp"]["split_weight_violation"],
                results["tp"]["f64"]["loss_violation"],
                results["tp"]["f64"]["grads"]["violation"]) <= 0
    flag = torch.tensor([int(ok)], device=torch.device("cpu") if args.cpu
                        else r.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    results["ok"] = bool(flag.item())
    if rank == 0:
        for k, v in results.items():
            print(json.dumps({"phase": k, "result": v}, default=str),
                  flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    dist.destroy_process_group()
    sys.exit(0 if results["ok"] else 1)


if __name__ == "__main__":
    main()
