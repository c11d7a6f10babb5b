#!/usr/bin/env python3
"""GMFlow optical-flow training of the PyTorch port (the counterpart of
tools/train_flow.py; reference archs/gmflow/main.py:20-557):

  python tools/torch_train_flow.py --stage chairs --image_size 384 512 \
      --batch_size 8 --num_steps 100000 --lr 4e-4 \
      --chairs_root datasets/FlyingChairs_release/data \
      [--val_dataset chairs] [--resume ckpt.pth] [--device cuda|cpu] \
      [--num_workers 4] [--launcher torch]

The arguments and their defaults are tools/train_flow.py's, with three
more: --device (default cuda; it raises without a card), --num_workers
(the loader's threads; 0, as the JAX tool's loader, by default) and
--launcher (none, or torch: join torchrun's process group through
parallel/mesh.py:init_distributed). GMFlowTrainer
takes its steps through build_train_dataset(stage) and the loader, with
K1-K3 on the card forward and their plain versions' gradients backward.
Every --save_freq steps and at the last one the weights go to
<checkpoint_dir>/gmflow_<stage>_<step>.pth as {"params": state dict}
(the JAX tool writes .npz); --resume loads such a file's weights (not the
optimizer's moments, as in the JAX tool). --val_dataset chairs, sintel or
kitti validates through training/flow_eval.py every --val_freq steps.

In a group of more than one rank (the JAX tool's mesh over more than one
device) training is data-parallel: --batch_size is the global batch, each
rank's loader gives it batch_size / world pairs of its own share of the
sampler (EnlargedSampler), with the dataset's streams seeded by its rank;
the trainer averages the gradients over the ranks, the logged losses are
their mean, and rank 0 alone saves.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--image_size", type=int, nargs=2, default=[384, 512])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--attn_splits", type=int, default=2)
    p.add_argument("--corr_radius", type=int, default=-1)
    p.add_argument("--prop_radius", type=int, default=-1)
    p.add_argument("--chairs_root",
                   default="datasets/FlyingChairs_release/data")
    p.add_argument("--chairs_split_file", default=None)
    p.add_argument("--things_root", default="datasets/FlyingThings3D")
    p.add_argument("--sintel_root", default="datasets/Sintel")
    p.add_argument("--kitti_root", default="datasets/KITTI")
    p.add_argument("--hd1k_root", default="datasets/HD1K")
    p.add_argument("--val_dataset", default=None)
    p.add_argument("--val_freq", type=int, default=10000)
    p.add_argument("--save_freq", type=int, default=10000)
    p.add_argument("--checkpoint_dir", default="experiments/gmflow")
    p.add_argument("--resume", default=None)
    p.add_argument("--summary_freq", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--launcher", choices=["none", "torch"], default="none")
    return p.parse_args(argv)


def flow_opt(args):
    """GMFlowTrainer's options from the arguments, as the JAX tool builds
    them."""
    return {
        "model_type": "GMFlowModel",
        "network_g": {"attn_splits": args.attn_splits,
                      "corr_radius": args.corr_radius,
                      "prop_radius": args.prop_radius},
        "train": {"lr": args.lr, "weight_decay": args.weight_decay,
                  "grad_clip": args.grad_clip, "gamma": args.gamma,
                  "num_steps": args.num_steps},
    }


def setup(args):
    """(trainer, state) for parsed arguments: GMFlowTrainer on --device
    with its seeded weights, or --resume's; with --launcher torch, in the
    process group, on a ("data",) mesh over its ranks when it holds more
    than one."""
    from comfyui_keep_torch.parallel.mesh import (get_dist_info,
                                                  init_distributed, make_mesh)
    from comfyui_keep_torch.training.state import load_network
    from comfyui_keep_torch.training.trainers import build_model
    from comfyui_keep_torch.utils.logger import get_root_logger
    from comfyui_keep_torch.utils.options import check_device
    check_device(args.device)
    if args.launcher == "torch":
        init_distributed(device=args.device)
    world = get_dist_info()[1]
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over {world} ranks")
    trainer = build_model(flow_opt(args), device=args.device,
                          mesh=make_mesh() if world > 1 else None)
    trainer.batch_is_local = True
    state = trainer.make_state()
    if args.resume:
        state.model.load_state_dict(load_network(args.resume))
        get_root_logger().info(f"resumed weights from {args.resume}")
    return trainer, state


def train(args, trainer, state):
    """The training loop (module docstring). Returns run: "logs" (each
    step's losses, their mean over the ranks), "saved" (the paths
    written) and "val" ({step: flow_eval's results})."""
    import torch
    from comfyui_keep_torch.data.flow_datasets import build_train_dataset
    from comfyui_keep_torch.data.prefetch import CUDAPrefetcher, DataLoader
    from comfyui_keep_torch.data.samplers import EnlargedSampler
    from comfyui_keep_torch.parallel.mesh import reduce_loss_dict
    from comfyui_keep_torch.training import flow_eval
    from comfyui_keep_torch.utils.logger import get_root_logger
    logger = get_root_logger()
    roots = {"chairs": args.chairs_root, "things": args.things_root,
             "sintel": args.sintel_root, "kitti": args.kitti_root,
             "hd1k": args.hd1k_root}
    ds = build_train_dataset(args.stage, tuple(args.image_size), roots=roots,
                             chairs_split_file=args.chairs_split_file)
    mesh = trainer.mesh
    if mesh is None:
        rank, world, sampler = 0, 1, None
    else:
        rank, world = mesh.index("data"), mesh.size("data")
        sampler = EnlargedSampler(len(ds), num_replicas=world, rank=rank)
    loader = DataLoader(ds, batch_size=args.batch_size // world,
                        sampler=sampler, shuffle=sampler is None,
                        drop_last=True, num_workers=args.num_workers,
                        seed=rank)
    if len(loader) == 0:
        raise ValueError(f"{args.stage}: {len(ds)} pairs give no batch of "
                         f"{args.batch_size}")
    pre = CUDAPrefetcher(loader, device=args.device)
    logger.info(f"stage={args.stage} dataset={len(ds)} pairs")

    if rank == 0:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
    run = {"logs": [], "saved": [], "val": {}}
    step, epoch = 0, 0
    while step < args.num_steps:
        loader.epoch = epoch
        if sampler is not None:
            sampler.set_epoch(epoch)
        pre.reset()
        batch = pre.next()
        while batch is not None and step < args.num_steps:
            batch = {k: v for k, v in batch.items()
                     if k in ("img1", "img2", "flow", "valid")}
            state, logs = trainer.train_step(state, batch)
            if mesh is not None:
                logs = reduce_loss_dict(logs, mesh)
            run["logs"].append(logs)
            step += 1
            if step % args.summary_freq == 0:
                logger.info(f"step {step}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in logs.items()))
            if rank == 0 and (step % args.save_freq == 0
                              or step == args.num_steps):
                path = os.path.join(args.checkpoint_dir,
                                    f"gmflow_{args.stage}_{step}.pth")
                torch.save({"params": state.model.state_dict()}, path)
                run["saved"].append(path)
                logger.info(f"saved {path}")
            if args.val_dataset and step % args.val_freq == 0:
                fn = flow_eval.make_flow_fn(state.model, args.attn_splits,
                                            args.corr_radius,
                                            args.prop_radius)
                if args.val_dataset == "chairs":
                    res = flow_eval.validate_chairs(
                        fn, root=args.chairs_root,
                        split_file=args.chairs_split_file)
                elif args.val_dataset == "sintel":
                    res = flow_eval.validate_sintel(fn,
                                                    root=args.sintel_root)
                else:
                    res = flow_eval.validate_kitti(fn, root=args.kitti_root)
                run["val"][step] = res
                logger.info(f"val @{step}: {res}")
            batch = pre.next() if step < args.num_steps else None
        epoch += 1
    return run


def main(argv=None):
    """Train per argv (sys.argv[1:] by default). Returns (trainer, state,
    run) (train's run)."""
    args = parse_args(argv)
    trainer, state = setup(args)
    return trainer, state, train(args, trainer, state)


if __name__ == "__main__":
    main()
