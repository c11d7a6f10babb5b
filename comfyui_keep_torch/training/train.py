"""The train and test loops (reference wm_basicsr/train.py:91-210,
test.py:12-41), ported from comfyui_keep_tpu/training/train.py: seed ->
the experiment's directories -> the train and val loaders (EnlargedSampler)
-> the trainer -> auto-resume -> the CUDA prefetcher -> the loop {feed,
step, log, save, validate}, data-parallel over torch.distributed's ranks
when the process group holds more than one; test_pipeline: the trainer's
network from path.pretrain_network_g (a .pth state dict, where the JAX
package reads its .npz) through every test* / val* dataset.
"""
import copy
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from comfyui_keep_torch.data import build_dataloader, build_dataset
from comfyui_keep_torch.data.prefetch import CUDAPrefetcher, DataLoader
from comfyui_keep_torch.data.samplers import EnlargedSampler
from comfyui_keep_torch.parallel.mesh import (get_dist_info, make_mesh,
                                              reduce_loss_dict)
from comfyui_keep_torch.training.state import TrainState, load_network
from comfyui_keep_torch.training.trainers import build_model
from comfyui_keep_torch.utils.logger import (AvgTimer, MessageLogger,
                                             get_env_info, get_root_logger)
from comfyui_keep_torch.utils.misc import make_exp_dirs, set_random_seed


def create_train_val_loaders(opt: Dict, logger, num_devices: int = 1,
                             dist: bool = False):
    """(train loader, [(name, dataset type, loader)] of the val* phases)
    from opt["datasets"]: the train phase through an EnlargedSampler
    (dataset_enlarge_ratio), its dataset's streams seeded with
    manual_seed; a val phase in order, batch 1. With dist, each rank's
    train loader takes its own share of the sampler's indices and
    batch_size_per_gpu of them a batch, its streams seeded with
    manual_seed + rank."""
    train_loader, val_loaders = None, []
    rank = get_dist_info()[0] if dist else 0
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            ds = build_dataset(dataset_opt)
            sampler = EnlargedSampler(
                len(ds), ratio=dataset_opt.get("dataset_enlarge_ratio", 1))
            train_loader = build_dataloader(
                ds, {**dataset_opt, "phase": "train"}, sampler=sampler,
                num_devices=num_devices, dist=dist,
                seed=opt.get("manual_seed", 0) + rank)
            logger.info(f"train dataset {dataset_opt['type']}: {len(ds)} "
                        "items")
        elif phase.startswith("val"):
            ds = build_dataset(dataset_opt)
            val_loaders.append(
                (dataset_opt.get("name", phase), dataset_opt.get("type", ""),
                 build_dataloader(ds, {**dataset_opt, "phase": "val"})))
            logger.info(f"val dataset {dataset_opt['type']}: {len(ds)} items")
    return train_loader, val_loaders


def run_validation(trainer, model, val_loaders, metrics_opt: Dict,
                   opt: Optional[Dict] = None,
                   current_iter: Optional[int] = None) -> Dict:
    """Every val loader through trainer.forward(model, lq): video-style
    datasets (type Video*, VFHQ*, REDS*, Vimeo*) by validate_videos, with
    each folder's metrics logged, the rest by validate_images. Returns
    {dataset name: {metric: value}}.

    With val.save_img and path.visualization, each output is written as
    PNG in the reference's layout: in training <vis>/<img>/<img>_<iter>.png,
    in a test <vis>/<dataset>/<img>_<val.suffix or the run's name>.png;
    video frames <vis>/<dataset>/<folder>/<frame>_<iter or tag>.png."""
    from comfyui_keep_torch.training.validation import (validate_images,
                                                        validate_videos)
    from comfyui_keep_torch.utils import png
    logger = get_root_logger()
    opt = opt or {}
    vis_dir = opt.get("path", {}).get("visualization")
    save_img = bool(opt.get("val", {}).get("save_img")) and vis_dir
    in_training = bool(opt.get("is_train")) and current_iter is not None

    def make_save_fn(ds_name):
        if not save_img:
            return None

        def save(img_bgr_u8, img_name):
            tag = (str(current_iter) if in_training else
                   opt.get("val", {}).get("suffix") or opt.get("name", "x"))
            if "/" in img_name:        # a video frame, "folder/00000042"
                folder, frame = img_name.rsplit("/", 1)
                path = os.path.join(vis_dir, ds_name, folder,
                                    f"{frame}_{tag}.png")
            elif in_training:
                path = os.path.join(vis_dir, img_name,
                                    f"{img_name}_{tag}.png")
            else:
                path = os.path.join(vis_dir, ds_name, f"{img_name}_{tag}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            png.imwrite_bgr(path, img_bgr_u8)
        return save

    def fwd(lq):
        return trainer.forward(model, torch.as_tensor(
            np.ascontiguousarray(lq), device=trainer.device))

    results = {}
    for name, ds_type, loader in val_loaders:
        if ds_type.startswith(("Video", "VFHQ", "REDS", "Vimeo")):
            per_folder, avg = validate_videos(fwd, loader, metrics_opt,
                                              save_fn=make_save_fn(name))
            for folder, fm in per_folder.items():
                logger.info(f"  [{name}] {folder}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in fm.items()))
            results[name] = avg
        else:
            results[name] = validate_images(fwd, loader, metrics_opt,
                                            save_fn=make_save_fn(name))
    return results


def _eval_model(state: TrainState):
    """The model validation runs: a copy holding the EMA when one is
    tracked (sr_model.py validates net_g_ema), else the model itself."""
    if state.ema is None:
        return state.model
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state.ema[n])
    return model


def _resume(opt, trainer, state: TrainState, latest: str, logger) -> Dict:
    """Optimizer, counters, weights, EMA and the trainer's extra state from
    `latest` and the net_g_<iter>.pth of its iteration. Returns the weights'
    {"loaded", "kept"} tensor counts ({} without a net_g_<iter>.pth)."""
    state.resume_optimizer(state.resume(latest))
    net_path = os.path.join(opt["path"]["models"], f"net_g_{state.iter}.pth")
    if not os.path.exists(net_path):
        logger.warning(f"resume state {latest} has no matching {net_path}; "
                       "continuing with fresh weights")
        return {}
    stats = state.load_networks(net_path, strict=False)
    if stats.get("kept", 0):
        logger.warning(
            f"resumed from {latest} at iter {state.iter}, but "
            f"{stats['kept']} tensors had no matching checkpoint entry (kept "
            f"init); {stats.get('loaded', 0)} restored: check the network "
            f"options against {net_path}")
    else:
        logger.info(f"resumed from {latest} at iter {state.iter}: "
                    f"{stats.get('loaded', 0)} tensors and the optimizer "
                    "state restored")
    if hasattr(trainer, "load_extra_state"):
        trainer.load_extra_state(state.resume_extra)
    return stats


def train_pipeline(opt: Dict, max_iters: Optional[int] = None,
                   trainer_kwargs: Optional[Dict] = None):
    """Train per the options to train.total_iter (or max_iters) and return
    (state, the last step's losses with the loop's mean iteration and data
    times in seconds, "time" and "data_time", and "run": what the run did,
    {"trainer", "start_iter" (after any resume), "restored" (the resume's
    {"loaded", "kept"} tensor counts, None on a fresh run), "resume_s",
    "step_s" (each train_step, which ends on the losses' host copy),
    "save_s" (each save), "batch" (the last batch fed, None if no step
    ran), "val" ({iter: run_validation's results}), "val_s"}). With val*
    datasets and val.val_freq, the model (its EMA when tracked) is
    validated every val_freq iterations; the metrics are logged, go to the
    tensorboard stream, and join the returned losses as
    "val/<dataset>/<metric>". A batch with blur kernels goes through the
    trainer's feed_data first (the Real-ESRGAN trainers). The trainer is
    build_model(opt,
    **trainer_kwargs) (its device: "cuda" unless trainer_kwargs say
    device="cpu"). opt["path"] names models, training_states and, for a
    fresh run, experiments_root (moved aside and made anew). With
    auto_resume, the latest <iter>.state in training_states and its
    net_g_<iter>.pth resume the run (the directories kept, as the
    reference keeps them); a new epoch starts. logger.save_checkpoint_freq
    and print_freq pace saves and log lines; the iteration and data times
    are the means of AvgTimer.

    Data parallelism (the JAX package's mesh over its devices): when a
    torch.distributed group of more than one rank is set up
    (parallel/mesh.py:init_distributed, e.g. under torchrun), the trainer
    gets a ("data",) mesh over every rank, each rank's loader gives it
    batch_size_per_gpu items of its own share of the sampler, the logged
    losses are their mean over the ranks (reduce_loss_dict), and rank 0
    alone makes the directories and saves; every rank resumes from
    rank 0's files. Validation runs on every rank."""
    import torch.distributed as tdist
    logger = get_root_logger()
    logger.info(get_env_info())
    set_random_seed(opt.get("manual_seed", 0))
    rank, world = get_dist_info()
    mesh = make_mesh() if world > 1 else None
    latest = (TrainState.latest_state(opt["path"]["training_states"])
              if opt.get("auto_resume") else None)
    if latest is None and opt["path"].get("experiments_root") and rank == 0:
        make_exp_dirs(opt)
    if mesh is not None:
        tdist.barrier()

    train_loader, val_loaders = create_train_val_loaders(
        opt, logger, dist=mesh is not None)
    trainer = build_model(opt, mesh=mesh, **(trainer_kwargs or {}))
    if hasattr(trainer, "check_lq_scale"):       # the KEEP trainers
        trainer.check_lq_scale(getattr(train_loader.dataset, "scale", 1))
    trainer.batch_is_local = True
    state = trainer.make_state()
    run = {"trainer": trainer, "restored": None, "resume_s": None,
           "step_s": [], "save_s": [], "batch": None, "val": {},
           "val_s": []}
    if latest is not None:
        t0 = time.perf_counter()
        run["restored"] = _resume(opt, trainer, state, latest, logger)
        run["resume_s"] = time.perf_counter() - t0
    run["start_iter"] = state.iter

    total_iter = max_iters or opt.get("train", {}).get("total_iter", 1000)
    logger_opt = opt.get("logger", {})
    save_freq = logger_opt.get("save_checkpoint_freq", 1e9)
    print_freq = logger_opt.get("print_freq", 100)
    val_freq = opt.get("val", {}).get("val_freq")
    tb_logger = None
    if (logger_opt.get("wandb") or {}).get("project") is not None:
        from comfyui_keep_torch.utils.logger import init_wandb_logger
        init_wandb_logger(opt)
    if logger_opt.get("use_tb_logger"):
        from comfyui_keep_torch.utils.logger import init_tb_logger
        tb_logger = init_tb_logger(
            os.path.join(opt["path"].get("log", "."), "tb_logger"))
    msg_logger = MessageLogger(opt, state.iter + 1, tb_logger)
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    prefetcher = CUDAPrefetcher(train_loader, device=trainer.device)

    epoch = state.epoch
    logs = {}
    while state.iter < total_iter:
        train_loader.epoch = epoch
        if train_loader.sampler is not None:
            train_loader.sampler.set_epoch(epoch)
        data_timer.start()
        iter_timer.start()
        prefetcher.reset()
        batch = prefetcher.next()
        if batch is None:
            raise ValueError(
                "train loader produced no batches: dataset smaller than the "
                "batch (drop_last); raise dataset_enlarge_ratio or lower "
                "batch_size_per_gpu")
        while batch is not None and state.iter < total_iter:
            data_timer.record()
            run["batch"] = {k: v for k, v in batch.items()
                            if torch.is_tensor(v)}
            if hasattr(trainer, "feed_data"):
                run["batch"] = trainer.feed_data(run["batch"])
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, run["batch"])
            if mesh is not None:
                logs = reduce_loss_dict(logs, mesh)
            run["step_s"].append(time.perf_counter() - t0)
            iter_timer.record()
            if state.iter % print_freq == 0:
                msg_logger({"iter": state.iter, "epoch": epoch,
                            "lrs": [trainer.current_lr(state.iter)],
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time(), **logs})
            if state.iter % save_freq == 0 and rank == 0:
                t0 = time.perf_counter()
                state.save(opt["path"]["models"],
                           opt["path"]["training_states"], state.iter,
                           extra=trainer.extra_state()
                           if hasattr(trainer, "extra_state") else None)
                run["save_s"].append(time.perf_counter() - t0)
            if val_loaders and val_freq and state.iter % val_freq == 0:
                t0 = time.perf_counter()
                res = run_validation(trainer, _eval_model(state),
                                     val_loaders,
                                     opt.get("val", {}).get("metrics", {}),
                                     opt=opt, current_iter=state.iter)
                run["val_s"].append(time.perf_counter() - t0)
                run["val"][state.iter] = res
                for name, r in res.items():
                    logger.info(f"validation [{name}] @{state.iter}: " +
                                ", ".join(f"{k}={v:.4f}"
                                          for k, v in r.items()))
                    for k, v in r.items():
                        if tb_logger is not None:
                            tb_logger.add_scalar(f"metrics/{name}/{k}", v,
                                                 state.iter)
                    logs.update({f"val/{name}/{k}": v for k, v in r.items()})
            data_timer.start()
            iter_timer.start()
            batch = prefetcher.next()
        epoch += 1
        state.epoch = epoch
    return state, {**logs, "time": iter_timer.get_avg_time(),
                   "data_time": data_timer.get_avg_time(), "run": run}


def test_pipeline(opt: Dict, trainer_kwargs: Optional[Dict] = None) -> Dict:
    """The test run (reference test.py:12-41): the trainer's network
    (init_model, seeded from manual_seed) with path.pretrain_network_g's
    weights if given (a .pth: a state dict, or a net_g_<iter>.pth whose EMA
    is preferred), on the trainer's device, through every test* / val*
    dataset in name order, batch 1. Returns {dataset name: {metric:
    value}}."""
    logger = get_root_logger()
    set_random_seed(opt.get("manual_seed", 0))
    trainer = build_model(opt, **(trainer_kwargs or {}))
    model = trainer.init_model()
    ckpt = opt.get("path", {}).get("pretrain_network_g")
    if ckpt:
        model.load_state_dict(load_network(ckpt))
        logger.info(f"loaded network weights from {ckpt}")
    model = model.to(trainer.device).eval()
    loaders = []
    for phase, dataset_opt in sorted(opt["datasets"].items()):
        if not phase.startswith(("test", "val")):
            continue
        ds = build_dataset(dataset_opt)
        name = dataset_opt.get("name", phase)
        logger.info(f"testing {name} ({len(ds)} items)")
        loaders.append((name, dataset_opt.get("type", ""),
                        DataLoader(ds, batch_size=1, drop_last=False)))
    results = run_validation(trainer, model, loaders,
                             opt.get("val", {}).get("metrics", {}), opt=opt)
    for name, res in results.items():
        logger.info(f"{name}: {res}")
    return results
