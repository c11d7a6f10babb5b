"""The train loop (reference wm_basicsr/train.py:91-210), ported from
comfyui_keep_tpu/training/train.py: seed -> the experiment's directories ->
the train loader (EnlargedSampler) -> the trainer -> auto-resume -> the
CUDA prefetcher -> the loop {feed, step, log, save}.

Validation during training (`val*` datasets, run_validation) is ROADMAP
Queue 1 item 6.5; options that ask for it raise here.
"""
import os
import time
from typing import Dict, Optional

import torch

from comfyui_keep_torch.data import build_dataloader, build_dataset
from comfyui_keep_torch.data.prefetch import CUDAPrefetcher
from comfyui_keep_torch.data.samplers import EnlargedSampler
from comfyui_keep_torch.training.state import TrainState
from comfyui_keep_torch.training.trainers import build_model
from comfyui_keep_torch.utils.logger import (AvgTimer, MessageLogger,
                                             get_env_info, get_root_logger)
from comfyui_keep_torch.utils.misc import make_exp_dirs, set_random_seed


def create_train_val_loaders(opt: Dict, logger, num_devices: int = 1):
    """(train loader, val loaders) from opt["datasets"]: the train phase
    through an EnlargedSampler (dataset_enlarge_ratio), its dataset's
    streams seeded with manual_seed. A val* phase raises: validation is
    ROADMAP Queue 1 item 6.5."""
    train_loader = None
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            ds = build_dataset(dataset_opt)
            sampler = EnlargedSampler(
                len(ds), ratio=dataset_opt.get("dataset_enlarge_ratio", 1))
            train_loader = build_dataloader(
                ds, {**dataset_opt, "phase": "train"}, sampler=sampler,
                num_devices=num_devices, seed=opt.get("manual_seed"))
            logger.info(f"train dataset {dataset_opt['type']}: {len(ds)} "
                        "items")
        elif phase.startswith("val"):
            raise NotImplementedError(
                f"dataset {phase!r}: validation during training is not "
                "ported yet (ROADMAP Queue 1 item 6.5)")
    return train_loader, []


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
    ran)}). The trainer is build_model(opt,
    **trainer_kwargs) (its device: "cuda" unless trainer_kwargs say
    device="cpu"). opt["path"] names models, training_states and, for a
    fresh run, experiments_root (moved aside and made anew). With
    auto_resume, the latest <iter>.state in training_states and its
    net_g_<iter>.pth resume the run (the directories kept, as the
    reference keeps them); a new epoch starts. logger.save_checkpoint_freq
    and print_freq pace saves and log lines; the iteration and data times
    are the means of AvgTimer."""
    logger = get_root_logger()
    logger.info(get_env_info())
    set_random_seed(opt.get("manual_seed", 0))
    latest = (TrainState.latest_state(opt["path"]["training_states"])
              if opt.get("auto_resume") else None)
    if latest is None and opt["path"].get("experiments_root"):
        make_exp_dirs(opt)

    train_loader, _ = create_train_val_loaders(opt, logger)
    trainer = build_model(opt, **(trainer_kwargs or {}))
    state = trainer.make_state()
    run = {"trainer": trainer, "restored": None, "resume_s": None,
           "step_s": [], "save_s": [], "batch": None}
    if latest is not None:
        t0 = time.perf_counter()
        run["restored"] = _resume(opt, trainer, state, latest, logger)
        run["resume_s"] = time.perf_counter() - t0
    run["start_iter"] = state.iter

    total_iter = max_iters or opt.get("train", {}).get("total_iter", 1000)
    logger_opt = opt.get("logger", {})
    save_freq = logger_opt.get("save_checkpoint_freq", 1e9)
    print_freq = logger_opt.get("print_freq", 100)
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
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, run["batch"])
            run["step_s"].append(time.perf_counter() - t0)
            iter_timer.record()
            if state.iter % print_freq == 0:
                msg_logger({"iter": state.iter, "epoch": epoch,
                            "lrs": [trainer.current_lr(state.iter)],
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time(), **logs})
            if state.iter % save_freq == 0:
                t0 = time.perf_counter()
                state.save(opt["path"]["models"],
                           opt["path"]["training_states"], state.iter,
                           extra=trainer.extra_state()
                           if hasattr(trainer, "extra_state") else None)
                run["save_s"].append(time.perf_counter() - t0)
            data_timer.start()
            iter_timer.start()
            batch = prefetcher.next()
        epoch += 1
        state.epoch = epoch
    return state, {**logs, "time": iter_timer.get_avg_time(),
                   "data_time": data_timer.get_avg_time(), "run": run}
