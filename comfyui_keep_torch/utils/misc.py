"""Run set-up helpers of the train loop (reference wm_basicsr/utils/misc.py),
the port's copy of comfyui_keep_tpu/utils/misc.py: seeding and the
experiment directories."""
import os
import random
import time

import numpy as np
import torch


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global streams (the card's too)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str):
    """Move an existing directory aside with a time stamp, then create it
    empty."""
    if os.path.exists(path):
        os.rename(path, path + "_archived_" + get_time_str())
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt):
    """Create the options' path directories: experiments_root renamed aside
    if it exists (a training run), results_root otherwise; the others
    (models, training_states, log, ...) created in place, except the
    pretrain_* / resume_* entries, which name files."""
    path_opt = dict(opt["path"])
    if opt.get("is_train"):
        mkdir_and_rename(path_opt.pop("experiments_root"))
    else:
        mkdir_and_rename(path_opt.pop("results_root",
                                      path_opt.get("log", ".")))
    for key, path in path_opt.items():
        if "pretrain" in key or "resume" in key or path is None:
            continue
        os.makedirs(path, exist_ok=True)
