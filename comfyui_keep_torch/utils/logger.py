"""Logging and timing of the train loop (reference wm_basicsr/utils/
logger.py), the port's copy of comfyui_keep_tpu/utils/logger.py: the rank-0
root logger, AvgTimer, MessageLogger with its ETA, the environment banner,
and the TensorBoard / wandb writers where those packages are installed."""
import datetime
import functools
import logging
import sys
import time
from typing import Dict, Optional

import torch

_loggers: Dict[str, logging.Logger] = {}


def get_rank() -> int:
    """This process's rank in torch.distributed's group, 0 outside one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def get_root_logger(logger_name: str = "comfyui_keep_torch",
                    log_level=logging.INFO, log_file: Optional[str] = None):
    """The named logger, set up once: a stream handler on every rank, at
    ERROR level off rank 0; on rank 0 at log_level, with a file handler
    when log_file is given."""
    if logger_name in _loggers:
        return _loggers[logger_name]
    logger = logging.getLogger(logger_name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    if get_rank() != 0:
        logger.setLevel("ERROR")
    else:
        logger.setLevel(log_level)
        if log_file is not None:
            fh = logging.FileHandler(log_file, "w")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    _loggers[logger_name] = logger
    return logger


def master_only(func):
    """Run func on rank 0 only (reference utils/dist_util.py:74-82)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_rank() == 0:
            return func(*args, **kwargs)
    return wrapper


class AvgTimer:
    """Mean time between record() calls over a window of records
    (reference logger.py:10-42)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0.0
        self.tic = time.time()

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """One line per print_freq iterations: epoch, iteration, LRs, iteration
    and data time, ETA and the losses (reference logger.py:45-117); each
    scalar also goes to the TensorBoard writer when one is given."""

    def __init__(self, opt: Dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt.get("name", "exp")
        self.start_iter = start_iter
        self.max_iters = opt.get("train", {}).get("total_iter", 0)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: Dict):
        log_vars = dict(log_vars)
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lrs = log_vars.pop("lrs", [])
        message = (f"[{self.exp_name[:31]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}, lr:(")
        message += ", ".join(f"{v:.3e}" for v in lrs) + ")] "
        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(
                current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(max(eta_sec, 0))))
            message += (f"[eta: {eta_str}, time (data): "
                        f"{iter_time:.3f} ({data_time:.3f})] ")
        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None:
                self.tb_logger.add_scalar(
                    f"losses/{k}" if k.startswith("l_") else k, v,
                    current_iter)
        self.logger.info(message)


def get_env_info() -> str:
    """Versions of Python, torch and CUDA, and the card (or "cpu")."""
    cuda = torch.cuda.is_available()
    card = (f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
            if cuda else "cpu")
    return (f"\n\tPython: {sys.version.split()[0]}"
            f"\n\tPyTorch: {torch.__version__}"
            f"\n\tCUDA: {torch.version.cuda if cuda else 'unavailable'}"
            f"\n\tDevice: {card}")


@master_only
def init_tb_logger(log_dir: str):
    """A TensorBoard SummaryWriter (reference utils/logger.py:118-122);
    raises ImportError where the tensorboard package is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError("logger.use_tb_logger needs the tensorboard "
                          "package, which is not installed") from e
    return SummaryWriter(log_dir=log_dir)


@master_only
def init_wandb_logger(opt: Dict):
    """wandb syncing the TensorBoard stream (reference utils/logger.py:
    125-146); raises ImportError where wandb is not installed."""
    try:
        import wandb
    except ImportError as e:
        raise ImportError("logger.wandb needs the wandb package, which is "
                          "not installed") from e
    logger = get_root_logger()
    project = opt["logger"]["wandb"]["project"]
    resume_id = opt["logger"]["wandb"].get("resume_id")
    if resume_id:
        wandb_id, resume = resume_id, "allow"
        logger.warning(f"Resume wandb logger with id={wandb_id}.")
    else:
        wandb_id, resume = wandb.util.generate_id(), "never"
    wandb.init(id=wandb_id, resume=resume, name=opt["name"], config=opt,
               project=project, sync_tensorboard=True)
    logger.info(f"Use wandb logger with id={wandb_id}; project={project}.")
