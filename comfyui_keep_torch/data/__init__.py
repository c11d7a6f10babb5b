"""Training data of the PyTorch port (reference wm_basicsr/data/), ported
from comfyui_keep_tpu/data/: datasets, online degradations, samplers and
the loader with its CUDA prefetcher. Host-side numpy and torch CPU ops; the
batches reach the card through prefetch.CUDAPrefetcher."""
from copy import deepcopy

from comfyui_keep_torch.data import datasets  # noqa: F401 (registers them)
from comfyui_keep_torch.utils.registry import DATASET_REGISTRY


def build_dataset(opt):
    """The dataset the options' `type` names, built on a copy of them."""
    opt = deepcopy(opt)
    return DATASET_REGISTRY.get(opt["type"])(opt)


def build_dataloader(dataset, dataset_opt, num_devices=1, dist=False,
                     sampler=None, seed=None):
    """The loader of a phase (reference data/__init__.py:40-90). train:
    batch_size_per_gpu (and num_worker_per_gpu) times num_devices in one
    process, per process under dist; shuffled when no sampler is given;
    drop_last; the dataset's streams seeded with `seed`. val / test: batch
    1, in order, nothing dropped."""
    from comfyui_keep_torch.data.prefetch import DataLoader

    phase = dataset_opt.get("phase", "train")
    if phase == "train":
        mult = 1 if dist or num_devices == 0 else num_devices
        batch_size = dataset_opt["batch_size_per_gpu"] * mult
        num_workers = dataset_opt.get("num_worker_per_gpu", 0) * mult
        return DataLoader(dataset, batch_size=batch_size,
                          shuffle=sampler is None, sampler=sampler,
                          num_workers=num_workers, drop_last=True,
                          seed=seed or 0)
    if phase in ("val", "test"):
        return DataLoader(dataset, batch_size=1, shuffle=False,
                          num_workers=0, drop_last=False)
    raise ValueError(f"Wrong dataset phase: {phase}. "
                     "Supported ones are 'train', 'val' and 'test'.")
