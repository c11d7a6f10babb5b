"""EnlargedSampler (reference wm_basicsr/data/data_sampler.py), the port's
copy of comfyui_keep_tpu/data/samplers.py: the dataset's indices repeated
`ratio` times, permuted per epoch and split across the data-parallel
ranks (torch.distributed's rank and world size when a group is set up,
else rank 0 of 1), so that an epoch is long enough to amortise its
restart."""
from typing import Iterator, Optional

import numpy as np
import torch


def dist_info():
    """(rank, world size) of torch.distributed's default group, or (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class EnlargedSampler:
    def __init__(self, dataset_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, ratio: int = 1):
        d_rank, d_world = dist_info()
        self.dataset_size = dataset_size
        self.num_replicas = d_world if num_replicas is None else num_replicas
        self.rank = d_rank if rank is None else rank
        self.epoch = 0
        self.num_samples = int(np.ceil(dataset_size * ratio
                                       / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        indices = np.random.default_rng(self.epoch).permutation(
            self.total_size)
        indices = (indices % self.dataset_size).tolist()
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples
