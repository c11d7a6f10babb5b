"""Batching and the host-to-card feed (reference data/
prefetch_dataloader.py), the port's copy of comfyui_keep_tpu/data/
prefetch.py with a CUDA side-stream prefetcher in place of its
DevicePrefetcher.

DataLoader: sampler-driven batches over a map-style dataset, on worker
threads (numpy, zlib and torch's CPU ops release the interpreter lock).
CUDAPrefetcher: the reference's CUDAPrefetcher: the next batch is pinned
and copied on a side stream while the current step runs; the step's stream
waits on that copy before using it.
"""
import collections
import concurrent.futures as cf
import itertools
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def default_collate(samples):
    """Stack the arrays of each key; other values (paths, keys) as lists."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class DataLoader:
    """Batches of `batch_size` indices from the sampler (else 0..n-1,
    shuffled by np.random.default_rng(seed + epoch) when shuffle), the last
    short batch dropped when drop_last. With num_workers > 0 the batches
    are made on that many threads, at most 2 * num_workers ahead, and
    handed out in order; a worker's exception is raised where its batch
    would have been. A dataset that owns random streams (`seed_streams`)
    has them seeded with `seed` here."""

    def __init__(self, dataset, batch_size=1, sampler=None, shuffle=False,
                 num_workers=0, collate_fn=default_collate, drop_last=True,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate = collate_fn
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if hasattr(dataset, "seed_streams"):
            dataset.seed_streams(seed)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(
            self.dataset)
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _load(self, batch):
        return self.collate([self.dataset[i] for i in batch])

    def __iter__(self) -> Iterator[Dict]:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers <= 0:
            for b in batches:
                yield self._load(b)
            return
        pool = cf.ThreadPoolExecutor(self.num_workers)
        try:
            todo = iter(batches)
            pending = collections.deque(
                pool.submit(self._load, b)
                for b in itertools.islice(todo, 2 * self.num_workers))
            while pending:
                f = pending.popleft()
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                yield f.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


class CPUPrefetcher:
    """The loader's batches as they come, None at the end of an epoch."""

    def __init__(self, loader):
        self.loader = loader
        self._iter = None

    def reset(self):
        self._iter = iter(self.loader)

    def next(self):
        if self._iter is None:
            self.reset()
        try:
            return next(self._iter)
        except StopIteration:
            return None


class CUDAPrefetcher:
    """The loader's batches with their arrays as tensors on `device`, one
    batch ahead (reference prefetch_dataloader.py:82-140). On a CUDA device
    the arrays are pinned and copied with non_blocking on a side stream;
    next() makes the current stream wait for that copy and records the
    tensors on it, so the caching allocator keeps them until the step is
    done with them. On a CPU device the arrays are copied into tensors.
    next() returns None at the end of an epoch and raises the loader's
    exception where its batch would have been."""

    def __init__(self, loader, device="cuda"):
        self.loader = loader
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._iter = None
        self._batch: Optional[Dict] = None
        self._error: Optional[BaseException] = None

    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                out[k] = v
            elif self.stream is None:
                out[k] = torch.tensor(v)
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(
                    v)).pin_memory().to(self.device, non_blocking=True)
        return out

    def _preload(self):
        self._batch = None
        try:
            batch = next(self._iter)
        except StopIteration:
            return
        except Exception as e:  # raised by next(), after the current batch
            self._error = e
            return
        if self.stream is None:
            self._batch = self._to_device(batch)
        else:
            with torch.cuda.stream(self.stream):
                self._batch = self._to_device(batch)

    def reset(self):
        self._iter = iter(self.loader)
        self._error = None
        self._preload()

    def next(self):
        if self._iter is None:
            self.reset()
        if self._error is not None:
            err, self._error = self._error, None
            self._iter = None
            raise err
        batch = self._batch
        if batch is None:
            return None
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for v in batch.values():
                if torch.is_tensor(v):
                    v.record_stream(current)
        self._preload()
        return batch
