"""Process groups and collectives of the port (reference
wm_basicsr/utils/dist_util.py:10-82, base_model.py:367-392), ported from
comfyui_keep_tpu/parallel/mesh.py onto torch.distributed.

Mapping from the JAX package:
  jax.distributed.initialize           -> init_distributed (torchrun's
                                          RANK / WORLD_SIZE / MASTER_ADDR /
                                          LOCAL_RANK, where JAX reads
                                          JAX_COORDINATOR_ADDRESS)
  Mesh(devices, axes)                  -> Mesh: the axes' sizes and one
                                          process group per axis line
  data_sharding (P("data"))            -> shard_batch: this rank's rows of
                                          the batch along the data axis
  replicated_sharding (P())            -> broadcast_module: every parameter
                                          and buffer from the group's first
                                          rank
  process_allgather(...).mean()        -> reduce_loss_dict: one all_reduce

A rank is one process holding one card (NCCL) or one CPU process (gloo).
NCCL takes contiguous tensors only (gloo copies others itself), so the
helpers here hand a strided tensor, such as a transposed gradient, over as
a contiguous copy and write the result back.
Ranks lie on the mesh in row-major order: with axes ("data", "model") and
shape (D, M), rank r sits at data index r // M and model index r % M, so
the model axis is the contiguous one, as JAX reshapes its device list.

Under gloo a collective takes CPU tensors: `comm_device` says where a
tensor must sit for the group's backend, and the callers here stage a CUDA
tensor through the host only when the backend is gloo.
"""
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group and return (rank, world size).

    The group's address, size and this process's rank come from the
    arguments, else from torchrun's environment (MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK). With neither, the process stays alone,
    (0, 1), as the JAX package does without JAX_COORDINATOR_ADDRESS.
    The backend is NCCL, with this process on card LOCAL_RANK (or rank
    modulo the visible cards), unless the caller names one or asks for the
    CPU (device="cpu"), which takes gloo. Calling it again in a process
    that already joined returns the group's (rank, world)."""
    if _initialized():
        return get_dist_info()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or (init_method is None
                              and "MASTER_ADDR" not in env):
        return 0, 1
    if rank is None:
        raise ValueError("init_distributed: a world size without a rank")
    on_cpu = device == "cpu" or not torch.cuda.is_available()
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if backend == "nccl" and on_cpu:
        raise ValueError("NCCL needs a card; ask for gloo on the CPU")
    if not on_cpu:
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return get_dist_info()


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) outside one
    (reference dist_util.get_dist_info)."""
    if _initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def comm_device(group=None) -> torch.device:
    """Where a collective of `group` takes its tensors: the current card
    under NCCL, the CPU under gloo (or with no group at all)."""
    if _initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """Ranks laid out on named axes (the JAX Mesh's counterpart). `shape`
    maps each axis to its size, `coords` this rank's index on each, and
    `group(axis)` is the process group of the ranks that share this rank's
    indices on every other axis (None where the axis has size 1, or with no
    process group at all). Build it with make_mesh."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        rank, world = get_dist_info()
        size = 1
        for s in self.shape.values():
            size *= s
        if size != world:
            raise ValueError(f"mesh {self.shape} holds {size} ranks, the "
                             f"group has {world}")
        self.rank = rank
        strides, acc = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = acc
            acc *= self.shape[a]
        self.coords = {a: rank // strides[a] % self.shape[a]
                       for a in self.axis_names}
        self._groups: Dict[str, object] = {}
        for a in self.axis_names:
            if self.shape[a] == 1:
                continue
            # every rank makes every group, in one order (new_group's rule)
            others = [b for b in self.axis_names if b != a]
            lines = {}
            for r in range(world):
                key = tuple(r // strides[b] % self.shape[b] for b in others)
                lines.setdefault(key, []).append(r)
            for ranks in lines.values():
                g = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[a] = g

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A Mesh over the default group's ranks (a world of 1 outside one).
    axes=("data",) is data parallelism over every rank; ("data", "model")
    adds a tensor-parallel axis; shape defaults to (world, 1, ...)."""
    _, world = get_dist_info()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"axes {axes} and shape {shape} differ in length")
    return Mesh(axes, shape)


def all_reduce_(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """torch.distributed.all_reduce of `t` in place over `group`, staged
    through the host when the backend is gloo and `t` is on a card (and
    through float32 for a 16-bit `t` under gloo), and through a contiguous
    copy when `t` is strided."""
    op = dist.ReduceOp.SUM if op is None else op
    dev = comm_device(group)
    dtype = (torch.float32 if dev.type == "cpu"
             and t.dtype in (torch.float16, torch.bfloat16) else t.dtype)
    if t.device == dev and t.dtype == dtype and t.is_contiguous():
        dist.all_reduce(t, op=op, group=group)
        return t
    buf = t.to(dev, dtype).contiguous()
    dist.all_reduce(buf, op=op, group=group)
    t.copy_(buf)
    return t


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0
                   ) -> torch.Tensor:
    """The group's tensors of one shape, concatenated along `dim` in rank
    order, on t's device (staged through the host under gloo)."""
    dev = comm_device(group)
    src = t.to(dev).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def shard_batch(batch: Dict, mesh: Optional[Mesh], axis: str = "data"
                ) -> Dict:
    """This rank's rows of every tensor or array in `batch` (its share of
    the batch along `axis`: rows [i * B / D, (i + 1) * B / D) for index i of
    D), the JAX package's data_sharding; other values pass through. The
    batch size must divide by the axis size."""
    d = 1 if mesh is None else mesh.size(axis)
    if d == 1:
        return batch
    i = mesh.index(axis)
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1:
            n = v.shape[0]
            if n % d:
                raise ValueError(f"batch {k!r} of {n} rows does not split "
                                 f"over {d} ranks of {axis!r}")
            out[k] = v[i * (n // d):(i + 1) * (n // d)]
        else:
            out[k] = v
    return out


def broadcast_module(module: torch.nn.Module, mesh: Optional[Mesh] = None,
                     axis: Optional[str] = None) -> torch.nn.Module:
    """Every parameter and buffer of `module` from the first rank of
    `axis`'s group (the default group's rank 0 when axis is None), in
    place: the JAX package's replicated_sharding."""
    if not _initialized():
        return module
    group = None if axis is None else mesh.group(axis)
    if axis is not None and group is None:
        return module
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dev = comm_device(group)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            buf = t.data.to(dev).contiguous()
            dist.broadcast(buf, src=src, group=group)
            if buf is not t.data:
                t.data.copy_(buf)
    return module


def reduce_loss_dict(loss_dict: Dict, mesh: Optional[Mesh] = None,
                     axis: str = "data") -> Dict[str, float]:
    """The mean of each scalar loss over the ranks of `axis`'s group (the
    default group's ranks without a mesh), in sorted key order, with one
    all_reduce (reference base_model.py:367-392); floats."""
    keys = sorted(loss_dict)
    vals = [float(loss_dict[k]) for k in keys]
    group = None if mesh is None else mesh.group(axis)
    n = (dist.get_world_size(group)
         if _initialized() and (mesh is None or group is not None) else 1)
    if n == 1:
        return dict(zip(keys, vals))
    t = torch.tensor(vals, dtype=torch.float64, device=comm_device(group))
    dist.all_reduce(t, group=group)
    return {k: float(v) for k, v in zip(keys, (t / n).tolist())}
