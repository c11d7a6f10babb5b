"""Carried-state pipeline serving, ported from
comfyui_keep_tpu/parallel/sequence.py over torch.distributed's send / recv.

Chunk-parallel serving (parallel/inference.py) resets KEEP's state at
every chunk. This is its carried-state counterpart: a clip of n * tc
frames is cut into n chunks, rank d of the mesh's "seq" axis holds chunk d
of every clip, and the Kalman / CFA carry, with the chunk's last input
frame, passes from rank d to rank d + 1. One clip alone would leave every
rank but one idle, so the entry point takes a stream of clips and
pipelines them: at tick k rank d runs clip k - d, and the steady state
keeps n_clips / (n_clips + n - 1) of the ranks busy.
"""
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from comfyui_keep_torch.models.keep import arch_tables
from comfyui_keep_torch.parallel.mesh import Mesh, all_gather_cat, comm_device


def _carry_shapes(cfg, b: int, h: int, w: int):
    """Shapes of a carry's tensors, in send order: prev_out (B, H, W, 3),
    each CFA feature (B, s, s, c) in cfa_list order, the last LQ frame."""
    channels = arch_tables(cfg)[0]
    return ([(b, h, w, 3)]
            + [(b, int(f), int(f), channels[f]) for f in cfg["cfa_list"]]
            + [(b, h, w, 3)])


def _send(tensors: List[torch.Tensor], dst: int, group):
    dev = comm_device(group)
    for t in tensors:
        dist.send(t.contiguous().to(dev), dst=dst, group=group)


def _recv(shapes, src: int, group, dtype, device) -> List[torch.Tensor]:
    dev = comm_device(group)
    out = []
    for s in shapes:
        buf = torch.empty(s, dtype=dtype, device=dev)
        dist.recv(buf, src=src, group=group)
        out.append(buf.to(device))
    return out


def restore_stream_pipeline(processor, clips: np.ndarray,
                            mesh: Optional[Mesh] = None,
                            axis: str = "seq") -> np.ndarray:
    """Carried-state restoration of `clips` (N, B, T, H, W, 3) RGB in
    [-1, 1], T = n * tc for n ranks on the mesh's `axis` (1 without a
    mesh): chunk d of every clip runs on rank d, rank 0 in the first-chunk
    form (frame 0 from a reset state), rank d > 0 in the carried form on
    the carry that rank d - 1 sends it. Returns (N, B, T, H, W, 3) float32
    on every rank (the chunks gathered with all_gather).

    `processor` is a KEEPFaceProcessor. With its GMFlow, each chunk's flows
    are its own, and the boundary flow of a carried chunk maps its frame 0
    to the previous chunk's last LQ frame, which rides the ring with the
    carry, as processor.restore_clip computes it with a carry; without
    GMFlow the flows are zero. The carry goes out as ((prev_out, CFA
    features), last LQ frame) by send / recv in the processor's dtype,
    through the host under gloo (gloo's send and recv take CPU tensors)."""
    n_clips, b, t, h, w = clips.shape[:5]
    n = 1 if mesh is None else mesh.size(axis)
    if t % n:
        raise ValueError(f"T = {t} does not split into {n} chunks")
    tc = t // n
    d = 0 if mesh is None else mesh.index(axis)
    group = None if mesh is None else mesh.group(axis)
    ranks = ([dist.get_global_rank(group, i) for i in range(n)]
             if group is not None else [0])
    shapes = _carry_shapes(processor.keep.cfg, b, h, w)
    cfa_keys = list(processor.keep.cfg["cfa_list"])
    x = clips[:, :, d * tc:(d + 1) * tc]
    outs = []
    with torch.no_grad():
        for j in range(n_clips):
            xc = x[j]
            if d == 0:
                out, carry = processor._restore(xc, None, True)
            else:
                got = _recv(shapes, ranks[d - 1], group, processor.dtype,
                            processor.device)
                carry = (got[0], dict(zip(cfa_keys, got[1:-1])))
                prev_last = got[-1].float().cpu().numpy()
                out, carry = processor._restore(
                    np.concatenate([prev_last[:, None], xc], axis=1), carry,
                    True)
            outs.append(out)
            if d < n - 1:
                last = torch.as_tensor(xc[:, -1]).to(processor.device,
                                                     processor.dtype)
                _send([carry[0]] + [carry[1][f] for f in cfa_keys] + [last],
                      ranks[d + 1], group)
    res = np.stack(outs)
    if n > 1:
        res = all_gather_cat(torch.from_numpy(res), group, dim=2).numpy()
    return res
