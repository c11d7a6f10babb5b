"""Chunk-parallel clip restoration, ported from
comfyui_keep_tpu/parallel/inference.py.

The reference's max_clip_length chunking (keep_processor.py:263-270) resets
the recurrent state at every chunk, so the chunks are independent programs:
the stream, padded to whole chunks, is split over the mesh's "data" axis,
each rank restores its own chunks, and an all_gather puts the stream back
together on every rank.
"""
import math
from typing import Optional

import numpy as np
import torch

from comfyui_keep_torch.parallel.mesh import Mesh, all_gather_cat


def restore_chunks_parallel(processor, faces_pm1: np.ndarray,
                            max_clip_length: int = 20,
                            mesh: Optional[Mesh] = None) -> np.ndarray:
    """faces_pm1: (N, H, W, 3) RGB in [-1, 1] -> restored (N, H, W, 3)
    float32, on every rank.

    `processor` is a KEEPFaceProcessor (its KEEP, GMFlow, device and
    dtype). The stream is padded with its last frame to whole chunks of
    max_clip_length; with a mesh, the chunk count is rounded up to a
    multiple of the "data" size, and rank i of D restores the contiguous
    chunks [i * C / D, (i + 1) * C / D). Each chunk goes through the
    processor's chunk body one at a time (B = 1: GMFlow on its frame pairs,
    then KEEP from a reset state), and the chunks are gathered with
    all_gather (through the host under gloo) and cut back to N.

    The padded tail gives the JAX package's result, not the processor's:
    the processor restores a ragged last chunk as it is (a 1-frame chunk
    duplicated), this pads it to max_clip_length with its last frame. The
    recurrence is causal, so the pad reaches a real frame only through the
    Kalman estimator's bidirectional temporal attention; the JAX package
    measures that leak (tests/test_parallel.py::
    test_padded_tail_perturbation_bound): exactly zero with the reference's
    zero-initialised temporal output projection, and with that projection
    armed about 3 % of the logit scale with 99 % of the code picks
    unchanged on random weights. For the processor's result use
    restore_face_stream; this entry point is for throughput serving."""
    n = faces_pm1.shape[0]
    if n == 0:
        return faces_pm1
    length = max_clip_length
    n_chunks = math.ceil(n / length)
    d = 1 if mesh is None else mesh.size("data")
    n_chunks = math.ceil(n_chunks / d) * d
    total = n_chunks * length
    idx = np.concatenate([np.arange(n), np.full(total - n, n - 1,
                                                dtype=np.int64)])
    chunks = faces_pm1[idx].reshape((n_chunks, length) + faces_pm1.shape[1:])
    per = n_chunks // d
    rank = 0 if mesh is None else mesh.index("data")
    mine = chunks[rank * per:(rank + 1) * per]
    with torch.no_grad():
        out = np.stack([processor.restore_clip(c) for c in mine])
    if d > 1:
        out = all_gather_cat(torch.from_numpy(out), mesh.group("data"),
                             dim=0).numpy()
    return out.reshape((total,) + out.shape[2:])[:n]
