"""Multi-face tracking across frames (reference keep_processor.py:33-115),
a copy of comfyui_keep_tpu/pipeline/tracking.py.

On the host, in numpy and scipy: the assignment is O(faces^2) per frame on
5-point landmarks, negligible next to the device work.
"""
from typing import Dict, List

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.optimize import linear_sum_assignment


def interpolate_sequence(sequence: np.ndarray) -> np.ndarray:
    """Fill NaNs per 1-D coordinate via linear interpolation
    (keep_processor.py:33-40)."""
    out = np.copy(sequence)
    missing = np.isnan(sequence)
    if np.any(missing) and np.any(~missing):
        x = np.arange(len(sequence))
        out[missing] = np.interp(x[missing], x[~missing], sequence[~missing])
    return out


def track_faces(all_frames_landmarks: List[List[np.ndarray]],
                distance_threshold: float = 75.0) -> Dict[int, List[np.ndarray]]:
    """Hungarian assignment on landmark-centroid distance (< threshold px);
    per-track landmark sequences padded with NaN for missing frames
    (keep_processor.py:42-115). Robust to zero-detection frames."""
    nan_lm = np.full((5, 2), np.nan)
    tracks: Dict[int, List[np.ndarray]] = {}
    next_id = 0
    n = len(all_frames_landmarks)
    if n and all_frames_landmarks[0]:
        for lm in all_frames_landmarks[0]:
            tracks[next_id] = [lm]
            next_id += 1

    for i in range(1, n):
        for tid in tracks:
            if len(tracks[tid]) < i:
                tracks[tid].append(nan_lm)

        prev, active = [], []
        for tid, seq in tracks.items():
            if len(seq) == i and not np.all(np.isnan(seq[-1])):
                prev.append(seq[-1])
                active.append(tid)

        current = all_frames_landmarks[i]
        matched = set()
        if prev and current:
            cost = np.full((len(prev), len(current)), np.inf)
            for r, plm in enumerate(prev):
                for c, clm in enumerate(current):
                    d = np.linalg.norm(plm.mean(axis=0) - clm.mean(axis=0))
                    if d < distance_threshold:
                        cost[r, c] = d
            if not np.all(np.isinf(cost)):
                finite = np.where(np.isinf(cost), 1e12, cost)
                rows, cols = linear_sum_assignment(finite)
                for r, c in zip(rows, cols):
                    if np.isfinite(cost[r, c]):
                        tracks[active[r]].append(current[c])
                        matched.add(c)

        for tid in active:
            if len(tracks[tid]) == i:
                tracks[tid].append(nan_lm)

        for c in set(range(len(current))) - matched:
            tracks[next_id] = [nan_lm] * i + [current[c]]
            next_id += 1

    for tid in tracks:
        while len(tracks[tid]) < n:
            tracks[tid].append(nan_lm)
    return tracks


def smooth_landmark_tracks(tracks: Dict[int, List[np.ndarray]],
                           num_frames: int, sigma: float = 2.0) -> Dict[int, np.ndarray]:
    """Per-coordinate NaN interpolation + temporal gaussian smoothing
    (keep_processor.py:216-231). Returns {track_id: (T, 5, 2)}."""
    out = {}
    for tid, seq in tracks.items():
        arr = np.array([lm.reshape(10) if not np.all(np.isnan(lm))
                        else np.full((10,), np.nan) for lm in seq])
        for j in range(10):
            arr[:, j] = interpolate_sequence(arr[:, j])
        arr = gaussian_filter1d(arr, sigma=sigma, axis=0)
        out[tid] = arr.reshape(num_frames, 5, 2)
    return out
