"""Optical-flow files and pictures (reference wm_basicsr/utils/flow_util.py,
gmflow utils/flow_viz.py), ported from comfyui_keep_tpu/utils/flow.py
without OpenCV: Middlebury .flo, flow quantised into an 8-bit gray PNG
(through utils/png.py), and the Middlebury colour picture of a flow."""
import os

import numpy as np

from comfyui_keep_torch.utils import png

_FLO_TAG = 202021.25


def flowread(flow_path: str, quantize: bool = False, concat_axis: int = 0,
             *, denorm_args=None) -> np.ndarray:
    """A .flo file, or with quantize a gray PNG holding dx and dy
    concatenated along concat_axis, -> (H, W, 2) float32."""
    if quantize:
        cat_flow = png.imread(flow_path)
        if cat_flow.shape[2] != 1:
            raise IOError(f"{flow_path} is not a valid quantized flow image")
        cat_flow = cat_flow[..., 0]
        if cat_flow.shape[concat_axis] % 2:
            raise IOError(f"{flow_path}: odd size along axis {concat_axis}")
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, *(denorm_args or ()))
    with open(flow_path, "rb") as f:
        header = np.fromfile(f, np.float32, count=1)
        if header.size == 0 or header[0] != _FLO_TAG:
            raise IOError(f"invalid flow file {flow_path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        flow = np.fromfile(f, np.float32, count=2 * w * h)
    return flow.reshape(h, w, 2)


def flowwrite(flow: np.ndarray, filename: str, quantize: bool = False,
              concat_axis: int = 0):
    """flowread's inverse: .flo, or the quantised gray PNG."""
    if quantize:
        dx, dy = quantize_flow(flow)
        with open(filename, "wb") as f:
            f.write(png.encode(np.concatenate([dx, dy], axis=concat_axis)))
        return
    with open(filename, "wb") as f:
        np.array([_FLO_TAG], np.float32).tofile(f)
        h, w = flow.shape[:2]
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def quantize_flow(flow: np.ndarray, max_val: float = 0.02, norm: bool = True):
    """(H, W, 2) -> [dx, dy] uint8: each (over the width / height when
    norm) clipped to +-max_val and mapped to 0..254."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    out = []
    for d in (dx, dy):
        d = np.clip(d, -max_val, max_val)
        out.append(np.round((d + max_val) / (2 * max_val) * 254).astype(
            np.uint8))
    return out


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    dx = dx.astype(np.float32) / 254 * 2 * max_val - max_val
    dy = dy.astype(np.float32) / 254 * 2 * max_val - max_val
    if denorm:
        dx = dx * dx.shape[1]
        dy = dy * dy.shape[0]
    return np.stack([dx, dy], axis=-1)


def make_lmdb_from_imgs(data_path: str, lmdb_path: str, img_path_list,
                        keys, batch: int = 5000, compress_level: int = 1):
    """PNG images -> an lmdb folder with meta_info.txt (the JAX package's
    flow-data form of utils/lmdb_util.py's builder): each image re-encoded
    at compress_level under its key, committed every `batch` puts, and the
    meta lines "<key>.png (<h>,<w>,<c>) <compress_level>" joined by
    newlines. The lmdb package is imported here."""
    from comfyui_keep_torch.utils.lmdb_util import (read_img_worker,
                                                    require_lmdb)
    lmdb = require_lmdb()
    if len(img_path_list) != len(keys):
        raise ValueError("img_path_list and keys differ in length")
    os.makedirs(lmdb_path, exist_ok=True)
    first = read_img_worker(os.path.join(data_path, img_path_list[0]),
                            keys[0], compress_level)[1]
    env = lmdb.open(lmdb_path, map_size=len(first) * len(img_path_list) * 10
                    + (1 << 24))
    txn = env.begin(write=True)
    meta = []
    for i, (rel, key) in enumerate(zip(img_path_list, keys)):
        _, buf, (h, w, c) = read_img_worker(os.path.join(data_path, rel),
                                            key, compress_level)
        txn.put(key.encode("ascii"), buf)
        meta.append(f"{key}.png ({h},{w},{c}) {compress_level}")
        if (i + 1) % batch == 0:
            txn.commit()
            txn = env.begin(write=True)
    txn.commit()
    env.close()
    with open(os.path.join(lmdb_path, "meta_info.txt"), "w") as f:
        f.write("\n".join(meta))


def _make_color_wheel() -> np.ndarray:
    """The Middlebury flow colour wheel (55 colours, Baker et al.)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow, max_flow=None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB Middlebury picture: hue from
    the direction, saturation from the magnitude over max_flow (the
    largest magnitude when None); beyond 1, the colour darkened to 0.75."""
    flow = np.asarray(flow, np.float64)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow is not None else max(rad.max(), 1e-9)
    u, v = u / maxrad, v / maxrad
    wheel = _make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0, col1 = wheel[k0, c] / 255.0, wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img
