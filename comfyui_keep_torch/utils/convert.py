"""Weights into the port: reference .pth checkpoints, and JAX param trees.

`read_pth` + `split_keep_checkpoint` load a reference KEEP checkpoint the
way the reference loader does (params_ema preferred, `module.` stripped,
legacy `cross_fuse` -> `cfa` and `fuse_convs_dict` -> `cft` names, the flow
net's `flownet.model.*` subtree split off for GMFlow).

`params_from_jax` is the inverse of the JAX package's checkpoint converters
(`convert_checkpoint`, `convert_gmflow_checkpoint`, and the layout rules of
its utils/checkpoint.py): it turns a JAX param tree of numpy arrays into a
state dict of the port's module, so both packages can run on one set of
weights. The port keeps its own copy of these rules and imports nothing
from the JAX package.
"""
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

LEGACY_NAMES = (("cross_fuse", "cfa"), ("fuse_convs_dict", "cft"))
FLOWNET_PREFIX = "flownet.model."
_MHA_KEYS = {"q_w", "k_w", "v_w", "q_b", "k_b", "v_b", "out_w", "out_b"}


def read_pth(path: str, prefer: Sequence[str] = ("params_ema", "params")
             ) -> Dict[str, torch.Tensor]:
    """A torch checkpoint as {key: tensor}, preferring `params_ema`, with
    the DataParallel `module.` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for k in prefer:
            if k in ckpt:
                ckpt = ckpt[k]
                break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in ckpt.items()}


def split_keep_checkpoint(sd: Dict[str, Any]
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference KEEP state dict -> (KEEP state dict with current module
    names, GMFlow state dict relative to the GMFlow module)."""
    flow = {k[len(FLOWNET_PREFIX):]: v for k, v in sd.items()
            if k.startswith(FLOWNET_PREFIX)}
    keep = {}
    for k, v in sd.items():
        if k.startswith("flownet."):
            continue
        for old, new in LEGACY_NAMES:
            k = k.replace(old, new)
        keep[k] = v
    return keep, flow


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Dict[str, np.ndarray]:
    """One JAX leaf -> {torch key: array} (inverse of the rank rules)."""
    *parent, name = path
    pre = ".".join(parent)
    if name == "w":
        if arr.ndim == 4:      # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:    # (in, out) -> (out, in)
            arr = arr.T
        return {f"{pre}.weight": arr}
    if name == "b":
        return {f"{pre}.bias": arr}
    if name == "scale":
        return {f"{pre}.weight": arr}
    if name == "embedding":    # nn.Embedding keeps its (num, dim) layout
        return {f"{pre}.embedding.weight": arr}
    return {".".join(path): arr}


def _mha(pre: str, p: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Split q/k/v (in, out) projections -> nn.MultiheadAttention's packed
    in_proj_weight (3E, E) and out_proj."""
    return {
        f"{pre}.in_proj_weight": np.concatenate(
            [p["q_w"].T, p["k_w"].T, p["v_w"].T], axis=0),
        f"{pre}.in_proj_bias": np.concatenate([p["q_b"], p["k_b"], p["v_b"]]),
        f"{pre}.out_proj.weight": p["out_w"].T,
        f"{pre}.out_proj.bias": p["out_b"],
    }


def _flatten(node, path: Tuple[str, ...], out: Dict[str, np.ndarray]):
    if isinstance(node, dict):
        if node and set(node) == _MHA_KEYS:
            out.update(_mha(".".join(path), {k: np.asarray(v)
                                             for k, v in node.items()}))
            return
        for k, v in node.items():
            _flatten(v, path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            if v is not None:
                _flatten(v, path + (str(i),), out)
    elif node is not None:
        out.update(_leaf(path, np.asarray(node)))


def params_from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> state dict for `model` (a KEEP or a
    GMFlow of the port). Raises unless keys and shapes match `model`
    exactly."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, (), flat)
    want = model.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match {type(model).__name__}:"
                         f" missing {missing[:8]}, unexpected {extra[:8]}")
    sd = {}
    for k, v in flat.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {v.shape} != {tuple(want[k].shape)}")
        sd[k] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return sd
