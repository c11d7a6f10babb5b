"""Tensor-parallel shards over the mesh's "model" axis, ported from
comfyui_keep_tpu/parallel/tensor.py.

The JAX package states Megatron-style column / row splits as GSPMD
shardings of its param tree and lets XLA place the collectives. Here the
splits are made by hand over the port's own state_dict keys:

  column-parallel (the output rows split, each rank a slice of the heads or
  hidden units): the token transformer's self_attn.in_proj_weight / _bias,
  cut per third (q, k, v) along head boundaries, and linear1; the Kalman
  filter's and CFA's to_q / to_k / to_v, and their GEGLU ff.net.0.proj,
  cut per half (value, gate) so that each rank pairs its values with its
  own gates;
  row-parallel (the input columns split): out_proj, linear2, to_out.0 and
  ff.net.2, whose partial outputs are summed by an all_reduce over the
  model group before the bias is added once.

A column-parallel layer's input enters through an op that is the identity
forward and an all_reduce of the gradient backward; a row-parallel output
leaves through an all_reduce forward and the identity backward (Megatron's
f and g). Norms, convolutions and every other parameter stay whole on
every rank. A layer whose heads (or hidden units) do not divide by the
model size stays whole, as the JAX package replicates a leaf whose
dimension does not divide.
"""
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from comfyui_keep_torch.models import layers as L
from comfyui_keep_torch.parallel.mesh import Mesh, all_reduce_

__all__ = ["DEFAULT_TP_RULES", "leaf_path", "tp_param_specs",
           "shard_params"]

# (module path regex, layer kind): the layers that split. Kinds:
# "sa" TransformerSALayer (attention by heads, MLP by hidden units),
# "attn" CrossAttention (by heads), "ff" FeedForward (by hidden units).
DEFAULT_TP_RULES: Sequence[Tuple[str, str]] = (
    (r"(^|\.)ft_layers\.\d+$", "sa"),
    (r"(^|\.)(kalman_filter|cfa)\..*\.(attn1|attn_temp|attn)$", "attn"),
    (r"(^|\.)(kalman_filter|cfa)\..*\.ff$", "ff"),
)

_KINDS = {"sa": L.TransformerSALayer, "attn": L.CrossAttention,
          "ff": L.FeedForward}


def leaf_path(key_path) -> str:
    """The dotted state_dict key of a path ("ft_layers.0.linear1.weight"),
    from a key or a sequence of its parts (the JAX package's leaf_path
    joins its tree path with "/")."""
    if isinstance(key_path, str):
        return key_path.replace("/", ".")
    return ".".join(str(k) for k in key_path)


def _layers(model: nn.Module):
    compiled = [(re.compile(p), k) for p, k in DEFAULT_TP_RULES]
    for name, mod in model.named_modules():
        for pat, kind in compiled:
            if pat.search(name) and isinstance(mod, _KINDS[kind]):
                yield name, mod, kind
                break


def _plan(model: nn.Module, mod, kind: str, m: int
          ) -> Dict[str, Optional[str]]:
    """{parameter name in the layer: split form or None} for one layer."""
    if kind == "sa":
        heads = getattr(model, "cfg", {}).get("n_head")
        e = mod.self_attn.out_proj.weight.shape[0]
        attn = heads is not None and heads % m == 0 and e % m == 0
        mlp = mod.linear1.weight.shape[0] % m == 0
        return {"self_attn.in_proj_weight": "qkv" if attn else None,
                "self_attn.in_proj_bias": "qkv" if attn else None,
                "self_attn.out_proj.weight": "row" if attn else None,
                "linear1.weight": "col" if mlp else None,
                "linear1.bias": "col" if mlp else None,
                "linear2.weight": "row" if mlp else None}
    if kind == "attn":
        ok = mod.heads % m == 0
        return {"to_q.weight": "col" if ok else None,
                "to_k.weight": "col" if ok else None,
                "to_v.weight": "col" if ok else None,
                "to_out.0.weight": "row" if ok else None}
    ok = mod.net[2].weight.shape[1] % m == 0
    return {"net.0.proj.weight": "geglu" if ok else None,
            "net.0.proj.bias": "geglu" if ok else None,
            "net.2.weight": "row" if ok else None}


_DIM = {"qkv": 0, "col": 0, "geglu": 0, "row": 1}


def tp_param_specs(model: nn.Module, axis_size: int
                   ) -> Dict[str, Optional[int]]:
    """{state_dict key: the dimension it splits on over `axis_size` ranks,
    or None where it stays whole} for every parameter of `model`."""
    specs = {k: None for k, _ in model.named_parameters()}
    if axis_size == 1:
        return specs
    for name, mod, kind in _layers(model):
        for p, form in _plan(model, mod, kind, axis_size).items():
            if form is not None:
                specs[leaf_path((name, p)) if name else p] = _DIM[form]
    return specs


def _slice(t: torch.Tensor, form: str, m: int, i: int) -> torch.Tensor:
    if form in ("col", "row"):
        n = t.shape[_DIM[form]] // m
        return t.narrow(_DIM[form], i * n, n)
    parts = 3 if form == "qkv" else 2
    whole = t.shape[0] // parts
    n = whole // m
    return torch.cat([t[k * whole + i * n:k * whole + (i + 1) * n]
                      for k in range(parts)])


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Partial outputs summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TP:
    """A split layer's `_tp` (models/layers.py): its model group of `size`
    ranks, with Megatron's f (copy) and g (reduce). Kept, not copied, by
    deepcopy: a process group does not copy."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = size

    def copy(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x):
        return _ReduceFromModel.apply(x, self.group)

    def __deepcopy__(self, memo):
        return self


def shard_params(model: nn.Module, mesh: Mesh, axis: str = "model"
                 ) -> nn.Module:
    """Split `model`'s tensor-parallel layers over `axis` in place: each
    rank keeps its slice of every split parameter (tp_param_specs), and
    the split layers get a `_tp`, with which their own forwards run the
    column- / row-parallel form (models/layers.py). Call it before the
    optimizer and the EMA are made, on whole (e.g. broadcast) weights. A
    mesh whose `axis` has size 1 leaves the model as it is."""
    m = mesh.size(axis)
    if m == 1:
        return model
    i, group = mesh.index(axis), mesh.group(axis)
    for name, mod, kind in list(_layers(model)):
        plan = _plan(model, mod, kind, m)
        if not any(plan.values()):
            continue
        with torch.no_grad():
            for p, form in plan.items():
                if form is None:
                    continue
                path, leaf = p.rsplit(".", 1)
                param = getattr(mod.get_submodule(path), leaf)
                param.data = _slice(param.data, form, m, i).clone()
        tp = _TP(group, m)
        if kind == "sa":
            if plan["self_attn.in_proj_weight"] is not None:
                mod.self_attn._tp = tp
            if plan["linear1.weight"] is not None:
                mod._tp = tp
        else:
            if kind == "attn":
                mod.heads = mod.heads // m
            mod._tp = tp
    return model
