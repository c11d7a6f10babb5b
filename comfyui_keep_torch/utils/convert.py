"""Weights into the port: reference .pth checkpoints, and JAX param trees.

`read_pth` + `split_keep_checkpoint` load a reference KEEP checkpoint the
way the reference loader does (params_ema preferred, `module.` stripped,
legacy `cross_fuse` -> `cfa` and `fuse_convs_dict` -> `cft` names, the flow
net's `flownet.model.*` subtree split off for GMFlow).

`params_from_jax` is the inverse of the JAX package's checkpoint converters
(`convert_checkpoint`, `convert_gmflow_checkpoint`,
`convert_stylegan2_generator` / `_discriminator`, and the layout rules of
its utils/checkpoint.py's `convert_state_dict`, which the trees of
RetinaFace, ParseNet, YOLOv5-face, BiSeNet, RRDBNet, SRVGGNetCompact,
MSRResNet, EDSR and SwinIR follow; SRVGG's PReLU slopes sit under
`prelu_w`; the VQAutoEncoder's, whose Gumbel code table `embed` keeps its
(num, dim) layout; the discriminators' grouped `layers`, VQGANDiscriminator's
conv + BatchNorm pairs and Discriminator3D's DHWIO convs with their
spectral-norm vector `u`): it turns a JAX param tree of numpy arrays into a state dict of
the port's module, so both packages can run on one set of weights. A BatchNorm's `num_batches_tracked`, which the JAX trees drop, is
filled with 0. The port keeps its own copy of these rules and imports nothing
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
        if arr.ndim == 5:      # DHWIO -> OIDHW
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 4:    # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:    # (in, out) -> (out, in)
            arr = arr.T
        return {f"{pre}.weight": arr}
    if name == "b":
        return {f"{pre}.bias": arr}
    if name in ("scale", "prelu_w"):   # a norm's or a PReLU's weight
        return {f"{pre}.weight": arr}
    if name in ("mean", "var"):  # BatchNorm running statistics
        return {f"{pre}.running_{name}": arr}
    if name in ("embedding", "embed"):  # nn.Embedding: (num, dim) as it is
        return {".".join(path) + ".weight": arr}
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


def _hwio_to_oihw(a) -> np.ndarray:
    return np.asarray(a).transpose(3, 2, 0, 1)


def _stylegan2_generator(tree) -> Dict[str, np.ndarray]:
    """Inverse of convert_stylegan2_generator: style_mlp layer i is the
    reference's style_mlp.{i+1} (index 0 is NormStyleCode), NHWC constant,
    noises and ToRGB bias to NCHW, the modulated conv weight (k, k, in, out)
    to (1, out, in, k, k), scalar noise weights to (1,)."""
    out: Dict[str, np.ndarray] = {}
    for i, lp in enumerate(tree["style_mlp"]):
        out[f"style_mlp.{i + 1}.weight"] = np.asarray(lp["w"]).T
        out[f"style_mlp.{i + 1}.bias"] = np.asarray(lp["b"])
    out["constant_input.weight"] = np.asarray(
        tree["constant_input"]["weight"]).transpose(0, 3, 1, 2)
    for k, v in tree["noises"].items():
        out[f"noises.{k}"] = np.asarray(v).transpose(0, 3, 1, 2)

    def mod_conv(pre, p):
        out[f"{pre}.modulated_conv.weight"] = _hwio_to_oihw(
            p["modulated_conv"]["weight"])[None]
        mod = p["modulated_conv"]["modulation"]
        out[f"{pre}.modulated_conv.modulation.weight"] = np.asarray(mod["w"]).T
        out[f"{pre}.modulated_conv.modulation.bias"] = np.asarray(mod["b"])

    def style_conv(pre, p):
        mod_conv(pre, p)
        out[f"{pre}.weight"] = np.asarray(p["weight"]).reshape(1)
        out[f"{pre}.activate.bias"] = np.asarray(p["activate"]["bias"])

    def to_rgb(pre, p):
        mod_conv(pre, p)
        out[f"{pre}.bias"] = np.asarray(p["bias"]).transpose(0, 3, 1, 2)

    style_conv("style_conv1", tree["style_conv1"])
    to_rgb("to_rgb1", tree["to_rgb1"])
    for i, p in enumerate(tree["style_convs"]):
        style_conv(f"style_convs.{i}", p)
    for i, p in enumerate(tree["to_rgbs"]):
        to_rgb(f"to_rgbs.{i}", p)
    return out


def _stylegan2_discriminator(tree) -> Dict[str, np.ndarray]:
    """Inverse of convert_stylegan2_discriminator: each ConvLayer's conv and
    activation bias at the reference's Sequential indices (a FIR smooth
    first where it downsamples)."""
    out: Dict[str, np.ndarray] = {}

    def conv_layer(pre, p, conv_at):
        out[f"{pre}.{conv_at}.weight"] = _hwio_to_oihw(p["conv"]["w"])
        if "act_bias" in p:
            out[f"{pre}.{conv_at + 1}.bias"] = np.asarray(p["act_bias"])

    conv_layer("conv_body.0", tree["conv_body"][0], 0)
    for i, blk in enumerate(tree["conv_body"][1:], start=1):
        conv_layer(f"conv_body.{i}.conv1", blk["conv1"], 0)
        conv_layer(f"conv_body.{i}.conv2", blk["conv2"], 1)
        conv_layer(f"conv_body.{i}.skip", blk["skip"], 1)
    conv_layer("final_conv", tree["final_conv"], 0)
    for i, lp in enumerate(tree["final_linear"]):
        out[f"final_linear.{i}.weight"] = np.asarray(lp["w"]).T
        out[f"final_linear.{i}.bias"] = np.asarray(lp["b"])
    return out


def _vqgan_discriminator(tree) -> Dict[str, np.ndarray]:
    """The JAX tree's (conv[, bn]) layers -> the reference's `main`
    Sequential: conv i at its index, its BatchNorm right after, one leaky
    ReLU after each pair."""
    out: Dict[str, np.ndarray] = {}
    i = 0
    for layer in tree["layers"]:
        _flatten(layer["conv"], (f"main.{i}",), out)
        if "bn" in layer:
            i += 1
            _flatten(layer["bn"], (f"main.{i}",), out)
        i += 2
    return out


def _discriminator3d(tree) -> Dict[str, np.ndarray]:
    """The JAX tree's six conv3d layers -> `conv.{0,2,...,10}`: a
    spectral-norm layer's weight as weight_orig, its `u` as weight_u, and
    weight_v, which the JAX tree does not keep, as the first power-iteration
    step from u, W^T u normalised."""
    out: Dict[str, np.ndarray] = {}
    for i, p in enumerate(tree["layers"]):
        w = np.asarray(p["w"]).transpose(4, 3, 0, 1, 2)
        pre = f"conv.{2 * i}"
        if "b" in p:
            out[f"{pre}.bias"] = np.asarray(p["b"])
        if "u" in p:
            u = np.asarray(p["u"])
            v = w.reshape(w.shape[0], -1).T @ u
            out[f"{pre}.weight_orig"] = w
            out[f"{pre}.weight_u"] = u
            out[f"{pre}.weight_v"] = v / (np.linalg.norm(v) + 1e-12)
        else:
            out[f"{pre}.weight"] = w
    return out


# port classes whose JAX trees need their own layout rules, by class name
# (any class in the model's MRO)
_TREE_RULES = {"StyleGAN2Generator": _stylegan2_generator,
               "StyleGAN2Discriminator": _stylegan2_discriminator,
               "VQGANDiscriminator": _vqgan_discriminator,
               "Discriminator3D": _discriminator3d}


def params_from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> state dict for `model` (a KEEP, a
    GMFlow with or without its trident conv, a VQHQEncoder, a
    VQAutoEncoder, a VQGANDiscriminator, a Discriminator3D, a StyleGAN2
    generator or discriminator, a detector, a parser or an upscaler of the
    port; also a gradient tree of the same layout). Raises unless keys and shapes match `model` exactly."""
    rules = [_TREE_RULES[c.__name__] for c in type(model).__mro__
             if c.__name__ in _TREE_RULES]
    flat: Dict[str, np.ndarray] = {}
    if rules:
        flat = rules[0](tree)
    else:
        _flatten(tree, (), flat)
    want = model.state_dict()
    sd = {k: torch.zeros_like(want[k], device="cpu") for k in want
          if k.endswith(".num_batches_tracked") and k not in flat}
    missing = sorted(set(want) - set(flat) - set(sd))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match {type(model).__name__}:"
                         f" missing {missing[:8]}, unexpected {extra[:8]}")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {v.shape} != {tuple(want[k].shape)}")
        sd[k] = torch.from_numpy(np.array(v, dtype=np.float32))
    return sd
