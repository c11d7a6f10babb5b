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
spectral-norm vector `u`; the archs behind build_network: any
spectral-norm layer ({w, u}) to weight_orig / weight_u / weight_v, VGG's
convolutions under `vgg_net`, DFDNet's attention blocks under `mask`,
HiFaceGAN's discriminator layers in their `model{n}` groups, ECBSR's
SeqConv3x3 tensors): it turns a JAX param tree of numpy arrays into a state
dict of the port's module, so both packages can run on one set of weights.
A BatchNorm's `num_batches_tracked`, which the JAX trees drop, is filled
with 0, and so are the constants a module lists in JAX_ABSENT (an input
normalisation's mean and std, ECBSR's fixed masks, RIDNet's mean shifts,
HiFaceGAN's unused `fc`) filled with the module's own values. The port
keeps its own copy of these rules and imports nothing from the JAX
package.
"""
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from comfyui_keep_torch.ops.spectral import power_iteration_v

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


def _torch_weight(arr: np.ndarray) -> np.ndarray:
    """A JAX weight `w` in torch's layout (inverse of the rank rules)."""
    if arr.ndim == 5:      # DHWIO -> OIDHW
        return arr.transpose(4, 3, 0, 1, 2)
    if arr.ndim == 4:      # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:      # (in, out) -> (out, in)
        return arr.T
    return arr


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Dict[str, np.ndarray]:
    """One JAX leaf -> {torch key: array} (inverse of the rank rules)."""
    *parent, name = path
    pre = ".".join(parent)
    if name == "w":
        return {f"{pre}.weight": _torch_weight(arr)}
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


def _spectral(pre: str, p) -> Dict[str, np.ndarray]:
    """A spectral-norm layer {w, u[, b]} -> torch's spectral_norm names:
    weight_orig, weight_u, and weight_v, which the JAX tree does not keep,
    as the first power-iteration step from u, W^T u normalised. The bias
    may also be named `bias`, as the JAX package's convert_state_dict
    names it beside a weight_orig."""
    w = _torch_weight(np.asarray(p["w"]))
    u = np.asarray(p["u"])
    v = power_iteration_v(torch.from_numpy(np.array(w, np.float32)),
                          torch.from_numpy(np.array(u, np.float32)))
    out = {f"{pre}.weight_orig": w, f"{pre}.weight_u": u,
           f"{pre}.weight_v": v.numpy()}
    b = p.get("b", p.get("bias"))
    if b is not None:
        out[f"{pre}.bias"] = np.asarray(b)
    return out


def _flatten(node, path: Tuple[str, ...], out: Dict[str, np.ndarray]):
    if isinstance(node, dict):
        if node and set(node) == _MHA_KEYS:
            out.update(_mha(".".join(path), {k: np.asarray(v)
                                             for k, v in node.items()}))
            return
        if "u" in node and "w" in node:
            out.update(_spectral(".".join(path), node))
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


def _stylegan2_generator(tree, model=None) -> Dict[str, np.ndarray]:
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


def _stylegan2_discriminator(tree, model=None) -> Dict[str, np.ndarray]:
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


def _vqgan_discriminator(tree, model=None) -> Dict[str, np.ndarray]:
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


def _discriminator3d(tree, model=None) -> Dict[str, np.ndarray]:
    """The JAX tree's six conv3d layers -> `conv.{0,2,...,10}` (the
    spectral-norm ones as _spectral names them)."""
    out: Dict[str, np.ndarray] = {}
    for i, p in enumerate(tree["layers"]):
        _flatten(p, (f"conv.{2 * i}",), out)
    return out


def _vgg(tree, model=None) -> Dict[str, np.ndarray]:
    """VGGFeatureExtractor's {conv1_1: {w, b}, ...} -> vgg_net.conv1_1.*"""
    out: Dict[str, np.ndarray] = {}
    _flatten(tree, ("vgg_net",), out)
    return out


def _dfdnet(tree, model=None) -> Dict[str, np.ndarray]:
    """DFDNet: the VGG subtree as _vgg under `vgg_extractor`, each
    attention block's [SN conv, None, SN conv] under `mask`; the dictionary
    (data, not weights) and the dilation rates dropped."""
    t = {k: v for k, v in tree.items() if k not in ("dict", "vgg_extractor")}
    t["attn_blocks"] = {k: {"mask": v} for k, v in tree["attn_blocks"].items()}
    t["multi_scale_dilation"] = {
        k: v for k, v in tree["multi_scale_dilation"].items()
        if k != "dilation"}
    out: Dict[str, np.ndarray] = {}
    _flatten(t, (), out)
    _flatten(tree["vgg_extractor"], ("vgg_extractor", "vgg_net"), out)
    return out


def _hifacegan_discriminator(tree, model=None) -> Dict[str, np.ndarray]:
    """{discriminator_i: [{conv}, ...]} -> discriminator_i.model{n}: the
    first and last layers' convs at `.0`, the spectral-instance ones at
    `.0.0` (conv, then instance norm, in a Sequential)."""
    out: Dict[str, np.ndarray] = {}
    for name, layers in tree.items():
        for n, lp in enumerate(layers):
            inner = ("0",) if 0 < n < len(layers) - 1 else ()
            _flatten(lp["conv"], (name, f"model{n}", "0") + inner, out)
    return out


def _ecbsr(tree, model) -> Dict[str, np.ndarray]:
    """ECBSR's blocks: each SeqConv3x3 {k0: {w, b}[, k1: {w, b}]} to its raw
    k0 / b0 (/ k1 / b1), a fixed-kernel branch's per-channel scale as (C,
    1, 1, 1); the PReLU slopes only where the port's block has a PReLU
    (the JAX init gives every block slopes, the last block is linear)."""
    want = model.state_dict()
    out: Dict[str, np.ndarray] = {}
    for i, bp in enumerate(tree["backbone"]):
        pre = f"backbone.{i}"
        _flatten(bp["conv3x3"], (pre, "conv3x3"), out)
        for name in ("conv1x1_3x3", "conv1x1_sbx", "conv1x1_sby",
                     "conv1x1_lpl"):
            sp, q = bp[name], f"{pre}.{name}"
            for j, key in enumerate(("k0", "k1")):
                if key in sp:
                    out[f"{q}.k{j}"] = _hwio_to_oihw(sp[key]["w"])
                    out[f"{q}.b{j}"] = np.asarray(sp[key]["b"])
            if "scale" in sp:
                out[f"{q}.scale"] = np.asarray(sp["scale"]).reshape(-1, 1, 1,
                                                                    1)
                out[f"{q}.bias"] = np.asarray(sp["bias"])
        if f"{pre}.act.weight" in want:
            out[f"{pre}.act.weight"] = np.asarray(bp["act"]["prelu_w"])
    return out


# port classes whose JAX trees need their own layout rules, by class name
# (any class in the model's MRO)
_TREE_RULES = {"StyleGAN2Generator": _stylegan2_generator,
               "StyleGAN2Discriminator": _stylegan2_discriminator,
               "VQGANDiscriminator": _vqgan_discriminator,
               "Discriminator3D": _discriminator3d,
               "VGGFeatureExtractor": _vgg, "DFDNet": _dfdnet,
               "HiFaceGANDiscriminator": _hifacegan_discriminator,
               "ECBSR": _ecbsr}


def _jax_absent(model: nn.Module, want) -> List[str]:
    """The state-dict keys of the constants the model's modules list in
    JAX_ABSENT."""
    keys = []
    for prefix, m in model.named_modules():
        for name in getattr(type(m), "JAX_ABSENT", ()):
            k = f"{prefix}.{name}" if prefix else name
            if k in want:
                keys.append(k)
    return keys


def params_from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> state dict for `model` (a KEEP, a
    GMFlow with or without its trident conv, a VQHQEncoder, a
    VQAutoEncoder, a VQGANDiscriminator, a Discriminator3D, a StyleGAN2
    generator or discriminator, a detector, a parser or an upscaler of the
    port, or any arch of build_network; also a gradient tree of the same
    layout). Raises unless keys and shapes match `model` exactly."""
    rules = [_TREE_RULES[c.__name__] for c in type(model).__mro__
             if c.__name__ in _TREE_RULES]
    flat: Dict[str, np.ndarray] = {}
    if rules:
        flat = rules[0](tree, model)
    else:
        _flatten(tree, (), flat)
    want = model.state_dict()
    sd = {k: torch.zeros_like(want[k], device="cpu") for k in want
          if k.endswith(".num_batches_tracked") and k not in flat}
    sd.update({k: want[k].detach().cpu().clone()
               for k in _jax_absent(model, want) if k not in flat})
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
