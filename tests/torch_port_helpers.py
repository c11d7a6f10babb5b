"""Helpers shared by the port's parity tests (tests/test_torch_*.py): seeded
BatchNorm statistics, signal-keeping weights, param-tree comparison,
relative error."""
import math

import numpy as np
import torch


def randomize_bn(model, seed):
    """Every BatchNorm's weight, bias, mean and var drawn at random (var in
    [0.5, 2]): the init's mean 0 / var 1 would hide a swapped pair."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
    return model


def he_scaled(model):
    """Every conv and linear weight times sqrt(6): torch's default init
    (variance 1 / (3 fan_in)) shrinks a plain conv stack's signal by ~sqrt(3)
    a layer, so a deep one (VGG-style, Inception, ArcFace) outputs its last
    bias whatever the input; He's variance 2 / fan_in keeps it."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                              torch.nn.Linear)):
                m.weight.mul_(math.sqrt(6))
    return model


def torchvision_vgg(vgg):
    """A port VGGFeatureExtractor's convolutions as torchvision's
    `features.N.*` numpy state dict (N the layer's index in `names`)."""
    return {f"features.{vgg.names.index(k.split('.')[1])}.{k.split('.')[2]}":
            v.numpy() for k, v in vgg.state_dict().items()
            if k.startswith("vgg_net.")}


def flat(tree, path=()):
    """{path: array} of a param tree's leaves (None entries skipped)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, path + (str(i),)))
    elif tree is not None:
        out[path] = np.asarray(tree)
    return out


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def state_numpy(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def same_values(a, b):
    """Equal values of equal Python types, mappings in equal order (NaN
    equal to NaN): how two YAML loads of one file are compared."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_values(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_values(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def pyyaml_opt(path, force=()):
    """A yml as the JAX package loads it (pyyaml's Loader through
    utils/options.py:ordered_yaml), `force` applied by its
    apply_force_yml."""
    import yaml
    from comfyui_keep_tpu.utils import options as jopt
    with open(path) as f:
        opt = yaml.load(f, Loader=jopt.ordered_yaml()[0])
    return jopt.apply_force_yml(opt, force)
