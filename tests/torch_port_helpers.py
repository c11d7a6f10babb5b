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


class SpectralUFeed:
    """A JAX discriminator class (its `apply` and everything else) whose
    apply, at its n-th call, reads the spectral-norm vectors u the port's
    discriminator held before its own n-th forward. The port's training
    forwards advance u in place (torch's spectral_norm) where the JAX
    package's apply keeps the u of its tree; fed the same incoming u, the
    two compute the same forward. Run the port's step first: a JAX trainer
    traces each jitted step once, and each traced apply call takes the
    next recorded u as a constant."""

    def __init__(self, jcls, tree, port_disc):
        import jax
        from comfyui_keep_torch.utils.convert import params_from_jax
        self.jcls, self.seen, self.calls = jcls, [], 0
        # the tree's u leaves by the port buffer they load into: each u
        # marked with its index, carried over by params_from_jax
        paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
        at = [i for i, (path, _) in enumerate(paths)
              if getattr(path[-1], "key", None) == "u"]
        marked = [np.asarray(leaf) for _, leaf in paths]
        for j, i in enumerate(at):
            marked[i] = np.full(np.shape(marked[i]), j + 1, np.float32)
        sd = params_from_jax(jax.tree_util.tree_unflatten(treedef, marked),
                             port_disc)
        self.slots = {k: at[int(np.asarray(v).reshape(-1)[0]) - 1]
                      for k, v in sd.items() if k.endswith("weight_u")}
        port_disc.register_forward_pre_hook(self._record)

    def _record(self, module, args):
        self.seen.append({k: v.detach().cpu().numpy().copy() for k, v
                          in module.state_dict().items()
                          if k.endswith("weight_u")})

    def apply(self, params, *args, **kw):
        import jax
        import jax.numpy as jnp
        u = self.seen[self.calls]
        self.calls += 1
        leaves, treedef = jax.tree_util.tree_flatten(params)
        for name, i in self.slots.items():
            leaves[i] = jnp.asarray(u[name], leaves[i].dtype)
        return self.jcls.apply(jax.tree_util.tree_unflatten(treedef, leaves),
                               *args, **kw)

    def __getattr__(self, name):
        return getattr(self.jcls, name)


def power_iterations(w, u, n):
    """The u after each of n power-iteration steps from u (float64), W
    (O, ...) in torch's layout: torch's spectral_norm in training."""
    wm = np.asarray(w, np.float64).reshape(np.shape(w)[0], -1)
    out, u = [], np.asarray(u, np.float64)
    for _ in range(n):
        v = wm.T @ u
        v = v / max(np.linalg.norm(v), 1e-12)
        u = wm @ v
        u = u / max(np.linalg.norm(u), 1e-12)
        out.append(u)
    return out


# The tensor cores' TF32 products as the port's 3xTF32 kernels do them
# (csrc/sm90.cuh split_tf32, tf32_hi_bits): modelled in torch on the CPU by
# mantissa masking, f32 sums in torch's order.
def tf32_trunc(x):
    """x (f32) with its low 13 mantissa bits cleared: what the tensor core
    reads of an f32 operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """(hi, lo) of the kernels' split: hi x rounded to TF32 by a carry into
    bit 12 and the mask, lo = x - hi (exact in f32)."""
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def mm_3xtf32(a, b):
    """a @ b as 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, every operand as
    the tensor core reads it, f32 sums."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    t = tf32_trunc
    return (torch.matmul(t(al), t(bh)) + torch.matmul(t(ah), t(bl))
            + torch.matmul(t(ah), t(bh)))


def mm_1xtf32(a, b):
    """a @ b as one TF32 product (the control the f32 gates must refuse)."""
    return torch.matmul(tf32_trunc(a), tf32_trunc(b))
