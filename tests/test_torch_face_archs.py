"""The port's face archs against the JAX package's, on the CPU in f32:
HiFaceGAN (the forward at phases 4 and 1, and mixed_guidance_forward in
its three modes), HiFaceGANDiscriminator (multi-scale, with and without
keep_features) and DFDNet (models/hifacegan.py, models/dfdnet.py).

Weights: the port's seeded init carried into a JAX tree by the JAX
package's convert_state_dict (the oracle); where the JAX trees are laid out
otherwise, the test regroups the converted tree as the JAX init lays it out
(HiFaceGANDiscriminator's layers as a list per scale; DFDNet's attention
blocks without the reference's `mask` level, its VGG through
convert_vgg_checkpoint on torchvision's names, its dilation rates and
dictionary beside; a spectral-norm conv's bias as `b`: convert_state_dict
names it `bias`, which the JAX apply does not read; a Sequential whose
first layer has no weights as a list, where convert_state_dict leaves a
dict). params_from_jax must rebuild the port's state dict exactly. The
discriminator's JAX init tree loads too; HiFaceGAN's and DFDNet's JAX
inits take 20-40 s on the CPU and are not run: their layout is the
regrouped one above.

DFDNet's dictionary swap picks each part's atom by an argmax over random
atoms, which can flip between the packages where two scores nearly tie.
The test compares the similarity vectors (within 1e-4 of their largest
magnitude), requires the same pick wherever the top two scores differ by
more than that, and then runs the port with the JAX package's picks to
compare the outputs. The JAX DFDNet runs eagerly (its slices take their
sizes from the data), so the fast case is a 128^2 face (features 64 / 32
/ 16 / 8, the parts inside them); the 512^2 case is `slow`.

Tolerances: no JAX golden exists for these nets; outputs within 1e-4 /
1e-3 (atol / rtol) of their largest magnitude, the discriminator's and
the generator's (tanh) outputs alike.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import dfdnet as jdfd
from comfyui_keep_tpu.models import hifacegan as jhfg
from comfyui_keep_tpu.models.layers import \
    adaptive_instance_normalization as jadain
from comfyui_keep_tpu.models.vgg import (VGGFeatureExtractor as JVGG,
                                         convert_vgg_checkpoint)
from comfyui_keep_tpu.ops import resize_bilinear as jresize
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch.models import dfdnet as tdfd
from comfyui_keep_torch.models import hifacegan as thfg
from comfyui_keep_torch.models.layers import adaptive_instance_normalization
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (assert_trees_equal, state_numpy,
                                      torchvision_vgg)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-3)


def port_net(cls, seed=0, **kw):
    return cls(device="cpu", generator=torch.Generator().manual_seed(seed),
               **kw)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def images(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def as_init_lists(node):
    """convert_state_dict keeps a Sequential whose index 0 holds no weights
    as a dict {"1": ...}; the JAX init (and DFDNet's apply) has a list
    there."""
    if isinstance(node, dict):
        node = {k: as_init_lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node.get(str(i)) for i in range(max(map(int, node)) + 1)]
    elif isinstance(node, list):
        node = [as_init_lists(v) for v in node]
    return node


def sn_bias_as_b(node):
    """convert_state_dict names a spectral-norm conv's bias `bias` (its
    sibling is weight_orig, not weight), which the JAX apply does not read;
    the JAX init names it `b`. The tree goes to the JAX apply as its init
    lays it out."""
    if isinstance(node, dict):
        node = {k: sn_bias_as_b(v) for k, v in node.items()}
        if "u" in node and "bias" in node:
            node["b"] = node.pop("bias")
    elif isinstance(node, list):
        node = [sn_bias_as_b(v) for v in node]
    return node


def close(got, ref):
    scale = max(np.abs(np.asarray(ref)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(ref) / scale, **TOL)


def assert_same_state(net, again):
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


# -- HiFaceGAN ---------------------------------------------------------------------

UNUSED_FC = ("fc.weight", "fc.bias")


def hifacegan_tree(net):
    return sn_bias_as_b(convert_state_dict(
        {k: v for k, v in state_numpy(net).items() if k not in UNUSED_FC}))


@pytest.mark.parametrize("phase", [4, 1])
def test_hifacegan_matches_jax_and_round_trips(phase):
    net = port_net(thfg.HiFaceGAN, num_feat=4, phase=phase)
    tree = hifacegan_tree(net)
    size = 64 if phase == 4 else 32   # the output is size / 2^(4 - phase)
    x = images(1, 1, size, size, 3)
    want = jax.jit(lambda p, v: jhfg.HiFaceGAN.apply(p, v, num_feat=4,
                                                     phase=phase))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert got.shape == want.shape
    close(got, want)
    again = thfg.HiFaceGAN(device="cpu", num_feat=4, phase=phase)
    sd = params_from_jax(tree, again)
    assert torch.equal(sd["fc.weight"], again.state_dict()["fc.weight"])
    sd["fc.weight"], sd["fc.bias"] = net.fc.weight, net.fc.bias
    again.load_state_dict(sd)
    assert_same_state(net, again)
    assert_trees_equal(hifacegan_tree(again), tree)


@pytest.mark.parametrize("mode", ["progressive", "one_plug", "one_ablate"])
def test_hifacegan_mixed_guidance_matches_jax(mode):
    net = port_net(thfg.HiFaceGAN, num_feat=4, phase=1)
    tree = hifacegan_tree(net)
    x, y = images(2, 1, 32, 32, 3), images(3, 1, 32, 32, 3)
    for n in (2, 5):
        want = jhfg.HiFaceGAN.mixed_guidance_forward(
            tree, jnp.asarray(x), jnp.asarray(y), n=n, mode=mode, num_feat=4,
            phase=1)
        with torch.no_grad():
            got = nhwc(net.mixed_guidance_forward(nchw(x), nchw(y), n=n,
                                                  mode=mode))
        close(got, want)
    with torch.no_grad():
        plain = nhwc(net(nchw(x)))
        same = nhwc(net.mixed_guidance_forward(nchw(x), None, mode=mode))
    np.testing.assert_array_equal(same, plain)


def hifacegan_d_tree(net):
    """The converted tree regrouped as the JAX init lays it out: per scale
    a list of layers {conv: ...} (model{n}.0 or, spectral-instance,
    model{n}.0.0)."""
    conv = convert_state_dict(state_numpy(net))
    tree = {}
    for name, groups in conv.items():
        layers = []
        for n in range(len(groups)):
            g = groups[f"model{n}"][0]
            layers.append({"conv": g[0] if isinstance(g, list) else g})
        tree[name] = layers
    return tree


@pytest.mark.parametrize("keep_features", [True, False])
def test_hifacegan_discriminator_matches_jax(keep_features):
    kw = dict(num_feat=8, num_d=2, n_layers_d=3, keep_features=keep_features)
    net = port_net(thfg.HiFaceGANDiscriminator, **kw)
    tree = hifacegan_d_tree(net)
    x = images(5, 1, 64, 48, 6)
    want = jax.jit(lambda p, v: jhfg.HiFaceGANDiscriminator.apply(
        p, v, num_d=2, n_layers_d=3, keep_features=keep_features))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        if keep_features:
            assert len(g) == len(w) == 4
            for gi, wi in zip(g, w):
                close(nhwc(gi), wi)
        else:
            close(nhwc(g), w)
    again = thfg.HiFaceGANDiscriminator(device="cpu", **kw)
    again.load_state_dict(params_from_jax(tree, again))
    assert_same_state(net, again)
    assert_trees_equal(hifacegan_d_tree(again), tree)
    init = jax.tree.map(np.asarray, jhfg.HiFaceGANDiscriminator.init(
        jax.random.PRNGKey(2), num_feat=8, n_layers_d=3))
    again.load_state_dict(params_from_jax(init, again))


# -- DFDNet ------------------------------------------------------------------------

def dictionary(seed, n=3, hw=8):
    """Random atoms in the JAX layout (N, h, w, C), as the JAX package's
    tests draw them."""
    rng = np.random.default_rng(seed)
    return {str(fs): {p: rng.standard_normal((n, hw, hw, c),
                                             dtype=np.float32) * 0.1
                      for p in tdfd.PARTS}
            for fs, c in zip(tdfd.FEATURE_SIZES, tdfd.CHANNEL_SIZES)}


def port_dictionary(d):
    return {fs: {p: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                 for p, a in parts.items()} for fs, parts in d.items()}


def dfdnet_tree(net, d):
    """The JAX tree of the port's weights: convert_state_dict on all but
    the VGG, whose convolutions go through convert_vgg_checkpoint on
    torchvision's names; the attention blocks' `mask` level removed; the
    dilation rates and the dictionary beside, as the JAX init holds
    them."""
    sd = {k: v for k, v in state_numpy(net).items()
          if not k.startswith("vgg_extractor.")}
    tree = as_init_lists(sn_bias_as_b(convert_state_dict(sd)))
    tree["attn_blocks"] = {k: v["mask"]
                           for k, v in tree["attn_blocks"].items()}
    tree["multi_scale_dilation"]["dilation"] = (4, 3, 2, 1)
    tree["vgg_extractor"] = convert_vgg_checkpoint(
        torchvision_vgg(net.vgg_extractor))
    tree["dict"] = d
    return tree


def jax_scores(tree, x, locs):
    """The JAX package's swap scores, step by step as its DFDNet._swap
    computes them: {(feature size, part): similarity to each atom}."""
    feats = JVGG.apply(tree["vgg_extractor"], jnp.asarray(x),
                       list(jdfd.VGG_LAYERS), use_input_norm=True,
                       range_norm=True)
    out = {}
    for layer, fs in zip(jdfd.VGG_LAYERS, jdfd.FEATURE_SIZES):
        for pi, part in enumerate(jdfd.PARTS):
            x1, y1, x2, y2 = [int(v) for v in
                              np.asarray(locs[pi][0]) // (512 // fs)]
            atoms = jnp.asarray(tree["dict"][str(fs)][part])
            part_r = jresize(feats[layer][:, y1:y2, x1:x2], atoms.shape[1:3])
            d = jadain(atoms, part_r)
            out[(fs, part)] = np.asarray(jnp.einsum("hwc,nhwc->n",
                                                    part_r[0], d))
    return out


def dfdnet_case(size, locs, seed):
    d = dictionary(seed)
    net = port_net(tdfd.DFDNet, dictionary=port_dictionary(d))
    tree = dfdnet_tree(net, d)
    x = images(seed, 1, size, size, 3) * 2 - 1
    want_scores = jax_scores(tree, x, locs)
    with torch.no_grad():
        _, _, scores = net.swap_features(nchw(x), locs)
    picks = {}
    for key, w in want_scores.items():
        got = scores[key].numpy()
        tol = 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(got, w, atol=tol, rtol=0, err_msg=str(key))
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > tol:
            assert got.argmax() == w.argmax(), key
        picks[key] = int(w.argmax())
    want = jdfd.DFDNet.apply(tree, jnp.asarray(x), locs)
    with torch.no_grad():
        got = nhwc(net(nchw(x), locs, picks=picks))
    assert got.shape == want.shape == (1, size, size, 3)
    close(got, want)
    return net, tree


def test_dfdnet_matches_jax_and_round_trips():
    """A 128^2 face: the parts' boxes (at 512 scale) inside its features,
    each at least 16 px so the 32-level slice is not empty."""
    locs = [np.array([[16, 16, 48, 48]]), np.array([[64, 16, 96, 48]]),
            np.array([[32, 48, 80, 80]]), np.array([[32, 80, 96, 112]])]
    net, tree = dfdnet_case(128, locs, 6)
    again = tdfd.DFDNet(device="cpu",
                        dictionary=port_dictionary(tree["dict"]))
    again.load_state_dict(params_from_jax(tree, again))
    assert_same_state(net, again)
    assert_trees_equal(dfdnet_tree(again, tree["dict"]), tree)
    assert not any(k.startswith("dict_") for k in net.state_dict())
    v = torch.randn(2, 8, 5, 6)
    s = torch.randn(1, 8, 3, 4)
    np.testing.assert_allclose(
        adaptive_instance_normalization(v, s).permute(0, 2, 3, 1).numpy(),
        jadain(jnp.asarray(v.permute(0, 2, 3, 1).numpy()),
               jnp.asarray(s.permute(0, 2, 3, 1).numpy())),
        atol=1e-5, rtol=1e-5)


@pytest.mark.slow
def test_dfdnet_512_matches_jax():
    """The JAX package's own 512^2 case (tests/test_face_restore_archs.py
    part boxes)."""
    locs = [np.array([[96, 96, 160, 160]]), np.array([[352, 96, 416, 160]]),
            np.array([[224, 192, 288, 288]]),
            np.array([[192, 352, 320, 416]])]
    dfdnet_case(512, locs, 7)
