"""The port's registry and its remaining image archs against the JAX
package's, on the CPU in f32: build_network's names, VGGFeatureExtractor
(vgg19 / vgg16), RCAN, RIDNet, ECBSR (the training form and the
re-parameterised one), VGGStyleDiscriminator (128^2 and 256^2),
UNetDiscriminatorSN, ResNetArcFace and InceptionV3.

Weights: the port's seeded init (BatchNorm statistics randomised; the deep
plain stacks, VGG, VGG-style, ArcFace and Inception, He-scaled so their
outputs depend on the input) carried
into a JAX tree by the JAX package's converters (the oracle):
convert_state_dict, VGG's convert_vgg_checkpoint on torchvision's
`features.N` names, and for ECBSR the hand conversion of the JAX package's
golden test; the constants the JAX trees do not hold (RIDNet's mean
shifts) left out. params_from_jax must rebuild the port's state dict
exactly and give the same tree again; JAX init trees load too.

Tolerances (atol / rtol) are the JAX package's golden ones against the
reference: RCAN, ECBSR 1e-4 / 1e-3; RIDNet, VGGStyle 1e-3 / 1e-3; UNetSN
5e-3 / 1e-2; ArcFace 1e-3 / 1e-2. VGG and InceptionV3 have no JAX golden:
1e-4 / 1e-3 of their outputs' scale (outputs divided by their largest
magnitude first, as deep random-weight features range widely). ECBSR's
re-parameterised form equals its training form within 2e-5 (the JAX
package's own bound).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import discriminators as jdisc
from comfyui_keep_tpu.models import inception as jinc
from comfyui_keep_tpu.models import misc_archs as jmisc
from comfyui_keep_tpu.models import sr_extra as jsrx
from comfyui_keep_tpu.models import vgg as jvgg
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_tpu.utils.registry import ARCH_REGISTRY as JAX_ARCHS
from comfyui_keep_torch.models import build_network
from comfyui_keep_torch.models import discriminators as tdisc
from comfyui_keep_torch.models import inception as tinc
from comfyui_keep_torch.models import misc_archs as tmisc
from comfyui_keep_torch.models import sr_extra as tsrx
from comfyui_keep_torch.models import vgg as tvgg
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (assert_trees_equal, he_scaled,
                                      randomize_bn, state_numpy,
                                      torchvision_vgg)

torch.set_num_threads(2)


def port_net(cls, seed=0, **kw):
    return cls(device="cpu", generator=torch.Generator().manual_seed(seed),
               **kw)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def images(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def jax_tree(net, drop=()):
    return convert_state_dict({k: v for k, v in state_numpy(net).items()
                               if k not in drop})


def assert_round_trip(net, tree, to_tree, **kw):
    again = type(net)(device="cpu", **kw)
    again.load_state_dict(params_from_jax(tree, again))
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert_trees_equal(to_tree(again), tree)


def scaled_close(got, ref, atol=1e-4, rtol=1e-3):
    scale = max(np.abs(np.asarray(ref)).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(ref) / scale, atol=atol, rtol=rtol)


# -- registry ---------------------------------------------------------------------

def test_build_network_names_equal_the_jax_registry():
    import comfyui_keep_tpu.models  # noqa: F401 (registers the JAX archs)
    from comfyui_keep_torch.utils.registry import ARCH_REGISTRY
    build_network("KEEP")
    assert set(ARCH_REGISTRY.keys()) == set(JAX_ARCHS.keys())
    assert len(ARCH_REGISTRY.keys()) == 36
    for name in JAX_ARCHS.keys():
        cls = build_network(name)
        assert issubclass(cls, torch.nn.Module), name
        assert cls.__name__ == name or name == "YoloFace", name
    with pytest.raises(KeyError, match="Available"):
        build_network("NoSuchArch")


# -- VGG -----------------------------------------------------------------------------

def vgg_tree(net, vgg_type):
    """The JAX package's converter on torchvision's names."""
    return jvgg.convert_vgg_checkpoint(torchvision_vgg(net), vgg_type)


@pytest.mark.parametrize("vgg_type,layers,range_norm", [
    ("vgg19", ("relu1_2", "pool2", "conv3_4", "relu4_4", "conv5_4"), True),
    ("vgg16", ("conv1_1", "relu3_3", "pool4"), False)])
def test_vgg_features_match_jax_and_round_trip(vgg_type, layers, range_norm):
    kw = dict(layer_name_list=layers, vgg_type=vgg_type,
              range_norm=range_norm)
    net = he_scaled(port_net(tvgg.VGGFeatureExtractor, **kw))
    tree = vgg_tree(net, vgg_type)
    x = images(1, 2, 32, 48, 3) * (2 if range_norm else 1) - range_norm
    want = jax.jit(lambda p, v: jvgg.VGGFeatureExtractor.apply(
        p, v, list(layers), vgg_type=vgg_type, range_norm=range_norm))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert set(got) == set(layers)
    for name in layers:
        scaled_close(nhwc(got[name]), want[name])
    assert_round_trip(net, tree, lambda m: vgg_tree(m, vgg_type), **kw)
    sd = net.from_torchvision({k: torch.from_numpy(v) for k, v in
                               torchvision_vgg(net).items()})
    assert sd.keys() == net.state_dict().keys()
    for k, v in sd.items():
        assert torch.equal(v, net.state_dict()[k]), k
    init = jax.tree.map(np.asarray, jvgg.VGGFeatureExtractor.init(
        jax.random.PRNGKey(1), vgg_type))
    net.load_state_dict(params_from_jax(init, net))


# -- RCAN / RIDNet / ECBSR -------------------------------------------------------------

def test_rcan_matches_jax_and_round_trips():
    kw = dict(num_feat=16, num_group=2, num_block=2, squeeze_factor=4,
              upscale=2)
    net = port_net(tsrx.RCAN, **kw)
    tree = jax_tree(net)
    x = images(2, 1, 12, 12, 3)
    want = jax.jit(lambda p, v: jsrx.RCAN.apply(p, v, upscale=2))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    assert_round_trip(net, tree, jax_tree, **kw)


RIDNET_MEANS = ("sub_mean.weight", "sub_mean.bias", "add_mean.weight",
                "add_mean.bias")


def test_ridnet_matches_jax_and_round_trips():
    kw = dict(mid_channels=16, num_block=2)
    net = port_net(tsrx.RIDNet, **kw)
    tree = jax_tree(net, RIDNET_MEANS)
    x = images(3, 1, 16, 16, 3) * 255
    want = jax.jit(jsrx.RIDNet.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert_round_trip(net, tree, lambda m: jax_tree(m, RIDNET_MEANS), **kw)
    init = jax.tree.map(np.asarray, jsrx.RIDNet.init(
        jax.random.PRNGKey(2), mid_channels=16, num_block=1))
    small = tsrx.RIDNet(device="cpu", mid_channels=16, num_block=1)
    sd = params_from_jax(init, small)
    assert torch.equal(sd["sub_mean.bias"], small.state_dict()[
        "sub_mean.bias"])
    small.load_state_dict(sd)


def ecbsr_tree(net):
    """The JAX package's golden-test conversion of ECBSR's SeqConv3x3
    tensors (tests/test_archs_extra_golden.py)."""
    def hwio(t):
        return t.detach().numpy().transpose(2, 3, 1, 0)

    tree = {"backbone": []}
    for blk in net.backbone:
        bp = {"conv3x3": {"w": hwio(blk.conv3x3.weight),
                          "b": blk.conv3x3.bias.detach().numpy()},
              "conv1x1_3x3": {
                  "k0": {"w": hwio(blk.conv1x1_3x3.k0),
                         "b": blk.conv1x1_3x3.b0.detach().numpy()},
                  "k1": {"w": hwio(blk.conv1x1_3x3.k1),
                         "b": blk.conv1x1_3x3.b1.detach().numpy()}}}
        for name in ("conv1x1_sbx", "conv1x1_sby", "conv1x1_lpl"):
            sub = getattr(blk, name)
            bp[name] = {"k0": {"w": hwio(sub.k0),
                               "b": sub.b0.detach().numpy()},
                        "scale": sub.scale.detach().numpy().reshape(-1),
                        "bias": sub.bias.detach().numpy()}
        if isinstance(getattr(blk, "act", None), torch.nn.PReLU):
            bp["act"] = {"prelu_w": blk.act.weight.detach().numpy()}
        tree["backbone"].append(bp)
    return tree


@pytest.mark.parametrize("num_in_ch,with_idt,act_type", [
    (3, False, "prelu"), (3, True, "prelu"), (1, True, "relu")])
def test_ecbsr_both_forms_match_jax_and_round_trip(num_in_ch, with_idt,
                                                   act_type):
    kw = dict(num_in_ch=num_in_ch, num_out_ch=num_in_ch, num_block=2,
              num_channel=8, with_idt=with_idt, act_type=act_type, scale=2)
    net = port_net(tsrx.ECBSR, **kw)
    with torch.no_grad():   # per-channel slopes, not the init's 0.25
        for m in net.modules():
            if isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.05, 0.5)
    tree = ecbsr_tree(net)
    x = images(4, 2, 10, 12, num_in_ch)
    ja = dict(num_in_ch=num_in_ch, scale=2, act_type=act_type)
    want = jax.jit(lambda p, v: jsrx.ECBSR.apply(
        p, v, with_idt=with_idt, **ja))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
        reps = net.rep_params()
        got_rep = net.apply_rep(reps, nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(nhwc(got_rep), nhwc(got), atol=2e-5, rtol=0)
    # JAX's rep_params carries each block's slopes along; the linear last
    # block (and a relu net) has none, and apply_rep reads none there
    jrep = jsrx.ECBSR.rep_params({"backbone": [
        dict(bp, act=bp.get("act", {"prelu_w": np.zeros(1, np.float32)}))
        for bp in tree["backbone"]]}, with_idt=with_idt)
    for (w, b), jb in zip(reps, jrep["backbone"]):
        np.testing.assert_allclose(w.numpy().transpose(2, 3, 1, 0), jb["w"],
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(b.numpy(), jb["b"], atol=1e-6, rtol=1e-5)
    want_rep = jsrx.ECBSR.apply_rep(jrep, jnp.asarray(x), **ja)
    np.testing.assert_allclose(nhwc(got_rep), want_rep, atol=1e-4, rtol=1e-3)
    assert_round_trip(net, tree, ecbsr_tree, **kw)
    init = jax.tree.map(np.asarray, jsrx.ECBSR.init(jax.random.PRNGKey(3),
                                                    **kw))
    fresh = tsrx.ECBSR(device="cpu", **kw)
    fresh.load_state_dict(params_from_jax(init, fresh))


# -- discriminators ----------------------------------------------------------------

@pytest.mark.parametrize("input_size", [128, 256])
def test_vgg_style_discriminator_matches_jax(input_size):
    kw = dict(num_feat=8, input_size=input_size)
    net = randomize_bn(he_scaled(port_net(tdisc.VGGStyleDiscriminator,
                                          **kw)), 5)
    tree = jax_tree(net)
    x = images(5, 2, input_size, input_size, 3)
    want = jax.jit(lambda p, v: jdisc.VGGStyleDiscriminator.apply(
        p, v, num_feat=8, input_size=input_size))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert_round_trip(net, tree, jax_tree, **kw)


@pytest.mark.parametrize("skip", [True, False])
def test_unet_sn_discriminator_matches_jax(skip):
    kw = dict(num_feat=8, skip_connection=skip)
    net = port_net(tdisc.UNetDiscriminatorSN, **kw)
    tree = jax_tree(net)
    assert "weight_v" not in str(tree) and "u" in tree["conv1"]
    x = images(6, 1, 32, 40, 3)
    want = jax.jit(lambda p, v: jdisc.UNetDiscriminatorSN.apply(
        p, v, skip_connection=skip))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-2)
    assert_round_trip(net, tree, lambda m: jax_tree(m), **kw)
    init = jax.tree.map(np.asarray, jdisc.UNetDiscriminatorSN.init(
        jax.random.PRNGKey(4), num_feat=8))
    fresh = tdisc.UNetDiscriminatorSN(device="cpu", num_feat=8)
    sd = params_from_jax(init, fresh)
    w = sd["conv2.weight_orig"].reshape(sd["conv2.weight_orig"].shape[0], -1)
    v = w.t() @ sd["conv2.weight_u"]
    torch.testing.assert_close(sd["conv2.weight_v"], v / v.norm())


# -- ArcFace / Inception ------------------------------------------------------------

def test_arcface_matches_jax_and_round_trips():
    net = randomize_bn(he_scaled(port_net(tmisc.ResNetArcFace)), 6)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_var.uniform_(0.5, 2.0)
                m.running_mean.normal_(0, 0.1)
            if isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.05, 0.5)
    tree = jax_tree(net)
    x = images(7, 2, 128, 128, 1)
    want = jax.jit(jmisc.ResNetArcFace.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-2)
    assert_round_trip(net, tree, jax_tree)


def test_inception_blocks_match_jax_and_round_trip():
    """Every block's output on a 75^2 input (no resize), and the FID
    feature function's resize to 299^2 on a 40 x 56 one."""
    net = randomize_bn(he_scaled(port_net(
        tinc.InceptionV3, output_blocks=(0, 1, 2, 3), resize_input=False)), 8)
    tree = jax_tree(net)
    x = images(8, 1, 75, 75, 3)
    want = jax.jit(lambda p, v: jinc.InceptionV3.apply(
        p, v, output_blocks=(0, 1, 2, 3), resize_input=False))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert [o.shape[1] for o in got] == [64, 192, 768, 2048]
    for g, w in zip(got, want):
        scaled_close(nhwc(g), w)
    assert_round_trip(net, tree, jax_tree, output_blocks=(0, 1, 2, 3),
                      resize_input=False)
    fid_net = tinc.InceptionV3(device="cpu")
    fid_net.load_state_dict(net.state_dict())
    x = images(9, 1, 40, 56, 3)
    feats = tinc.make_fid_feature_fn(fid_net)(nchw(x)).numpy()
    want = jinc.make_fid_feature_fn(tree)(jnp.asarray(x))
    assert feats.shape == (1, 2048)
    scaled_close(feats, want)
