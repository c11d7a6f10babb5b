"""The port's flow and video SR archs against the JAX package's, on the CPU
in f32: SpyNet, BasicVSR, EDVR (PCD + TSA, and without TSA), BasicVSR++,
IconVSR (models/spynet.py, models/video_sr.py), TOFlow and DUF
(models/misc_archs.py), at narrow widths (8 channels, 1 block, 3-7 frames
of 16-64 px).

Weights: the port's seeded init (the deformable layers' zero-initialised
offset convs drawn N(0, 0.05^2), so the deformable paths are live; DUF's
BatchNorm statistics randomised) carried into a JAX tree by the JAX
package's convert_state_dict (the oracle), the normalisation buffers the
JAX trees do not hold left out, as the JAX package's golden tests do; and
back by params_from_jax, which must rebuild the port's state dict exactly
and give the same tree again. One JAX init tree per family goes the other
way.

Tolerances (atol / rtol) are the JAX package's golden ones against the
reference: SpyNet, TOFlow 1e-3 / 1e-2; BasicVSR, EDVR 2e-3 / 1e-2;
BasicVSR++, IconVSR 3e-3 / 1e-2; DUF 1e-4 / 1e-3.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import misc_archs as jmisc
from comfyui_keep_tpu.models import spynet as jspy
from comfyui_keep_tpu.models import video_sr as jvsr
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch.models import misc_archs as tmisc
from comfyui_keep_torch.models import spynet as tspy
from comfyui_keep_torch.models import video_sr as tvsr
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (assert_trees_equal, randomize_bn,
                                      state_numpy)

torch.set_num_threads(2)
TOL = {"spynet": (1e-3, 1e-2), "toflow": (1e-3, 1e-2),
       "basicvsr": (2e-3, 1e-2), "edvr": (2e-3, 1e-2),
       "basicvsrpp": (3e-3, 1e-2), "iconvsr": (3e-3, 1e-2),
       "duf": (1e-4, 1e-3)}
NORM_BUFFERS = ("mean", "std")


def port_net(cls, seed=0, **kw):
    net = cls(device="cpu", generator=torch.Generator().manual_seed(seed),
              **kw)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, m in net.named_modules():
            if name.endswith("conv_offset"):
                last = m[-1] if isinstance(m, torch.nn.Sequential) else m
                last.weight.copy_(torch.randn(last.weight.shape,
                                              generator=g) * 0.05)
                last.bias.copy_(torch.randn(last.bias.shape,
                                            generator=g) * 0.05)
    return net


def jax_tree(net):
    """The port's weights through the JAX package's converter, the
    normalisation buffers (which its trees do not hold) left out."""
    return convert_state_dict({k: v for k, v in state_numpy(net).items()
                               if k.split(".")[-1] not in NORM_BUFFERS})


def assert_round_trip(net, tree, **kw):
    again = type(net)(device="cpu", **kw)
    again.load_state_dict(params_from_jax(tree, again))
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert_trees_equal(jax_tree(again), tree)


def clip(seed, t, h, w):
    return np.random.default_rng(seed).random((1, t, h, w, 3),
                                              dtype=np.float32)


def to_port(x):
    """(B, T, H, W, 3) or (B, H, W, 3) numpy -> the port's channels-second
    tensor."""
    t = torch.from_numpy(x)
    return t.permute(0, 1, 4, 2, 3) if t.dim() == 5 else t.permute(0, 3, 1,
                                                                   2)


def from_port(y):
    y = y.detach()
    return (y.permute(0, 1, 3, 4, 2) if y.dim() == 5
            else y.permute(0, 2, 3, 1)).numpy()


def check(got, ref, name):
    atol, rtol = TOL[name]
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def test_spynet_flow_matches_jax_and_round_trips():
    """40 x 56 frames: resized to 64 x 64 and the flow back, an odd level
    on the way (edge-padded upsampling)."""
    net = port_net(tspy.SpyNet)
    tree = jax_tree(net)
    rng = np.random.default_rng(1)
    ref, supp = (rng.random((2, 40, 56, 3), dtype=np.float32)
                 for _ in range(2))
    want = jax.jit(jspy.SpyNet.apply)(tree, jnp.asarray(ref),
                                      jnp.asarray(supp))
    with torch.no_grad():
        got = net(to_port(ref), to_port(supp))
    check(from_port(got), want, "spynet")
    assert_round_trip(net, tree)
    assert set(tree) == {"basic_module"}


def test_basicvsr_matches_jax_and_round_trips():
    kw = dict(num_feat=8, num_block=1)
    net = port_net(tvsr.BasicVSR, **kw)
    tree = jax_tree(net)
    x = clip(2, 3, 64, 64)
    want = jax.jit(lambda p, v: jvsr.BasicVSR.apply(p, v, num_feat=8))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_port(x))
    check(from_port(got), want, "basicvsr")
    assert_round_trip(net, tree, **kw)


@pytest.mark.parametrize("with_tsa", [True, False], ids=["tsa", "conv"])
def test_edvr_matches_jax_and_round_trips(with_tsa):
    """3 frames of 24 x 40: the pyramid's 6 x 10 level, the TSA pools'
    odd sizes resized back exactly."""
    kw = dict(num_feat=8, num_frame=3, deformable_groups=2,
              num_extract_block=1, num_reconstruct_block=1,
              with_tsa=with_tsa)
    net = port_net(tvsr.EDVR, **kw)
    tree = jax_tree(net)
    x = clip(3, 3, 24, 40)
    want = jax.jit(lambda p, v: jvsr.EDVR.apply(
        p, v, num_feat=8, deformable_groups=2, with_tsa=with_tsa))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_port(x))
    check(from_port(got), want, "edvr")
    assert_round_trip(net, tree, **kw)


def test_basicvsrpp_matches_jax_and_round_trips():
    """3 frames: the second-order terms at the third frame of each of the
    four propagations."""
    kw = dict(mid_channels=8, num_blocks=1)
    net = port_net(tvsr.BasicVSRPlusPlus, **kw)
    tree = jax_tree(net)
    x = clip(4, 3, 64, 64)
    want = jax.jit(lambda p, v: jvsr.BasicVSRPlusPlus.apply(
        p, v, mid_channels=8, deformable_groups=16))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_port(x))
    check(from_port(got), want, "basicvsrpp")
    assert_round_trip(net, tree, **kw)


def test_iconvsr_matches_jax_and_round_trips():
    """5 frames of 34 x 38 (reflect-padded to 36 x 40 and cropped back),
    keyframes 0 and 4 at stride 4."""
    kw = dict(num_feat=8, num_block=1, keyframe_stride=4)
    net = port_net(tvsr.IconVSR, **kw)
    tree = jax_tree(net)
    x = clip(5, 5, 34, 38)
    want = jax.jit(lambda p, v: jvsr.IconVSR.apply(
        p, v, num_feat=8, keyframe_stride=4))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_port(x))
    check(from_port(got), want, "iconvsr")
    assert_round_trip(net, tree, **kw)


@pytest.mark.parametrize("adapt", [False, True], ids=["ref3", "official"])
def test_toflow_matches_jax_and_round_trips(adapt):
    net = randomize_bn(port_net(tmisc.TOFlow, adapt_official_weights=adapt),
                       7)
    tree = jax_tree(net)
    x = clip(6, 7, 32, 32)
    want = jax.jit(lambda p, v: jmisc.TOFlow.apply(
        p, v, adapt_official_weights=adapt))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_port(x))
    check(from_port(got), want, "toflow")
    assert_round_trip(net, tree, adapt_official_weights=adapt)


def randomize_bn3d(net, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
    return net


@pytest.mark.parametrize("scale,num_layer", [(2, 16), (4, 16)])
def test_duf_matches_jax_and_round_trips(scale, num_layer):
    kw = dict(scale=scale, num_layer=num_layer)
    net = randomize_bn3d(port_net(tmisc.DUF, **kw), 8)
    tree = jax_tree(net)
    x = clip(9, 7, 8, 12)
    want = jax.jit(lambda p, v: jmisc.DUF.apply(p, v, **kw))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_port(x))
    check(from_port(got), want, "duf")
    assert_round_trip(net, tree, **kw)


@pytest.mark.parametrize("name", ["SpyNet", "BasicVSR", "EDVR", "TOFlow"])
def test_video_jax_init_trees_load(name):
    """A tree from the JAX init loads into the port through
    params_from_jax (the buffers the tree lacks keep the port's values).
    BasicVSR++, IconVSR and DUF are built of the same kinds of layers
    (their JAX inits take 15-30 s each on the CPU)."""
    jcls = {"SpyNet": jspy.SpyNet, "TOFlow": jmisc.TOFlow}.get(name) \
        or getattr(jvsr, name)
    tcls = {"SpyNet": tspy.SpyNet, "TOFlow": tmisc.TOFlow}.get(name) \
        or getattr(tvsr, name)
    kw = {"BasicVSR": dict(num_feat=8, num_block=1),
          "EDVR": dict(num_feat=8, num_frame=3, deformable_groups=2,
                       num_extract_block=1, num_reconstruct_block=1)
          }.get(name, {})
    tree = jax.tree.map(np.asarray, jcls.init(jax.random.PRNGKey(3), **kw))
    net = tcls(device="cpu", **kw)
    fresh = net.state_dict()
    sd = params_from_jax(tree, net)
    net.load_state_dict(sd)
    for k in ("mean", "std", "spynet.mean", "spynet.std"):
        if k in fresh:
            assert torch.equal(sd[k], fresh[k]), k
