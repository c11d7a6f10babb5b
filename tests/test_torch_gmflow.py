"""GMFlow in the PyTorch port against the JAX package, on the CPU in f32.

64x64 frames (8x8 features, 4x4 windows with attn_splits=2), two
transformer layers (one plain, one shifted), one set of weights carried
from the JAX tree by params_from_jax. Tolerances are the JAX package's
GMFlow golden ones (tests/test_gmflow_golden.py): 2e-4/1e-3 for features,
2e-3 px / 1e-2 for flows.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import gmflow as jg
from comfyui_keep_torch.models import gmflow as tg
from comfyui_keep_torch.utils.convert import _flatten, params_from_jax

torch.set_num_threads(2)
FEAT_TOL = dict(atol=2e-4, rtol=1e-3)
FLOW_TOL = dict(atol=2e-3, rtol=1e-2)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jg.GMFlow.init(jax.random.PRNGKey(1), num_layers=2))
    net = tg.GMFlow(num_layers=2, device="cpu")
    net.load_state_dict(params_from_jax(tree, net))
    return tree, net


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_params_round_trip_through_jax_converter(nets):
    tree, net = nets
    back = jg.convert_gmflow_checkpoint(
        {k: v.numpy() for k, v in net.state_dict().items()})
    a = jax.tree_util.tree_flatten_with_path(tree)[0]
    b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(a) == len(b)
    for path, v in a:
        np.testing.assert_array_equal(v, b[path])


def test_full_width_structure_matches_jax():
    shapes = jax.eval_shape(jg.GMFlow.init, jax.random.PRNGKey(0))
    flat = {}
    _flatten(jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                          shapes), (), flat)
    with torch.device("meta"):
        net = tg.GMFlow(device="meta")
    assert ({k: tuple(v.shape) for k, v in flat.items()}
            == {k: tuple(v.shape) for k, v in net.state_dict().items()})


@pytest.mark.parametrize("hw,k", [((8, 8), 2), ((64, 64), 2), ((16, 24), 4)])
def test_shifted_window_mask_and_position_embedding(hw, k):
    np.testing.assert_array_equal(tg.shifted_window_mask(*hw, k),
                                  jg.shifted_window_mask(*hw, k))
    np.testing.assert_array_equal(tg.sine_pos_embed(*hw, 64),
                                  np.asarray(jg.sine_pos_embed(*hw, 64)))


def test_backbone_parity(nets):
    tree, net = nets
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3),
                                                 dtype=np.float32)
    ours = net.backbone(_nchw(x)).permute(0, 2, 3, 1)
    ref = jg.backbone_apply(tree["backbone"], jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FEAT_TOL)


def test_transformer_parity(nets):
    """Windowed self/cross attention (shifted on layer 1) + fused FFN."""
    tree, net = nets
    rng = np.random.default_rng(2)
    f0, f1 = (rng.standard_normal((2, 8, 8, 128), dtype=np.float32)
              for _ in range(2))
    ours = net.transformer_apply(torch.as_tensor(f0), torch.as_tensor(f1), 2)
    ref = jg.transformer_apply(tree["transformer"], jnp.asarray(f0),
                               jnp.asarray(f1), 2)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **FEAT_TOL)


def test_matching_propagation_and_upsampling_parity(nets):
    tree, net = nets
    rng = np.random.default_rng(3)
    f0, f1 = (rng.standard_normal((2, 8, 8, 128), dtype=np.float32)
              for _ in range(2))
    flow = tg.global_correlation_softmax(torch.as_tensor(f0),
                                         torch.as_tensor(f1))
    jflow, _ = jg.global_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1))
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), **FLOW_TOL)
    prop = net.feature_flow_attn(torch.as_tensor(f0), flow)
    jprop = jg.flow_attention(tree["feature_flow_attn"], jnp.asarray(f0),
                              jflow)
    np.testing.assert_allclose(prop.numpy(), np.asarray(jprop), **FLOW_TOL)
    fx, fy = tg.upsample_flow_convex(net.upsampler, prop, torch.as_tensor(f0))
    jfx, jfy = jg.upsample_flow_convex(tree["upsampler"], jprop,
                                       jnp.asarray(f0), planes=True)
    np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), **FLOW_TOL)
    np.testing.assert_allclose(fy.numpy(), np.asarray(jfy), **FLOW_TOL)


def test_flow_from_clip_parity(nets):
    tree, net = nets
    x = np.random.default_rng(4).random((1, 3, 64, 64, 3),
                                        dtype=np.float32) * 2 - 1
    fx, fy = tg.flow_from_clip(net, torch.as_tensor(x))
    jfx, jfy = jg.flow_from_clip(tree, jnp.asarray(x), planes=True)
    assert fx.shape == fy.shape == (1, 2, 64, 64)
    np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), **FLOW_TOL)
    np.testing.assert_allclose(fy.numpy(), np.asarray(jfy), **FLOW_TOL)
