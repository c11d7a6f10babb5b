"""GMFlow's refinement model in the port (the trident backbone, local
matching and propagation, GMFlow.apply, apply_refine, the occlusion check)
against the JAX package, on the CPU in f32.

64x64 frames, two transformer layers, one JAX param tree built with
num_scales=2 (perturbed by 0.02) carried into the port by params_from_jax.
At the defaults, attn_splits (2, 8), scale 0 runs 1/8-resolution features
(8x8, 4x4 windows) with global matching and propagation, scale 1 the
1/4-resolution ones (16x16, 2x2 windows of the 8x8 split) with local
matching (radius 4) and propagation (radius 1). The published model's
upsample_factor=4 (the port's; JAX is fixed at 8): its convex upsampling
against JAX's factor-generic upsample_flow_convex, its output size and
the reference's training predictions. Tolerances are the JAX
package's GMFlow golden ones (tests/test_gmflow_golden.py): 2e-4/1e-3 for
features, 2e-3 px / 1e-2 for flows.
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
# the JAX forwards jitted: op by op they take 5-6x longer on the CPU
japply = jax.jit(jg.GMFlow.apply, static_argnums=(3, 4, 5))
japply_refine = jax.jit(jg.GMFlow.apply_refine,
                        static_argnames=("pred_bidir_flow",))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jg.GMFlow.init(jax.random.PRNGKey(1), num_layers=2, num_scales=2))
    net = tg.GMFlow(num_layers=2, num_scales=2, device="cpu")
    net.load_state_dict(params_from_jax(tree, net))
    return tree, net


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return tuple(rng.random((1, 64, 64, 3), dtype=np.float32) * 255
                 for _ in range(2))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_refine_params_round_trip_through_jax_converter(nets):
    """The trident conv's weight (backbone.trident_conv.weight) goes back to
    the JAX tree's backbone.trident_conv.w like every other key."""
    tree, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert "backbone.trident_conv.weight" in sd
    back = jg.convert_gmflow_checkpoint(sd)
    a = jax.tree_util.tree_flatten_with_path(tree)[0]
    b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(a) == len(b)
    for path, v in a:
        np.testing.assert_array_equal(v, b[path])


@pytest.mark.parametrize("num_scales", [2, 4])
def test_refine_full_width_structure_matches_jax(num_scales):
    shapes = jax.eval_shape(lambda k: jg.GMFlow.init(k, num_scales=num_scales),
                            jax.random.PRNGKey(0))
    flat = {}
    _flatten(jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                          shapes), (), flat)
    with torch.device("meta"):
        net = tg.GMFlow(num_scales=num_scales, device="meta")
    assert ({k: tuple(v.shape) for k, v in flat.items()}
            == {k: tuple(v.shape) for k, v in net.state_dict().items()})


@pytest.mark.parametrize("num_output_scales", [1, 2])
def test_trident_backbone_matches_jax(nets, num_output_scales):
    """Two scales: layer3 at stride 1 and the shared trident conv at
    strides 1 and 2, high resolution first (16x16, 8x8). One scale: the
    JAX package's backbone_apply default, layer3 at stride 2 and no trident
    conv, on the same weights."""
    tree, net = nets
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    ref = jg.backbone_apply(tree["backbone"], jnp.asarray(x),
                            num_output_scales=num_output_scales)
    ours = net.backbone(_t(x.transpose(0, 3, 1, 2)), num_output_scales)
    if num_output_scales == 1:
        ref, ours = [ref], [ours]
    assert [tuple(o.shape[2:]) for o in ours] == [r.shape[1:3] for r in ref]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), **FEAT_TOL)


@pytest.mark.parametrize("radius", [1, 4])
def test_local_correlation_softmax_matches_jax(radius):
    """Windows reaching past the border take -1e9 there (zero-padded
    samples); at radius 4 on 9x7 most windows do."""
    rng = np.random.default_rng(3)
    f0, f1 = (rng.standard_normal((2, 9, 7, 128)).astype(np.float32)
              for _ in range(2))
    ref, _ = jg.local_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1),
                                          radius)
    ours = tg.local_correlation_softmax(_t(f0), _t(f1), radius)
    assert ours.shape == (2, 9, 7, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FLOW_TOL)


@pytest.mark.parametrize("radius", [-1, 1, 2])
def test_flow_propagation_matches_jax(nets, radius):
    """The local branch keys on k_proj(feature0), the global one on
    k_proj(q_proj(feature0)) (the reference's quirk): both against JAX."""
    tree, net = nets
    rng = np.random.default_rng(4)
    f0 = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    flow = (rng.standard_normal((2, 8, 8, 2)) * 3).astype(np.float32)
    ref = jg.flow_attention(tree["feature_flow_attn"], jnp.asarray(f0),
                            jnp.asarray(flow), local_window_radius=radius)
    ours = net.feature_flow_attn(_t(f0), _t(flow), radius)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FLOW_TOL)


def test_unfold_nhwc_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 5, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tg._unfold_nhwc(_t(x), 3, 1).numpy(),
                                  np.asarray(jg._unfold_nhwc(jnp.asarray(x),
                                                             3, 1)))


@pytest.mark.parametrize("attn_splits,corr_radius,prop_radius", [
    (2, -1, -1), (2, 4, 1), (1, 2, -1)])
def test_gmflow_apply_matches_jax(nets, images, attn_splits, corr_radius,
                                  prop_radius):
    """GMFlow.apply through the single-scale backbone, global or local
    matching and propagation, as (B, H, W, 2) flows."""
    tree, net = nets
    img0, img1 = images
    ref = japply(tree, jnp.asarray(img0), jnp.asarray(img1), attn_splits,
                 corr_radius, prop_radius)
    ours = net.apply(_t(img0), _t(img1), attn_splits, corr_radius,
                     prop_radius)
    assert ours.shape == (1, 64, 64, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FLOW_TOL)


def test_apply_refine_matches_jax(nets, images):
    """The defaults: (2, 8) splits, global then radius-4 matching, global
    then radius-1 propagation, f1 warped by the x2 coarse flow."""
    tree, net = nets
    img0, img1 = images
    ref = japply_refine(tree, jnp.asarray(img0), jnp.asarray(img1))
    ours = net.apply_refine(_t(img0), _t(img1))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FLOW_TOL)


def test_apply_refine_upsamples_x8_from_quarter_resolution(nets, images):
    """At the default upsample_factor 8 (the JAX package's only factor) the
    convex upsampler has 8^2 * 9 mask channels, so two scales
    (1/4-resolution features) return twice the input size, as in JAX. The
    published gmflow_with_refine is built with upsample_factor=4: its
    upsampler.2 has the published 4^2 * 9 = 144 channels, and two scales
    return the input's size."""
    tree, net = nets
    img0, img1 = images
    assert net.upsampler[2].out_channels == 8 * 8 * 9
    assert net.apply_refine(_t(img0), _t(img1)).shape == (1, 128, 128, 2)
    x4 = x4_net(tree)
    assert x4.state_dict()["upsampler.2.weight"].shape == (144, 256, 1, 1)
    assert x4.state_dict()["upsampler.2.bias"].shape == (144,)
    assert x4.apply_refine(_t(img0), _t(img1)).shape == (1, 64, 64, 2)
    assert x4.apply_refine(_t(img0), _t(img1),
                           pred_bidir_flow=True).shape == (2, 64, 64, 2)


def x4_net(tree, seed=5):
    """The port's refinement model at upsample_factor=4 on `tree`, its
    upsampler JAX's upsampler_init(factor=4) (perturbed by 0.02)."""
    rng = np.random.default_rng(seed)
    up = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jg.upsampler_init(jax.random.PRNGKey(seed), factor=4))
    net = tg.GMFlow(num_layers=2, num_scales=2, upsample_factor=4,
                    device="cpu")
    net.load_state_dict(params_from_jax({**tree, "upsampler": up}, net))
    return net


def test_convex_upsampling_at_factor_4_matches_jax(nets):
    """upsample_flow_convex at factor 4 (16 x 9 softmax weights a pixel)
    against JAX's factor-generic upsample_flow_convex on the same
    upsampler (upsampler_init(factor=4)), flow and features."""
    tree, _ = nets
    net = x4_net(tree)
    rng = np.random.default_rng(6)
    flow = (rng.standard_normal((2, 8, 12, 2)) * 3).astype(np.float32)
    feat = rng.standard_normal((2, 8, 12, 128)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, params_from_jax_upsampler(net))
    ref = jg.upsample_flow_convex(p, jnp.asarray(flow), jnp.asarray(feat),
                                  factor=4)
    with torch.no_grad():
        fx, fy = tg.upsample_flow_convex(net.upsampler, _t(flow), _t(feat),
                                         4)
    ours = torch.stack([fx, fy], dim=-1).numpy()
    assert ours.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(ours, np.asarray(ref), **FLOW_TOL)


def params_from_jax_upsampler(net):
    """The port upsampler's weights in JAX's layout ([conv, None, conv],
    w (kh, kw, cin, cout))."""
    c0, c2 = net.upsampler[0], net.upsampler[2]
    return [{"w": c.weight.detach().permute(2, 3, 1, 0).numpy(),
             "b": c.bias.detach().numpy()} if c is not None else None
            for c in (c0, None, c2)]


def test_refine_predictions_follow_the_reference(nets, images):
    """refine(return_preds=True), the reference's training predictions on
    the x4 model: scale 0's flow before and after propagation, bilinear
    x8 (4 * 2^1) from 1/8 resolution, scale 1's before it, bilinear x4
    from 1/4, then the convex flow, all at the input's size; the last is
    apply_refine's, bitwise. The default factor's refine gives the same
    list at twice the size."""
    tree, net = nets
    img0, img1 = images
    x4 = x4_net(tree).requires_grad_(True)
    preds = x4.refine(_t(img0), _t(img1), return_preds=True)
    assert [tuple(p.shape) for p in preds] == [(1, 64, 64, 2)] * 4
    assert preds[-1].requires_grad
    np.testing.assert_array_equal(
        preds[-1].detach().numpy(),
        x4.apply_refine(_t(img0), _t(img1)).numpy())
    with torch.no_grad():
        preds8 = net.refine(_t(img0), _t(img1), return_preds=True)
    assert [tuple(p.shape) for p in preds8] == [(1, 128, 128, 2)] * 4


def test_apply_refine_bidirectional_matches_jax(nets, images):
    """pred_bidir_flow runs both directions as one doubled batch: both
    halves against JAX, and the backward half equal to the forward pass on
    the swapped pair (JAX's golden test's requirement)."""
    tree, net = nets
    img0, img1 = images
    ref = japply_refine(tree, jnp.asarray(img0), jnp.asarray(img1),
                        pred_bidir_flow=True)
    ours = net.apply_refine(_t(img0), _t(img1), pred_bidir_flow=True)
    assert ours.shape == (2, 128, 128, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FLOW_TOL)
    swapped = net.apply_refine(_t(img1), _t(img0))
    np.testing.assert_allclose(ours[1:].numpy(), swapped.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_forward_backward_consistency_check_matches_jax():
    """Occlusion masks of a bidirectional pair: equal to JAX's, with both
    values present."""
    rng = np.random.default_rng(6)
    fwd, bwd = ((rng.standard_normal((2, 16, 16, 2)) * 0.6).astype(
        np.float32) for _ in range(2))
    ref = jg.forward_backward_consistency_check(jnp.asarray(fwd),
                                                jnp.asarray(bwd))
    ours = tg.forward_backward_consistency_check(_t(fwd), _t(bwd))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert 0 < o.mean().item() < 1
