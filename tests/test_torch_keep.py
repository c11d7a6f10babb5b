"""KEEP in the PyTorch port against the JAX package, on the CPU in f32.

Both packages run one set of weights: a JAX param tree (perturbed so the
zero-initialised CFT/CFA/temporal blocks are live) carried into the port by
params_from_jax. Tolerances are those of the JAX package's golden tests
(tests/test_keep_golden.py): Kalman gain 2e-4/1e-3, forward 5e-3/1e-2.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import keep as jkeep
from comfyui_keep_torch.models.keep import (KEEP, arch_tables,
                                            kalman_calc_gain)
from comfyui_keep_torch.utils.convert import (_flatten, params_from_jax,
                                              split_keep_checkpoint)

torch.set_num_threads(2)

TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=())


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def nets():
    tree = perturbed(jkeep.KEEP.init(jax.random.PRNGKey(0), **TINY), 0)
    net = KEEP(device="cpu", **TINY)
    net.load_state_dict(params_from_jax(tree, net))
    return tree, net


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_params_round_trip_through_jax_converter(nets):
    """tree -> params_from_jax -> state dict -> convert_checkpoint -> the
    same tree, leaf for leaf."""
    tree, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back, flownet_sd = jkeep.convert_checkpoint(sd)
    assert flownet_sd == {}
    a, b = _leaves(tree), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("variant", ["KEEP", "Asian"])
def test_full_width_structure_matches_jax(variant):
    """Every key and shape of the full-width model equals the JAX tree's
    (shapes only: no weights are drawn)."""
    cfg = jkeep.KEEP.config(variant)
    shapes = jax.eval_shape(lambda k: jkeep.KEEP.init(k, **cfg),
                            jax.random.PRNGKey(0))
    flat = {}
    _flatten(jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                          shapes), (), flat)
    with torch.device("meta"):
        net = KEEP(variant, device="meta")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert sum(int(np.prod(s)) for s in want.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_arch_tables_match_reference_constants():
    channels, enc, gen = arch_tables(jkeep.DEFAULT_CFG)
    assert channels == jkeep.CHANNELS
    assert enc == jkeep.FUSE_ENCODER_BLOCK
    assert gen == jkeep.FUSE_GENERATOR_BLOCK


def test_legacy_checkpoint_names_and_flownet_split():
    sd = {"cross_fuse.16.norm1.weight": 1, "fuse_convs_dict.32.scale.0.bias": 2,
          "flownet.model.backbone.conv1.weight": 3, "feat_emb.weight": 4}
    keep, flow = split_keep_checkpoint(sd)
    assert keep == {"cfa.16.norm1.weight": 1, "cft.32.scale.0.bias": 2,
                    "feat_emb.weight": 4}
    assert flow == {"backbone.conv1.weight": 3}


def test_kalman_gain_parity(nets):
    tree, net = nets
    rng = np.random.default_rng(1)
    z = rng.standard_normal((1, 3, 16, 16, 32), dtype=np.float32) * 0.5
    ours = kalman_calc_gain(net.kalman_filter, torch.as_tensor(z))
    ref = jkeep.kalman_calc_gain(tree["kalman_filter"], jnp.asarray(z),
                                 n_head=TINY["n_head"])
    assert ours.shape == (1, 3, 16, 16, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("with_flows", [True, False])
def test_keep_apply_parity_teacher_forced(nets, with_flows):
    """Frames 0..2 through the recurrence (flow warp, HQ encoder, Kalman
    update, transformer, generator with CFT/CFA). The JAX run's code picks
    are forced on the port, and the logits are compared as well."""
    tree, net = nets
    rng = np.random.default_rng(2)
    x = rng.random((1, 3, 64, 64, 3), dtype=np.float32) * 2 - 1
    flows = None
    if with_flows:
        flows = tuple(rng.standard_normal((1, 2, 64, 64), dtype=np.float32)
                      * 2 for _ in range(2))
    ref, aux = jkeep.KEEP.apply(
        tree, jnp.asarray(x),
        flows=None if flows is None else tuple(map(jnp.asarray, flows)),
        remat=False, return_aux=True, **TINY)
    picks = np.asarray(aux["logits"]).argmax(-1).reshape(1, 3, -1)
    out, ours = net.apply(
        torch.as_tensor(x),
        flows=None if flows is None else tuple(map(torch.as_tensor, flows)),
        return_aux=True, force_indices=torch.as_tensor(picks))
    assert out.shape == (1, 3, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(ours["logits"].numpy(),
                               np.asarray(aux["logits"]), atol=5e-3,
                               rtol=1e-2)
