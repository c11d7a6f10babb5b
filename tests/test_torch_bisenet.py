"""The port's BiSeNet parser (comfyui_keep_torch/models/bisenet.py) against
the JAX package's, on the CPU in f32: the three heads and their features
at a small size, the parser plug-in at 512^2 (the helper's size), the
weights through convert_bisenet_checkpoint (the oracle) and
params_from_jax both ways, and a tree from the JAX init. BatchNorm
statistics are drawn at random. Tolerance: within 1e-4 of each output's
largest magnitude (measured ~1e-6; summation order only).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import bisenet as jbis
from comfyui_keep_torch.models.bisenet import BiSeNet, make_parser_fn
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (assert_trees_equal, randomize_bn, rel,
                                      state_numpy)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bisenet():
    model = randomize_bn(BiSeNet(device="cpu", generator=torch.Generator(
    ).manual_seed(0)), 1)
    return model, jbis.convert_bisenet_checkpoint(state_numpy(model))


@pytest.mark.parametrize("hw", [(64, 96), (72, 40)])
def test_bisenet_heads_and_features_match_jax(bisenet, hw):
    model, tree = bisenet
    x = np.random.default_rng(2).uniform(-1, 1, (2,) + hw + (3,)).astype(
        np.float32)
    ref = jax.jit(jbis.BiSeNet.apply, static_argnames="return_feat")(
        tree, jnp.asarray(x), return_feat=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), return_feat=True)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape and g.shape[1:3] == hw
        assert rel(g, r) <= 1e-4


def test_parser_at_512_matches_jax(bisenet):
    model, tree = bisenet
    x = np.random.default_rng(3).uniform(-1, 1, (1, 512, 512, 3)).astype(
        np.float32)
    ref = jbis.make_parser_fn(tree)(jnp.asarray(x))
    got = make_parser_fn(model)(x)
    assert got.shape == (1, 512, 512, 19)
    assert rel(got.numpy(), ref) <= 1e-4


def test_bisenet_round_trip_and_reference_names(bisenet):
    model, tree = bisenet
    again = BiSeNet(device="cpu")
    sd = params_from_jax(tree, again)
    again.load_state_dict(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert_trees_equal(jbis.convert_bisenet_checkpoint(state_numpy(again)),
                       tree)
    for key in ("cp.resnet.layer2.0.downsample.1.running_mean",
                "cp.arm32.conv_atten.weight", "cp.arm16.bn_atten.bias",
                "cp.conv_avg.conv.weight", "ffm.convblk.bn.weight",
                "ffm.conv2.weight", "conv_out.conv_out.weight",
                "conv_out32.conv.bn.running_var"):
        assert key in sd, key


def test_jax_init_tree_loads():
    tree = jax.tree.map(np.asarray, jbis.BiSeNet.init(jax.random.PRNGKey(4)))
    model = BiSeNet(device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    assert_trees_equal(jbis.convert_bisenet_checkpoint(state_numpy(model)),
                       tree)
