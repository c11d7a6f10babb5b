"""The rest of the VQGAN family in the port (the Gumbel quantizer, the
VQAutoEncoder, VQGANDiscriminator, Discriminator3D) and the ops they need
(conv3d, spectral_norm_weight, avg_pool_2x) against the JAX package, on the
CPU in f32.

Each model runs one JAX param tree (drawn by the JAX init, perturbed by 0.02
so no table or statistic sits at its init value) carried into the port by
params_from_jax; the round-trip tests hold the new state-dict keys to the
JAX package's converter (utils/checkpoint.py's convert_state_dict).
Tolerances are the JAX package's VQGAN golden ones
(tests/test_vqgan_golden.py): 2e-4/1e-4 for the encoder and the
discriminators, 5e-4/1e-3 for the full autoencoder; ops 1e-5 relative.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import vqgan as jv
from comfyui_keep_tpu.ops.conv import conv3d as jconv3d
from comfyui_keep_tpu.ops.resample import avg_pool_2x as javg_pool_2x
from comfyui_keep_tpu.ops.spectral import spectral_norm_weight as jsn
from comfyui_keep_tpu.utils.checkpoint import (convert_state_dict,
                                               embedding_rule)
from comfyui_keep_torch.models import vqgan as tv
from comfyui_keep_torch.ops import avg_pool_2x, conv3d, spectral_norm_weight
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (assert_trees_equal, flat, rel,
                                      state_numpy)

torch.set_num_threads(2)
CFG = dict(img_size=32, nf=32, ch_mult=(1, 2), res_blocks=1,
           attn_resolutions=(16,), codebook_size=64, emb_dim=16)
ENC_TOL = dict(atol=2e-4, rtol=1e-4)
FULL_TOL = dict(atol=5e-4, rtol=1e-3)
OP_RTOL = 1e-5


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _ported(cls, tree, **kw):
    net = cls(device="cpu", **kw)
    net.load_state_dict(params_from_jax(tree, net))
    return net


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,padding", [
    (1, 1), ((1, 2, 2), [(1, 1), (2, 2), (2, 2)]),
    ((2, 1, 2), [(0, 1), (1, 2), (2, 0)])])
def test_conv3d_matches_jax(stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 9, 11, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 5, 5, 4, 6)) * 0.1).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jconv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=stride, padding=padding))
    ours = conv3d(torch.as_tensor(x.transpose(0, 4, 1, 2, 3).copy()),
                  torch.as_tensor(w.transpose(4, 3, 0, 1, 2).copy()),
                  torch.as_tensor(b), stride, padding)
    assert rel(ours.numpy().transpose(0, 2, 3, 4, 1), ref) <= OP_RTOL


@pytest.mark.parametrize("n_power_iterations", [1, 3])
@pytest.mark.parametrize("shape,to_jax", [
    ((6, 4, 3, 5, 5), (2, 3, 4, 1, 0)),    # Conv3d OIDHW -> DHWIO
    ((7, 12), (1, 0))])                    # Linear (out, in) -> (in, out)
def test_spectral_norm_weight_matches_jax(n_power_iterations, shape, to_jax):
    """w / sigma and the updated u; sigma keeps W's gradient, the power
    iteration none (the gradients of sum(r * w / sigma) agree too)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape[0]).astype(np.float32)
    u /= np.linalg.norm(u)
    r = rng.standard_normal(shape).astype(np.float32)
    wj = w.transpose(to_jax)
    (ref, ref_u) = jsn(jnp.asarray(wj), jnp.asarray(u), n_power_iterations)
    ref_g = jax.grad(lambda a: jnp.sum(
        jnp.asarray(r.transpose(to_jax)) * jsn(a, jnp.asarray(u),
                                               n_power_iterations)[0]))(
        jnp.asarray(wj))
    wt = torch.as_tensor(w).requires_grad_(True)
    ours, ours_u = spectral_norm_weight(wt, torch.as_tensor(u),
                                        n_power_iterations)
    (torch.as_tensor(r) * ours).sum().backward()
    back = np.argsort(to_jax)
    assert rel(ours.detach().numpy(), np.asarray(ref).transpose(back)) \
        <= OP_RTOL
    assert rel(ours_u.numpy(), np.asarray(ref_u)) <= OP_RTOL
    assert rel(wt.grad.numpy(), np.asarray(ref_g).transpose(back)) <= 1e-4


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 9, 2)])
def test_avg_pool_2x_matches_jax(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ref = np.asarray(javg_pool_2x(jnp.asarray(x)))
    ours = avg_pool_2x(torch.as_tensor(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Gumbel quantizer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gumbel():
    tree = perturbed(jv.gumbel_quantizer_init(jax.random.PRNGKey(3), 64, 16,
                                              16), 3)
    q = tv.GumbelQuantizer(64, 16, 16).requires_grad_(False)
    q.load_state_dict(params_from_jax(tree, q))
    return tree, q


@pytest.mark.parametrize("noise,hard", [(True, True), (False, True),
                                        (True, False)])
def test_gumbel_quantize_on_jax_draw(gumbel, noise, hard):
    """The port fed JAX's own uniform draw (jax.random.uniform(key, logits
    shape)) gives JAX's codes, z_q and KL term; without a key neither adds
    noise. The straight-through gradient of z_q agrees as well."""
    tree, q = gumbel
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    r = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5) if noise else None
    jp = jax.tree.map(jnp.asarray, tree)
    zq, diff, st = jv.gumbel_quantize(jp, jnp.asarray(z), key=key, hard=hard)
    grad = jax.grad(lambda a: jnp.sum(jnp.asarray(r) * jv.gumbel_quantize(
        jp, a, key=key, hard=hard)[0]))(jnp.asarray(z))
    uniform = (torch.as_tensor(np.array(jax.random.uniform(key, (2, 4, 4,
                                                                   64))))
               if noise else None)
    zt = torch.as_tensor(z).requires_grad_(True)
    ours, odiff, ost = tv.gumbel_quantize(q, zt, uniform=uniform, hard=hard)
    (torch.as_tensor(r) * ours).sum().backward()
    np.testing.assert_array_equal(ost["min_encoding_indices"].numpy(),
                                  np.asarray(st["min_encoding_indices"]))
    assert rel(ours.detach().numpy(), np.asarray(zq)) <= 1e-5
    assert abs(odiff.item() - float(diff)) <= 1e-6 * max(abs(float(diff)), 1)
    assert rel(zt.grad.numpy(), np.asarray(grad)) <= 1e-4


def test_gumbel_quantize_draws_from_a_generator(gumbel):
    """A seeded torch.Generator draws the noise: the same seed the same
    codes, the draw the same as uniform= of torch.rand on that seed."""
    _, q = gumbel
    z = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (1, 4, 4, 16)).astype(np.float32))
    a = tv.gumbel_quantize(q, z, generator=torch.Generator().manual_seed(7))
    b = tv.gumbel_quantize(q, z, uniform=torch.rand(
        (1, 4, 4, 64), generator=torch.Generator().manual_seed(7)))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    c = tv.gumbel_quantize(q, z)
    assert not torch.equal(a[2]["min_encoding_indices"],
                           c[2]["min_encoding_indices"])


# ---------------------------------------------------------------------------
# VQAutoEncoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["nearest", "gumbel"])
def autoencoder(request):
    quantizer = request.param
    tree = perturbed(jv.VQAutoEncoder.init(jax.random.PRNGKey(8),
                                           quantizer=quantizer, **CFG), 8)
    return quantizer, tree, _ported(tv.VQAutoEncoder, tree,
                                    quantizer=quantizer, **CFG)


def test_autoencoder_params_round_trip_through_jax_converter(autoencoder):
    """tree -> params_from_jax -> state dict -> convert_state_dict (the code
    table under its nn.Embedding name kept (num, dim)) -> the same tree."""
    quantizer, tree, net = autoencoder
    name = "embedding" if quantizer == "nearest" else "embed"
    back = convert_state_dict(state_numpy(net), rules=[embedding_rule(
        f"quantize.{name}", ("quantize", name))])
    assert_trees_equal(tree, back)


def test_autoencoder_matches_jax(autoencoder):
    """Reconstruction, quantizer loss and codes; the nearest codes come from
    VectorQuantizer.nearest (K4's plain version on the CPU), the Gumbel
    ones from JAX's own draw."""
    quantizer, tree, net = autoencoder
    x = np.random.default_rng(9).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(10) if quantizer == "gumbel" else None
    out, loss, stats = jv.VQAutoEncoder.apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), quantizer=quantizer,
        key=key, **CFG)
    uniform = None
    if key is not None:
        uniform = torch.as_tensor(np.array(jax.random.uniform(
            key, (2, 16, 16, CFG["codebook_size"]))))
    with torch.no_grad():
        ours, oloss, ostats = net(torch.as_tensor(x), uniform=uniform)
    assert ours.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(
        ostats["min_encoding_indices"].numpy().reshape(-1),
        np.asarray(stats["min_encoding_indices"]).reshape(-1))
    np.testing.assert_allclose(ours.numpy(), np.asarray(out), **FULL_TOL)
    assert abs(oloss.item() - float(loss)) <= 1e-5 + 1e-4 * abs(float(loss))


def test_autoencoder_seeded_init_and_structure_match_jax():
    """Full-width keys and shapes equal the JAX tree's in both quantizer
    modes, and a seed gives the same weights twice."""
    for quantizer in ("nearest", "gumbel"):
        shapes = jax.eval_shape(lambda k: jv.VQAutoEncoder.init(
            k, quantizer=quantizer), jax.random.PRNGKey(0))
        with torch.device("meta"):
            net = tv.VQAutoEncoder(quantizer=quantizer, device="meta")
        name = "embedding" if quantizer == "nearest" else "embed"
        zeros = {k: np.zeros(v.shape, np.float32)
                 for k, v in net.state_dict().items()}
        back = convert_state_dict(zeros, rules=[embedding_rule(
            f"quantize.{name}", ("quantize", name))])
        want = flat(jax.tree.map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
        assert ({k: v.shape for k, v in flat(back).items()}
                == {k: v.shape for k, v in want.items()})
    a, b = (tv.VQAutoEncoder(quantizer="gumbel", device="cpu", **CFG,
                             generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_autoencoder_rejects_an_unknown_quantizer():
    with pytest.raises(ValueError, match="quantizer"):
        tv.VQAutoEncoder(quantizer="kmeans", device="cpu", **CFG)


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patch_disc():
    tree = perturbed(jv.VQGANDiscriminator.init(jax.random.PRNGKey(11), nc=3,
                                                ndf=16, n_layers=2), 11)
    for layer in tree["layers"]:   # running variances kept positive
        if "bn" in layer:
            layer["bn"]["var"] = np.abs(layer["bn"]["var"]) + 0.5
    return tree, _ported(tv.VQGANDiscriminator, tree, ndf=16, n_layers=2)


def test_vqgan_discriminator_matches_jax(patch_disc):
    tree, net = patch_disc
    x = np.random.default_rng(12).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = jv.VQGANDiscriminator.apply(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x), nc=3, ndf=16,
                                      n_layers=2)
    ours = net(torch.as_tensor(x))
    assert ours.shape == ref.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **ENC_TOL)


def test_vqgan_discriminator_params_round_trip(patch_disc):
    """The reference's `main` Sequential keys (conv, BatchNorm, leaky ReLU
    triples) through convert_state_dict, regrouped into (conv, bn) layers
    as the JAX golden test does, give the tree back."""
    tree, net = patch_disc
    sd = state_numpy(net)
    assert "main.3.running_var" in sd and "main.8.bias" in sd
    main = convert_state_dict(sd)["main"]
    layers = [m for m in main if m is not None]
    grouped, i = [], 0
    while i < len(layers):
        entry = {"conv": layers[i]}
        if i + 1 < len(layers) and "mean" in layers[i + 1]:
            entry["bn"] = layers[i + 1]
            i += 1
        grouped.append(entry)
        i += 1
    assert_trees_equal(tree, {"layers": grouped})


@pytest.fixture(scope="module")
def video_disc():
    tree = perturbed(jv.Discriminator3D.init(jax.random.PRNGKey(13), nf=8),
                     13)
    return tree, _ported(tv.Discriminator3D, tree, nf=8)


@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_discriminator3d_matches_jax(video_disc, use_sigmoid):
    """(B, T, H, W, C) clips; five spectral-norm conv3d layers, each
    normalised by one power iteration from its stored u, and a plain one."""
    tree, net = video_disc
    x = np.random.default_rng(14).standard_normal((1, 4, 64, 64, 3)).astype(
        np.float32)
    ref = jv.Discriminator3D.apply(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(x), use_sigmoid=use_sigmoid)
    net.use_sigmoid = use_sigmoid
    try:
        ours = net(torch.as_tensor(x))
    finally:
        net.use_sigmoid = False
    assert ours.shape == ref.shape == (1, 4, 1, 1, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **ENC_TOL)


def test_discriminator3d_params_round_trip(video_disc):
    """weight_orig / weight_u / weight_v (torch's spectral_norm names) at
    the reference's conv.{0,2,..,10}: convert_state_dict takes the weight
    and u back and drops v; v is W^T u normalised."""
    tree, net = video_disc
    sd = state_numpy(net)
    assert {"conv.0.weight_orig", "conv.0.weight_u", "conv.0.weight_v",
            "conv.10.weight", "conv.10.bias"} <= set(sd)
    conv = convert_state_dict(sd)["conv"]
    assert_trees_equal(tree, {"layers": [conv[i] for i in range(0, 11, 2)]})
    w = sd["conv.2.weight_orig"].reshape(sd["conv.2.weight_orig"].shape[0],
                                         -1)
    v = w.T @ sd["conv.2.weight_u"]
    np.testing.assert_allclose(sd["conv.2.weight_v"], v / np.linalg.norm(v),
                               rtol=1e-5, atol=1e-7)


def test_discriminator3d_without_spectral_norm_and_seeded():
    """use_spectral_norm=False builds plain biased Conv3d's (keys
    conv.{i}.weight / bias); a seed gives unit u vectors and finite
    logits."""
    net = tv.Discriminator3D(nf=4, use_spectral_norm=False, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert "conv.0.bias" in net.state_dict()
    sn = tv.Discriminator3D(nf=4, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    u = sn.state_dict()["conv.4.weight_u"]
    assert abs(u.norm().item() - 1) < 1e-6
    x = torch.randn(1, 2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    for m in (net, sn):
        out = m(x)
        assert out.shape == (1, 2, 1, 1, 16) and torch.isfinite(out).all()


SN_MODES = ("train", "train", "eval", "train", "eval", "train")


@pytest.mark.parametrize("dims", [2, 3])
def test_spectral_norm_layers_step_as_torch_spectral_norm(dims):
    """SpectralNormConv2d (discriminators.py: UNetDiscriminatorSN,
    HiFaceGAN, DFDNet) and SpectralNormConv3d (Discriminator3D) against
    torch.nn.utils.spectral_norm on an nn.Conv2d / nn.Conv3d with the same
    weight_orig, bias, u and v, over a sequence of train and eval forwards.
    Each training forward advances u and v in place as torch's does: the
    outputs and both buffers within 1e-6 of their largest magnitude
    (measured: equal) and the output equal to the JAX package's form from
    the incoming u. Eval forwards move neither buffer, as torch's; their
    output is the JAX package's (one power iteration from u, not kept),
    where torch's divides by u.(W v) from the stored vectors (ROADMAP
    Queue 3)."""
    from comfyui_keep_torch.models.discriminators import SpectralNormConv2d
    from comfyui_keep_torch.models.init import spectral_init_
    g = torch.Generator().manual_seed(40 + dims)
    if dims == 2:
        ours = SpectralNormConv2d(6, 10, 3, stride=2, padding=1)
        ref = torch.nn.Conv2d(6, 10, 3, 2, 1)
        x = torch.randn(2, 6, 12, 12, generator=g)
    else:
        ours = tv.SpectralNormConv3d(6, 10, (3, 5, 5), (1, 2, 2), (1, 2, 2),
                                     bias=True)
        ref = torch.nn.Conv3d(6, 10, (3, 5, 5), (1, 2, 2), (1, 2, 2))
        x = torch.randn(2, 6, 3, 12, 12, generator=g)
    spectral_init_(ours, g)
    ref = torch.nn.utils.spectral_norm(ref)
    with torch.no_grad():
        for n in ("weight_orig", "bias", "weight_u", "weight_v"):
            getattr(ref, n).copy_(getattr(ours, n))

    def close(a, b):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), (
            (a - b).abs().max(), b.abs().max())

    def jax_form(u):
        w = ours.weight_orig.detach()
        wt = np.moveaxis(w.numpy(), (0, 1), (-1, -2))    # (..., I, O)
        wn, _ = jsn(jnp.asarray(wt), jnp.asarray(u.numpy()))
        wn = torch.from_numpy(np.moveaxis(np.array(wn), (-1, -2), (0, 1)))
        fn = torch.nn.functional.conv2d if dims == 2 else \
            torch.nn.functional.conv3d
        return fn(x, wn.contiguous(), ours.bias.detach(), ours.stride,
                  ours.padding)

    moved = 0
    for mode in SN_MODES:
        ours.train(mode == "train")
        ref.train(mode == "train")
        u_in = ours.weight_u.clone()
        with torch.no_grad():
            got, want = ours(x), ref(x)
        close(ours.weight_u, ref.weight_u)
        close(ours.weight_v, ref.weight_v)
        np.testing.assert_allclose(got.numpy(), jax_form(u_in).numpy(),
                                   rtol=OP_RTOL, atol=1e-6)
        if mode == "train":
            close(got, want)
            moved += not torch.equal(ours.weight_u, u_in)
        else:
            assert torch.equal(ours.weight_u, u_in)
            assert (got - want).abs().max() > 1e-4 * want.abs().max()
    assert moved == SN_MODES.count("train")
