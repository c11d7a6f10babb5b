"""StyleGAN2 in the PyTorch port against the JAX package, on the CPU in f32:
upfirdn2d, the modulated conv, the generator (FIR and bilinear), the
discriminator, the GAN losses, R1 and the path-length penalty with their
gradients, one full GAN alternation of the trainer, and the param round
trip through the JAX converters.

Both packages run one set of weights: JAX param trees at a tiny size (out
size 32, narrow 0.25, channel multiplier 1, 16 style features, 2 mapping
layers), perturbed so that the zero-initialised noise weights and biases
are live, carried into the port by params_from_jax. Noise and codes are
drawn by jax.random as the JAX package draws them and handed to the port.
Tolerances: single ops 1e-5 (summation order); generator and discriminator
2e-3 / 1e-2 (tests/test_stylegan2_golden.py); losses 1e-4 relative;
per-leaf gradients and updates 2e-3 * max|ref| + 1e-7.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import stylegan2 as js
from comfyui_keep_tpu.models.stylegan2_bilinear import (
    StyleGAN2GeneratorBilinear as JBilinear)
from comfyui_keep_tpu.ops import native as jn
from comfyui_keep_tpu.training import losses as JL
from comfyui_keep_tpu.training.trainers import StyleGAN2Trainer as JTrainer
from comfyui_keep_torch.models import stylegan2 as ts
from comfyui_keep_torch.models.stylegan2_bilinear import (
    StyleGAN2GeneratorBilinear)
from comfyui_keep_torch.ops import kernels as K
from comfyui_keep_torch.ops import native as tn
from comfyui_keep_torch.training import losses as TL
from comfyui_keep_torch.training.trainers import StyleGAN2Trainer, build_model
from comfyui_keep_torch.utils.convert import params_from_jax

torch.set_num_threads(2)
SIZE, S, MLP = 32, 16, 2
G_CFG = dict(num_style_feat=S, num_mlp=MLP, channel_multiplier=1, narrow=0.25)
D_CFG = dict(channel_multiplier=1, narrow=0.25)
NUM_LAYERS = (int(np.log2(SIZE)) - 2) * 2 + 1
OP_TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=2e-3, rtol=1e-2)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-3, 1e-7


def perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _nchw(a):
    return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def layer_noise(key, b):
    """The generator's random noise as the JAX package draws it: one key per
    layer, (B, r, r, 1) each at layer i's resolution r = 2 ** ((i + 5) // 2).
    """
    return [jax.random.normal(k, (b, 2 ** ((i + 5) // 2),
                                  2 ** ((i + 5) // 2), 1))
            for i, k in enumerate(jax.random.split(key, NUM_LAYERS))]


def param_grads(loss, net):
    """d loss / d every parameter, zero where a parameter is not reached
    (the JAX gradient tree has a zero leaf there)."""
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}


def assert_leaves_close(ours, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Per leaf: max|ours - ref| <= rtol * max|ref| + atol."""
    assert ours.keys() == ref.keys()
    for n, r in ref.items():
        r = torch.tensor(np.asarray(r)).double()
        err = (ours[n].detach().double() - r).abs().max().item()
        lim = rtol * r.abs().max().item() + atol
        assert err <= lim, f"{n}: max|d| {err} > {lim}"


@pytest.fixture(scope="module")
def g_pair():
    tree = perturbed(js.StyleGAN2Generator.init(jax.random.PRNGKey(0), SIZE,
                                                **G_CFG), 1)
    net = ts.StyleGAN2Generator(SIZE, device="cpu", **G_CFG)
    net.load_state_dict(params_from_jax(tree, net))
    return tree, net


@pytest.fixture(scope="module")
def d_pair():
    tree = perturbed(js.StyleGAN2Discriminator.init(jax.random.PRNGKey(1),
                                                    SIZE, **D_CFG), 2)
    net = ts.StyleGAN2Discriminator(SIZE, device="cpu", **D_CFG)
    net.load_state_dict(params_from_jax(tree, net))
    return tree, net


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["upsample", "downsample", "smooth_up",
                                   "smooth_down", "raw_up2_down2"])
def test_upfirdn2d_vs_jax(which):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    k_np = np.asarray(jn.make_resample_kernel((1, 3, 3, 1)))
    kt = tn.make_resample_kernel((1, 3, 3, 1))
    np.testing.assert_allclose(kt.numpy(), k_np, rtol=0, atol=0)
    jk = jnp.asarray(k_np)
    if which == "upsample":
        ref, ours = js.upfirdn_upsample(x, jk), ts.upfirdn_upsample(_nchw(x), kt)
    elif which == "downsample":
        ref = js.upfirdn_downsample(x, jk)
        ours = ts.upfirdn_downsample(_nchw(x), kt)
    elif which == "smooth_up":
        ref = js.upfirdn_smooth(x, jk, upsample_factor=2, kernel_size=3)
        ours = ts.upfirdn_smooth(_nchw(x), kt, upsample_factor=2, kernel_size=3)
    elif which == "smooth_down":
        ref = js.upfirdn_smooth(x, jk, downsample_factor=2, kernel_size=3)
        ours = ts.upfirdn_smooth(_nchw(x), kt, downsample_factor=2,
                                 kernel_size=3)
    else:  # an asymmetric kernel, both factors at once
        kr = rng.standard_normal((4, 4)).astype(np.float32)
        ref = jn.upfirdn2d(jnp.asarray(x), jnp.asarray(kr), up=2, down=2,
                           pad=(2, 1))
        ours = tn.upfirdn2d(_nchw(x), torch.as_tensor(kr), up=2, down=2,
                            pad=(2, 1))
    assert _nhwc(ours).shape == np.asarray(ref).shape
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("sample_mode,demodulate,ksize", [
    (None, True, 3), ("upsample", True, 3), ("downsample", True, 3),
    (None, False, 1)])
def test_modulated_conv2d_vs_jax(sample_mode, demodulate, ksize):
    rng = np.random.default_rng(4)
    cin, cout, b = 6, 5, 3
    p = {"weight": rng.standard_normal((ksize, ksize, cin, cout)).astype(
        np.float32),
        "modulation": {"w": rng.standard_normal((S, cin)).astype(np.float32),
                       "b": 1 + 0.1 * rng.standard_normal(cin).astype(
                           np.float32)}}
    x = rng.standard_normal((b, 8, 8, cin)).astype(np.float32)
    style = rng.standard_normal((b, S)).astype(np.float32)
    k2d = jn.make_resample_kernel((1, 3, 3, 1))
    ref = js.modulated_conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jnp.asarray(style), demodulate=demodulate,
                              sample_mode=sample_mode, kernel2d=k2d)
    mc = ts.ModulatedConv2d(cin, cout, ksize, S, demodulate=demodulate,
                            sample_mode=sample_mode)
    mc.load_state_dict({
        "weight": torch.as_tensor(p["weight"].transpose(3, 2, 0, 1)[None]),
        "modulation.weight": torch.as_tensor(p["modulation"]["w"].T.copy()),
        "modulation.bias": torch.as_tensor(p["modulation"]["b"])})
    ours = mc(_nchw(x), torch.as_tensor(style))
    assert _nhwc(ours).shape == np.asarray(ref).shape
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["stored_noise", "random_noise",
                                  "truncation", "input_is_latent"])
def test_generator_vs_jax(g_pair, case):
    tree, net = g_pair
    rng = np.random.default_rng(5)
    z = [rng.standard_normal((2, S)).astype(np.float32) for _ in range(2)]
    jt = jax.tree.map(jnp.asarray, tree)
    kw, tkw = {}, {}
    if case == "random_noise":
        key = jax.random.PRNGKey(7)
        kw = dict(randomize_noise=True, rng=key)
        tkw = dict(noise=[_nchw(n) for n in layer_noise(key, 2)])
    elif case == "truncation":
        mean = js.StyleGAN2Generator.style_mlp(
            jt, jnp.asarray(rng.standard_normal((64, S)), jnp.float32)
        ).mean(0, keepdims=True)
        kw = dict(truncation=0.7, truncation_latent=mean, return_latents=True)
        tkw = dict(truncation=0.7, return_latents=True,
                   truncation_latent=torch.tensor(np.asarray(mean)))
    elif case == "input_is_latent":
        z = [rng.standard_normal((2, 2 * 5 - 2, S)).astype(np.float32)]
        kw = tkw = dict(input_is_latent=True, return_latents=True)
    img, lat = js.StyleGAN2Generator.apply(jt, [jnp.asarray(a) for a in z],
                                           SIZE, num_style_feat=S, **kw)
    with torch.no_grad():
        ours, olat = net([torch.as_tensor(a) for a in z], **tkw)
    assert ours.shape == (2, 3, SIZE, SIZE)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(img), **NET_TOL)
    if lat is not None:
        np.testing.assert_allclose(olat.numpy(), np.asarray(lat), **OP_TOL)


def test_generator_noise_changes_the_image(g_pair):
    """The perturbed noise weights make the noise path live, so the noise
    comparisons above are not vacuous."""
    _, net = g_pair
    z = torch.randn(2, S, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = net([z])[0]
        b = net([z], randomize_noise=True,
                generator=torch.Generator().manual_seed(1))[0]
    assert (a - b).abs().max() > 1e-2


def test_bilinear_generator_vs_jax(g_pair):
    tree, _ = g_pair
    net = StyleGAN2GeneratorBilinear(SIZE, device="cpu", **G_CFG)
    net.load_state_dict(params_from_jax(tree, net))
    z = np.random.default_rng(6).standard_normal((2, S)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    img, _ = JBilinear.apply(jax.tree.map(jnp.asarray, tree), [jnp.asarray(z)],
                             SIZE, num_style_feat=S, randomize_noise=True,
                             rng=key)
    with torch.no_grad():
        ours, _ = net([torch.as_tensor(z)],
                      noise=[_nchw(n) for n in layer_noise(key, 2)])
    np.testing.assert_allclose(_nhwc(ours), np.asarray(img), **NET_TOL)


def test_discriminator_vs_jax(d_pair):
    """B = 4: one minibatch-stddev group of 4."""
    tree, net = d_pair
    x = np.random.default_rng(9).standard_normal((4, SIZE, SIZE, 3)).astype(
        np.float32)
    ref = js.StyleGAN2Discriminator.apply(jax.tree.map(jnp.asarray, tree),
                                          jnp.asarray(x), SIZE)
    with torch.no_grad():
        ours = net(_nchw(x))
    assert ours.shape == (4, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **NET_TOL)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_params_round_trip_through_jax_converter(g_pair, d_pair, net):
    """tree -> port state dict -> the JAX package's converter -> the same
    tree, every leaf exactly."""
    tree, mod = g_pair if net == "generator" else d_pair
    conv = (js.convert_stylegan2_generator if net == "generator"
            else js.convert_stylegan2_discriminator)
    sd = {k: v.numpy() for k, v in params_from_jax(tree, mod).items()}
    back = conv(sd)
    flat_a, td_a = jax.tree.flatten(tree)
    flat_b, td_b = jax.tree.flatten(back)
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(sd) == set(mod.state_dict())   # FIR kernels stay out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan",
                                      "wgan_softplus", "hinge"])
def test_gan_loss_vs_jax(gan_type):
    x = np.random.default_rng(10).standard_normal((4, 1)).astype(
        np.float32) * 3
    ref_l = JL.GANLoss(gan_type, loss_weight=0.5)
    ours_l = TL.build_loss({"type": "GANLoss", "gan_type": gan_type,
                            "loss_weight": 0.5})
    for real in (True, False):
        for disc in (True, False):
            v, g = jax.value_and_grad(lambda a: ref_l(a, real, is_disc=disc))(
                jnp.asarray(x))
            xt = torch.as_tensor(x).requires_grad_(True)
            ov = ours_l(xt, real, is_disc=disc)
            og, = torch.autograd.grad(ov, xt)
            np.testing.assert_allclose(ov.item(), float(v), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(og.numpy(), np.asarray(g), rtol=1e-6,
                                       atol=1e-7)


def test_r1_penalty_and_gradients_vs_jax(d_pair):
    tree, net = d_pair
    real = np.random.default_rng(11).standard_normal(
        (4, SIZE, SIZE, 3)).astype(np.float32)
    v, grads = jax.value_and_grad(lambda dp: JL.r1_penalty(
        lambda r: js.StyleGAN2Discriminator.apply(dp, r, SIZE),
        jnp.asarray(real)))(jax.tree.map(jnp.asarray, tree))
    net = copy.deepcopy(net).requires_grad_(True)
    pen = TL.r1_penalty(net, _nchw(real))
    ours = param_grads(pen, net)
    np.testing.assert_allclose(pen.item(), float(v), rtol=LOSS_RTOL)
    ref = params_from_jax(jax.tree.map(np.asarray, grads), net)
    assert_leaves_close(ours, {n: ref[n] for n in ours})


def test_path_regularize_and_gradients_vs_jax(g_pair):
    """The path length over the z latents (through the mapping MLP) as one
    scalar over the batch, the JAX package's form; noise keyed as the JAX
    trainer keys it (kp for the latents and the image noise, kn for the
    layers)."""
    tree, net = g_pair
    kp, kn = jax.random.PRNGKey(12), jax.random.PRNGKey(13)
    lat = jax.random.normal(kp, (2, S))
    mpl = 0.3

    def fake_fn(gp):
        return lambda l: js.StyleGAN2Generator.apply(
            gp, [l], SIZE, num_style_feat=S, randomize_noise=True, rng=kn)[0]

    (pen, (pm, pl)), grads = jax.value_and_grad(
        lambda gp: (lambda r: (r[0], (r[1], r[2])))(JL.g_path_regularize(
            fake_fn(gp), lat, kp, mpl)), has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    img_noise = jax.random.normal(kp, (2, SIZE, SIZE, 3))
    noise = [_nchw(n) for n in layer_noise(kn, 2)]
    net = copy.deepcopy(net).requires_grad_(True)
    open_, opm, opl = TL.g_path_regularize(
        lambda l: net([l], noise=noise)[0], torch.tensor(np.asarray(lat)),
        mpl, noise=_nchw(img_noise))
    np.testing.assert_allclose(open_.item(), float(pen), rtol=LOSS_RTOL)
    np.testing.assert_allclose(opm.item(), float(pm), rtol=LOSS_RTOL)
    np.testing.assert_allclose(opl.item(), float(pl), rtol=LOSS_RTOL)
    assert float(pen) > 0 and float(pl) > 0
    ours = param_grads(open_, net)
    ref = params_from_jax(jax.tree.map(np.asarray, grads), net)
    assert_leaves_close(ours, {n: ref[n] for n in ours})


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def sg2_opt(**train):
    return {"model_type": "StyleGAN2Model", "manual_seed": 0,
            "network_g": {"out_size": SIZE, **G_CFG},
            "network_d": {"out_size": SIZE, "channel_multiplier": 1},
            "train": {"optim_g": {"lr": 2e-3}, "optim_d": {"lr": 2e-3},
                      "ema_decay": 0.999, **train}}


def jax_draws(jtr, key, b):
    """The JAX trainer's random inputs of one alternation at a reg
    iteration, rebuilt from its keys for the port (gan_train_step's draws)."""
    kd, kg, kp, kn = jax.random.split(key, 4)
    pb = max(1, b // 2)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return {
        "d_styles": [t(a) for a in jtr._mixing_noise(kd, b)],
        "g_styles": [t(a) for a in jtr._mixing_noise(kg, b)],
        "noise": [_nchw(n) for n in layer_noise(kn, b)],
        "path_latents": t(jax.random.normal(kp, (pb, S))),
        "path_layer_noise": [_nchw(n) for n in layer_noise(kn, pb)],
        "path_noise": _nchw(jax.random.normal(kp, (pb, SIZE, SIZE, 3))),
    }


def test_gan_train_step_vs_jax(g_pair, d_pair):
    """One alternation at iteration 16, where R1 (every 16) and the path
    penalty (every 4) both fire, so G and D each take two Adam steps from
    fresh optimizers: the losses, the running mean path length and every
    updated G, D and EMA leaf against the JAX trainer's.

    Both packages run it in float64. The penalties are gradient norms
    through leaky ReLUs, and in f32 one activation that rounding moves
    across zero moves them by ~1e-3 of themselves (measured at this size);
    Adam's first step with b1 = 0 moves every element by about lr whatever
    its gradient, so an element whose gradient is at f32 rounding level
    moves by +-lr in either package. Every quantity after the first update
    would then agree only by luck. In f64 both effects are some 1e9 times
    rarer; the f32 pieces are held at identical weights by the tests
    above."""
    b = 4
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), t)
    with jax.enable_x64(True):
        jtr = JTrainer(sg2_opt())
        jstate = jtr.make_state(jax.random.PRNGKey(0))
        jstate.params = f64(g_pair[0])
        jstate.opt_state = jtr.tx.init(jstate.params)
        jstate.ema_params = f64(g_pair[0])
        jtr.d_params = f64(d_pair[0])   # narrow: a tiny D
        jtr.d_opt_state = jtr.tx_d.init(jtr.d_params)
        jtr.mean_path_length = 0.25
        real = np.random.default_rng(14).standard_normal((b, SIZE, SIZE, 3))
        key = jax.random.PRNGKey(15)
        draws = jax_draws(jtr, key, b)
        assert draws["noise"][0].dtype == torch.float64
        assert 2 in (len(draws["d_styles"]), len(draws["g_styles"]))
        jstate, jlogs = jtr.gan_train_step(jstate, {"gt": jnp.asarray(real)},
                                           16, rng=key)

    tr = StyleGAN2Trainer(sg2_opt(), device="cpu")
    state = tr.make_state(copy.deepcopy(g_pair[1]).double(),
                          copy.deepcopy(d_pair[1]).double())
    tr.mean_path_length = 0.25
    g0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    d0 = {n: p.detach().clone() for n, p in tr.disc.named_parameters()}
    state, logs = tr.gan_train_step(state, {"gt": _nchw(real)}, 16,
                                    draws=draws)
    assert logs.keys() == jlogs.keys() == {"l_d", "l_d_r1", "l_g", "l_g_path"}
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], v, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(tr.mean_path_length, jtr.mean_path_length,
                               rtol=LOSS_RTOL)
    assert state.iter == 1

    # compared in the JAX layout, through the JAX package's converters,
    # which keep f64
    def deltas(new, old):
        flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(new)[0]}
        old = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_flatten_with_path(old)[0]}
        return {k: torch.as_tensor(flat[k] - np.asarray(v, np.float64))
                for k, v in old.items() if k in flat}

    def tree(sd, conv):
        return conv({k: v.detach().numpy() for k, v in sd.items()})

    gconv = js.convert_stylegan2_generator
    ours_g = deltas(tree(state.model.state_dict(), gconv), g_pair[0])
    assert len(ours_g) == len(jax.tree.leaves(g_pair[0]))
    assert_leaves_close(ours_g, deltas(jstate.params, g_pair[0]))
    assert_leaves_close(
        deltas(tree(tr.disc.state_dict(),
                    js.convert_stylegan2_discriminator), d_pair[0]),
        deltas(jtr.d_params, d_pair[0]))
    ours_e = deltas(tree(state.ema, gconv), g_pair[0])
    assert_leaves_close(ours_e, {k: v for k, v in deltas(
        jstate.ema_params, g_pair[0]).items() if k in ours_e})
    assert all(not torch.equal(p.detach(), g0[n])
               for n, p in state.model.named_parameters())


def test_trainer_options_and_extra_state():
    with pytest.raises(ValueError, match="accumulate_steps"):
        StyleGAN2Trainer(sg2_opt(accumulate_steps=2), device="cpu")
    with pytest.raises(ValueError, match="mixed_precision"):
        StyleGAN2Trainer(sg2_opt(mixed_precision=True), device="cpu")
    tr = build_model(sg2_opt())
    assert isinstance(tr, StyleGAN2Trainer) and tr.device.type == "cuda"
    assert tr.current_lr(0) == pytest.approx(2e-3 * 4 / 5)
    assert tr.cri_gan.gan_type == "wgan_softplus"
    # the ratio'd Adam of JAX's make_optimizer / make_state
    tr = StyleGAN2Trainer(sg2_opt(), device="cpu")
    state = tr.make_state(disc=ts.StyleGAN2Discriminator(SIZE, device="cpu",
                                                         **D_CFG))
    for opt, every in ((state.optimizer, 4), (tr.d_optimizer, 16)):
        r = every / (every + 1)
        assert opt.defaults["lr"] == pytest.approx(2e-3 * r)
        assert opt.defaults["betas"] == (0.0, pytest.approx(0.99 ** r))
    K.reset_launch_counts()
    batch = {"gt": torch.randn(2, 3, SIZE, SIZE)}
    state, logs = tr.train_step(state, batch)
    assert state.iter == 1 and set(logs) == {"l_d", "l_g"}
    assert all(np.isfinite(v) for v in logs.values())
    assert K.LAUNCHES["fused_bias_lrelu"] == 0   # CPU: the plain version
    # in-memory extra state carries D, its optimizer and the path length
    tr.mean_path_length = 0.25
    extra = copy.deepcopy(tr.extra_state())
    tr2 = StyleGAN2Trainer(sg2_opt(), device="cpu")
    tr2.make_state(disc=ts.StyleGAN2Discriminator(SIZE, device="cpu", **D_CFG))
    tr2.load_extra_state(extra)
    assert tr2.mean_path_length == 0.25
    for (n, a), b in zip(tr.disc.state_dict().items(),
                         tr2.disc.state_dict().values()):
        assert torch.equal(a, b), n
    assert tr2.d_optimizer.state_dict()["state"].keys() == \
        tr.d_optimizer.state_dict()["state"].keys()
    # draws are a function of (manual_seed, iteration)
    d1 = tr.draw(4, 2, state.model)
    d2 = tr.draw(4, 2, state.model)
    assert torch.equal(d1["path_noise"], d2["path_noise"])
    assert "path_latents" not in tr.draw(3, 2, state.model)
