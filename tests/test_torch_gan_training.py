"""KEEP stage III in the port (KEEPGANTrainer with Discriminator3D) against
the JAX package's KEEPGANTrainer, on the CPU in f32, and the options
chip_smoke.py drives it with.

One alternation from the same G and D weights (JAX trees, the KEEP one
perturbed so that the zero-initialised CFT/CFA/temporal blocks are live,
carried into the port by params_from_jax) and the same batch: the loss
terms within 1e-4 relative; the updated generator, its EMA and the updated
discriminator within 1e-5 of each leaf's largest magnitude; the port's D
advances its spectral-norm u at each training forward, and JAX's D is fed
the u the port's held before each of its calls. The code picks
are argmaxes / argmins: their top-1/top-2 margins are asserted first, far
above the numeric error, so no pick flips between the packages. G and D
take SGD here (optim_g / optim_d), whose update is linear in the gradient,
so a gradient difference of f32 summation order stays one in the weights;
Adam's first step is lr * sign(g), where a gradient element near zero can
take either sign in either package (Adam itself is held to optax in
tests/test_torch_train_state.py).
"""
import copy
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import keep as jkeep
from comfyui_keep_tpu.models import vqgan as jvq
from comfyui_keep_tpu.training.trainers import \
    KEEPGANTrainer as JKEEPGANTrainer
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.models.vqgan import Discriminator3D, VQHQEncoder
from comfyui_keep_torch.training.trainers import KEEPGANTrainer, build_model
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.torch_port_helpers import (SpectralUFeed, power_iterations,
                                      pyyaml_opt, same_values)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, PARAM_RTOL = 1e-4, 1e-5
LOGIT_MARGIN, DIST_MARGIN = 1e-4, 1e-5   # relative top-1/top-2 gaps

TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=("32",))
HQ = {k: TINY[k] for k in ("img_size", "nf", "ch_mult", "res_blocks",
                           "attn_resolutions", "codebook_size", "emb_dim")}
D_ARGS = {"nf": 8}


def gan_opt(**train):
    return {"model_type": "KEEPGANModel", "manual_seed": 0,
            "network_g": {"type": "KEEP", **TINY,
                          "fix_modules": ["quantize", "generator"]},
            "network_d": {"type": "Discriminator3D", "args": D_ARGS},
            "train": {"use_hq_feat_loss": True, "feat_loss_weight": 1.0,
                      "cross_entropy_loss": True, "entropy_loss_weight": 0.5,
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "temporal_opt": {"type": "L1Loss", "loss_weight": 0.1},
                      "temporal_warp_type": "GT",
                      "gan_opt": {"type": "GANLoss", "gan_type": "hinge",
                                  "loss_weight": 1e-2},
                      "net_d_iters": 1, "net_d_start_iter": 0,
                      "optim_g": {"type": "SGD", "lr": 1e-2},
                      "optim_d": {"type": "SGD", "lr": 1e-2},
                      "ema_decay": 0.995, **train}}


def rel_margin(x, smallest=False):
    x = np.asarray(x, np.float64)
    s = np.sort(x if smallest else -x, axis=-1)
    return (s[..., 1] - s[..., 0]).min() / np.abs(x).max()


@pytest.fixture(scope="module")
def setup():
    """JAX trees of KEEP (perturbed), the VQHQEncoder (codebook at the
    latents' scale) and Discriminator3D (nf 8); the port's modules on them;
    one batch, a 64x64 clip of 3 frames."""
    rng = np.random.default_rng(34)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(
            np.shape(a)).astype(np.float32),
        jkeep.KEEP.init(jax.random.PRNGKey(0), **TINY))
    hq_tree = jax.tree.map(np.asarray,
                           jvq.VQHQEncoder.init(jax.random.PRNGKey(3), **HQ))
    hq_tree["quantize"]["embedding"] = (0.5 * np.random.default_rng(4)
                                        .standard_normal((64, 32))
                                        .astype(np.float32))
    d_tree = jax.tree.map(np.asarray, jvq.Discriminator3D.init(
        jax.random.PRNGKey(5), **D_ARGS))
    net = KEEP(device="cpu", **TINY)
    net.load_state_dict(params_from_jax(tree, net))
    hq = VQHQEncoder(device="cpu", **HQ)
    hq.load_state_dict(params_from_jax(hq_tree, hq))
    disc = Discriminator3D(device="cpu", **D_ARGS)
    disc.load_state_dict(params_from_jax(d_tree, disc))
    rng = np.random.default_rng(9)
    batch = {k: rng.random((1, 3, 64, 64, 3), np.float32) * 2 - 1
             for k in ("lq", "gt")}
    return {"tree": tree, "hq_tree": hq_tree, "d_tree": d_tree, "net": net,
            "hq": hq, "disc": disc, "batch": batch}


def port_trainer(setup, **train):
    tr = KEEPGANTrainer(gan_opt(**train), hq_vqgan=copy.deepcopy(setup["hq"]),
                        device="cpu")
    state = tr.make_state(copy.deepcopy(setup["net"]),
                          disc=copy.deepcopy(setup["disc"]))
    return tr, state


def tbatch(setup):
    return {k: torch.as_tensor(v) for k, v in setup["batch"].items()}


def assert_leaves_close(ours, ref, what):
    assert ours.keys() == ref.keys(), what
    for k, r in ref.items():
        r = torch.as_tensor(np.asarray(r))
        err = (ours[k].detach() - r).abs().max().item()
        assert err <= PARAM_RTOL * r.abs().max().item() + 1e-12, \
            f"{what} {k}: max|d| {err} against max|ref| {r.abs().max()}"


def test_keep_gan_alternation_vs_jax(setup):
    """Iteration 1 of the alternation in both packages: G's step with the
    hinge GAN term (D frozen for it), the EMA, then D's step on (gt,
    restored). The port's D advances its spectral-norm u at each of its
    three training forwards (torch's spectral_norm; the JAX package keeps
    u): JAX's D is fed, at each call, the u the port's held before the
    same call (SpectralUFeed), and the port's u after each call is the
    float64 power iteration's from the weights and the initial u (within
    1e-5)."""
    tr, state = port_trainer(setup)
    feed = SpectralUFeed(jvq.Discriminator3D, setup["d_tree"], tr.disc)
    batch = tbatch(setup)
    with torch.no_grad():
        _, aux = state.model.apply(batch["lq"], flows=tr._flows(batch["lq"]),
                                   return_aux=True)
        gt = batch["gt"].reshape(-1, 64, 64, 3)
        z = tr.hq_vqgan.encode(gt)
        from comfyui_keep_torch.models.vqgan import vq_indices
        _, dist = vq_indices(tr.hq_vqgan.quantize.embedding.weight, z)
    assert rel_margin(aux["logits"].numpy()) > LOGIT_MARGIN
    assert rel_margin(dist.numpy(), smallest=True) > DIST_MARGIN

    d_before = copy.deepcopy(tr.disc.state_dict())
    state, logs = tr.gan_train_step(state, batch, current_iter=1)

    jtr = JKEEPGANTrainer(gan_opt(), hq_vqgan_params=jax.tree.map(
        jnp.asarray, setup["hq_tree"]))
    jstate = jtr.make_state(jax.random.PRNGKey(0))
    jstate.params = jax.tree.map(jnp.asarray, setup["tree"])
    jstate.opt_state = jtr.tx.init(jstate.params)
    jstate.ema_params = jstate.params
    jtr.d_params = jax.tree.map(jnp.asarray, setup["d_tree"])
    jtr.d_opt_state = jtr.tx_d.init(jtr.d_params)
    jtr.disc = feed
    jstate, logs_j = jtr.gan_train_step(
        jstate, {k: jnp.asarray(v) for k, v in setup["batch"].items()},
        current_iter=1)
    assert len(feed.seen) == feed.calls == 3
    # JAX's l_total is the sum before the GAN term; the port's the whole
    # generator objective
    logs_j["l_total"] += logs_j["l_g_gan"]
    assert logs.keys() == logs_j.keys()
    for k, v in logs_j.items():
        assert abs(logs[k] - v) <= LOSS_RTOL * abs(v), (k, logs[k], v)

    g_ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                            state.model)
    params = dict(state.model.named_parameters())
    assert_leaves_close(params, {n: g_ref[n] for n in params}, "G")
    ema_ref = params_from_jax(jax.tree.map(np.asarray, jstate.ema_params),
                              state.model)
    assert_leaves_close(state.ema, {n: ema_ref[n] for n in state.ema}, "EMA")
    # D's weights; its u and v are the port's own, held below (JAX keeps
    # the tree's u, and params_from_jax derives v from it)
    d_ref = {k: v for k, v in params_from_jax(
        jax.tree.map(np.asarray, jtr.d_params), tr.disc).items()
        if not k.endswith(("weight_u", "weight_v"))}
    assert_leaves_close({k: v for k, v in tr.disc.state_dict().items()
                         if k in d_ref}, d_ref, "D")
    # the updates are large against the tolerance, and u advanced
    for n in ("feat_emb.weight", "encoder.blocks.0.weight"):
        moved = (params[n] - setup["net"].get_parameter(n)).abs().max()
        assert moved > 30 * PARAM_RTOL * params[n].abs().max(), n
    sd = tr.disc.state_dict()
    for k, v in d_before.items():
        if k.endswith(("weight_u", "weight_orig")):
            assert not torch.equal(sd[k], v), k
        if k.endswith("weight_u"):
            w = d_before[k.replace("weight_u", "weight_orig")]
            want = power_iterations(w.numpy(), v.numpy(), 3)
            got = [u[k] for u in feed.seen[1:]] + [sd[k].numpy()]
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_net_d_start_iter_gates_the_gan_terms(setup):
    """Before net_d_start_iter neither l_g_gan nor D's step runs (D's
    weights and optimizer untouched); from it on both do, with D's LR the
    schedule's at D's own update count."""
    tr, state = port_trainer(
        setup, net_d_start_iter=2, optim_d={"type": "Adam", "lr": 1e-3},
        scheduler={"type": "MultiStepLR", "milestones": [1], "gamma": 0.5})
    batch = tbatch(setup)
    d0 = copy.deepcopy(tr.disc.state_dict())
    state, logs = tr.train_step(state, batch)        # iteration 1
    assert "l_g_gan" not in logs and "l_d" not in logs
    assert all(torch.equal(v, d0[k]) for k, v in tr.disc.state_dict().items())
    assert not tr.d_optimizer.state
    assert tr.d_lr(2) == 1e-3 and tr.d_lr(3) == 5e-4
    state, logs = tr.train_step(state, batch)        # iteration 2
    assert {"l_g_gan", "l_d", "l_d_real", "l_d_fake"} <= logs.keys()
    assert logs["l_d"] == pytest.approx(logs["l_d_real"] + logs["l_d_fake"])
    assert tr.d_optimizer.param_groups[0]["lr"] == 1e-3
    assert not torch.equal(tr.disc.conv[0].weight_orig, d0["conv.0.weight_orig"])
    assert state.iter == 2


def test_extra_state_round_trip(setup):
    """extra_state carries D (its weight_u buffers too) and D's optimizer
    into a fresh trainer; the optimizer holds no weight_u."""
    tr, state = port_trainer(setup, optim_d={"type": "Adam", "lr": 1e-3})
    state, _ = tr.train_step(state, tbatch(setup))
    extra = copy.deepcopy(tr.extra_state())
    assert any(k.endswith("weight_u") for k in extra["d_params"])
    held = {id(p) for g in tr.d_optimizer.param_groups for p in g["params"]}
    assert not any(id(b) in held for b in tr.disc.buffers())

    fresh = KEEPGANTrainer({**gan_opt(optim_d={"type": "Adam", "lr": 1e-3}),
                            "manual_seed": 5},
                           hq_vqgan=copy.deepcopy(setup["hq"]), device="cpu")
    fresh.make_state()
    assert not torch.equal(fresh.disc.conv[0].weight_orig,
                           tr.disc.conv[0].weight_orig)
    fresh.load_extra_state(extra)
    for k, v in tr.disc.state_dict().items():
        assert torch.equal(fresh.disc.state_dict()[k], v), k
    a, b = tr.d_optimizer.state_dict(), fresh.d_optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)
    fresh.load_extra_state(None)      # a state without D: warned, kept


def test_build_model_names_keep_gan():
    opt = gan_opt()
    opt["train"] = {"gan_opt": opt["train"]["gan_opt"]}
    tr = build_model(opt)
    assert isinstance(tr, KEEPGANTrainer) and tr.device.type == "cuda"
    with pytest.raises(KeyError):    # every JAX model type is built now
        build_model({"model_type": "NoSuchModel"})


def test_chip_smoke_stage3_opt_matches_the_yml():
    """chip_smoke.py reads options/train_keep_stage3_gan.yml with the port's
    YAML reader (the card machine has no pyyaml) and applies its one
    departure, the dataset's `scale: 1`, as --force_yml applies it (the yml
    sets none, and the dataset's default of 4 gives KEEP's 512 net a 128^2
    LQ clip, which JAX refuses and the port's trainers upscale): the result
    equals pyyaml's load
    of the yml with the same departure, value for value, type for type, in
    order."""
    sys.path.insert(0, REPO)
    import chip_smoke
    assert chip_smoke.STAGE3_FORCE == ("datasets:train:scale=1",)
    path = os.path.join(REPO, "options", "train_keep_stage3_gan.yml")
    ours = chip_smoke.stage3_opt()
    assert same_values(ours, pyyaml_opt(path, chip_smoke.STAGE3_FORCE))
    assert ours["datasets"]["train"].pop("scale") == 1
    assert same_values(ours, pyyaml_opt(path))
    assert ours["train"]["gan_opt"]["loss_weight"] == 1e-2
    assert type(ours["logger"]["save_checkpoint_freq"]) is float


def test_perceptual_term_in_the_generator_loss(setup):
    """perceptual_opt adds l_percep and l_style to the generator's
    objective: PerceptualLoss on the restored and GT frames as NCHW
    (B*T, 3, H, W), the features from the feature_fn the trainer is
    given."""
    from comfyui_keep_torch.models.vgg import VGGFeatureExtractor
    from comfyui_keep_torch.training.losses import PerceptualLoss
    vgg = VGGFeatureExtractor(("relu1_1",), device="cpu",
                              generator=torch.Generator().manual_seed(3))
    percep = {"type": "PerceptualLoss", "style_weight": 0.5,
              "layer_weights": {"relu1_2": 1.0, "relu2_2": 0.5}}
    tr = KEEPGANTrainer(gan_opt(perceptual_opt=percep),
                        hq_vqgan=copy.deepcopy(setup["hq"]), device="cpu",
                        feature_fn=vgg)
    state = tr.make_state(copy.deepcopy(setup["net"]),
                          disc=copy.deepcopy(setup["disc"]))
    batch = tbatch(setup)
    with torch.no_grad():
        total, logs, outs = tr._loss_outs(state.model, batch)
        ref = PerceptualLoss(percep["layer_weights"], vgg, style_weight=0.5)(
            outs.reshape(-1, 64, 64, 3).permute(0, 3, 1, 2),
            batch["gt"].reshape(-1, 64, 64, 3).permute(0, 3, 1, 2))
    assert torch.equal(logs["l_percep"], ref[0])
    assert torch.equal(logs["l_style"], ref[1])
    assert torch.allclose(total, sum(logs.values()), rtol=1e-6)
