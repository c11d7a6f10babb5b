"""KEEP's stage-II training step in the PyTorch port against the JAX package,
on the CPU in f32 (bf16 where the dtype is the point).

Both packages run one set of weights: JAX param trees (perturbed so that
the zero-initialised CFT/CFA/temporal blocks are live) carried into the
port by params_from_jax, and batches made with numpy. The code picks of
the step are argmaxes and argmins, so each comparison first asserts that
their top-1/top-2 margins exceed the numeric error by far. Tolerances:
loss terms 1e-4 relative; per-leaf gradients 2e-3 * max|g_ref| + 1e-7
(f32 summation order through a deep network); optimizer, schedule and EMA
arithmetic 1e-6; mixed precision tracks f32 within 2 % (bf16 resolution),
and JAX's mixed precision as set out at MP_GRAD_RATIO.
"""
import copy
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import yaml

from comfyui_keep_tpu.models import gmflow as jgm
from comfyui_keep_tpu.models import keep as jkeep
from comfyui_keep_tpu.models import vqgan as jvq
from comfyui_keep_tpu.ops import warp as jwarp
from comfyui_keep_tpu.training import losses as JL
from comfyui_keep_tpu.training import schedulers as JS
from comfyui_keep_tpu.training import state as JST
from comfyui_keep_tpu.training.trainers import KEEPTrainer as JKEEPTrainer
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict, embedding_rule
from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.models.keep import KEEP, count_parameters, mask_by_ratio
from comfyui_keep_torch.models.vqgan import (VQHQEncoder, VectorQuantizer,
                                             vq_indices, vq_quantize)
from comfyui_keep_torch.ops import flow_warp, resize_flow
from comfyui_keep_torch.ops import kernels as K
from comfyui_keep_torch.training import losses as TL
from comfyui_keep_torch.training import schedulers as TS
from comfyui_keep_torch.training.state import (build_optimizer, ema_init,
                                               ema_update)
from comfyui_keep_torch.training.trainers import (BaseTrainer, KEEPTrainer,
                                                  build_model)
from comfyui_keep_torch.utils.convert import params_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-3, 1e-7
LOGIT_MARGIN, DIST_MARGIN = 1e-4, 1e-5   # relative top-1/top-2 gaps
# bf16 mixed precision, port against JAX: bf16 rounding moves a weak leaf's
# gradient as far as its own size (about 20 % of the whole gradient in L2,
# in both packages alike) and a small loss term by a few %, so each loss
# term, and each leaf's gradient in L2, is held to 3x the distance of JAX's
# bf16 value from its f32 one, plus 2 % of the term or the f32 gradient
# tolerance
MP_LOSS_RTOL, MP_GRAD_RATIO = 2e-2, 3.0

TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=("32",))
HQ = {k: TINY[k] for k in ("img_size", "nf", "ch_mult", "res_blocks",
                           "attn_resolutions", "codebook_size", "emb_dim")}


def perturbed(tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def rel_margin(x, smallest=False):
    """Least top-1/top-2 gap along the last axis, relative to max|x|."""
    x = np.asarray(x, np.float64)
    s = np.sort(x if smallest else -x, axis=-1)
    return (s[..., 1] - s[..., 0]).min() / np.abs(x).max()


def opt_dict(**train):
    return {"model_type": "KEEPModel", "manual_seed": 0,
            "network_g": {"type": "KEEP", **TINY,
                          "fix_modules": ["quantize", "generator"]},
            "train": {"use_hq_feat_loss": True, "feat_loss_weight": 1.0,
                      "cross_entropy_loss": True, "entropy_loss_weight": 0.5,
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "temporal_opt": {"type": "L1Loss", "loss_weight": 0.1},
                      "temporal_warp_type": "GT",
                      "optim_g": {"type": "Adam", "lr": 1e-3},
                      "ema_decay": 0.99, **train}}


# ---------------------------------------------------------------------------
# vqgan: vq_indices, vq_quantize, VQHQEncoder
# ---------------------------------------------------------------------------

def test_vq_indices_and_quantize_vs_jax():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    cb = rng.standard_normal((64, 16)).astype(np.float32)
    idx_j, d_j = jvq.vq_indices({"embedding": jnp.asarray(cb)},
                                jnp.asarray(z))
    assert rel_margin(np.asarray(d_j), smallest=True) > DIST_MARGIN
    idx, d = vq_indices(torch.as_tensor(cb), torch.as_tensor(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-5,
                               rtol=1e-5)

    w = rng.standard_normal(z.shape).astype(np.float32)

    def jfn(cb_, z_):
        zq, loss, stats = jvq.vq_quantize({"embedding": cb_}, z_)
        return loss + jnp.sum(zq * w), (zq, loss, stats)

    (_, (zq_j, loss_j, st_j)), (gcb_j, gz_j) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(cb), jnp.asarray(z))
    vq = VectorQuantizer(64, 16)
    with torch.no_grad():
        vq.embedding.weight.copy_(torch.as_tensor(cb))
    zt = torch.as_tensor(z).requires_grad_()
    zq, loss, st = vq_quantize(vq, zt)
    (loss + (zq * torch.as_tensor(w)).sum()).backward()
    np.testing.assert_allclose(zq.detach().numpy(), np.asarray(zq_j),
                               atol=1e-6)
    for ours, ref in ((loss, loss_j), (st["perplexity"], st_j["perplexity"]),
                      (st["mean_distance"], st_j["mean_distance"])):
        np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    np.testing.assert_array_equal(st["min_encoding_indices"].numpy(),
                                  np.asarray(st_j["min_encoding_indices"]))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz_j), atol=1e-6)
    np.testing.assert_allclose(vq.embedding.weight.grad.numpy(),
                               np.asarray(gcb_j), atol=1e-6)


@pytest.fixture(scope="module")
def hq_pair():
    """A tiny VQHQEncoder: JAX tree (codebook drawn at the latents' scale, so
    the ground-truth picks have clear margins) and the port module."""
    tree = jax.tree.map(np.asarray,
                        jvq.VQHQEncoder.init(jax.random.PRNGKey(3), **HQ))
    tree["quantize"]["embedding"] = (0.5 * np.random.default_rng(4)
                                     .standard_normal((64, 32))
                                     .astype(np.float32))
    net = VQHQEncoder(device="cpu", **HQ)
    net.load_state_dict(params_from_jax(tree, net))
    return tree, net


def test_vqhq_params_round_trip_through_jax_converter(hq_pair):
    """tree -> params_from_jax -> state dict -> the JAX package's
    convert_state_dict with its codebook rule -> the same tree."""
    tree, net = hq_pair
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = convert_state_dict(sd, rules=[embedding_rule(
        "quantize.embedding", ("quantize", "embedding"))])
    a = jax.tree_util.tree_flatten_with_path(tree)[0]
    b = dict((jax.tree_util.keystr(p), v) for p, v in
             jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(a) == len(b)
    for p, v in a:
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(b[jax.tree_util.keystr(p)]))


def test_vqhq_encoder_vs_jax(hq_pair):
    tree, net = hq_pair
    x = np.random.default_rng(4).random((3, 64, 64, 3), np.float32) * 2 - 1
    z_j, loss_j, st_j = jvq.VQHQEncoder.apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), **HQ)
    _, d_j = jvq.vq_indices(tree["quantize"], z_j)
    assert rel_margin(np.asarray(d_j), smallest=True) > DIST_MARGIN
    with torch.no_grad():
        z, loss, st = net.apply(torch.as_tensor(x))
        idx = net.indices(torch.as_tensor(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    picks = np.asarray(st_j["min_encoding_indices"])
    np.testing.assert_array_equal(st["min_encoding_indices"].numpy(), picks)
    np.testing.assert_array_equal(idx.numpy(), picks.reshape(3, -1))
    assert idx.dtype == torch.int32


# ---------------------------------------------------------------------------
# warp, losses, schedulers, optimizers, EMA
# ---------------------------------------------------------------------------

def test_flow_warp_and_resize_flow_vs_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 20, 6)).astype(np.float32)
    flow = (rng.standard_normal((2, 16, 20, 2)) * 3).astype(np.float32)
    ref = jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow))
    ours = flow_warp(torch.as_tensor(x).permute(0, 3, 1, 2),
                     torch.as_tensor(flow))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=1e-5)
    big = (rng.standard_normal((3, 64, 48, 2)) * 5).astype(np.float32)
    for hw in ((8, 6), (32, 32), (64, 48)):
        np.testing.assert_allclose(
            resize_flow(torch.as_tensor(big), hw).numpy(),
            np.asarray(jwarp.resize_flow(jnp.asarray(big), hw)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "CharbonnierLoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_pixel_losses_vs_jax(name, reduction):
    rng = np.random.default_rng(6)
    a, b, w = (rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
               for _ in range(3))
    opt = {"type": name, "loss_weight": 0.7, "reduction": reduction}
    ours, ref = TL.build_loss(opt), JL.build_loss(opt)
    for weight in (None, w):
        np.testing.assert_allclose(
            ours(torch.as_tensor(a), torch.as_tensor(b),
                 None if weight is None else torch.as_tensor(weight)).item(),
            float(ref(jnp.asarray(a), jnp.asarray(b),
                      None if weight is None else jnp.asarray(weight))),
            rtol=1e-5)
    with pytest.raises(NotImplementedError):
        TL.build_loss({"type": "PerceptualLoss"})


def test_schedulers_vs_jax():
    cases = [
        {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
        {"type": "MultiStepRestartLR", "milestones": [3, 6, 9], "gamma": 0.5,
         "restarts": [8, 4], "restart_weights": [0.7, 0.9]},
        {"type": "CosineAnnealingRestartLR", "periods": [4, 6],
         "restart_weights": [1, 0.5], "eta_min": 0.2, "base_lr": 2.0},
    ]
    for opt in cases:
        for warm in (-1, 3):
            ours = TS.with_warmup(TS.build_scheduler(opt), warm)
            ref = JS.with_warmup(JS.build_scheduler(opt), warm)
            for step in list(range(14)) + [399999, 400000, 400001]:
                np.testing.assert_allclose(ours(step), float(ref(step)),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=f"{opt} step {step}")


@pytest.mark.parametrize("optim", [
    {"type": "Adam", "lr": 1e-2},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.1, "betas": (0.8, 0.99)},
    {"type": "AdamW", "lr": 1e-2, "weight_decay": 0.1}])
def test_optimizers_and_ema_vs_optax(optim):
    """Five updates on fixed gradients with a decaying schedule (the LR set
    on the param group as base * schedule(step)), and the EMA after each."""
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(5)]
    sched = TS.build_scheduler({"type": "MultiStepLR", "milestones": [2, 4],
                                "gamma": 0.5})
    tx = JST.build_optimizer(optim, schedule=JS.build_scheduler(
        {"type": "MultiStepLR", "milestones": [2, 4], "gamma": 0.5}))
    pj, state, ej = jnp.asarray(p0), None, jnp.asarray(p0)
    state = tx.init(pj)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = build_optimizer(optim, [model.w])
    ema = ema_init(model)
    for step, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        ej = JST.ema_update(ej, pj, 0.9)
        opt.param_groups[0]["lr"] = optim["lr"] * sched(step)
        model.w.grad = torch.as_tensor(g)
        opt.step()
        ema_update(ema, model, 0.9)
        np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(pj),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ema["w"].numpy(), np.asarray(ej),
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        build_optimizer({"type": "SGD"}, [model.w])


class _Toy(BaseTrainer):
    """A trainer whose loss is sum(p * g) for a gradient g in the batch, so
    each micro-step's gradient is exactly g; `frozen` is fix_modules'."""

    def init_model(self):
        m = torch.nn.Module()
        m.live = torch.nn.Parameter(torch.zeros(3, 4))
        m.frozen = torch.nn.Parameter(torch.ones(4))
        return m

    def loss_fn(self, model, batch):
        total = (model.live * batch["g"]).sum() + model.frozen.sum()
        return total, {"l": total}


def test_accumulate_steps_vs_optax_multisteps():
    """accumulate_steps=2: gradients averaged over 2 micro-steps, Adam's
    count and the schedule advance once per 2, the EMA on every micro-step
    (optax.MultiSteps inside the JAX package's trainer)."""
    rng = np.random.default_rng(8)
    opt = {"network_g": {"fix_modules": ["frozen"]},
           "train": {"optim_g": {"type": "Adam", "lr": 0.05},
                     "scheduler": {"type": "MultiStepLR", "milestones": [1],
                                   "gamma": 0.5},
                     "accumulate_steps": 2, "ema_decay": 0.9}}
    tr = _Toy(opt, device="cpu")
    state = tr.make_state()
    jtx = optax.MultiSteps(JST.build_optimizer(
        opt["train"]["optim_g"], schedule=JS.build_scheduler(
            opt["train"]["scheduler"])), every_k_schedule=2)
    pj = jnp.zeros((3, 4))
    jstate, ej = jtx.init(pj), pj
    for step in range(6):
        g = rng.standard_normal((3, 4)).astype(np.float32)
        upd, jstate = jtx.update(jnp.asarray(g), jstate, pj)
        pj = optax.apply_updates(pj, upd)
        ej = JST.ema_update(ej, pj, 0.9)
        state, _ = tr.train_step(state, {"g": torch.as_tensor(g)})
        np.testing.assert_allclose(state.model.live.detach().numpy(),
                                   np.asarray(pj), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(state.ema["live"].numpy(), np.asarray(ej),
                                   atol=1e-6, rtol=1e-6)
        assert torch.equal(state.model.frozen.detach(), torch.ones(4))
        assert tr.current_lr(step) == 0.05 * (0.5 if step >= 2 else 1.0)
    assert state.iter == 6 and state.optimizer.state[
        state.model.live]["step"] == 3


# ---------------------------------------------------------------------------
# KEEP: mask_by_ratio, count_parameters, the full trainer step
# ---------------------------------------------------------------------------

def test_count_parameters_and_mask_by_ratio():
    tree = jkeep.KEEP.init(jax.random.PRNGKey(0), **TINY)
    assert count_parameters(KEEP(device="cpu", **TINY)) == \
        jkeep.count_parameters(tree)
    z = torch.randn(2, 3, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    assert mask_by_ratio(z, 0.0) is z
    out = mask_by_ratio(z, 0.25, torch.Generator().manual_seed(1))
    kept = (out != 0).all(-1).reshape(2, 3, 16)
    assert (kept.sum(-1) == 12).all()          # int(16 * 0.75) per frame
    assert torch.equal(out[kept.reshape(2, 3, 4, 4)],
                       z[kept.reshape(2, 3, 4, 4)])
    ref = jkeep.mask_by_ratio(jax.random.PRNGKey(1), jnp.asarray(z.numpy()),
                              0.25)
    assert (np.asarray(ref != 0).all(-1).reshape(2, 3, 16).sum(-1) == 12).all()


@pytest.fixture(scope="module")
def keep_setup(hq_pair):
    """JAX trees of KEEP (perturbed) and a 2-layer GMFlow, the port's
    modules on the same weights, and a 64x64 clip of 3 frames."""
    hq_tree, hq = hq_pair
    tree = perturbed(jkeep.KEEP.init(jax.random.PRNGKey(0), **TINY), 34)
    gm_tree = jax.tree.map(np.asarray, jgm.GMFlow.init(jax.random.PRNGKey(1),
                                                       num_layers=2))
    net = KEEP(device="cpu", **TINY)
    net.load_state_dict(params_from_jax(tree, net))
    gm = GMFlow(num_layers=2, device="cpu")
    gm.load_state_dict(params_from_jax(gm_tree, gm))
    rng = np.random.default_rng(9)
    batches = [{k: rng.random((1, 3, 64, 64, 3), np.float32) * 2 - 1
                for k in ("lq", "gt")} for _ in range(2)]
    return {"tree": tree, "net": net, "hq_tree": hq_tree, "hq": hq,
            "gm_tree": gm_tree, "gm": gm, "batches": batches}


_JAX_GRADS = {}


def jax_loss_and_grads(setup, with_gmflow, i):
    """JAX KEEPTrainer.loss_fn and its gradient on batch i, jitted (one
    compile per flow setting; cached)."""
    if with_gmflow not in _JAX_GRADS:
        jtr = JKEEPTrainer(opt_dict(), hq_vqgan_params=jax.tree.map(
            jnp.asarray, setup["hq_tree"]), gmflow_params=jax.tree.map(
            jnp.asarray, setup["gm_tree"]) if with_gmflow else None)
        _JAX_GRADS[with_gmflow] = {"fn": jax.jit(jax.value_and_grad(
            jtr.loss_fn, has_aux=True))}
    cache = _JAX_GRADS[with_gmflow]
    if i not in cache:
        batch = {k: jnp.asarray(v) for k, v in setup["batches"][i].items()}
        (_, logs), grads = cache["fn"](
            jax.tree.map(jnp.asarray, setup["tree"]), batch,
            jax.random.PRNGKey(0))
        cache[i] = ({k: float(v) for k, v in logs.items()},
                    params_from_jax(jax.tree.map(np.asarray, grads),
                                    setup["net"]))
    return cache[i]


def logit_margin(tr, state, batch):
    """rel_margin of the code logits of a no-grad forward on batch["lq"]."""
    with torch.no_grad():
        _, aux = state.model.apply(batch["lq"], flows=tr._flows(batch["lq"]),
                                   return_aux=True)
    return rel_margin(aux["logits"].numpy())


def port_trainer(setup, with_gmflow, **train):
    tr = KEEPTrainer(opt_dict(**train), hq_vqgan=copy.deepcopy(setup["hq"]),
                     gmflow=copy.deepcopy(setup["gm"]) if with_gmflow
                     else None, device="cpu")
    return tr, tr.make_state(copy.deepcopy(setup["net"]))


def _batch(setup, i):
    return {k: torch.as_tensor(v) for k, v in setup["batches"][i].items()}


def assert_grads_match(grads, ref):
    assert grads.keys() == ref.keys()
    for n, g in grads.items():
        r = ref[n]
        err = (g - r).abs().max().item()
        assert err <= GRAD_RTOL * r.abs().max().item() + GRAD_ATOL, \
            f"{n}: max|d| {err} against max|g_ref| {r.abs().max().item()}"


@pytest.mark.parametrize("with_gmflow", [False, True])
def test_keep_train_step_vs_jax(keep_setup, with_gmflow):
    """Loss terms and per-leaf gradients of one step against JAX's
    loss_fn/jax.grad; then the port's update leaves the frozen leaves
    bitwise unchanged and moves the trainable ones."""
    logs_j, grads_j = jax_loss_and_grads(keep_setup, with_gmflow, 0)
    z_j = jvq.blocks_apply(
        keep_setup["hq_tree"]["encoder"], jvq.VQAutoEncoder.make_plans(**HQ)[0],
        jnp.asarray(keep_setup["batches"][0]["gt"].reshape(3, 64, 64, 3)))
    _, d_j = jvq.vq_indices(keep_setup["hq_tree"]["quantize"], z_j)
    assert rel_margin(np.asarray(d_j), smallest=True) > DIST_MARGIN

    tr, state = port_trainer(keep_setup, with_gmflow)
    assert logit_margin(tr, state, _batch(keep_setup, 0)) > LOGIT_MARGIN
    K.reset_launch_counts()
    logs = tr.backward(state, _batch(keep_setup, 0))
    assert set(K.LAUNCHES.values()) == {0}   # CPU tensors: plain versions
    assert logs.keys() == logs_j.keys()
    for k, v in logs_j.items():
        assert abs(logs[k].item() - v) <= LOSS_RTOL * abs(v), (k, logs[k], v)
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.requires_grad}
    assert_grads_match(grads, {n: grads_j[n] for n in grads})
    frozen = {n for n, p in state.model.named_parameters()
              if not p.requires_grad}
    assert frozen and all(n.split(".")[0] in ("quantize", "generator")
                          for n in frozen)

    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    state, step_logs = tr.train_step(state, _batch(keep_setup, 0))
    assert all(np.isfinite(v) for v in step_logs.values())
    for n, p in state.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, before[n]), n
    for n in ("feat_emb.weight", "encoder.blocks.0.weight",
              "hq_encoder.blocks.0.weight", "cft.32.scale.2.weight"):
        assert not torch.equal(state.model.get_parameter(n), before[n]), n


@pytest.mark.parametrize("warp", ["HR", "Diff"])
def test_keep_temporal_warp_types_vs_jax(keep_setup, warp):
    """temporal_warp_type HR (the restored frames' flows) and Diff (the GT
    flows against those): the loss terms against JAX's loss_fn, with a
    2-layer GMFlow; also the eval forward's shape."""
    jtr = JKEEPTrainer(opt_dict(temporal_warp_type=warp),
                       hq_vqgan_params=jax.tree.map(jnp.asarray,
                                                    keep_setup["hq_tree"]),
                       gmflow_params=jax.tree.map(jnp.asarray,
                                                  keep_setup["gm_tree"]))
    _, logs_j = jax.jit(jtr.loss_fn)(
        jax.tree.map(jnp.asarray, keep_setup["tree"]),
        {k: jnp.asarray(v) for k, v in keep_setup["batches"][0].items()},
        jax.random.PRNGKey(0))
    tr, state = port_trainer(keep_setup, True, temporal_warp_type=warp)
    batch = _batch(keep_setup, 0)
    assert logit_margin(tr, state, batch) > LOGIT_MARGIN
    with torch.no_grad():
        _, logs = tr.loss_fn(state.model, batch)
        assert tr.forward(state.model, batch["lq"]).shape == (1, 3, 64, 64, 3)
    assert logs.keys() == set(logs_j) - {"l_total"}
    for k, v in logs.items():
        ref = float(logs_j[k])
        assert abs(v.item() - ref) <= LOSS_RTOL * abs(ref) + 1e-7, (k, v, ref)


def test_keep_accumulate_steps_vs_jax_mean_gradient(keep_setup):
    """accumulate_steps=2: nothing moves after the first micro-step; after
    the second, Adam's first moment is (1 - b1) times the mean of the two
    micro-batches' gradients, which equals the mean of JAX's."""
    tr, state = port_trainer(keep_setup, False, accumulate_steps=2)
    for i in (0, 1):
        assert logit_margin(tr, state, _batch(keep_setup, i)) > LOGIT_MARGIN
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    state, _ = tr.train_step(state, _batch(keep_setup, 0))
    for n, p in state.model.named_parameters():
        assert torch.equal(p, before[n]), n
    ema = state.ema["feat_emb.weight"]
    torch.testing.assert_close(ema, before["feat_emb.weight"], rtol=0,
                               atol=1e-7)
    state, _ = tr.train_step(state, _batch(keep_setup, 1))
    mean_j = {n: 0.5 * (jax_loss_and_grads(keep_setup, False, 0)[1][n]
                        + jax_loss_and_grads(keep_setup, False, 1)[1][n])
              for n, p in state.model.named_parameters() if p.requires_grad}
    first = {n: state.optimizer.state[p]["exp_avg"] / 0.1 for n, p
             in state.model.named_parameters() if p.requires_grad}
    assert_grads_match(first, mean_j)
    assert all(state.optimizer.state[p]["step"] == 1
               for p in state.optimizer.param_groups[0]["params"])


def bf16_exact(v):
    return torch.tensor(v).bfloat16().float().item() == v


def spy_dtypes(tr):
    """Record the dtypes the network and the batch have inside loss_fn."""
    seen = {}
    inner = tr.loss_fn

    def loss_fn(model, batch):
        seen.update(weight=model.feat_emb.weight.dtype, lq=batch["lq"].dtype)
        return inner(model, batch)
    tr.loss_fn = loss_fn
    return seen


def test_keep_mixed_precision_step(keep_setup):
    """bf16 compute: inside the step the network's parameters and the batch
    are bf16 and the loss terms are bf16 values; masters, optimizer moments
    and EMA stay f32; the losses track the f32 step's within 2 %."""
    losses = {}
    for mp in (False, True):
        tr, state = port_trainer(keep_setup, True, mixed_precision=mp)
        seen = spy_dtypes(tr)
        state, losses[mp] = tr.train_step(state, _batch(keep_setup, 0))
        want = torch.bfloat16 if mp else torch.float32
        assert seen == {"weight": want, "lq": want}
        assert all(p.dtype == torch.float32
                   for p in state.model.parameters())
        assert all(v.dtype == torch.float32 for v in state.ema.values())
        assert all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype
                   == torch.float32 for s in state.optimizer.state.values())
    assert tr.hq_vqgan.quantize.embedding.weight.dtype == torch.bfloat16
    assert all(bf16_exact(v) for v in losses[True].values())
    assert not all(bf16_exact(v) for v in losses[False].values())
    for k, v in losses[False].items():
        np.testing.assert_allclose(losses[True][k], v, rtol=2e-2, atol=2e-3,
                                   err_msg=k)


def test_keep_mixed_precision_step_vs_jax(keep_setup):
    """bf16 mixed precision against the JAX package's, with a 2-layer
    GMFlow: its KEEPTrainer with mixed_precision runs loss_fn on bf16 casts
    of the f32 trees and batch, and jax.grad reaches the f32 masters through
    the casts. Loss terms and each leaf's f32 gradient (L2) within
    MP_GRAD_RATIO times JAX's own bf16-to-f32 distance, plus MP_LOSS_RTOL
    or the f32 gradient tolerance."""
    jtr = JKEEPTrainer(opt_dict(mixed_precision=True),
                       hq_vqgan_params=jax.tree.map(jnp.asarray,
                                                    keep_setup["hq_tree"]),
                       gmflow_params=jax.tree.map(jnp.asarray,
                                                  keep_setup["gm_tree"]))
    (_, logs_j), grads_j = jax.jit(jax.value_and_grad(
        jtr._compute_loss_fn(), has_aux=True))(
        jax.tree.map(jnp.asarray, keep_setup["tree"]),
        {k: jnp.asarray(v) for k, v in keep_setup["batches"][0].items()},
        jax.random.PRNGKey(0))
    grads_j = params_from_jax(jax.tree.map(np.asarray, grads_j),
                              keep_setup["net"])
    logs_f32, grads_f32 = jax_loss_and_grads(keep_setup, True, 0)

    tr, state = port_trainer(keep_setup, True, mixed_precision=True)
    seen = spy_dtypes(tr)
    logs = tr.backward(state, _batch(keep_setup, 0))
    assert seen == {"weight": torch.bfloat16, "lq": torch.bfloat16}
    assert logs.keys() == logs_j.keys()
    for k, v in logs_j.items():
        assert bf16_exact(logs[k].item()), k
        v = float(v)
        lim = MP_GRAD_RATIO * abs(v - logs_f32[k]) + MP_LOSS_RTOL * abs(v)
        assert abs(logs[k].item() - v) <= lim, (k, logs[k], v, lim)
    for n, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        assert p.grad.dtype == torch.float32, n
        ref, f32 = grads_j[n], grads_f32[n]
        err = (p.grad - ref).norm().item()
        lim = (MP_GRAD_RATIO * (ref - f32).norm().item()
               + GRAD_RTOL * f32.norm().item() + GRAD_ATOL)
        assert err <= lim, f"{n}: |d| {err} against {lim}"


def test_build_model_and_unported_options():
    with pytest.raises(NotImplementedError):
        build_model({"model_type": "SRModel"})
    with pytest.raises(NotImplementedError):
        KEEPTrainer(opt_dict(perceptual_opt={"type": "PerceptualLoss"}),
                    device="cpu")
    tr = build_model({**opt_dict(), "train": {"pixel_opt": {
        "type": "L1Loss"}}})
    assert isinstance(tr, KEEPTrainer) and tr.device.type == "cuda"
    # fix_modules: the options' list, else each trainer's default (the JAX
    # package's: KEEP freezes its codebook and generator, a base trainer
    # nothing); not left in the network's config
    assert tr.fix_modules == ("quantize", "generator")
    assert "fix_modules" not in tr.cfg
    net = {k: v for k, v in opt_dict()["network_g"].items()
           if k != "fix_modules"}
    assert KEEPTrainer({"network_g": net}, device="cpu").fix_modules == \
        ("quantize", "generator")
    assert KEEPTrainer({"network_g": {**net, "fix_modules": ["cfa"]}},
                       device="cpu").fix_modules == ("cfa",)
    assert _Toy({}, device="cpu").fix_modules == ()


def test_chip_smoke_opt_matches_the_stage2_yml():
    """chip_smoke.py drives options/train_keep_stage2.yml from a dict (the
    card machine is not specified to have pyyaml): the two agree on every
    field the port reads."""
    sys.path.insert(0, REPO)
    import chip_smoke
    with open(os.path.join(REPO, "options", "train_keep_stage2.yml")) as f:
        yml = yaml.safe_load(f)
    ours = chip_smoke.TRAIN_OPT
    for key in ("model_type", "manual_seed", "network_g", "train"):
        assert ours[key] == yml[key], key
    for key in ("num_frame", "batch_size_per_gpu"):
        assert ours["datasets"]["train"][key] == yml["datasets"]["train"][key]
