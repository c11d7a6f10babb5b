"""Save and resume of the port's training state, and the optimizers it
gained, on the CPU.

- A save / resume round trip: weights, EMA, Adam's moments and step, epoch
  and iteration come back bitwise; latest_state finds the newest save;
  load_network prefers the EMA form.
- Resume equivalence of a KEEPGANTrainer run, bitwise as the JAX package's
  tests/test_training.py holds its own (on one thread): 2 alternations,
  save, a fresh
  trainer from another seed, resume, 1 alternation, against 3 without the
  break: G, its EMA and Adam state, D (its spectral-norm weight_u and
  weight_v too, which each of D's training forwards advances) and D's
  Adam state.
- merge_network_params without strict: a missing key or a shape mismatch
  keeps the live tensor and warns; with strict they raise.
- Adamax, SGD (momentum), ASGD (plain SGD, as the JAX package maps it),
  RMSprop (momentum) and Rprop against the JAX package's optax
  optimizers: 6 updates on fixed gradients under a decaying schedule,
  within 1e-6.
"""
import copy
import logging

import numpy as np
import pytest
import jax.numpy as jnp
import optax
import torch

from comfyui_keep_tpu.training import schedulers as JS
from comfyui_keep_tpu.training import state as JST
from comfyui_keep_torch.models.vqgan import VQHQEncoder
from comfyui_keep_torch.training import schedulers as TS
from comfyui_keep_torch.training.state import (TrainState, build_optimizer,
                                               ema_init, ema_update,
                                               load_network,
                                               merge_network_params)
from comfyui_keep_torch.training.trainers import KEEPGANTrainer
from comfyui_keep_torch.utils.logger import get_root_logger

torch.set_num_threads(2)

TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=1,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32",),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=("32",))
HQ = {k: TINY[k] for k in ("img_size", "nf", "ch_mult", "res_blocks",
                           "attn_resolutions", "codebook_size", "emb_dim")}


class _Net(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.a = torch.nn.Parameter(torch.randn(3, 4, generator=g))
        self.b = torch.nn.Parameter(torch.randn(5, generator=g))
        self.register_buffer("stat", torch.randn(2, generator=g))


def _state(seed):
    net = _Net(seed)
    return TrainState(model=net, optimizer=build_optimizer(
        {"type": "Adam", "lr": 1e-2}, net.parameters()), ema=ema_init(net))


def _steps(state, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        for p in state.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        state.optimizer.step()
        ema_update(state.ema, state.model, 0.9)
        state.iter += 1


def assert_opt_equal(a, b):
    a, b = a.state_dict(), b.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, s in a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)


def test_save_resume_round_trip(tmp_path):
    st = _state(0)
    _steps(st, 3)
    st.epoch = 4
    net_dir, state_dir = tmp_path / "models", tmp_path / "states"
    assert TrainState.latest_state(str(state_dir)) is None
    st.save(str(net_dir), str(state_dir), 3, extra={"note": torch.ones(2)})
    _steps(st, 2, seed=1)
    st.save(str(net_dir), str(state_dir), 12)
    latest = TrainState.latest_state(str(state_dir))
    assert latest.endswith("12.state")

    fresh = _state(7)
    fresh.resume_optimizer(fresh.resume(str(state_dir / "3.state")))
    stats = fresh.load_networks(str(net_dir / "net_g_3.pth"))
    assert stats == {"loaded": 3 + 2}          # 3 state-dict + 2 EMA tensors
    assert (fresh.iter, fresh.epoch) == (3, 4)
    assert torch.equal(fresh.resume_extra["note"], torch.ones(2))
    st2 = _state(0)
    _steps(st2, 3)
    for k, v in st2.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in st2.ema.items():
        assert torch.equal(fresh.ema[k], v), k
    assert_opt_equal(fresh.optimizer, st2.optimizer)
    ema_at_3 = {k: v.clone() for k, v in st2.ema.items()}
    # the same updates on both from here
    _steps(fresh, 1, seed=2)
    _steps(st2, 1, seed=2)
    assert torch.equal(fresh.model.a, st2.model.a)

    ema_sd = load_network(str(net_dir / "net_g_3.pth"))
    raw_sd = load_network(str(net_dir / "net_g_3.pth"), prefer_ema=False)
    assert torch.equal(ema_sd["a"], ema_at_3["a"])
    assert set(ema_sd) == set(raw_sd) == {"a", "b", "stat"}
    assert torch.equal(ema_sd["stat"], raw_sd["stat"])
    assert not torch.equal(ema_sd["a"], raw_sd["a"])


def test_merge_network_params_non_strict():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = get_root_logger()
    logger.addHandler(handler)
    try:
        cur = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
        loaded = {"a": torch.ones(2), "b": torch.ones(4), "z": torch.ones(1)}
        stats = {}
        merged = merge_network_params(cur, loaded, strict=False, stats=stats)
    finally:
        logger.removeHandler(handler)
    assert torch.equal(merged["a"], torch.ones(2))
    assert torch.equal(merged["b"], torch.zeros(3))      # size mismatch: kept
    assert torch.equal(merged["c"], torch.zeros(1))      # missing: kept
    assert stats == {"loaded": 1, "kept": 2}
    msgs = [r.getMessage() for r in records]
    assert any("size mismatch for b" in m for m in msgs)
    assert any("missing key" in m and ": c" in m for m in msgs)
    assert any("1 unexpected" in m for m in msgs)
    with pytest.raises(ValueError):
        merge_network_params(cur, {**loaded, "c": torch.ones(1)})
    with pytest.raises(KeyError):
        merge_network_params(cur, {"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(KeyError):
        merge_network_params(cur, {**cur, "z": torch.ones(1)})


def _gan_trainer(seed, hq):
    opt = {"model_type": "KEEPGANModel", "manual_seed": seed,
           "network_g": {"type": "KEEP", **TINY,
                         "fix_modules": ["quantize", "generator"]},
           "network_d": {"type": "Discriminator3D", "args": {"nf": 8}},
           "train": {"use_hq_feat_loss": True, "cross_entropy_loss": True,
                     "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                     "temporal_opt": {"type": "L1Loss", "loss_weight": 0.1},
                     "gan_opt": {"type": "GANLoss", "gan_type": "hinge",
                                 "loss_weight": 1e-2},
                     "optim_g": {"type": "Adam", "lr": 5e-5},
                     "optim_d": {"type": "Adam", "lr": 5e-5},
                     "scheduler": {"type": "MultiStepLR", "milestones": [2],
                                   "gamma": 0.5},
                     "ema_decay": 0.995}}
    tr = KEEPGANTrainer(opt, hq_vqgan=copy.deepcopy(hq), device="cpu")
    return tr, tr.make_state()


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: with more, the CPU convolutions'
    weight-gradient reduction is split across threads in an order that
    varies from call to call (measured: a 4-frame step repeated from one
    state differs in 74 leaves by ~1e-9 with 2 threads, in none with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_keep_gan_resume_is_bitwise(tmp_path, one_thread):
    hq = VQHQEncoder(device="cpu", generator=torch.Generator().manual_seed(1),
                     **HQ)
    rng = np.random.default_rng(2)
    batches = [{k: torch.as_tensor(rng.random((1, 4, 64, 64, 3), np.float32)
                                   * 2 - 1) for k in ("lq", "gt")}
               for _ in range(3)]

    tr, st = _gan_trainer(0, hq)
    u0 = {k: v.clone() for k, v in tr.disc.state_dict().items()
          if k.endswith("weight_u")}
    for b in batches:
        st, _ = tr.train_step(st, b)

    tr1, st1 = _gan_trainer(0, hq)
    for b in batches[:2]:
        st1, _ = tr1.train_step(st1, b)
    st1.save(str(tmp_path / "models"), str(tmp_path / "states"), st1.iter,
             extra=tr1.extra_state())

    tr2, st2 = _gan_trainer(11, hq)    # other weights: the resume overwrites
    assert not torch.equal(st2.model.feat_emb.weight,
                           st.model.feat_emb.weight)
    latest = TrainState.latest_state(str(tmp_path / "states"))
    st2.resume_optimizer(st2.resume(latest))
    stats = st2.load_networks(str(tmp_path / "models" / "net_g_2.pth"))
    assert stats.get("kept", 0) == 0
    tr2.load_extra_state(st2.resume_extra)
    assert st2.iter == 2
    for k, v in tr1.disc.state_dict().items():   # u and v restored too
        assert torch.equal(tr2.disc.state_dict()[k], v), k
    st2, _ = tr2.train_step(st2, batches[2])

    for k, v in st.model.state_dict().items():
        assert torch.equal(st2.model.state_dict()[k], v), k
    for k, v in st.ema.items():
        assert torch.equal(st2.ema[k], v), k
    assert_opt_equal(st2.optimizer, st.optimizer)
    for k, v in tr.disc.state_dict().items():
        assert torch.equal(tr2.disc.state_dict()[k], v), k
    assert_opt_equal(tr2.d_optimizer, tr.d_optimizer)
    for k, v in u0.items():       # D's forwards advanced u; no optimizer
        assert not torch.equal(tr.disc.state_dict()[k], v), k
    held = {id(p) for g in tr.d_optimizer.param_groups for p in g["params"]}
    assert not any(id(b) in held for b in tr.disc.buffers())


@pytest.mark.parametrize("optim", [
    {"type": "Adamax", "lr": 1e-2, "betas": (0.8, 0.99)},
    {"type": "SGD", "lr": 1e-2, "momentum": 0.9},
    {"type": "SGD", "lr": 1e-2},
    {"type": "ASGD", "lr": 1e-2},
    {"type": "RMSprop", "lr": 1e-2, "momentum": 0.5},
    {"type": "RMSprop", "lr": 1e-2},
    {"type": "Rprop", "lr": 1e-2}])
def test_new_optimizers_vs_optax(optim):
    """Each update's LR set on the param group as base * schedule(step), as
    the trainers set it; the gradients flip sign at step 3 and one element
    is 0 at step 4 (Rprop's three cases)."""
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(6)]
    grads[3] = -grads[2]
    grads[4][0, 0] = 0.0
    sched = {"type": "MultiStepLR", "milestones": [2, 4], "gamma": 0.5}
    tx = JST.build_optimizer(optim, schedule=JS.build_scheduler(sched))
    ts = TS.build_scheduler(sched)
    pj = jnp.asarray(p0)
    jstate = tx.init(pj)
    w = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = build_optimizer(optim, [w])
    for step, g in enumerate(grads):
        upd, jstate = tx.update(jnp.asarray(g), jstate, pj)
        pj = optax.apply_updates(pj, upd)
        opt.param_groups[0]["lr"] = optim["lr"] * ts(step)
        w.grad = torch.as_tensor(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(pj),
                                   atol=1e-6, rtol=1e-6, err_msg=str(step))
