"""GMFlow training in the PyTorch port against the JAX package, on the CPU
in f32: the flow loss and its metrics, optax's one-cycle schedule and
global-norm clip, one GMFlowTrainer step (its final-prediction term
against JAX's loss_fn and jax.grad from the same tree; the reference's
two-term loss, which JAX lacks, against a float64 recomputation, and the
update against optax's on the port's own gradients), and the kernels'
autograd wrapper (PlainBackward) against the plain versions' autograd.

GMFlow at its 128 channels (the position embedding fixes them) with 2
transformer layers (one plain, one shifted), 64x96 crops (8x12 features,
4x6 windows), B = 2. Tolerances: the loss 1e-5 relative; each leaf's
gradient within 1e-4 of its largest magnitude (the JAX gradient's) plus
1e-6 of the tree's largest (three leaves have a true gradient of zero:
the biases of the backbone's two downsample convolutions, which an
InstanceNorm follows, and the flow attention's key bias, under a softmax;
theirs is rounding noise on both sides). The update: optax's clip and
AdamW on the port's own gradients give the port's new leaves within 1e-5
of each leaf's scale.
The schedule within 1e-6 of the
peak LR (optax evaluates its cosine in f32); the clip 1e-6 relative. The
wrapper's forward is the launch it is given and its gradient the plain
version's, so on the CPU both equal the plain version's bit for bit.
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comfyui_keep_tpu.models import gmflow as jg
from comfyui_keep_tpu.training import flow_losses as jfl
from comfyui_keep_tpu.training.trainers import GMFlowTrainer as JTrainer
from comfyui_keep_torch.models import gmflow as tgm
from comfyui_keep_torch.models.gmflow import GMFlow
from comfyui_keep_torch.ops import kernels as K
from comfyui_keep_torch.training import flow_losses as tfl
from comfyui_keep_torch.training.schedulers import cosine_onecycle
from comfyui_keep_torch.training.trainers import (GMFlowTrainer,
                                                  build_model,
                                                  clip_by_global_norm_)
from comfyui_keep_torch.utils.convert import params_from_jax

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6      # of the tree's largest gradient
PARAM_RTOL = 1e-5
ZERO_GRAD_LEAVES = {"backbone.layer2.0.downsample.0.bias",
                    "backbone.layer3.0.downsample.0.bias",
                    "feature_flow_attn.k_proj.bias"}
HW = (64, 96)


def flow_batch(seed, b=2, hw=HW, valid_share=0.8):
    rng = np.random.default_rng(seed)
    h, w = hw
    return {"img1": (rng.random((b, h, w, 3)) * 255).astype(np.float32),
            "img2": (rng.random((b, h, w, 3)) * 255).astype(np.float32),
            "flow": (rng.standard_normal((b, h, w, 2)) * 4).astype(
                np.float32),
            "valid": (rng.random((b, h, w)) < valid_share).astype(
                np.float32)}


def tiny_tree(seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jg.GMFlow.init(jax.random.PRNGKey(seed), num_layers=2))


def opt_dict(**train):
    return {"model_type": "GMFlowModel", "manual_seed": 0,
            "network_g": {"attn_splits": 2, "corr_radius": -1,
                          "prop_radius": -1},
            "train": {"lr": 4e-4, "weight_decay": 1e-4, "grad_clip": 1.0,
                      "gamma": 0.9, "num_steps": 100000, **train}}


def leaf_rel(ours, ref):
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("n_preds,valid", [(1, True), (3, True), (2, False)])
def test_flow_loss_and_metrics_vs_jax(n_preds, valid):
    b = flow_batch(3)
    rng = np.random.default_rng(4)
    preds = [b["flow"] + rng.standard_normal(b["flow"].shape).astype(
        np.float32) * s for s in (6.0, 2.0, 0.5)[:n_preds]]
    b["flow"][0, :3] = 500.0          # past max_flow: masked out
    v = b["valid"] if valid else None
    ref, ref_m = jfl.flow_loss_func([jnp.asarray(p) for p in preds],
                                    jnp.asarray(b["flow"]),
                                    None if v is None else jnp.asarray(v),
                                    gamma=0.8)
    got, got_m = tfl.flow_loss_func([torch.as_tensor(p) for p in preds],
                                    torch.as_tensor(b["flow"]),
                                    None if v is None else torch.as_tensor(v),
                                    gamma=0.8)
    assert abs(got.item() - float(ref)) <= LOSS_RTOL * abs(float(ref))
    assert got_m.keys() == ref_m.keys()
    for k in ref_m:
        assert abs(got_m[k].item() - float(ref_m[k])) <= 1e-6 + LOSS_RTOL \
            * abs(float(ref_m[k])), k
    epe_ref = jfl.end_point_error(jnp.asarray(preds[-1]),
                                  jnp.asarray(b["flow"]),
                                  None if v is None else jnp.asarray(v))
    epe = tfl.end_point_error(torch.as_tensor(preds[-1]),
                              torch.as_tensor(b["flow"]),
                              None if v is None else torch.as_tensor(v))
    assert abs(epe.item() - float(epe_ref)) <= LOSS_RTOL * float(epe_ref)


@pytest.mark.parametrize("steps", [100000, 37])
def test_onecycle_schedule_vs_optax(steps):
    total = steps + 10
    ref = optax.cosine_onecycle_schedule(total, 4e-4, pct_start=0.05)
    ours = cosine_onecycle(total, 4e-4, pct_start=0.05)
    warm = int(0.05 * total)
    for i in sorted({0, 1, 2, warm - 1, warm, warm + 1, total // 2,
                     total - 1, total, total + 5}):
        assert abs(ours(i) - float(ref(i))) <= 1e-6 * 4e-4, i
    # torch's OneCycleLR would peak one step earlier: optax peaks at `warm`
    assert ours(warm) == pytest.approx(4e-4) and ours(warm - 1) < 4e-4
    tr = GMFlowTrainer(opt_dict(num_steps=steps, lr=4e-4), device="cpu")
    assert tr.current_lr(warm) == ours(warm)
    with pytest.raises(ValueError):
        cosine_onecycle(13, 4e-4, pct_start=0.05)   # optax: NaN


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_global_norm_clip_vs_optax(scale):
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (7,), (2, 2, 5)]
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in shapes]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    for p, g in zip(params, grads):
        p.grad = torch.as_tensor(g.copy())
    n = clip_by_global_norm_(params, 1.0)
    assert n.item() == pytest.approx(float(optax.global_norm(
        [jnp.asarray(g) for g in grads])), rel=1e-6)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)
    if scale < 1:   # below max_norm the gradients stay as they are
        for p, g in zip(params, grads):
            np.testing.assert_array_equal(p.grad.numpy(), g)


def test_gmflow_forward_is_differentiable_and_apply_is_not():
    net = GMFlow(num_layers=2, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    net.requires_grad_(True)
    b = flow_batch(6, b=1)
    i1, i2 = torch.as_tensor(b["img1"]), torch.as_tensor(b["img2"])
    out = net(i1, i2)
    assert out.shape == (1,) + HW + (2,) and out.requires_grad
    served = net.apply(i1, i2)
    assert not served.requires_grad
    np.testing.assert_array_equal(served.numpy(), out.detach().numpy())


def test_gmflow_step_vs_jax():
    """One step. The final-prediction term (what JAX's loss_fn is: the JAX
    package passes [final]): its loss, metrics and each leaf's gradient
    against jax.grad of JAX's loss_fn from one tree and batch. The
    trainer's step takes the reference's two-term loss (pre-propagation
    flow weighted gamma, then the final flow): its l_flow is gamma times
    the first term plus the final one, its metrics JAX's, and each leaf
    after the clip + AdamW update optax's on the port's own gradients."""
    tree = tiny_tree()
    b = flow_batch(7)
    jt = JTrainer(opt_dict())
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        jt.loss_fn, has_aux=True)(tree, {k: jnp.asarray(v)
                                         for k, v in b.items()}, None)
    tx = jt.make_optimizer(tree)

    net = GMFlow(num_layers=2, device="cpu")
    net.load_state_dict(params_from_jax(tree, net))
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    # the final-prediction term alone, on a copy of the weights
    alone = copy.deepcopy(net).requires_grad_(True)
    pre, final = alone(tb["img1"], tb["img2"], return_preds=True)
    l_final, metrics = tfl.flow_loss_func([final], tb["flow"],
                                          valid=tb["valid"], gamma=0.9)
    l_pre, _ = tfl.flow_loss_func([pre], tb["flow"], valid=tb["valid"])
    l_final.backward()
    assert abs(l_final.item() - float(ref_loss)) \
        <= LOSS_RTOL * float(ref_loss)
    for k in ("epe", "1px", "3px", "5px"):
        assert abs(metrics[k].item() - float(ref_m[k])) \
            <= 1e-6 + LOSS_RTOL * float(ref_m[k]), k
    grads = params_from_jax(jax.tree.map(np.asarray, ref_g), net)
    named = dict(alone.named_parameters())
    assert grads.keys() == named.keys()
    gmax = max(g.abs().max().item() for g in grads.values())
    assert {n for n, g in grads.items()
            if g.abs().max().item() <= GRAD_ATOL * gmax} == ZERO_GRAD_LEAVES
    for n, p in named.items():
        assert p.grad is not None, n
        ref = grads[n].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL * gmax, n
    # the q/k/v, merge and FFN weights reach the loss through the kernels'
    # wrappers (their plain versions on the CPU) and get a gradient
    for n in ("transformer.layers.0.self_attn.q_proj.weight",
              "transformer.layers.1.cross_attn_ffn.v_proj.weight",
              "transformer.layers.1.cross_attn_ffn.mlp.0.weight",
              "backbone.conv1.weight"):
        assert named[n].grad.abs().max() > 1e-4 * gmax, n

    tr = GMFlowTrainer(opt_dict(), device="cpu")
    state = tr.make_state(net)
    logs = tr.backward(state, tb)
    both = 0.9 * l_pre.item() + l_final.item()
    assert abs(logs["l_flow"].item() - both) <= LOSS_RTOL * both
    for k in ("epe", "1px", "3px", "5px"):
        assert abs(logs[k].item() - float(ref_m[k])) \
            <= 1e-6 + LOSS_RTOL * float(ref_m[k]), k
    named = dict(net.named_parameters())
    own = jg.convert_gmflow_checkpoint(
        {n: p.grad.numpy().copy() for n, p in named.items()})
    upd, _ = tx.update(own, tx.init(tree), tree)
    own_new = params_from_jax(jax.tree.map(
        np.asarray, optax.apply_updates(tree, upd)), net)
    tr.update(state)
    for n, p in net.named_parameters():
        assert leaf_rel(p.detach().numpy(), own_new[n].numpy()) \
            <= PARAM_RTOL, n
    assert state.iter == 1
    assert tr.current_lr(0) == pytest.approx(float(optax.cosine_onecycle_schedule(
        100010, 4e-4, pct_start=0.05)(0)), rel=1e-5)


def test_gmflow_two_term_loss_vs_float64():
    """GMFlowTrainer.loss_fn against a float64 numpy recomputation from
    the two flows GMFlow.forward(return_preds=True) returns on the same
    weights and batch: gamma times the pre-propagation flow's masked
    mean L1 (summed over x and y) plus the final flow's, over the pixels
    with valid >= 0.5 and |gt| < 400 (within 1e-5 relative); the metrics
    are the final flow's end-point errors. The first flow is the matched
    flow upsampled bilinearly x8, align_corners (the reference's
    upsample_flow(bilinear=True)): its 1/8-scale corners reappear at the
    output's corners, times 8."""
    net = GMFlow(num_layers=2, device="cpu")
    net.load_state_dict(params_from_jax(tiny_tree(2), net))
    b = flow_batch(8, valid_share=0.7)
    b["flow"][0, :3, :3] = 500.0        # beyond max_flow: left out
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tr = GMFlowTrainer(opt_dict(gamma=0.8), device="cpu")
    with torch.no_grad():
        loss, logs = tr.loss_fn(net, tb)
        pre, final = net(tb["img1"], tb["img2"], return_preds=True)
        feats = net.extract_features(torch.cat([tb["img1"], tb["img2"]]))
        pre_c, _ = net.correlate(feats[:2], feats[2:], 2, -1)
    np.testing.assert_allclose(pre[:, ::63, ::95].numpy(),
                               8 * pre_c[:, ::7, ::11].numpy(), rtol=1e-6,
                               atol=1e-5)
    gt = b["flow"].astype(np.float64)
    valid = (b["valid"] >= 0.5) & (np.sqrt((gt ** 2).sum(-1)) < 400)
    terms = [float((valid * np.abs(p.numpy().astype(np.float64) - gt)
                    .sum(-1)).sum() / valid.sum()) for p in (pre, final)]
    want = 0.8 * terms[0] + terms[1]
    assert abs(loss.item() - want) <= 1e-5 * want
    epe = np.sqrt(((final.numpy().astype(np.float64) - gt) ** 2).sum(-1))
    assert abs(logs["epe"].item() - (epe * valid).sum() / valid.sum()) \
        <= 1e-5 * logs["epe"].item()
    assert terms[0] != terms[1]


def test_pre_propagation_term_gives_the_correlation_a_gradient(monkeypatch):
    """The matched flow reaches the final flow only detached (the
    propagation takes it without gradient), so with the final term alone
    the correlation's second input, f1 after the transformer, gets none;
    the trainer's two-term loss gives both of the correlation's inputs
    one, and with them the f1 half of the last cross attention."""
    net = GMFlow(num_layers=2, device="cpu")
    net.load_state_dict(params_from_jax(tiny_tree(3), net))
    net.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in flow_batch(9).items()}
    seen = []
    corr = tgm.global_correlation_softmax

    def spy(f0, f1):
        f0.retain_grad()
        f1.retain_grad()
        seen.append((f0, f1))
        return corr(f0, f1)
    monkeypatch.setattr(tgm, "global_correlation_softmax", spy)
    final = net(tb["img1"], tb["img2"])
    tfl.flow_loss_func([final], tb["flow"], valid=tb["valid"])[0].backward()
    f0, f1 = seen.pop()
    assert f0.grad is not None and f0.grad.abs().max() > 0
    assert f1.grad is None
    tr = GMFlowTrainer(opt_dict(), device="cpu")
    loss, _ = tr.loss_fn(net, tb)
    loss.backward()
    f0, f1 = seen.pop()
    for f in (f0, f1):
        assert f.grad is not None and f.grad.abs().max() > 0


def test_build_model_gmflow_defaults_to_cuda():
    tr = build_model(opt_dict())
    assert isinstance(tr, GMFlowTrainer) and tr.device.type == "cuda"
    assert (tr.attn_splits, tr.corr_radius, tr.prop_radius) == (2, -1, -1)


def _kernel_inputs(seed):
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).requires_grad_(True)

    return g, r


@pytest.mark.parametrize("form", ["window", "window+bias", "global"])
def test_attention_autograd_wrapper_equals_plain(form):
    g, r = _kernel_inputs(11)
    dv = 2 if form == "global" else 16
    q, k, v = r(4, 24, 16), r(4, 24, 16), r(4, 24, dv, scale=3.0)
    bias = (torch.where(torch.rand(2, 24, 24, generator=g) < 0.3, -100.0, 0.0)
            if form == "window+bias" else None)
    args = (q, k, v, 0.25, bias)
    out = K.PlainBackward.apply(K.attention_plain, K.attention_plain,
                                (0, 1, 2), *args)
    ref = K.attention_plain(*args)
    go = torch.randn(ref.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), go)
    want = torch.autograd.grad(ref, (q, k, v), go)
    assert torch.equal(out, ref)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_correlation_autograd_wrapper_equals_plain():
    g, r = _kernel_inputs(12)
    f0, f1 = r(3, 20, 16), r(3, 20, 16)
    ys, xs = torch.meshgrid(torch.arange(4.0), torch.arange(5.0),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(20, 2)
    out = K.PlainBackward.apply(K.global_correlation_expectation_plain,
                                K.global_correlation_expectation_plain,
                                (0, 1), f0, f1, grid)
    ref = K.global_correlation_expectation_plain(f0, f1, grid)
    go = torch.randn(ref.shape, generator=g)
    for a, b_ in zip(torch.autograd.grad(out, (f0, f1), go),
                     torch.autograd.grad(ref, (f0, f1), go)):
        assert torch.equal(a, b_)


def test_mlp_autograd_wrapper_equals_plain_and_forward_is_the_launch():
    """Every one of the six tensors gets the plain version's gradient; the
    forward value is the launch's (here the plain output plus one, which
    the backward must not see)."""
    g, r = _kernel_inputs(13)
    c, h = 8, 32
    args = (r(2, 10, c), r(2, 10, c), r(h, 2 * c, scale=0.3),
            r(c, h, scale=0.3), r(c), r(c), False)
    out = K.PlainBackward.apply(lambda *a: K.mlp_fused_plain(*a) + 1,
                                K.mlp_fused_plain, (0, 1, 2, 3, 4, 5), *args)
    ref = K.mlp_fused_plain(*args)
    assert torch.equal(out, ref + 1)
    go = torch.randn(ref.shape, generator=g)
    tensors = args[:6]
    for a, b_ in zip(torch.autograd.grad(out, tensors, go),
                     torch.autograd.grad(ref, tensors, go)):
        assert torch.equal(a, b_)


def test_wrapper_gives_no_gradient_to_bias_or_grid_and_is_skipped_without_grad():
    g, r = _kernel_inputs(14)
    q, k, v = r(2, 6, 4), r(2, 6, 4), r(2, 6, 4)
    bias = torch.zeros(1, 6, 6, requires_grad=True)
    out = K.PlainBackward.apply(K.attention_plain, K.attention_plain,
                                (0, 1, 2), q, k, v, 0.5, bias)
    gq, gb = torch.autograd.grad(out.sum(), (q, bias), allow_unused=True)
    assert gq is not None and gb is None
    calls = []

    def launch(*a):
        calls.append(1)
        return K.attention_plain(*a)

    with torch.no_grad():
        y = K._with_grad(launch, K.attention_plain, (0, 1, 2), q, k, v, 0.5)
    assert not y.requires_grad and calls == [1]
    y = K._with_grad(launch, K.attention_plain, (0, 1, 2), q.detach(),
                     k.detach(), v.detach(), 0.5)
    assert not y.requires_grad and y.grad_fn is None and calls == [1, 1]
    y = K._with_grad(launch, K.attention_plain, (0, 1, 2), q, k, v, 0.5)
    assert type(y.grad_fn).__name__ == "PlainBackwardBackward"


@pytest.mark.parametrize("fn", ["attention", "correlation", "mlp"])
def test_plain_versions_compute_in_float64_on_f64_inputs(fn):
    """A float64 input keeps float64 throughout the plain version (the
    float64 GMFlow step is the card-against-CPU reference): within 1e-12 of
    the same function written out in float64, where an f32 pass is ~1e-7
    off. An f32 input still gives an f32 output."""
    g = torch.Generator().manual_seed(15)

    def r(*s, scale=1.0):
        return torch.randn(s, generator=g, dtype=torch.float64) * scale

    if fn == "attention":
        q, k, v = r(2, 12, 8, scale=2.0), r(2, 12, 8, scale=2.0), r(2, 12, 8)
        bias = torch.where(torch.rand(1, 12, 12, generator=g) < 0.3,
                           -100.0, 0.0)
        args = (q, k, v, 0.3, bias)
        got = K.attention_plain(*args)
        want = torch.softmax(q @ k.transpose(-1, -2) * 0.3 + bias.double(),
                             -1) @ v
        f32 = K.attention_plain(q.float(), k.float(), v.float(), 0.3, bias)
    elif fn == "correlation":
        f0, f1 = r(2, 20, 8, scale=2.0), r(2, 20, 8, scale=2.0)
        grid = torch.rand(20, 2, generator=g) * 5
        got = K.global_correlation_expectation_plain(f0, f1, grid)
        want = torch.softmax(f0 @ f1.transpose(-1, -2) / math.sqrt(8),
                             -1) @ grid.double()
        f32 = K.global_correlation_expectation_plain(f0.float(), f1.float(),
                                                     grid)
    else:
        c, h = 8, 32
        src, msg = r(2, 10, c), r(2, 10, c)
        w1, w2, gamma, beta = (r(h, 2 * c, scale=0.3), r(c, h, scale=0.3),
                               r(c), r(c))
        got = K.mlp_fused_plain(src, msg, w1, w2, gamma, beta, False)
        o = torch.nn.functional.gelu(
            torch.cat([src, msg], -1) @ w1.t()) @ w2.t()
        o = (o - o.mean(-1, keepdim=True)) / torch.sqrt(
            o.var(-1, unbiased=False, keepdim=True) + 1e-5)
        want = src + o * gamma + beta
        f32 = K.mlp_fused_plain(src.float(), msg.float(), w1.float(),
                                w2.float(), gamma.float(), beta.float(),
                                False)
    assert got.dtype == torch.float64 and f32.dtype == torch.float32
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-12 * scale
    assert (f32.double() - want).abs().max() > 1e-9 * scale
