"""The SR, SRGAN, Real-ESRNet / Real-ESRGAN and recurrent video trainers of
the PyTorch port against the JAX package, on the CPU in f32, one step each
from the same weights (the port's seeded nets through the JAX package's
convert_state_dict) and the same batch; the Real-ESRGAN synthesis against
the JAX package's with the noise off (sigma 0: the two packages' noise
streams cannot agree); usm_sharp against cv2.

Tolerances: each loss 1e-5 relative. Adam's first step moves each element
by lr g / (|g| + eps), about lr times the sign of its gradient g, so
after a step each element whose port gradient is at least 1e-3 of its
leaf's largest and 100 eps (where the step no longer depends on |g|) is
held within 1e-5 of the leaf's scale, and every element within 2 lr
(where the gradient is rounding noise its sign may flip). The synthesis: the
intermediate float maps agree to ~1e-5 (the JAX package's bicubic resize
is a matrix product, torch's a 4-tap sum: 1e-5 apart on [0, 1] maps), so
the 8-bit rounding of the LQ may
flip at a tie: the LQ within one level (1/255) on at most 1e-3 of its
values, the GT crops bit for bit. usm_sharp within 1e-6 of cv2's.
"""
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_keep_tpu.training import realesrgan_feed as jfeed
from comfyui_keep_tpu.training import trainers as jtr
from comfyui_keep_tpu.training.state import TrainState as JState
from comfyui_keep_tpu.training.state import build_optimizer as jbuild_opt
from comfyui_keep_tpu.utils import img_process as jimg
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch.training import realesrgan_feed as tfeed
from comfyui_keep_torch.training import trainers as ttr
from comfyui_keep_torch.utils import img_process as timg
from comfyui_keep_torch.utils.convert import params_from_jax

from tests.torch_port_helpers import SpectralUFeed, state_numpy

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
SURE = 1e-3          # share of a leaf's largest gradient above which the
                     # sign of Adam's first step is certain
LR = 2e-4
ADAM_EPS = 1e-8
NORM_BUFFERS = ("mean", "std")


def jax_tree(net):
    return convert_state_dict({k: v for k, v in state_numpy(net).items()
                               if k.split(".")[-1] not in NORM_BUFFERS})


def capture_grads(model, optimizer):
    """The gradient Adam's moments see at each step, by parameter name:
    the parameter's, plus weight_decay times the parameter (torch's Adam,
    as optax's add_decayed_weights before adam)."""
    seen = {}
    names = {id(p): n for n, p in model.named_parameters()}

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                seen[names[id(p)]] = (p.grad + group["weight_decay"]
                                      * p).detach().clone()
    optimizer.register_step_pre_hook(hook)
    return seen


def assert_step_matches(model, grads, ref_tree, lr):
    ref = params_from_jax(jax.tree.map(np.asarray, ref_tree), model)
    gmax = max(g.abs().max().item() for g in grads.values())
    for n, p in model.named_parameters():
        ours, want = p.detach(), ref[n]
        d = (ours - want).abs()
        assert d.max().item() <= 2 * lr * (1 + 1e-3), n
        g = grads[n].abs()
        sure = ((g >= SURE * g.max()) & (g >= 100 * ADAM_EPS)
                & (g.max() > 1e-6 * gmax))
        if sure.any():
            assert d[sure].max().item() <= PARAM_RTOL * want.abs().max(), n


def assert_losses(logs, ref, keys):
    for k in keys:
        assert abs(logs[k] - float(ref[k])) <= LOSS_RTOL * abs(float(ref[k])) \
            + 1e-12, (k, logs[k], float(ref[k]))


def sr_opt(model_type="SRModel", **train):
    return {"model_type": model_type, "manual_seed": 0,
            "network_g": {"type": "MSRResNet", "num_feat": 16,
                          "num_block": 2, "upscale": 4},
            "network_d": {"type": "UNetDiscriminatorSN", "num_feat": 8},
            "train": {"pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "optim_g": {"type": "Adam", "lr": LR},
                      "optim_d": {"type": "Adam", "lr": LR}, **train}}


def sr_batch(seed, b=2, lq=12, scale=4):
    rng = np.random.default_rng(seed)
    return {"lq": rng.random((b, lq, lq, 3), dtype=np.float32),
            "gt": rng.random((b, lq * scale, lq * scale, 3),
                             dtype=np.float32)}


def jax_state(jt, tree):
    jt.tx = jt.make_optimizer(tree)
    return JState(params=tree, opt_state=jt.tx.init(tree))


@pytest.mark.parametrize("ema", [0, 0.9])
def test_sr_step_vs_jax(ema):
    opt = sr_opt(ema_decay=ema)
    tr = ttr.SRTrainer(opt, device="cpu")
    state = tr.make_state()
    tree = jax_tree(state.model)
    grads = capture_grads(state.model, state.optimizer)
    b = sr_batch(1)
    jt = jtr.SRTrainer(opt)
    js = jax_state(jt, tree)
    js.ema_params = jax.tree.map(lambda a: a, tree) if ema else None
    js, ref_logs = jt.train_step(js, b)
    state, logs = tr.train_step(state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
    assert_losses(logs, ref_logs, ("l_pix", "l_total"))
    assert_step_matches(state.model, grads, js.params, LR)
    if ema:
        want = params_from_jax(jax.tree.map(np.asarray, js.ema_params),
                               state.model)
        for n, v in state.ema.items():
            assert (v - want[n]).abs().max() <= 2 * LR * (1 - ema) + 1e-7, n


def test_sr_forward_and_self_ensemble_vs_jax():
    tr = ttr.SRTrainer(sr_opt(), device="cpu")
    model = tr.init_model()
    tree = jax_tree(model)
    jt = jtr.SRTrainer(sr_opt())
    lq = sr_batch(2, b=1, lq=10)["lq"]
    got = tr.forward(model, torch.as_tensor(lq)).numpy()
    np.testing.assert_allclose(got, np.asarray(jt.forward(tree, lq)),
                               atol=1e-5, rtol=1e-5)
    ens = tr.test_selfensemble(model, torch.as_tensor(lq)).numpy()
    np.testing.assert_allclose(ens, np.asarray(jt.test_selfensemble(tree,
                                                                    lq)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("it,d_init", [(1, 0), (1, 2)])
def test_srgan_alternation_vs_jax(it, d_init):
    """A generator step with the GAN term (or, before net_d_init_iters, a
    plain forward) and the discriminator's step, from one state."""
    opt = sr_opt("SRGANModel", net_d_init_iters=d_init,
                 gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                          "loss_weight": 0.1})
    tr = ttr.build_model(opt, device="cpu")
    assert isinstance(tr, ttr.SRGANTrainer)
    state = tr.make_state()
    g_grads = capture_grads(state.model, state.optimizer)
    d_grads = capture_grads(tr.disc, tr.d_optimizer)
    # copies: the port's step below updates the weights these would view
    tree, d_tree = (jax.tree.map(np.array, jax_tree(m))
                    for m in (state.model, tr.disc))
    jt = jtr.SRGANTrainer(opt)
    js = jax_state(jt, tree)
    jt.d_params = d_tree
    jt.tx_d = jbuild_opt(dict(opt["train"]["optim_d"]), schedule=jt.schedule)
    jt.d_opt_state = jt.tx_d.init(d_tree)
    b = sr_batch(3)
    # the port's D advances its spectral-norm u at each training forward;
    # JAX's is fed the u the port's held before the same call
    feed = SpectralUFeed(jt.d_arch, d_tree, tr.disc)
    state, logs = tr.train_step(state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
    jt.d_arch = feed
    js, ref_logs = jt.gan_train_step(js, b, current_iter=it)
    assert feed.calls == len(feed.seen) == (2 if d_init else 3)
    assert logs.keys() == ref_logs.keys()
    assert_losses(logs, ref_logs, ref_logs.keys())
    assert state.iter == 1 and tr.d_updates == 1
    if d_init:   # no generator step: the weights as they were
        assert not g_grads
        for n, v in params_from_jax(tree, state.model).items():
            assert torch.equal(state.model.state_dict()[n], v), n
    else:
        assert_step_matches(state.model, g_grads, js.params, LR)
    assert_step_matches(tr.disc, d_grads, jt.d_params, LR)
    extra = tr.extra_state()
    tr.load_extra_state(extra)
    assert tr.d_updates == 1


FEED = {"scale": 4, "gt_size": 64, "queue_size": 4,
        "resize_prob": [0.2, 0.7, 0.1], "resize_range": [0.5, 1.5],
        "gaussian_noise_prob": 1.0, "noise_range": [0, 0],
        "poisson_scale_range": [0.05, 3], "gray_noise_prob": 0.0,
        "jpeg_range": [30, 95], "second_blur_prob": 0.8,
        "resize_prob2": [0.3, 0.4, 0.3], "resize_range2": [0.6, 1.2],
        "gaussian_noise_prob2": 1.0, "noise_range2": [0, 0],
        "poisson_scale_range2": [0.05, 2.5], "gray_noise_prob2": 0.0,
        "jpeg_range2": [30, 95]}


def kernel_batch(seed, b=2, hw=96):
    rng = np.random.default_rng(seed)

    def kern():
        k = rng.random((b, 21, 21)).astype(np.float32) ** 4
        return k / k.sum(axis=(1, 2), keepdims=True)

    return {"gt": rng.random((b, hw, hw, 3), dtype=np.float32),
            "kernel1": kern(), "kernel2": kern(), "sinc_kernel": kern()}


def assert_lq_close(ours, ref):
    d = np.abs(ours - ref)
    assert d.max() <= 1 / 255 + 1e-6 and (d > 1e-6).mean() <= 1e-3, (
        d.max(), (d > 1e-6).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_realesrgan_synthesize_vs_jax_noise_off(seed):
    b = kernel_batch(seed)
    random.seed(seed)
    np.random.seed(seed)
    ref = jfeed.realesrgan_synthesize(b, FEED, jax.random.PRNGKey(0))
    ours = tfeed.realesrgan_synthesize(
        {k: torch.as_tensor(v) for k, v in b.items()}, FEED,
        torch.Generator().manual_seed(0), py_rng=random.Random(seed),
        np_rng=np.random.RandomState(seed))
    assert ours["lq"].shape == (2, 16, 16, 3) and ours["gt"].shape == (
        2, 64, 64, 3)
    assert_lq_close(ours["lq"].numpy(), np.asarray(ref["lq"]))
    np.testing.assert_array_equal(ours["gt"].numpy(), np.asarray(ref["gt"]))
    np.testing.assert_allclose(ours["gt_usm"].numpy(),
                               np.asarray(ref["gt_usm"]), atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "area"])
def test_feed_pieces_vs_jax(mode):
    b = kernel_batch(5)
    x = b["gt"]
    np.testing.assert_allclose(
        tfeed.resize_torch(torch.as_tensor(x), (17, 29), mode).numpy(),
        np.asarray(jfeed.resize_torch(jnp.asarray(x), (17, 29), mode)),
        atol=2e-5)
    np.testing.assert_allclose(
        tfeed.filter2d(torch.as_tensor(x), torch.as_tensor(
            b["kernel1"])).numpy(),
        np.asarray(jfeed.filter2d(jnp.asarray(x), jnp.asarray(b["kernel1"]))),
        atol=1e-6)


def test_noise_draws_are_seeded_and_bounded():
    x = torch.as_tensor(kernel_batch(6)["gt"])
    a = tfeed.random_add_gaussian_noise_pt(
        x, torch.Generator().manual_seed(1), (1, 30), gray_prob=0.5)
    b = tfeed.random_add_gaussian_noise_pt(
        x, torch.Generator().manual_seed(1), (1, 30), gray_prob=0.5)
    assert torch.equal(a, b) and not torch.equal(a, x)
    assert a.min() >= 0 and a.max() <= 1
    p = tfeed.random_add_poisson_noise_pt(
        x, torch.Generator().manual_seed(2), (0.05, 3), gray_prob=0.5)
    assert p.min() >= 0 and p.max() <= 1 and not torch.equal(p, x)
    z = tfeed.random_add_gaussian_noise_pt(
        x, torch.Generator().manual_seed(1), (0, 0))
    assert torch.equal(z, torch.clamp(x, 0, 1))


def test_pair_pool_vs_jax():
    rng = np.random.default_rng(7)
    jpool = jfeed.TrainingPairPool(4)
    tpool = tfeed.TrainingPairPool(4, np_rng=np.random.RandomState(3))
    np.random.seed(3)
    for _ in range(4):
        lq = rng.random((2, 2, 2, 3), dtype=np.float32)
        gt = rng.random((2, 4, 4, 3), dtype=np.float32)
        rl, rg = jpool.exchange(lq, gt)
        ol, og = tpool.exchange(torch.as_tensor(lq), torch.as_tensor(gt))
        np.testing.assert_array_equal(ol.numpy(), rl)
        np.testing.assert_array_equal(og.numpy(), rg)


@pytest.mark.parametrize("model_type", ["RealESRNetModel",
                                        "RealESRGANModel"])
def test_realesrgan_trainers_feed_and_step_vs_jax(model_type):
    """feed_data on the trainers' own streams, seeded alike (the JAX
    package's global ones with manual_seed), then one step of each on the
    same fed batch."""
    opt = {**sr_opt(model_type,
                    gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                             "loss_weight": 0.1}), **FEED}
    tr = ttr.build_model(opt, device="cpu")
    state = tr.make_state()
    grads = capture_grads(state.model, state.optimizer)
    # copies: the port's step below updates the weights these would view
    tree = jax.tree.map(np.array, jax_tree(state.model))
    jt = jtr.build_model(opt)
    js = jax_state(jt, tree)
    if model_type == "RealESRGANModel":
        jt.d_params = jax.tree.map(np.array, jax_tree(tr.disc))
        jt.tx_d = jbuild_opt(dict(opt["train"]["optim_d"]))
        jt.d_opt_state = jt.tx_d.init(jt.d_params)
    random.seed(0)
    np.random.seed(0)
    for i in range(3):       # the third exchange shuffles the full pool
        b = kernel_batch(10 + i)
        ref = jt.feed_data(b)
        fed = tr.feed_data({k: torch.as_tensor(v) for k, v in b.items()})
        assert fed.keys() == ref.keys()
        assert_lq_close(fed["lq"].numpy(), np.asarray(ref["lq"]))
        np.testing.assert_array_equal(fed["gt_raw"].numpy(),
                                      np.asarray(ref["gt_raw"]))
        np.testing.assert_allclose(fed["gt"].numpy(), np.asarray(ref["gt"]),
                                   atol=1e-6)
    step = {k: fed[k] for k in ("lq", "gt")}
    if model_type == "RealESRGANModel":
        # JAX's D fed the u the port's held before each of its training
        # forwards (which advance it)
        feed = SpectralUFeed(jt.d_arch, jt.d_params, tr.disc)
    state, logs = tr.train_step(state, step)
    if model_type == "RealESRGANModel":
        jt.d_arch = feed
    js, ref_logs = jt.train_step(js, {k: v.numpy() for k, v in step.items()})
    assert logs.keys() == ref_logs.keys()
    assert_losses(logs, ref_logs, ref_logs.keys())
    assert_step_matches(state.model, grads, js.params, LR)
    passthrough = {"lq": torch.zeros(1, 2, 2, 3), "gt": torch.zeros(1, 8, 8,
                                                                      3)}
    assert tr.feed_data(passthrough) is passthrough


def video_opt(fix_flow, wd, model="BasicVSR"):
    return {"model_type": "VideoRecurrentModel", "manual_seed": 0,
            "network_g": {"type": model, "num_feat": 8, "num_block": 1},
            "train": {"pixel_opt": {"type": "CharbonnierLoss"},
                      "optim_g": {"type": "Adam", "lr": LR,
                                  "weight_decay": wd},
                      "flow_lr_mul": 0.25, "fix_flow": fix_flow}}


@pytest.mark.parametrize("fix_flow,wd", [(0, 0.0), (2, 0.0), (2, 0.1)])
def test_video_recurrent_step_vs_jax(fix_flow, wd):
    """BasicVSR (its SpyNet the flow group at flow_lr_mul times the LR):
    with fix_flow 2 the first iteration zeroes SpyNet's gradient, and Adam
    still steps it (by its weight decay alone when wd > 0), as optax's
    multi_transform does."""
    opt = video_opt(fix_flow, wd)
    tr = ttr.build_model(opt, device="cpu")
    assert isinstance(tr, ttr.VideoRecurrentTrainer)
    state = tr.make_state()
    assert [g.get("lr_mul", 1.0) for g in state.optimizer.param_groups] == [
        1.0, 0.25]
    grads = capture_grads(state.model, state.optimizer)
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    tree = jax_tree(state.model)
    jt = jtr.build_model(opt)
    js = jax_state(jt, tree)
    rng = np.random.default_rng(4)
    b = {"lq": rng.random((1, 2, 64, 64, 3), dtype=np.float32),
         "gt": rng.random((1, 2, 256, 256, 3), dtype=np.float32)}
    js, ref_logs = jt.train_step(js, b)
    state, logs = tr.train_step(state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
    assert_losses(logs, ref_logs, ("l_pix", "l_total"))
    assert_step_matches(state.model, grads, js.params, LR)
    spy = [n for n in grads if n.startswith("spynet.")]
    # the loss's own gradient (Adam's less the decay term) is zero there
    assert spy and all((grads[n] - wd * before[n]).abs().max() == 0
                       for n in spy) == bool(fix_flow)
    moved = max((state.model.get_parameter(n) - before[n]).abs().max().item()
                for n in spy)
    assert (moved > 0) == (not fix_flow or wd > 0)
    if not fix_flow:   # the flow group's first step is 0.25 lr a element
        assert moved <= 0.25 * LR * (1 + 1e-3)


def test_usm_sharp_vs_cv2_and_jax():
    img = np.random.default_rng(8).random((40, 52, 3), dtype=np.float32)
    ref = jimg.usm_sharp(img)      # cv2.GaussianBlur
    np.testing.assert_allclose(timg.usm_sharp(img), ref, atol=1e-6)
    got = timg.usm_sharp(torch.as_tensor(img))
    assert torch.is_tensor(got)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    batch = img[None].repeat(2, 0)
    np.testing.assert_allclose(
        timg.usm_sharp_pt(torch.as_tensor(batch)).numpy(),
        np.asarray(jimg.usm_sharp_jax(jnp.asarray(batch))), atol=1e-6)


def test_every_jax_model_type_builds_on_cuda_by_default():
    from comfyui_keep_tpu.utils.registry import MODEL_REGISTRY as JREG
    from comfyui_keep_torch.utils.registry import MODEL_REGISTRY as TREG
    assert sorted(TREG._obj_map) == sorted(JREG._obj_map)
    opts = {"GMFlowModel": {}, "StyleGAN2Model": {},
            "KEEPModel": {"network_g": {"img_size": 64}},
            "KEEPGANModel": {"network_g": {"img_size": 64}}}
    for name in TREG._obj_map:
        opt = {"model_type": name, **opts.get(name, sr_opt(name))}
        if name.startswith(("Video", "EDVR")):
            opt = {**video_opt(0, 0.0), "model_type": name}
        tr = ttr.build_model(opt)
        assert tr.device.type == "cuda", name
    with pytest.raises(KeyError):
        ttr.build_model({"model_type": "NoSuchModel"})
