"""The losses the port gained with KEEP stage III against the JAX package's,
on the CPU in f32: WeightedTVLoss, PerceptualLoss and LPIPSLoss on one VGG19
(the port's seeded, He-scaled weights carried into JAX by its own
torchvision converter), MultiScaleGANLoss, gradient_penalty_loss with the
same alpha, and LDL's get_local_weights / get_refined_artifact_map. The
port takes NCHW images, JAX NHWC: the same numpy arrays, transposed.
Tolerance: 1e-5 relative to the JAX value throughout (f32 summation order;
VGG's convolutions sum in another order in each package).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import vgg as jvgg
from comfyui_keep_tpu.models.vqgan import Discriminator3D as JD3D
from comfyui_keep_tpu.training import losses as JL
from comfyui_keep_torch.models.vgg import VGGFeatureExtractor
from comfyui_keep_torch.models.vqgan import Discriminator3D
from comfyui_keep_torch.training import losses as TL
from comfyui_keep_torch.utils.convert import params_from_jax
from comfyui_keep_torch.utils.registry import LOSS_REGISTRY
from tests.torch_port_helpers import he_scaled, torchvision_vgg

torch.set_num_threads(2)
RTOL = 1e-5


def nchw(a):
    return torch.as_tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def close(ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert np.abs(ours - ref).max() <= rtol * max(np.abs(ref).max(), 1e-12), \
        (np.abs(ours - ref).max(), np.abs(ref).max())


def test_registry_holds_the_jax_names():
    from comfyui_keep_tpu.utils.registry import LOSS_REGISTRY as JREG
    assert set(LOSS_REGISTRY.keys()) == set(JREG.keys())


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_tv_loss_vs_jax(reduction, weighted):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    w = rng.random((2, 9, 11, 3)).astype(np.float32) if weighted else None
    opt = {"type": "WeightedTVLoss", "loss_weight": 0.3,
           "reduction": reduction}
    ref = JL.build_loss(opt)(jnp.asarray(x),
                             None if w is None else jnp.asarray(w))
    ours = TL.build_loss(opt)(nchw(x), None if w is None else nchw(w))
    close(ours.item(), float(ref))


@pytest.fixture(scope="module")
def vgg_pair():
    """A VGG19 feature extractor (seeded, He-scaled so deep layers keep the
    input's signal) and its JAX tree; the port's forward as the
    feature_fn(x, layers) both losses take, and JAX's."""
    net = he_scaled(VGGFeatureExtractor(("relu1_1",), device="cpu",
                                        generator=torch.Generator()
                                        .manual_seed(3)))
    tree = jvgg.convert_vgg_checkpoint(torchvision_vgg(net))

    def jfn(x, layers):
        return jvgg.VGGFeatureExtractor.apply(tree, x, layers)
    return net, jfn


@pytest.mark.parametrize("criterion", ["l1", "l2", "fro"])
def test_perceptual_loss_vs_jax(vgg_pair, criterion):
    net, jfn = vgg_pair
    rng = np.random.default_rng(1)
    x, gt = (rng.random((2, 32, 32, 3), np.float32) for _ in range(2))
    opt = {"type": "PerceptualLoss", "criterion": criterion,
           "layer_weights": {"conv1_2": 0.1, "relu2_2": 0.5, "relu3_4": 1.0,
                             "pool4": 0.3},
           "perceptual_weight": 0.7, "style_weight": 2.0}
    p_j, s_j = JL.build_loss(opt, feature_fn=jfn)(jnp.asarray(x),
                                                  jnp.asarray(gt))
    xt = nchw(x).requires_grad_(True)
    p, s = TL.build_loss(opt, feature_fn=net)(xt, nchw(gt))
    close(p.item(), float(p_j))
    close(s.item(), float(s_j))
    p.backward()                       # gt is detached, x is not
    assert xt.grad is not None and xt.grad.abs().sum() > 0
    off = TL.build_loss({**opt, "style_weight": 0.0}, feature_fn=net)(
        nchw(x), nchw(gt))
    assert off[1] is None and off[0].item() == pytest.approx(p.item())


@pytest.mark.parametrize("linear", [False, True])
def test_lpips_loss_vs_jax(vgg_pair, linear):
    net, jfn = vgg_pair
    rng = np.random.default_rng(2)
    x, gt = (rng.random((2, 32, 32, 3), np.float32) for _ in range(2))
    layers = ("relu1_2", "relu2_2", "relu3_4", "relu4_4", "relu5_4")
    chans = (64, 128, 256, 512, 512)
    lw = {k: rng.random(c).astype(np.float32)
          for k, c in zip(layers, chans)} if linear else None
    ref = JL.LPIPSLoss(jfn, loss_weight=0.5, linear_weights=None if lw is None
                       else {k: jnp.asarray(v) for k, v in lw.items()})(
        jnp.asarray(x), jnp.asarray(gt))
    ours = TL.LPIPSLoss(net, loss_weight=0.5, linear_weights=None if lw is None
                        else {k: torch.as_tensor(v).view(1, -1, 1, 1)
                              for k, v in lw.items()})(nchw(x), nchw(gt))
    close(ours.item(), float(ref))


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "hinge",
                                      "wgan_softplus"])
def test_multiscale_gan_loss_vs_jax(gan_type):
    rng = np.random.default_rng(3)
    preds = [rng.standard_normal((2, 4, 4, 1)).astype(np.float32),
             [rng.standard_normal((2, 8, 8, 1)).astype(np.float32),
              rng.standard_normal((2, 2, 2, 1)).astype(np.float32)]]
    opt = {"type": "MultiScaleGANLoss", "gan_type": gan_type,
           "loss_weight": 0.1}
    ref_l, our_l = JL.build_loss(opt), TL.build_loss(opt)

    def conv(p, f):
        return [f(q) if not isinstance(q, list) else [f(r) for r in q]
                for q in p]
    for real in (True, False):
        for disc in (True, False):
            close(our_l(conv(preds, torch.as_tensor), real, disc).item(),
                  float(ref_l(conv(preds, jnp.asarray), real, disc)))
    close(our_l(torch.as_tensor(preds[0]), True).item(),
          float(ref_l(jnp.asarray(preds[0]), True)))


@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_penalty_vs_jax(weighted):
    """On a Discriminator3D (nf 4) over 2-frame 16x16 clips, the same
    alpha: JAX draws it from a key, the port takes it."""
    rng = np.random.default_rng(4)
    jtree = jax.tree.map(np.asarray, JD3D.init(jax.random.PRNGKey(5), nf=4))
    disc = Discriminator3D(nf=4, device="cpu")
    disc.load_state_dict(params_from_jax(jtree, disc))
    disc.requires_grad_(True)
    real, fake = (rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
                  for _ in range(2))
    w = rng.random((2, 2, 16, 16, 3)).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(6)
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1, 1)))
    ref = JL.gradient_penalty_loss(
        lambda v: JD3D.apply(jtree, v), jnp.asarray(real), jnp.asarray(fake),
        key, None if w is None else jnp.asarray(w))
    ours = TL.gradient_penalty_loss(
        disc, torch.as_tensor(real), torch.as_tensor(fake),
        None if w is None else torch.as_tensor(w),
        alpha=torch.as_tensor(alpha))
    close(ours.item(), float(ref))
    ours.backward()                 # the penalty trains D
    assert disc.conv[0].weight_orig.grad.abs().sum() > 0
    drawn = TL.gradient_penalty_loss(
        disc, torch.as_tensor(real), torch.as_tensor(fake),
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn)


def test_ldl_artifact_map_vs_jax():
    rng = np.random.default_rng(7)
    gt, out, ema = (rng.random((2, 12, 14, 3), np.float32) for _ in range(3))
    res = rng.random((2, 12, 14, 1), np.float32)
    close(TL.get_local_weights(nchw(res), 7).numpy().transpose(0, 2, 3, 1),
          np.asarray(JL.get_local_weights(jnp.asarray(res), 7)))
    ref = np.asarray(JL.get_refined_artifact_map(
        jnp.asarray(gt), jnp.asarray(out), jnp.asarray(ema), 7))
    ours = TL.get_refined_artifact_map(nchw(gt), nchw(out), nchw(ema), 7)
    assert ours.shape == (2, 1, 12, 14)
    close(ours.numpy().transpose(0, 2, 3, 1), ref)
    assert (ref == 0).any() and (ref > 0).any()
