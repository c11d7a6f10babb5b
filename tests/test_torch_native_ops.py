"""The port's deformable convolution and correlation (ops/native.py) against
the JAX package's, on the CPU in f32.

Same seeded numpy inputs on both sides, the port in NCHW / OIHW, JAX in
NHWC / HWIO. The offsets (standard deviation 2 px) move taps across pixel
and image borders, so the bilinear gather's zero padding is exercised.
Tolerance 1e-5 of the largest magnitude: both sides compute the same
products and differ only in summation order.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.ops import native as jn
from comfyui_keep_torch.ops import native as tn
from tests.torch_port_helpers import rel

torch.set_num_threads(2)
RTOL = 1e-5


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.as_tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _inputs(seed, n=2, c=8, h=9, w=11, dg=2, k=3, stride=1, padding=1,
            dilation=1):
    rng = np.random.default_rng(seed)
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((n, ho, wo, dg * 2 * k * k)) * 2).astype(
        np.float32)
    mask = rng.random((n, ho, wo, dg * k * k)).astype(np.float32)
    return rng, x, off, mask


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 1, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (1, 1, 1, 2)])
def test_deform_conv2d_matches_jax(modulated, stride, padding, dilation,
                                   groups):
    """DCNv1 (no mask) and DCNv2 (a mask per tap), with stride, dilation and
    grouped weights."""
    dg, k, c, cout = 2, 3, 8, 6
    rng, x, off, mask = _inputs(1, c=c, dg=dg, k=k, stride=stride,
                                padding=padding, dilation=dilation)
    w = (rng.standard_normal((k, k, c // groups, cout)) * 0.1).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, deformable_groups=dg)
    ref = np.asarray(jn.deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), jnp.asarray(b),
        mask=jnp.asarray(mask) if modulated else None, **kw))
    ours = tn.deform_conv2d(_nchw(x), _nchw(off), _oihw(w),
                            torch.as_tensor(b),
                            mask=_nchw(mask) if modulated else None, **kw)
    assert ours.shape == (ref.shape[0], cout) + ref.shape[1:3]
    assert np.abs(ref).max() > 0.1
    assert rel(_nhwc(ours), ref) <= RTOL


def test_deform_conv2d_zero_offsets_is_a_convolution():
    """With zero offsets and a unit mask DCNv2 is the plain convolution."""
    rng, x, off, mask = _inputs(2)
    w = (rng.standard_normal((3, 3, 8, 4)) * 0.1).astype(np.float32)
    ours = tn.deform_conv2d(_nchw(x), torch.zeros(_nchw(off).shape),
                            _oihw(w), padding=1, deformable_groups=2,
                            mask=torch.ones(_nchw(mask).shape))
    ref = torch.nn.functional.conv2d(_nchw(x), _oihw(w), padding=1)
    assert rel(ours.numpy(), ref.numpy()) <= RTOL


@pytest.mark.parametrize("max_residue_magnitude", [None, 10.0])
def test_dcn_v2_pack_matches_jax(max_residue_magnitude):
    """DCNv2Pack: offsets and mask from conv_offset on a second map (its
    channels o1, o2, mask), optionally bounded by max_residue_magnitude."""
    dg, k, c, cout, cf = 2, 3, 8, 6, 5
    rng, x, _, _ = _inputs(3, c=c, dg=dg, k=k)
    feat = rng.standard_normal(x.shape[:3] + (cf,)).astype(np.float32)
    cw = (rng.standard_normal((k, k, cf, dg * 3 * k * k)) * 0.3).astype(
        np.float32)
    cb = rng.standard_normal(dg * 3 * k * k).astype(np.float32)
    w = (rng.standard_normal((k, k, c, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(jn.dcn_v2_pack(
        jnp.asarray(x), jnp.asarray(feat),
        {"conv_offset": {"w": jnp.asarray(cw), "b": jnp.asarray(cb)},
         "w": jnp.asarray(w), "b": jnp.asarray(b)},
        deformable_groups=dg, max_residue_magnitude=max_residue_magnitude))
    ours = tn.dcn_v2_pack(_nchw(x), _nchw(feat), _oihw(w), torch.as_tensor(b),
                          _oihw(cw), torch.as_tensor(cb),
                          deformable_groups=dg,
                          max_residue_magnitude=max_residue_magnitude)
    assert np.abs(ref).max() > 0.1
    assert rel(_nhwc(ours), ref) <= RTOL


@pytest.mark.parametrize("max_displacement", [1, 4])
def test_correlation_matches_jax(max_displacement):
    rng = np.random.default_rng(4)
    f1, f2 = (rng.standard_normal((2, 9, 12, 16)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jn.correlation(jnp.asarray(f1), jnp.asarray(f2),
                                    max_displacement))
    ours = tn.correlation(_nchw(f1), _nchw(f2), max_displacement)
    assert ours.shape == (2, (2 * max_displacement + 1) ** 2, 9, 12)
    assert rel(_nhwc(ours), ref) <= RTOL
