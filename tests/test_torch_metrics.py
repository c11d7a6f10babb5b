"""The port's metrics and their helpers against the JAX package's, on the
CPU: utils/color.py (and the tensor twin rgb2ycbcr_pt), utils/matlab.py's
imresize, PSNR / SSIM (numpy forms and batched tensor twins), NIQE on the
Y channel and on gray, FID and calculate_metric (comfyui_keep_torch/
metrics).

The port runs with cv2 unimportable (sys.modules["cv2"] = None), as on a
machine without OpenCV; the JAX package's metrics call the installed cv2
(getGaussianKernel, filter2D, cvtColor) and are the oracle.

Tolerances: PSNR and SSIM within 1e-8 relative of the JAX numpy forms
(the port's SSIM filters directly where cv2's filter2D takes a DFT, and
its Gaussian taps may differ from OpenCV's soft-float exp in the last
bit); NIQE within 1e-6 relative; the tensor twins in float32 within 1e-5
relative of the JAX float32 twins, in float64 within 1e-8 relative of the
numpy forms (PSNR: of the numpy form's value with the twin's 1e-8 added
to its mean squared error; 1e-6 on the Y channel, which the numpy forms
convert in float32, as the reference's do); colour conversions and
imresize bitwise; FID within 1e-9 relative.
"""
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import comfyui_keep_tpu.metrics as jm
from comfyui_keep_tpu.metrics import fid as jfid
from comfyui_keep_tpu.metrics import niqe as jniqe
from comfyui_keep_tpu.utils import color as jcolor
from comfyui_keep_tpu.utils.matlab import imresize as jimresize
import comfyui_keep_torch.metrics as tm
from comfyui_keep_torch.metrics import fid as tfid
from comfyui_keep_torch.metrics import niqe as tniqe
from comfyui_keep_torch.models import inception as tinc
from comfyui_keep_torch.utils import color as tcolor
from comfyui_keep_torch.utils.matlab import imresize as timresize

torch.set_num_threads(2)


def pair(seed, h=64, w=48, c=3):
    """Two related uint8 images: a smooth-ish one and a noisy copy."""
    rng = np.random.default_rng(seed)
    a = (rng.random((h, w, c)) * 255).astype(np.uint8)
    noise = rng.normal(0, 12, (h, w, c))
    b = np.clip(a + noise, 0, 255).astype(np.uint8)
    return a, b


def relerr(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# -- colour and imresize ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_color_conversions_equal_jax(dtype):
    a, _ = pair(1)
    img = a if dtype == np.uint8 else a.astype(np.float32) / 255
    for name in ("rgb2ycbcr", "bgr2ycbcr"):
        for y_only in (False, True):
            np.testing.assert_array_equal(
                getattr(tcolor, name)(img, y_only),
                getattr(jcolor, name)(img, y_only))
    for name in ("ycbcr2rgb", "ycbcr2bgr"):
        np.testing.assert_array_equal(getattr(tcolor, name)(img),
                                      getattr(jcolor, name)(img))
    np.testing.assert_array_equal(tcolor.to_y_channel(a.astype(np.float32)),
                                  jcolor.to_y_channel(a.astype(np.float32)))


def test_rgb2ycbcr_pt_matches_jax_twin():
    x = np.random.default_rng(2).random((2, 8, 9, 3), dtype=np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    for y_only in (False, True):
        got = tcolor.rgb2ycbcr_pt(t, y_only).permute(0, 2, 3, 1).numpy()
        want = np.asarray(jcolor.rgb2ycbcr_jax(jnp.asarray(x), y_only))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale,shape", [(0.5, (37, 50)), (0.25, (64, 48, 3)),
                                         (2.0, (9, 7, 3)), (0.7, (30, 20))])
def test_imresize_equals_jax(scale, shape):
    img = np.random.default_rng(3).random(shape)
    for aa in (True, False):
        np.testing.assert_array_equal(timresize(img, scale, aa),
                                      jimresize(img, scale, aa))


# -- PSNR / SSIM -----------------------------------------------------------------------

@pytest.mark.parametrize("crop,y,order", [(0, False, "HWC"), (4, False, "HWC"),
                                          (4, True, "HWC"), (2, True, "CHW"),
                                          (0, False, "HW")])
def test_psnr_ssim_without_cv2_match_jax(crop, y, order, monkeypatch):
    a, b = pair(4)
    if order == "CHW":
        a, b = a.transpose(2, 0, 1), b.transpose(2, 0, 1)
    elif order == "HW":
        a, b = a[..., 0], b[..., 0]
    kw = dict(crop_border=crop, input_order="HWC" if order == "HW" else order,
              test_y_channel=y)
    want = (jm.calculate_psnr(a, b, **kw), jm.calculate_ssim(a, b, **kw))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = (tm.calculate_psnr(a, b, **kw), tm.calculate_ssim(a, b, **kw))
    assert relerr(got[0], want[0]) <= 1e-8
    assert relerr(got[1], want[1]) <= 1e-8
    assert tm.calculate_psnr(a, a, **kw) == float("inf")


@pytest.mark.parametrize("crop,y", [(0, False), (4, True)])
def test_psnr_ssim_twins_match_jax_and_numpy(crop, y, monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.random((3, 40, 36, 3), dtype=np.float32)
    x2 = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    want_psnr = np.asarray(jm.calculate_psnr_jax(jnp.asarray(x),
                                                 jnp.asarray(x2), crop, y))
    want_ssim = np.asarray(jm.calculate_ssim_jax(jnp.asarray(x),
                                                 jnp.asarray(x2), crop, y))
    monkeypatch.setitem(sys.modules, "cv2", None)
    t, t2 = (torch.from_numpy(v).permute(0, 3, 1, 2) for v in (x, x2))
    psnr = tm.calculate_psnr_pt(t, t2, crop, test_y_channel=y).numpy()
    ssim = tm.calculate_ssim_pt(t, t2, crop, test_y_channel=y).numpy()
    np.testing.assert_allclose(psnr, want_psnr, rtol=1e-5)
    np.testing.assert_allclose(ssim, want_ssim, rtol=1e-5)
    # float64 twins against the numpy forms (BGR, [0, 255], per image)
    p64 = tm.calculate_psnr_pt(t.double(), t2.double(), crop, y).numpy()
    s64 = tm.calculate_ssim_pt(t.double(), t2.double(), crop, y).numpy()
    tol = 1e-6 if y else 1e-8   # the numpy forms' Y conversion is float32
    for i in range(len(x)):
        a, b = (v[i, ..., ::-1].astype(np.float64) * 255 for v in (x, x2))
        mse01 = 10 ** (-tm.calculate_psnr(a, b, crop, test_y_channel=y) / 10)
        assert relerr(p64[i], 10 * np.log10(1 / (mse01 + 1e-8))) <= tol
        assert relerr(s64[i], tm.calculate_ssim(a, b, crop,
                                                test_y_channel=y)) <= tol


# -- NIQE ------------------------------------------------------------------------------

def face_like(seed, h=200, w=196):
    """A smooth BGR image with texture (NIQE's statistics need structure,
    not white noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 13.0)[
        ..., None] * np.array([1.0, 0.8, 0.6])
    return np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
        np.float32)


@pytest.mark.parametrize("convert_to", ["y", "gray"])
def test_niqe_without_cv2_matches_jax(convert_to, monkeypatch):
    img = face_like(6)
    want = jniqe.calculate_niqe(img, crop_border=2, convert_to=convert_to)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tniqe.calculate_niqe(img, crop_border=2, convert_to=convert_to)
    assert np.isfinite(got)
    assert relerr(got, want) <= 1e-6
    mu, cov = tniqe.load_pris_params()
    jmu, jcov = jniqe.load_pris_params()
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(cov, jcov)


# -- FID and calculate_metric ----------------------------------------------------------

def test_fid_matches_jax_on_port_inception_features(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    net = tinc.InceptionV3(device="cpu",
                           generator=torch.Generator().manual_seed(0))
    fn = tinc.make_fid_feature_fn(net)
    rng = np.random.default_rng(7)
    batches = [torch.from_numpy(rng.random((2, 3, 48, 40), dtype=np.float32))
               for _ in range(2)]
    feats = tfid.extract_inception_features(batches, fn)
    assert feats.shape == (4, 2048) and np.isfinite(feats).all()
    # two Gaussians of a 16-dim slice, full rank from 24 draws each
    f1 = feats[:, :16].repeat(6, 0) + rng.normal(0, 0.1, (24, 16))
    f2 = feats[:, 16:32].repeat(6, 0) + rng.normal(0, 0.1, (24, 16))
    s1, s2 = tfid.feature_stats(f1), tfid.feature_stats(f2)
    want = jfid.calculate_fid(*jfid.feature_stats(f1),
                              *jfid.feature_stats(f2))
    assert relerr(tm.calculate_fid(*s1, *s2), want) <= 1e-9
    assert relerr(tm.calculate_metric(
        {"mu1": s1[0], "sigma1": s1[1], "mu2": s2[0], "sigma2": s2[1]},
        {"type": "calculate_fid"}), want) <= 1e-9


def test_calculate_metric_dispatches_like_jax(monkeypatch):
    a, b = pair(8, 120, 112)
    opts = [{"type": "calculate_psnr", "crop_border": 4,
             "test_y_channel": True},
            {"type": "calculate_ssim", "crop_border": 0}]
    want = [jm.calculate_metric({"img": a, "img2": b}, o) for o in opts]
    want_niqe = jm.calculate_metric({"img": face_like(9)}, {
        "type": "calculate_niqe", "crop_border": 0})
    monkeypatch.setitem(sys.modules, "cv2", None)
    for o, w in zip(opts, want):
        assert relerr(tm.calculate_metric({"img": a, "img2": b}, o),
                      w) <= 1e-8
    assert relerr(tm.calculate_metric({"img": face_like(9)}, {
        "type": "calculate_niqe", "crop_border": 0}), want_niqe) <= 1e-6
    with pytest.raises(KeyError, match="Available"):
        tm.calculate_metric({}, {"type": "calculate_lpips"})
