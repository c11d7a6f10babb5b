"""The port's kernels (comfyui_keep_torch/ops/kernels.py): GMFlow's three,
the nearest-codebook search, the fused bias + leaky ReLU and the
phase-packed convolution.

On the CPU: each plain version against the JAX package's Pallas kernel run
in interpret mode (as tests/test_native_ops.py runs it) and against the JAX
non-Pallas branch, from one numpy seed. The CUDA kernels themselves are
tested on the card by tests/test_torch_kernels_cuda.py.
"""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import gmflow as jg
from comfyui_keep_tpu.ops import native as JN
from comfyui_keep_tpu.ops import pallas_kernels as P
from comfyui_keep_tpu.ops import phase_pack as JPP
from comfyui_keep_tpu.ops.norm import layer_norm as jlayer_norm
from comfyui_keep_torch.ops import kernels as K
from comfyui_keep_torch.ops import native as TN

torch.set_num_threads(2)
# f32: order of summation and exp2 vs exp; bf16: 4 ulps of 8-bit mantissas
TOL = {np.float32: dict(atol=3e-5, rtol=1e-5),
       "bf16": dict(atol=3e-2, rtol=1.6e-2)}


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _to(a, dtype):
    t = torch.as_tensor(a)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jx(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_plain_vs_pallas_interpret(dtype, with_bias):
    rng = np.random.default_rng(0)
    b, l, d = 4, 256, 128
    q, k, v = (_np(rng, b, l, d) for _ in range(3))
    bias = (jg.shifted_window_mask(32, 32, 2)[:2, :l, :l].copy()
            if with_bias else None)
    scale = 1.0 / math.sqrt(d)
    ours = K.attention_plain(_to(q, dtype), _to(k, dtype), _to(v, dtype),
                             scale, None if bias is None
                             else torch.as_tensor(bias))
    ref = P.attention_pallas(_jx(q, dtype), _jx(k, dtype), _jx(v, dtype),
                             scale, bias=None if bias is None
                             else jnp.asarray(bias), interpret=True)
    np.testing.assert_allclose(_f32(ours), _f32(ref), **TOL[dtype])


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_plain_vs_jax_sdpa_branch(with_bias):
    rng = np.random.default_rng(1)
    b, l, d = 4, 200, 64   # the plain version takes any shape
    q, k, v = (_np(rng, b, l, d) for _ in range(3))
    bias = _np(rng, 2, l, l, scale=3.0) if with_bias else None
    ours = K.attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), 0.125,
                             None if bias is None else torch.as_tensor(bias))
    ref = jg._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125,
                   bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_attention_narrow_v_matches_padded_pallas(dtype):
    """Global flow attention: V of width 2 directly, against the JAX
    package's zero-padded-to-128 form sliced back (gmflow.py:482-484)."""
    rng = np.random.default_rng(2)
    b, l, d = 2, 256, 128
    q, k = _np(rng, b, l, d), _np(rng, b, l, d)
    v = _np(rng, b, l, 2, scale=8.0)
    ours = K.attention_plain(_to(q, dtype), _to(k, dtype), _to(v, dtype),
                             1.0 / math.sqrt(d))
    vpad = np.concatenate([v, np.zeros((b, l, d - 2), np.float32)], -1)
    ref = P.attention_pallas(_jx(q, dtype), _jx(k, dtype), _jx(vpad, dtype),
                             1.0 / math.sqrt(d), interpret=True)[..., :2]
    tol = TOL[dtype] if dtype == np.float32 else dict(atol=0.1, rtol=1.6e-2)
    np.testing.assert_allclose(_f32(ours), _f32(ref), **tol)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_correlation_plain_vs_pallas_interpret(dtype):
    rng = np.random.default_rng(3)
    b, l, c = 2, 256, 128
    f0, f1 = _np(rng, b, l, c), _np(rng, b, l, c)
    grid = (rng.random((l, 2)) * 16).astype(np.float32)
    ours = K.global_correlation_expectation_plain(
        _to(f0, dtype), _to(f1, dtype), torch.as_tensor(grid))
    ref = P.global_correlation_expectation_pallas(
        _jx(f0, dtype), _jx(f1, dtype), jnp.asarray(grid), interpret=True)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=3e-4 * 16, rtol=1e-5)


def test_correlation_plain_vs_jax_einsum_branch():
    """Against global_correlation_softmax's non-Pallas branch (which also
    subtracts the grid)."""
    rng = np.random.default_rng(4)
    f0, f1 = _np(rng, 2, 8, 8, 128), _np(rng, 2, 8, 8, 128)
    grid = jg.coords_grid(8, 8).reshape(64, 2)
    ours = K.global_correlation_expectation_plain(
        torch.as_tensor(f0.reshape(2, 64, 128)),
        torch.as_tensor(f1.reshape(2, 64, 128)),
        torch.as_tensor(np.array(grid)))
    ref, _ = jg.global_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1))
    np.testing.assert_allclose(
        ours.numpy() - np.asarray(grid), np.asarray(ref).reshape(2, 64, 2),
        atol=2e-5, rtol=1e-5)


def _mlp_inputs(seed, b=2, l=300, c=128, h=512):
    """(src, msg, w1a, w1b, w2, gamma, beta) in the Pallas kernel's layout:
    w1a, w1b (C, H), w2 (H, C)."""
    rng = np.random.default_rng(seed)
    return (_np(rng, b, l, c), _np(rng, b, l, c), _np(rng, c, h, scale=0.05),
            _np(rng, c, h, scale=0.05), _np(rng, h, c, scale=0.05),
            _np(rng, c), _np(rng, c))


def _linear_layout(src, msg, w1a, w1b, w2, gamma, beta):
    """The same in nn.Linear's layout, which mlp_fused takes: W1 (H, 2C)
    and W2 (C, H)."""
    w1 = np.ascontiguousarray(np.concatenate([w1a, w1b], 0).T)
    return src, msg, w1, np.ascontiguousarray(w2.T), gamma, beta


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_mlp_tanh_plain_vs_pallas_interpret(dtype):
    args = _mlp_inputs(5)
    ours = K.mlp_fused_plain(*(_to(a, dtype) for a in _linear_layout(*args)),
                             approximate=True)
    ref = P.mlp_fused_pallas(*(_jx(a, dtype) for a in args), block=128,
                             interpret=True)
    tol = (dict(atol=2e-4, rtol=1e-3) if dtype == np.float32
           else dict(atol=6e-2, rtol=1.6e-2))
    np.testing.assert_allclose(_f32(ours), _f32(ref), **tol)


def test_mlp_erf_plain_vs_jax_unfused_branch():
    """approximate=False is what the JAX package computes in f32
    (gmflow.py:336-337): erf gelu, unfused."""
    src, msg, w1a, w1b, w2, g, b = _mlp_inputs(6)
    ours = K.mlp_fused_plain(*map(torch.as_tensor, _linear_layout(
        src, msg, w1a, w1b, w2, g, b)), approximate=False)
    hmid = jax.nn.gelu(jnp.asarray(src) @ w1a + jnp.asarray(msg) @ w1b,
                       approximate=False)
    ref = src + jlayer_norm(hmid @ w2, {"scale": jnp.asarray(g),
                                        "bias": jnp.asarray(b)})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-3)


def _margin(d):
    """Least gap between the smallest and second-smallest entry of each
    row, relative to max|d|."""
    s = np.sort(d, axis=-1)
    return (s[:, 1] - s[:, 0]).min() / np.abs(d).max()


@pytest.mark.parametrize("t", [300, 1000])
def test_vq_plain_vs_pallas_interpret_and_xla_branch(t):
    """Exact picks against the Pallas kernel in interpret mode and the
    dispatcher's XLA branch (as tests/test_native_ops.py runs them), on a
    seed whose distance gaps are asserted first to exceed f32 rounding
    (1e-6 of max|d|) by far."""
    rng = np.random.default_rng(10 + t)
    z = rng.standard_normal((t, 32)).astype(np.float32)
    cb = rng.standard_normal((64, 32)).astype(np.float32)
    e2 = (cb.astype(np.float64) ** 2).sum(-1)
    assert _margin(e2 - 2.0 * z.astype(np.float64) @ cb.T) > 1e-6
    ours = K.vq_nearest_indices_plain(torch.as_tensor(z), torch.as_tensor(cb))
    assert ours.dtype == torch.int32 and ours.shape == (t,)
    xla = P.vq_nearest_indices(jnp.asarray(z), jnp.asarray(cb),
                               force_xla=True)
    pallas = P.vq_nearest_indices_pallas(jnp.asarray(z), jnp.asarray(cb),
                                         tile=128, interpret=True)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(pallas))


def test_vq_plain_bf16_vs_pallas_interpret():
    """bf16 inputs: products exact in f32, ||e||^2 in f32, as the Pallas
    kernel computes them."""
    rng = np.random.default_rng(12)
    z = rng.standard_normal((200, 64)).astype(np.float32)
    cb = rng.standard_normal((128, 64)).astype(np.float32)
    zb, cbb = _to(z, "bf16"), _to(cb, "bf16")
    ours = K.vq_nearest_indices_plain(zb, cbb)
    ref = P.vq_nearest_indices_pallas(_jx(z, "bf16"), _jx(cb, "bf16"),
                                      tile=128, interpret=True)
    d = (K.codebook_sq_norms(cbb) - 2.0 * zb.float() @ cbb.float().t()
         ).numpy()
    assert _margin(d) > 1e-6
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_vq_ties_go_to_the_lowest_index():
    cb = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    cb[40:48] = cb[0:8]
    z = cb[40:48] + 0.01
    np.testing.assert_array_equal(K.vq_nearest_indices_plain(z, cb).numpy(),
                                  np.arange(8))


def _flr_inputs(seed, shape=(2, 16, 5, 6)):
    """x (N, C, H, W) with h = x + b near zero in places, and b (C,)."""
    rng = np.random.default_rng(seed)
    x = _np(rng, *shape)
    x.reshape(-1)[::7] = 0.0
    b = _np(rng, shape[1])
    return x, b


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 5, 6), (3, 24)])
def test_fused_bias_lrelu_plain_vs_pallas_interpret(dtype, shape):
    """Against fused_bias_lrelu_pallas in interpret mode (channels last, as
    tests/test_native_ops.py runs it). f32: atol 1e-6 as there. bf16: the
    Pallas body adds and scales in bf16 (three roundings), the plain
    version in f32 with one: within 2 bf16 ulps (2 ** -6 relative)."""
    x, b = _flr_inputs(20, shape)
    ours = K.fused_bias_lrelu_plain(_to(x, dtype), _to(b, dtype))
    ref = P.fused_bias_lrelu_pallas(_jx(_nhwc(x), dtype), _jx(b, dtype),
                                    interpret=True)
    assert ours.dtype == (torch.bfloat16 if dtype == "bf16"
                          else torch.float32)
    tol = (dict(atol=1e-6, rtol=0) if dtype == np.float32
           else dict(atol=1e-6, rtol=2 ** -6))
    np.testing.assert_allclose(_nhwc(_f32(ours)), _f32(ref), **tol)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_fused_leaky_relu_forward_grad_and_second_order_vs_jax(dtype):
    """ops/native.py fused_leaky_relu (K5's plain version forward, the
    custom backward) against the JAX package's custom-VJP op: the value,
    the x- and bias-gradients of sum(out^2 * w), and a second-order term,
    d/d(x, b) of sum(gx * v) for that gradient gx (what R1 and the path
    penalty differentiate). The JAX op computes in x's dtype; the bf16 case
    compares at bf16's resolution."""
    x, b = _flr_inputs(21)
    rng = np.random.default_rng(22)
    w, v = _np(rng, *x.shape), _np(rng, *x.shape)

    def jf(xx, bb):
        return jnp.sum(JN.fused_leaky_relu(xx, bb).astype(jnp.float32) ** 2
                       * _nhwc(w))

    def jsecond(xx, bb):
        gx = jax.grad(jf)(xx, bb).astype(jnp.float32)
        return jnp.sum(gx * _nhwc(v))

    jx, jb = _jx(_nhwc(x), dtype), _jx(b, dtype)
    jout = JN.fused_leaky_relu(jx, jb)
    jgx, jgb = jax.grad(jf, argnums=(0, 1))(jx, jb)
    jhx, jhb = jax.grad(jsecond, argnums=(0, 1))(jx, jb)

    xt = _to(x, dtype).requires_grad_(True)
    bt = _to(b, dtype).requires_grad_(True)
    out = TN.fused_leaky_relu(xt, bt)
    f = (out.float() ** 2 * torch.as_tensor(w)).sum()
    gx, gb = torch.autograd.grad(f, (xt, bt), create_graph=True)
    hx, hb = torch.autograd.grad((gx.float() * torch.as_tensor(v)).sum(),
                                 (xt, bt))
    if dtype == np.float32:
        tol = dict(atol=1e-6, rtol=0)
        gtol = dict(atol=1e-5, rtol=1e-6)
    else:
        tol = gtol = dict(atol=2e-2, rtol=2 ** -6)
    np.testing.assert_allclose(_nhwc(_f32(out)), _f32(jout), **tol)
    np.testing.assert_allclose(_nhwc(_f32(gx)), _f32(jgx), **gtol)
    np.testing.assert_allclose(_f32(gb), _f32(jgb), **dict(
        gtol, atol=gtol["atol"] * x.size / b.size))
    np.testing.assert_allclose(_nhwc(_f32(hx)), _f32(jhx), **gtol)
    np.testing.assert_allclose(_f32(hb), _f32(jhb), **dict(
        gtol, atol=gtol["atol"] * x.size / b.size))
    assert np.abs(_f32(hx)).max() > 0   # the second order is not vacuous


def test_fused_leaky_relu_backward_keys_on_h_not_on_the_output():
    """At h = x + b = 0 the output is 0 and the gradient takes the positive
    branch (h >= 0), as the JAX op's residual does."""
    x = torch.tensor([[-1.0, 0.5]], requires_grad=True)
    b = torch.tensor([1.0, -0.5], requires_grad=True)
    out = TN.fused_leaky_relu(x, b)
    assert out.abs().max() == 0
    gx, = torch.autograd.grad(out.sum(), x)
    np.testing.assert_allclose(gx.numpy(), [[2 ** 0.5, 2 ** 0.5]], rtol=1e-7)


def _pallas_conv(x, w, br):
    """tools/_prof_packedconv.py's pallas_conv (body _kernel), copied with
    its shape constants as arguments (importing the script runs its TPU
    timing): the VALID 2x2 convolution of x (H, H, CI) by w (2, 2, CI, CO)
    as four shifted GEMMs summed in f32, BR output rows per grid step."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    h, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
    n_out = h - 1

    def kernel(xt_ref, xb_ref, w_ref, o_ref):
        wj = w_ref[...]
        acc = jnp.zeros((br * n_out, co), jnp.float32)
        for ty, xr in ((0, xt_ref), (1, xb_ref)):
            blk = xr[...]
            for tx in (0, 1):
                a = blk[:, tx:tx + n_out, :].reshape(br * n_out, ci)
                acc += jnp.dot(a, wj[ty, tx], preferred_element_type=jnp.float32)
        o_ref[...] = acc.astype(o_ref.dtype).reshape(br, n_out, co)

    return pl.pallas_call(
        kernel, grid=(n_out // br,),
        in_specs=[pl.BlockSpec((br, h, ci), lambda j: (j, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((br, h, ci), lambda j: (j, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((2, 2, ci, co), lambda j: (0, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((br, n_out, co), lambda j: (j, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_out, n_out, co), x.dtype),
        interpret=True)(x[:-1], x[1:], w)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("h,ci,co,br", [(17, 32, 16, 8), (9, 12, 24, 4)])
def test_packed_conv_plain_vs_pallas_interpret(dtype, h, ci, co, br):
    """K6's plain version against the Pallas kernel in interpret mode, at
    K6's own form (a parity-1 packed input, VALID 2x2) cut to small shapes.
    f32: summation order; bf16: both round the f32 sum once (1 ulp)."""
    rng = np.random.default_rng(30)
    x = _np(rng, h, h, ci)
    w = _np(rng, 2, 2, ci, co, scale=0.05)
    ours = K.packed_conv2x2_plain(_to(x, dtype)[None], _to(w, dtype),
                                  ((0, 0), (0, 0)))[0]
    ref = _pallas_conv(_jx(x, dtype), _jx(w, dtype), br)
    assert ours.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == np.float32
           else dict(atol=1e-2, rtol=2 ** -7))
    np.testing.assert_allclose(_f32(ours), _f32(ref), **tol)


PADS = [((pt, pb), (pl_, pr)) for pt in (0, 1) for pb in (0, 1)
        for pl_ in (0, 1) for pr in (0, 1)]


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("taps", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_packed_conv_plain_vs_xla_conv(dtype, taps):
    """K6's plain version against tools/_prof_packedconv.py's xla_conv
    reference (lax.conv_general_dilated, NHWC / HWIO) for every taps and
    pads combination the kernel takes, at channel counts that are multiples
    of 4 but not of 8 or 32 (the packed first and last convolutions' 12)."""
    rng = np.random.default_rng(31)
    for cin, cout in ((12, 20), (36, 12)):
        x = _np(rng, 2, 7, 9, cin)
        w = _np(rng, *taps, cin, cout, scale=0.1)
        for pads in PADS:
            ours = K.packed_conv2x2_plain(_to(x, dtype), _to(w, dtype), pads)
            ref = jax.lax.conv_general_dilated(
                _jx(x, dtype), _jx(w, dtype), (1, 1), list(pads),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            assert tuple(ours.shape) == ref.shape, pads
            tol = (dict(atol=1e-5, rtol=1e-5) if dtype == np.float32
                   else dict(atol=1e-2, rtol=2 ** -7))
            np.testing.assert_allclose(_f32(ours), _f32(ref), **tol,
                                       err_msg=str(pads))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("op", ["conv_p0", "conv_p1", "upconv", "down"])
def test_packed_conv_plain_fused_epilogue_vs_jax_packed_ops(dtype, op):
    """K6's plain version with the fused epilogue, packed_conv2x2_plain(x,
    w, pads, bias, mask_c), against the JAX package's packed ops
    (comfyui_keep_tpu/ops/phase_pack.py: packed_conv at both parities,
    packed_upconv, packed_downsample), pad half-cells included. f32: the
    order of summation (1e-5). bf16: the JAX ops round the convolution and
    then its sum with the bias, the plain version the f32 sum once, so they
    differ by at most one bf16 rounding of each: 2 ** -7 of the output's
    largest magnitude."""
    rng = np.random.default_rng(32)
    c = 8
    x = _np(rng, 2, 9, 9, 4 * c)
    w3, b = _np(rng, 3, 3, c, c, scale=0.1), _np(rng, c)
    pads = ((1, 1), (1, 1))
    if op == "upconv":
        x = x[..., :c]
        pw, pb = JPP.pack_upconv3x3(w3, b)
        ref = JPP.packed_upconv(_jx(x, dtype), _jx(pw, dtype), _jx(pb, dtype))
        mask_c = c
    elif op == "down":
        pw, pb = JPP.pack_downsample3x3(w3, b)
        xm = np.array(JPP.mask_parity1(x, c))   # a parity-1 input
        x, pads, mask_c = xm, ((0, 0), (0, 0)), None
        ref = JPP.packed_downsample(_jx(x, dtype), _jx(pw, dtype),
                                    _jx(pb, dtype))
    else:
        parity = int(op[-1])
        pw, pb = JPP.pack_conv3x3(w3, b)
        if parity:
            x, pads, mask_c = np.array(JPP.mask_parity1(x, c)), \
                ((0, 0), (0, 0)), None
        else:
            mask_c = c
        ref = JPP.packed_conv(_jx(x, dtype), _jx(pw, dtype), _jx(pb, dtype),
                              parity)
    ours = K.packed_conv2x2_plain(_to(x, dtype), _to(pw, dtype), pads,
                                  bias=_to(pb, dtype), mask_c=mask_c)
    ref = _f32(ref)
    assert tuple(ours.shape) == ref.shape
    assert ours.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    if mask_c is not None:   # the pad half-cells are exact zeros in both
        pad = K.mask_parity1_(torch.ones(ours.shape), mask_c).numpy() == 0
        assert pad.any() and not _f32(ours)[pad].any() and not ref[pad].any()
    atol = 1e-5 if dtype == np.float32 else 2 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(_f32(ours), ref, atol=atol, rtol=0)


def test_packed_conv_plain_keeps_float64():
    x = torch.randn(1, 5, 5, 8, dtype=torch.float64)
    w = torch.randn(2, 2, 8, 4, dtype=torch.float64)
    got = K.packed_conv2x2_plain(x, w, ((1, 0), (0, 1)))
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 1, 0)),
        w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(_np(rng, 2, 64, 128)) for _ in range(3))
    grid = torch.as_tensor(rng.random((64, 2)).astype(np.float32))
    args = tuple(map(torch.as_tensor, _linear_layout(*_mlp_inputs(8, l=64))))
    K.reset_launch_counts()
    torch.testing.assert_close(K.attention(q, k, v, 0.1),
                               K.attention_plain(q, k, v, 0.1), rtol=0, atol=0)
    torch.testing.assert_close(
        K.global_correlation_expectation(q, k, grid),
        K.global_correlation_expectation_plain(q, k, grid), rtol=0, atol=0)
    torch.testing.assert_close(K.mlp_fused(*args, approximate=False),
                               K.mlp_fused_plain(*args, approximate=False),
                               rtol=0, atol=0)
    z, cb = q[0, :, :32].contiguous(), k[0].reshape(256, 32)[:64]
    torch.testing.assert_close(K.vq_nearest_indices(z, cb),
                               K.vq_nearest_indices_plain(z, cb),
                               rtol=0, atol=0)
    torch.testing.assert_close(K.fused_bias_lrelu(q, q[0, :, 0]),
                               K.fused_bias_lrelu_plain(q, q[0, :, 0]),
                               rtol=0, atol=0)
    x, w = q.reshape(2, 8, 8, 128), k[0].reshape(2, 2, 128, 16)
    torch.testing.assert_close(K.packed_conv2x2(x, w, ((1, 1), (1, 1))),
                               K.packed_conv2x2_plain(x, w, ((1, 1), (1, 1))),
                               rtol=0, atol=0)
    bias = q[1, 0, :16]
    torch.testing.assert_close(
        K.packed_conv2x2(x, w, ((1, 1), (1, 1)), bias, 4),
        K.packed_conv2x2_plain(x, w, ((1, 1), (1, 1)), bias, 4),
        rtol=0, atol=0)
    assert set(K.LAUNCHES.values()) == {0}
    assert "packed_conv2x2" in K.LAUNCHES and "packed_conv2x2" in K.PLAIN


# ---------------------------------------------------------------------------
# K1's dense bf16 kernel (csrc/attention.cu flash_attention_bf16_kernel):
# its online softmax, modelled in numpy at its key-tile width
# ---------------------------------------------------------------------------

KERNEL_KEYS = 128           # csrc/attention.cu kWaKeys: keys a tile
KERNEL_RTOL_BF16 = 1.6e-2   # chip_smoke.py KERNEL_RTOL["bfloat16"]


def _bf16_round(x):
    """x (f32) rounded to bf16, to nearest even, as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _online_softmax_model(q, k, v, scale, bias=None, rescale=True):
    """The kernel's order of operations: f32 scores in log2 units (bias
    times log2 e), then per key tile of KERNEL_KEYS the running max m, P =
    2^(x - m) rounded to bf16 against that running max, O += P V and the
    running sum l += sum P in f32, both first rescaled by 2^(m_old - m_new)
    when m moves (rescale=False drops that rescale); one normalisation at
    the end, the output rounded to bf16. Returns (out, lse), lse = m +
    log2 l."""
    b, n, _ = q.shape
    x = np.matmul(q, k.transpose(0, 2, 1)) * np.float32(scale / math.log(2))
    if bias is not None:
        x = x + np.tile(bias, (b // bias.shape[0], 1, 1)) * np.float32(
            1 / math.log(2))
    m = np.full((b, n), -np.inf, np.float32)
    l = np.zeros((b, n), np.float32)
    o = np.zeros((b, n, v.shape[-1]), np.float32)
    for k0 in range(0, n, KERNEL_KEYS):
        xt = x[:, :, k0:k0 + KERNEL_KEYS]
        mn = np.maximum(m, xt.max(-1))
        a = np.exp2(m - mn) if rescale else np.ones_like(m)
        p = np.exp2(xt - mn[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + np.matmul(_bf16_round(p),
                                         v[:, k0:k0 + KERNEL_KEYS])
        m = mn
    return _bf16_round(o / l[..., None]), m + np.log2(l)


def _peaked_inputs(seed, b=4, n=1024, d=128):
    """bf16-valued q, k, v as chip_smoke.py's matched_keys makes them: key
    perm[i] = 0.8 q[i] + unit noise, so each softmax row puts about half its
    mass on one key and its running max moves between key tiles."""
    rng = np.random.default_rng(seed)
    q = _bf16_round(_np(rng, b, n, d))
    k = np.empty_like(q)
    k[:, rng.permutation(n)] = 0.8 * q + _np(rng, b, n, d)
    return q, _bf16_round(k), _bf16_round(_np(rng, b, n, d))


def _within(got, ref):
    """max|got - ref| and chip_smoke.py's tolerance for it: the bf16 rtol of
    the reference's spread, max|ref - mean(ref)|."""
    return (np.abs(got - ref).max(),
            KERNEL_RTOL_BF16 * np.abs(ref - ref.mean()).max())


def _float64_attention(q, k, v, scale, bias):
    x = np.matmul(q.astype(np.float64), k.transpose(0, 2, 1)) * scale
    if bias is not None:
        x = x + np.tile(bias, (q.shape[0] // bias.shape[0], 1, 1))
    p = np.exp(x - x.max(-1, keepdims=True))
    return np.matmul(p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("with_bias", [False, True])
def test_online_softmax_model_matches_plain_and_float64(with_bias):
    """The kernel's softmax order at its 128-key tiles stays within the bf16
    tolerance of the plain version (which rounds P against the row's final
    max) and of float64, on peaked keys at L = 1024 (the window attention's
    length), unmasked and under the (4, L, L) shifted-window mask; its lse
    matches attention_stats_plain's."""
    q, k, v = _peaked_inputs(5)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bias = (jg.shifted_window_mask(64, 64, 2).astype(np.float32)
            if with_bias else None)
    out, lse = _online_softmax_model(q, k, v, scale, bias)
    tb = None if bias is None else torch.as_tensor(bias)
    plain, plain_lse = K.attention_stats_plain(
        *(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)), scale,
        tb)
    err, tol = _within(out, plain.float().numpy())
    assert err <= tol, (err, tol)
    err, tol = _within(out, _float64_attention(q, k, v, scale, bias))
    assert err <= tol, (err, tol)
    np.testing.assert_allclose(lse, plain_lse.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("with_bias", [False, True])
def test_online_softmax_model_without_rescale_breaks_tolerance(with_bias):
    """Control: the same model without the rescale of O and of the running
    sum when the running max moves is far outside the tolerance on the same
    inputs, so the tests above see the rescale."""
    q, k, v = _peaked_inputs(5)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bias = (jg.shifted_window_mask(64, 64, 2).astype(np.float32)
            if with_bias else None)
    out, _ = _online_softmax_model(q, k, v, scale, bias, rescale=False)
    err, tol = _within(out, _float64_attention(q, k, v, scale, bias))
    assert err > 10 * tol, (err, tol)
