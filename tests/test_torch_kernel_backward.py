"""The plain versions of the port's backward kernels (ops/kernels.py:
attention_backward_plain, global_correlation_expectation_backward_plain,
mlp_fused_backward_plain), on the CPU, from the statistics their forwards
save (attention_stats_plain and the like):

- against torch autograd of the plain forward on the same inputs: within
  1e-12 of the largest gradient magnitude in float64, 1e-5 in f32 (the
  backward rebuilds the softmax from the saved log-sum-exp and sums in
  another order);
- against jax.vjp of the JAX package's plain branch on the same numpy
  inputs, f32 on both sides, within 2e-5 of the largest magnitude (the
  two sum in other orders): `_sdpa` over windows with and without the
  shifted mask, the global flow attention (`flow_attention`, whose key is
  k_proj(q_proj(x)), chained through its two projections; the key bias,
  whose true gradient is zero, within 2e-5 of the call's largest), the
  flow of
  `global_correlation_softmax` and the unfused MLP branch of a transformer
  sublayer.

Small shapes: GMFlow's kernels need D = 128 on the card, their plain
versions any width.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_keep_tpu.models import gmflow as jg
from comfyui_keep_tpu.ops.act import gelu as jgelu
from comfyui_keep_tpu.ops.norm import layer_norm as jlayer_norm
from comfyui_keep_torch.ops import kernels as K
from tests.torch_port_helpers import mm_1xtf32 as _mm_1xtf32
from tests.torch_port_helpers import mm_3xtf32 as _mm_3xtf32

torch.set_num_threads(1)
AUTOGRAD_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JAX_RTOL = 2e-5
FORMS = ("window", "window+mask", "global", "correlation", "mlp_erf",
         "mlp_tanh")


def _inputs(form, rng):
    """(plain forward, its stats form, plain backward, the inputs (numpy,
    f64), the indices that take a gradient)."""
    def a(*s, scale=1.0):
        return rng.standard_normal(s) * scale

    if form.startswith("mlp"):
        c, h = 8, 32
        args = (a(2, 10, c), a(2, 10, c), a(h, 2 * c, scale=0.3),
                a(c, h, scale=0.3), a(c), a(c), form == "mlp_tanh")
        return (K.mlp_fused_plain, K.mlp_fused_stats_plain,
                K.mlp_fused_backward_plain, args, range(6))
    if form == "correlation":
        ys, xs = np.meshgrid(np.arange(4.0), np.arange(5.0), indexing="ij")
        grid = np.stack([xs, ys], -1).reshape(20, 2)
        return (K.global_correlation_expectation_plain,
                K.global_correlation_expectation_stats_plain,
                K.global_correlation_expectation_backward_plain,
                (a(3, 20, 16), a(3, 20, 16), grid), range(2))
    dv = 2 if form == "global" else 16
    bias = (np.where(rng.random((2, 24, 24)) < 0.3, -100.0, 0.0)
            if form == "window+mask" else None)
    return (K.attention_plain, K.attention_stats_plain,
            K.attention_backward_plain,
            (a(4, 24, 16), a(4, 24, 16), a(4, 24, dv, scale=3.0), 0.25, bias),
            range(3))


def _torch(args, dtype, diff):
    """numpy inputs as tensors: those that take a gradient (and the MLP's
    LayerNorm affine) in dtype, the mask and the grid f32 as the kernels
    take them (exact values: 0 / -100, pixel coordinates)."""
    return [torch.tensor(x, dtype=dtype if i in diff else torch.float32)
            if isinstance(x, np.ndarray) else x for i, x in enumerate(args)]


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", FORMS)
def test_plain_backward_equals_autograd_of_plain_forward(form, dtype):
    plain, stats, backward, args, diff = _inputs(
        form, np.random.default_rng(FORMS.index(form)))
    args = _torch(args, dtype, diff)
    leaves = [x.clone().requires_grad_(True) if i in diff else x
              for i, x in enumerate(args)]
    out = plain(*leaves)
    assert out.dtype == dtype
    g = torch.tensor(np.random.default_rng(7).standard_normal(out.shape),
                     dtype=out.dtype)
    want = torch.autograd.grad(out, [leaves[i] for i in diff], g)
    got = backward(*args, *stats(*args), g)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _rel(x, y) <= AUTOGRAD_RTOL[dtype]


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("mask", [False, True])
def test_attention_backward_plain_vs_jax_vjp_sdpa(mask):
    rng = np.random.default_rng(20 + mask)
    q, k, v = (_f32(rng.standard_normal((4, 24, 16))) for _ in range(3))
    bias = (_f32(np.where(rng.random((2, 24, 24)) < 0.3, -100.0, 0.0))
            if mask else None)
    g = _f32(rng.standard_normal((4, 24, 16)))
    scale = 1.0 / math.sqrt(16)
    out, vjp = jax.vjp(lambda a, b_, c: jg._sdpa(
        a, b_, c, scale, None if bias is None else jnp.asarray(bias)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    t = [torch.as_tensor(x) for x in (q, k, v)]
    tb = None if bias is None else torch.as_tensor(bias)
    o, lse = K.attention_stats_plain(*t, scale, tb)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-6 * 3,
                               rtol=1e-5)
    got = K.attention_backward_plain(*t, scale, tb, o, lse,
                                     torch.as_tensor(g))
    for x, y in zip(got, want):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= JAX_RTOL * np.abs(y).max()


def test_attention_backward_plain_vs_jax_vjp_global_flow_attention():
    """The global flow attention of GMFlow's propagation: JAX's
    flow_attention (q = q_proj(x), k = k_proj(q), V the flow) against the
    plain backward chained through the two projections by hand."""
    rng = np.random.default_rng(30)
    b, h, w, c = 2, 4, 6, 16
    x = _f32(rng.standard_normal((b, h, w, c)))
    flow = _f32(rng.standard_normal((b, h, w, 2)) * 3)
    wq, wk = (_f32(rng.standard_normal((c, c)) * 0.3) for _ in range(2))
    bq, bk = (_f32(rng.standard_normal(c) * 0.1) for _ in range(2))
    g = _f32(rng.standard_normal((b, h, w, 2)))
    p = {"q_proj": {"w": jnp.asarray(wq), "b": jnp.asarray(bq)},
         "k_proj": {"w": jnp.asarray(wk), "b": jnp.asarray(bk)}}
    out, vjp = jax.vjp(lambda pp, f0, fl: jg.flow_attention(pp, f0, fl), p,
                       jnp.asarray(x), jnp.asarray(flow))
    dp, dx, dflow = vjp(jnp.asarray(g))
    tx = torch.as_tensor(x).reshape(b, h * w, c)
    q = tx @ torch.as_tensor(wq) + torch.as_tensor(bq)
    kk = q @ torch.as_tensor(wk) + torch.as_tensor(bk)
    v = torch.as_tensor(flow).reshape(b, h * w, 2)
    scale = 1.0 / math.sqrt(c)
    o, lse = K.attention_stats_plain(q, kk, v, scale)
    np.testing.assert_allclose(o.reshape(b, h, w, 2).numpy(),
                               np.asarray(out), atol=1e-5, rtol=1e-5)
    dq, dk, dv = K.attention_backward_plain(
        q, kk, v, scale, None, o, lse, torch.as_tensor(g).reshape(b, -1, 2))
    dq = dq + dk @ torch.as_tensor(wk).t()
    got = {"x": (dq @ torch.as_tensor(wq).t()).reshape(b, h, w, c),
           "flow": dv.reshape(b, h, w, 2),
           "wq": torch.einsum("blc,bld->cd", tx, dq),
           "bq": dq.sum((0, 1)),
           "wk": torch.einsum("blc,bld->cd", q, dk), "bk": dk.sum((0, 1))}
    want = {"x": dx, "flow": dflow, "wq": dp["q_proj"]["w"],
            "bq": dp["q_proj"]["b"], "wk": dp["k_proj"]["w"],
            "bk": dp["k_proj"]["b"]}
    # the key bias's true gradient is zero (a shift of every score of a
    # row, under the softmax): rounding noise on both sides, held to the
    # largest gradient of the call
    top = max(np.abs(np.asarray(y)).max() for y in want.values())
    for n, y in want.items():
        y = np.asarray(y)
        lim = JAX_RTOL * (top if n == "bk" else np.abs(y).max())
        assert np.abs(got[n].numpy() - y).max() <= lim, n


def test_correlation_backward_plain_vs_jax_vjp_global_correlation_softmax():
    rng = np.random.default_rng(40)
    b, h, w, c = 2, 4, 5, 16
    f0, f1 = (_f32(rng.standard_normal((b, h, w, c))) for _ in range(2))
    g = _f32(rng.standard_normal((b, h, w, 2)))
    flow, vjp = jax.vjp(lambda a, b_: jg.global_correlation_softmax(a, b_)[0],
                        jnp.asarray(f0), jnp.asarray(f1))
    want = vjp(jnp.asarray(g))
    ys, xs = torch.meshgrid(torch.arange(float(h)), torch.arange(float(w)),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(h * w, 2)
    t0, t1 = (torch.as_tensor(x).reshape(b, h * w, c) for x in (f0, f1))
    o, lse = K.global_correlation_expectation_stats_plain(t0, t1, grid)
    np.testing.assert_allclose((o - grid).reshape(b, h, w, 2).numpy(),
                               np.asarray(flow), atol=1e-5, rtol=1e-5)
    got = K.global_correlation_expectation_backward_plain(
        t0, t1, grid, o, lse, torch.as_tensor(g).reshape(b, h * w, 2))
    for x, y in zip(got, want):
        y = np.asarray(y).reshape(b, h * w, c)
        assert np.abs(x.numpy() - y).max() <= JAX_RTOL * np.abs(y).max()


def test_mlp_backward_plain_vs_jax_vjp_unfused_branch():
    """The unfused MLP branch of a transformer sublayer in f32 (gmflow.py
    :302-303, erf gelu), as test_mlp_erf_plain_vs_jax_unfused_branch
    builds it, with W1 split at C and the weights in the JAX layout."""
    rng = np.random.default_rng(50)
    c, hd = 16, 64
    src, msg = (_f32(rng.standard_normal((2, 30, c))) for _ in range(2))
    w1a, w1b = (_f32(rng.standard_normal((c, hd)) * 0.2) for _ in range(2))
    w2 = _f32(rng.standard_normal((hd, c)) * 0.2)
    gm, bt = _f32(rng.standard_normal(c)), _f32(rng.standard_normal(c))
    g = _f32(rng.standard_normal((2, 30, c)))

    def branch(s, m, a1, b1, a2, sc, bi):
        hmid = jgelu(s @ a1 + m @ b1, approximate=False)
        return s + jlayer_norm(hmid @ a2, {"scale": sc, "bias": bi})
    out, vjp = jax.vjp(branch, *map(jnp.asarray, (src, msg, w1a, w1b, w2,
                                                  gm, bt)))
    d = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    want = [d[0], d[1], np.concatenate([d[2], d[3]], 0).T, d[4].T, d[5], d[6]]
    args = [torch.as_tensor(x) for x in (
        src, msg, np.ascontiguousarray(np.concatenate([w1a, w1b], 0).T),
        np.ascontiguousarray(w2.T), gm, bt)]
    o_out, o = K.mlp_fused_stats_plain(*args, False)
    np.testing.assert_allclose(o_out.numpy(), np.asarray(out), atol=2e-5,
                               rtol=1e-5)
    got = K.mlp_fused_backward_plain(*args, False, o_out, o,
                                     torch.as_tensor(g))
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert np.abs(x.numpy() - y).max() <= JAX_RTOL * np.abs(y).max()


# ---------------------------------------------------------------------------
# A model of the backward kernels' rounding on the tensor cores
# ---------------------------------------------------------------------------
#
# csrc/attention_bwd.cu computes its products on the tensor cores: bf16
# inputs as exact bf16 products with f32 sums, dS (an f32 value) fed to
# dQ = scale dS K and dK = scale dS^T Q as a bf16 hi part plus a bf16 lo
# part; f32 inputs by 3xTF32, each operand x = hi + lo (hi x rounded to 11
# significant bits, lo = x - hi) and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
# with every operand's low 13 mantissa bits dropped by the tensor core. The
# f32 kernel streams 16-row tiles (ATTN_F32_TILE): dQ, dK and (D_v = 128)
# dV are each tile's product from zero, the tiles added in f32 in order.
# csrc/mlp.cu's backward (K2) does the same with its products: in bf16 a =
# [src | msg] W1^T and dW2 = dO'^T h (h the bf16 hidden) exact, dO' (f32)
# as hi + lo in dh = dO' W2 and dW2, da (f32) rounded to bf16 once in
# d[src | msg] = da W1 and dW1 = da^T [src | msg]; in f32 all five by
# 3xTF32; the weight products summed per row tile (64 rows bf16, 32 f32)
# and the tiles added in f32. The tests below model that rounding in torch
# on the CPU (TF32 by mantissa masking, f32 sums in torch's order) at small
# shapes and hold each scheme to float64 as chip_smoke.py's phase
# flow_kernel holds the kernels: max|d| over the float64 gradient's largest
# within BWD_RATIO times the plain backward's own distance (or the floor).
# Two controls show that the gate tells the schemes apart: a single TF32
# product, and the f32 form's operands rounded to bf16, each stand far past
# the limit; for K2 in bf16 a third, dO' rounded once too, breaks it at a
# single row. The model does not see the order of the card's sums within
# a tile or the tensor core's truncating adds (the kernels cut those chains
# short: bwf_scores and the per-tile `part` of bwf_consume; K2's f32
# products in groups of MLP_F32_CHAIN, each added in f32, which the model
# follows): the card decides, in chip_smoke.py's phase flow_kernel and
# tests/test_torch_kernels_cuda.py.

BWD_RATIO = 3.0
BWD_FLOOR = {torch.float32: 2e-6, torch.bfloat16: 1e-6}
EMU_FORMS = ("window", "window+mask", "global", "correlation", "mlp_erf",
             "mlp_tanh")
# K2's weight products: rows a tile of the weight blocks, by dtype (f32:
# the GEMM kernel's K steps of 32 rows, each added in f32)
MLP_TILE = {torch.float32: 32, torch.bfloat16: 64}
# K2's f32 products over C, 2C and H (csrc/mlp.cu mlp_bwd_gemm_kernel):
# the same K steps of 32, each from zero and added in f32 in order
MLP_F32_CHAIN = 32
# K1 / K3's f32 backward: streamed rows a tile (csrc/attention_bwd.cu
# kFRows), each tile's dQ / dK / dV product added to the gradient in f32
ATTN_F32_TILE = 16


def _tiled(mm, a, b, tile):
    """a @ b through mm, summed over the inner dimension in tiles of `tile`
    (all of it when None), the tiles' products added in f32 in order."""
    n = a.shape[-1]
    if tile is None or tile >= n:
        return mm(a, b)
    out = mm(a[..., :tile], b[..., :tile, :])
    for i in range(tile, n, tile):
        out = out + mm(a[..., i:i + tile], b[..., i:i + tile, :])
    return out


def _mm_bf16_operands(a, b):
    """a @ b with both operands rounded to bf16 and f32 sums: f32 inputs on
    the bf16 tensor cores (a control)."""
    r = torch.bfloat16
    return torch.matmul(a.to(r).float(), b.to(r).float())


def _mm_ds_bf16_split(ds, m):
    """dS (f32) @ M (bf16 values) as the bf16 kernels feed it: dS's bf16
    hi part and the bf16 of its remainder, two exact products, f32 sums."""
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float()
    return torch.matmul(lo, m) + torch.matmul(hi, m)


def _mm_bf16_a(a, m):
    """a (f32) @ M (bf16 values) with a rounded to bf16 once: K2's da."""
    return torch.matmul(a.to(torch.bfloat16).float(), m)


def _emulated_mlp_backward(args, stats, dout, mm_x, mm_do, mm_da, tile,
                           chain=None):
    """mlp_fused_backward_plain's formula with a = [src | msg] W1^T through
    mm_x, the products of dO' (dh = dO' W2, dW2 = dO'^T h) through mm_do and
    those of da (d[src | msg] = da W1, dW1 = da^T [src | msg]) through
    mm_da; the weight products summed over row tiles of `tile` rows, the
    tiles added in f32 in order, and the others over their inner dimension
    in tiles of `chain` (_tiled; all of it when None). f32 tensors in,
    gradients in the inputs' dtype."""
    src, msg, w1, w2, gamma = (x.float() for x in args[:5])
    approximate, o = args[6], stats[1]
    c = src.shape[-1]
    x = torch.cat([src, msg], -1).reshape(-1, 2 * c)
    a = _tiled(mm_x, x, w1.t().contiguous(), chain)
    h = torch.nn.functional.gelu(a, approximate="tanh" if approximate
                                 else "none")
    h = h.to(args[0].dtype).float()
    mean = o.mean(-1, keepdim=True)
    rs = torch.rsqrt((o - mean).square().mean(-1, keepdim=True) + 1e-5)
    oh = (o - mean) * rs
    dy = dout.float().reshape(-1, c)
    g = dy * gamma
    do = rs * (g - g.mean(-1, keepdim=True)
               - oh * (g * oh).mean(-1, keepdim=True))
    da = _tiled(mm_do, do, w2, chain) * K.gelu_grad(a, approximate)
    dx = _tiled(mm_da, da, w1, chain)
    t = range(0, x.shape[0], tile)
    dw1 = sum(mm_da(da[i:i + tile].t().contiguous(), x[i:i + tile])
              for i in t)
    dw2 = sum(mm_do(do[i:i + tile].t().contiguous(), h[i:i + tile])
              for i in t)
    dt = args[0].dtype
    return ((dx[:, :c] + dy).reshape(args[0].shape).to(dt),
            dx[:, c:].reshape(args[1].shape).to(dt), dw1.to(dt), dw2.to(dt),
            (dy * oh).sum(0).to(dt), dy.sum(0).to(dt))


def _emulated_backward(form, args, stats, dout, mm_in, mm_ds, round_p,
                       tile=None):
    """attention_backward_plain's (or the correlation's) formula with the
    products that carry 128-wide rows through mm_in (Q K^T, dO V^T, P^T dO)
    and mm_ds (dS K, dS^T Q), those over keys or queries (dS K, dS^T Q, P^T
    dO) summed in tiles of `tile` rows (_tiled); the 2-wide products (dO
    V^T and P^T dO at D_v = 2, the grid) in f32, as the kernels do them in
    FMAs. f32 tensors in, gradients in the inputs' dtype."""
    out, lse = stats
    f = [x.float() if torch.is_tensor(x) else x for x in args]
    if form == "correlation":
        q, k, v = f[0], f[1], f[2]
        scale, bias = 1.0 / math.sqrt(q.shape[-1]), None
    else:
        q, k, v, scale, bias = f
    wide = v.shape[-1] == q.shape[-1]
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    x = mm_in(q, kt) * scale
    if bias is not None:
        x = x + bias.repeat(q.shape[0] // bias.shape[0], 1, 1)
    p = torch.exp2(x * K.LOG2E - lse.float()[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    dp = mm_in(do, vt) if wide else torch.matmul(do, vt)
    ds = p * (dp - delta)
    dq = _tiled(mm_ds, ds, k, tile) * scale
    dk = _tiled(mm_ds, ds.transpose(-1, -2), q, tile) * scale
    dt = args[0].dtype
    if form == "correlation":
        return dq.to(dt), dk.to(dt)
    pv = p.to(torch.bfloat16).float() if round_p else p
    dv = (_tiled(mm_in, pv.transpose(-1, -2), do, tile) if wide
          else torch.matmul(pv.transpose(-1, -2), do))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _emu_case(form, dtype, seed):
    """The form's inputs at a small size with D = 128 (the kernels'
    width), keys near the queries (peaked softmax rows, as the GMFlow
    step's are), the mask a random 0 / -100 one; the plain backward's
    arguments, the statistics, the upstream gradient and the float64
    reference gradients."""
    rng = np.random.default_rng(seed)
    b, l, d = (2, 96, 128) if form.startswith("window") else (2, 160, 128)

    def a(*s, scale=1.0):
        return rng.standard_normal(s) * scale

    if form.startswith("mlp"):
        return _emu_mlp_case(form, dtype, rng, (b, l), 512)
    q = a(b, l, d)
    k = 0.7 * q[:, rng.permutation(l)] + a(b, l, d)
    if form == "correlation":
        ys, xs = np.meshgrid(np.arange(10.0), np.arange(16.0), indexing="ij")
        grid = np.stack([xs, ys], -1).reshape(l, 2)
        args64 = [q, k, grid]
        plain, stats_fn, backward = (
            K.global_correlation_expectation_plain,
            K.global_correlation_expectation_stats_plain,
            K.global_correlation_expectation_backward_plain)
        diff = (0, 1)
    else:
        dv = 128 if form.startswith("window") else 2
        bias = (np.where(rng.random((1, l, l)) < 0.3, -100.0, 0.0)
                if form == "window+mask" else None)
        args64 = [q, k, a(b, l, dv, scale=1.0 if dv == 128 else 8.0),
                  1.0 / math.sqrt(d), bias]
        plain, stats_fn, backward = (K.attention_plain,
                                     K.attention_stats_plain,
                                     K.attention_backward_plain)
        diff = (0, 1, 2)
    # the inputs that carry a gradient in dtype, the mask and the grid f32
    args = _torch(args64, torch.float32, diff)
    args = [x.to(dtype) if i in diff else x for i, x in enumerate(args)]
    a64 = [x.double().requires_grad_(i in diff) if torch.is_tensor(x) else x
           for i, x in enumerate(args)]
    # the statistics from float64, rounded: on the card the kernel forward
    # writes them with its own sums, which neither backward repeats (here a
    # plain f32 forward's would cancel the plain backward's own rounding)
    with torch.no_grad():
        out64, lse64 = stats_fn(*a64)
    stats = (out64.to(args[2].dtype if form != "correlation"
                      else torch.float32), lse64.float())
    up = torch.tensor(rng.standard_normal(tuple(stats[0].shape)),
                      dtype=torch.float32).to(stats[0].dtype)
    ref = torch.autograd.grad(plain(*a64), [a64[i] for i in diff],
                              up.double())
    want = backward(*args, *stats, up)
    return args, stats, up, ref, want


def _emu_mlp_case(form, dtype, rng, rows, h):
    """_emu_case's for K2: src, msg (rows..., 128), W1 (h, 256) and W2 (128,
    h) at nn.Linear's scale, gamma, beta; o the LayerNorm's input from a
    float64 forward, rounded to f32."""
    def a(*s, scale=1.0):
        return rng.standard_normal(s) * scale

    c = 128
    args = [torch.tensor(x, dtype=torch.float32).to(dtype) for x in (
        a(*rows, c), a(*rows, c), a(h, 2 * c, scale=0.05),
        a(c, h, scale=0.05), a(c), a(c))] + [form == "mlp_tanh"]
    a64 = [x.double().requires_grad_(True) for x in args[:6]] + [args[6]]
    with torch.no_grad():
        out64, o64 = K.mlp_fused_stats_plain(*a64)
    stats = (out64.to(dtype), o64.float())
    up = torch.tensor(a(*rows, c), dtype=torch.float32).to(dtype)
    ref = torch.autograd.grad(K.mlp_fused_plain(*a64), a64[:6], up.double())
    want = K.mlp_fused_backward_plain(*args, *stats, up)
    return args, stats, up, ref, want


def _emulated(form, args, stats, up, mm_in, mm_ds, mm_da=None, tile=64,
              round_p=False, attn_tile=None, chain=None):
    """_emulated_backward (its products over keys or queries in tiles of
    attn_tile rows), or for K2 _emulated_mlp_backward with a through
    mm_in, dO''s products through mm_ds and da's through mm_da (mm_ds when
    None), the others' sums in tiles of `chain`."""
    if form.startswith("mlp"):
        return _emulated_mlp_backward(args, stats, up, mm_in, mm_ds,
                                      mm_da or mm_ds, tile, chain)
    return _emulated_backward(form, args, stats, up, mm_in, mm_ds, round_p,
                              attn_tile)


def _offs(grads, ref):
    return [_rel(x, r) for x, r in zip(grads, ref)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", EMU_FORMS)
def test_kernel_rounding_model_holds_the_gate(form, dtype):
    """The kernels' scheme (3xTF32 in f32, K1 / K3's products over keys or
    queries in 16-row tiles added in f32, K2's every product in groups of
    MLP_F32_CHAIN added in f32; in bf16 exact bf16 products, dS and K2's
    dO' as hi + lo, K2's da rounded once), modelled on the CPU, stands
    within BWD_RATIO of the plain backward's distance to float64 on every
    gradient."""
    args, stats, up, ref, want = _emu_case(form, dtype,
                                           EMU_FORMS.index(form))
    if dtype == torch.float32:
        mm_in, mm_ds, mm_da = _mm_3xtf32, _mm_3xtf32, None
    else:
        mm_in, mm_ds, mm_da = torch.matmul, _mm_ds_bf16_split, _mm_bf16_a
    got = _emulated(form, args, stats, up, mm_in, mm_ds, mm_da,
                    MLP_TILE[dtype], round_p=dtype == torch.bfloat16,
                    attn_tile=ATTN_F32_TILE if dtype == torch.float32
                    else None,
                    chain=MLP_F32_CHAIN if dtype == torch.float32 else None)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
    for k_off, p_off in zip(_offs(got, ref), _offs(want, ref)):
        assert k_off <= max(BWD_RATIO * p_off, BWD_FLOOR[dtype])


@pytest.mark.parametrize("control", ["1xTF32", "bf16 operands"])
@pytest.mark.parametrize("form", EMU_FORMS)
def test_kernel_rounding_model_controls_break_the_gate(form, control):
    """In f32, a single TF32 product or bf16 operands put some gradient
    past BWD_RATIO times the plain backward's distance (and past the
    floor): the gate refuses them."""
    args, stats, up, ref, want = _emu_case(form, torch.float32,
                                           EMU_FORMS.index(form))
    mm = _mm_1xtf32 if control == "1xTF32" else _mm_bf16_operands
    got = _emulated(form, args, stats, up, mm, mm,
                    tile=MLP_TILE[torch.float32], attn_tile=ATTN_F32_TILE,
                    chain=MLP_F32_CHAIN)
    limits = [max(BWD_RATIO * p, BWD_FLOOR[torch.float32])
              for p in _offs(want, ref)]
    assert any(k > lim for k, lim in zip(_offs(got, ref), limits))


# K2 at a single row: no sum over rows averages the rounding of dW1 and
# dW2, nor much of d[src | msg]'s over H
MLP_ONE_ROW_SEEDS = range(12)


@pytest.mark.parametrize("scheme", ["kernel", "dO' rounded once"])
def test_mlp_rounding_model_at_one_row(scheme):
    """K2's bf16 scheme (dO' as hi + lo, da rounded once) holds the gate at
    one row and H = 512 for every seed and both gelus; with dO' rounded
    once as well (a control) some case breaks it."""
    worst = 0.0
    for seed in MLP_ONE_ROW_SEEDS:
        for form in ("mlp_erf", "mlp_tanh"):
            args, stats, up, ref, want = _emu_mlp_case(
                form, torch.bfloat16, np.random.default_rng(100 + seed),
                (1, 1), 512)
            mm_do = (_mm_ds_bf16_split if scheme == "kernel"
                     else _mm_bf16_a)
            got = _emulated_mlp_backward(args, stats, up, torch.matmul,
                                         mm_do, _mm_bf16_a, 64)
            worst = max(worst, max(
                k / max(BWD_RATIO * p, BWD_FLOOR[torch.bfloat16])
                for k, p in zip(_offs(got, ref), _offs(want, ref))))
    assert (worst <= 1.0) == (scheme == "kernel")
