"""The port's three GMFlow kernels (comfyui_keep_torch/ops/kernels.py).

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
from comfyui_keep_tpu.ops import pallas_kernels as P
from comfyui_keep_tpu.ops.norm import layer_norm as jlayer_norm
from comfyui_keep_torch.ops import kernels as K

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
        x, torch.Tensor) else x.float().numpy()


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
    rng = np.random.default_rng(seed)
    return (_np(rng, b, l, c), _np(rng, b, l, c), _np(rng, c, h, scale=0.05),
            _np(rng, c, h, scale=0.05), _np(rng, h, c, scale=0.05),
            _np(rng, c), _np(rng, c))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_mlp_tanh_plain_vs_pallas_interpret(dtype):
    args = _mlp_inputs(5)
    ours = K.mlp_fused_plain(*(_to(a, dtype) for a in args), approximate=True)
    ref = P.mlp_fused_pallas(*(_jx(a, dtype) for a in args), block=128,
                             interpret=True)
    tol = (dict(atol=2e-4, rtol=1e-3) if dtype == np.float32
           else dict(atol=6e-2, rtol=1.6e-2))
    np.testing.assert_allclose(_f32(ours), _f32(ref), **tol)


def test_mlp_erf_plain_vs_jax_unfused_branch():
    """approximate=False is what the JAX package computes in f32
    (gmflow.py:336-337): erf gelu, unfused."""
    src, msg, w1a, w1b, w2, g, b = _mlp_inputs(6)
    ours = K.mlp_fused_plain(*map(torch.as_tensor, (src, msg, w1a, w1b, w2,
                                                    g, b)), approximate=False)
    hmid = jax.nn.gelu(jnp.asarray(src) @ w1a + jnp.asarray(msg) @ w1b,
                       approximate=False)
    ref = src + jlayer_norm(hmid @ w2, {"scale": jnp.asarray(g),
                                        "bias": jnp.asarray(b)})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-3)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(_np(rng, 2, 64, 128)) for _ in range(3))
    grid = torch.as_tensor(rng.random((64, 2)).astype(np.float32))
    args = tuple(map(torch.as_tensor, _mlp_inputs(8, l=64)))
    K.reset_launch_counts()
    torch.testing.assert_close(K.attention(q, k, v, 0.1),
                               K.attention_plain(q, k, v, 0.1), rtol=0, atol=0)
    torch.testing.assert_close(
        K.global_correlation_expectation(q, k, grid),
        K.global_correlation_expectation_plain(q, k, grid), rtol=0, atol=0)
    torch.testing.assert_close(K.mlp_fused(*args, approximate=False),
                               K.mlp_fused_plain(*args, approximate=False),
                               rtol=0, atol=0)
    assert set(K.LAUNCHES.values()) == {0}
