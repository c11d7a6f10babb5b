"""A model of the rounding of the port's f32 forward kernels (csrc/attention.cu
flash_attention_f32_kernel, csrc/mlp.cu mlp_fused_f32_kernel,
csrc/packed_conv.cu packed_conv_tf32_kernel), which compute
every product as 3xTF32 on the tensor cores: x = hi + lo with hi x rounded
to TF32, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 sums.

The model runs in torch on the CPU at small shapes (TF32 by mantissa
masking, tests/torch_port_helpers.py) in the kernels' order of operations:
K1 and K3 with their online softmax (scores in log2 units, the running
max and sum over key tiles of the kernel's width, P kept f32, O rescaled
when the max moves, one normalisation at the end); K2 with both products
as 3xTF32, the erf gelu between them in f32, then the LayerNorm and the
residual; K6 over its K steps (32 input channels of one tap, taps
innermost), each step's products from zero and added in f32, at its
deepest K (4 taps x 1024 channels), held as chip_smoke.py holds the
kernel: within KERNEL_RTOL["float32"] times the plain output's spread of
the plain f32 version. Each other scheme is held to float64 (the plain
version on float64 inputs): max|d| over the float64 output's largest must
stay within 3x the plain f32 forward's own distance. A control with single TF32 products in
the same model stands far past that limit, so the test tells the schemes
apart. The model does not see the order of the card's sums or the tensor
core's truncating adds: the card decides, against the plain versions, in
chip_smoke.py's phase kernel and tests/test_torch_kernels_cuda.py.
"""
import math

import numpy as np
import pytest
import torch

from comfyui_keep_torch.ops import kernels as K
from tests.torch_port_helpers import mm_1xtf32, mm_3xtf32

torch.set_num_threads(1)
RATIO = 3.0        # the scheme's distance to float64 over the plain f32's
CONTROL_RATIO = 30.0   # where the single-TF32 control must stand at least
WIDE_KEYS, NARROW_KEYS = 32, 64   # keys a tile at D_v = 128 and at D_v = 2
FORMS = ("window", "window+mask", "global", "correlation", "mlp_erf")


def _online_attention(q, k, v, scale, bias, keys, mm, mm_pv):
    """out, lse of softmax(q k^T scale + bias) v as the f32 kernel orders
    it: x = mm(q, k^T) scale log2 e (+ bias log2 e), then over tiles of
    `keys` keys the running max m, P = 2^(x - m) in f32, l = l a + sum P,
    O = O a + mm_pv(P, V) with a = 2^(m_old - m_new); out = O / l, lse = m
    + log2 l."""
    log2e = 1.0 / math.log(2.0)
    x = mm(q, k.transpose(-1, -2)) * (scale * log2e)
    if bias is not None:
        x = x + bias.repeat(q.shape[0] // bias.shape[0], 1, 1) * log2e
    b, n = x.shape[:2]
    m = torch.full((b, n), -math.inf)
    l = torch.zeros(b, n)
    o = torch.zeros(b, n, v.shape[-1])
    for k0 in range(0, n, keys):
        xt = x[:, :, k0:k0 + keys]
        mn = torch.maximum(m, xt.amax(-1))
        a = torch.exp2(m - mn)
        p = torch.exp2(xt - mn[..., None])
        l = l * a + p.sum(-1)
        vt = v[:, k0:k0 + keys] if v.dim() == 3 else v[k0:k0 + keys]
        o = o * a[..., None] + mm_pv(p, vt)
        m = mn
    return o / l[..., None], m + torch.log2(l)


def _mlp(src, msg, w1, w2, gamma, beta, mm):
    """mlp_fused_plain's function (erf gelu) with both products through mm,
    the rest in f32."""
    c = src.shape[-1]
    x = torch.cat([src, msg], -1).reshape(-1, 2 * c)
    h = torch.nn.functional.gelu(mm(x, w1.t().contiguous()))
    o = mm(h, w2.t().contiguous())
    o = torch.nn.functional.layer_norm(o, (c,), gamma, beta, eps=1e-5)
    return (src.reshape(-1, c) + o).reshape(src.shape)


def _case(form, seed):
    """The form's f32 inputs at a small size with D = C = 128 (the
    kernels' width), peaked softmax rows (keys near their queries, as
    chip_smoke.py's matched_keys), the mask a random 0 / -100 one; the
    function of the model, the plain version and its float64 output."""
    rng = np.random.default_rng(seed)

    def t(*s, scale=1.0):
        return torch.as_tensor(rng.standard_normal(s) * scale,
                               dtype=torch.float32)

    if form == "mlp_erf":
        args = (t(2, 48, 128), t(2, 48, 128), t(256, 256, scale=0.05),
                t(128, 256, scale=0.05), t(128), t(128))

        def model(mm):
            return _mlp(*args, mm), None
        plain = (K.mlp_fused_plain, args + (False,))
    else:
        b, n = (2, 96) if form.startswith("window") else (2, 160)
        q = t(b, n, 128)
        k = (0.7 * q[:, torch.as_tensor(rng.permutation(n))] + t(b, n, 128))
        if form == "correlation":
            ys, xs = np.meshgrid(np.arange(10.0), np.arange(16.0),
                                 indexing="ij")
            v = torch.as_tensor(np.stack([xs, ys], -1).reshape(n, 2),
                                dtype=torch.float32)
            scale, bias = 1.0 / math.sqrt(128), None
            plain = (K.global_correlation_expectation_stats_plain, (q, k, v))
        else:
            v = t(b, n, 128 if form.startswith("window") else 2,
                  scale=1.0 if form.startswith("window") else 8.0)
            scale = 1.0 / math.sqrt(128)
            bias = (torch.as_tensor(np.where(rng.random((1, n, n)) < 0.3,
                                             -100.0, 0.0),
                                    dtype=torch.float32)
                    if form == "window+mask" else None)
            plain = (K.attention_stats_plain, (q, k, v, scale, bias))
        wide = v.shape[-1] == 128

        def model(mm):
            # the 2-wide product in FMAs: f32 sums of f32 products
            return _online_attention(q, k, v, scale, bias,
                                     WIDE_KEYS if wide else NARROW_KEYS, mm,
                                     mm if wide else torch.matmul)
    fn, pargs = plain
    ref = fn(*(a.double() if torch.is_tensor(a) else a for a in pargs))
    got = fn(*pargs)
    if form == "mlp_erf":
        ref, got = (ref, None), (got, None)
    return model, got, ref


def _off(x, ref):
    """max|x - ref| over ref's largest."""
    return ((x.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("form", FORMS)
def test_f32_forward_rounding_model_3xtf32(form):
    """3xTF32 in both products, in the kernels' order, stands within RATIO
    times the plain f32 forward's distance to float64, in the output and
    (K1, K3) in the lse."""
    model, plain, ref = _case(form, 11)
    out, lse = model(mm_3xtf32)
    lim = RATIO * _off(plain[0], ref[0])
    assert _off(out, ref[0]) <= lim, (_off(out, ref[0]), lim)
    if lse is not None:
        lim = RATIO * _off(plain[1], ref[1])
        assert _off(lse, ref[1]) <= lim, (_off(lse, ref[1]), lim)


@pytest.mark.parametrize("form", FORMS)
def test_f32_forward_rounding_model_1xtf32_control(form):
    """Control: single TF32 products in the same model stand past
    CONTROL_RATIO times the plain f32 forward's distance, far outside the
    limit above."""
    model, plain, ref = _case(form, 11)
    out, _ = model(mm_1xtf32)
    assert _off(out, ref[0]) > CONTROL_RATIO * _off(plain[0], ref[0])


# K6's f32 form (csrc/packed_conv.cu kFK, packed_conv_plan's f32 route)
K6_K_STEP = 32
K6_RTOL = 1e-4    # chip_smoke.py KERNEL_RTOL["float32"]


def _k6_case(seed, pixels=96, taps=4, cin=1024, cout=48):
    """A packed convolution's products at K6's deepest K: per tap the
    (pixels, Cin) patch and the (Cin, Cout) weights, as chip_smoke.py draws
    them (unit inputs, weights over sqrt(taps Cin)); the plain f32 version
    (the taps' products summed in f32) and float64."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((taps, pixels, cin)),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((taps, cin, cout))
                        / math.sqrt(taps * cin), dtype=torch.float32)
    plain = sum(torch.matmul(x[t], w[t]) for t in range(taps))
    ref = sum(torch.matmul(x[t].double(), w[t].double())
              for t in range(taps))
    return x, w, plain, ref


def _k6_model(x, w, mm):
    """The kernel's sum: K step s takes channels 32 (s // taps) .. of tap s %
    taps (taps innermost), its products through mm from zero, added to the
    output in f32 in order."""
    taps, _, cin = x.shape
    acc = None
    for s in range(taps * (cin // K6_K_STEP)):
        t, c0 = s % taps, (s // taps) * K6_K_STEP
        part = mm(x[t, :, c0:c0 + K6_K_STEP], w[t, c0:c0 + K6_K_STEP])
        acc = part if acc is None else acc + part
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_k6_f32_rounding_model_3xtf32(seed):
    """3xTF32 in the kernel's K order stands within KERNEL_RTOL["float32"]
    of the plain f32 version's output spread, as the card's gate holds it,
    and about as close to float64 as the plain version."""
    x, w, plain, ref = _k6_case(seed)
    got = _k6_model(x, w, mm_3xtf32)
    spread = (plain - plain.mean()).abs().max().item()
    assert (got - plain).abs().max().item() <= K6_RTOL * spread
    assert _off(got, ref) <= RATIO * _off(plain, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_k6_f32_rounding_model_1xtf32_control(seed):
    """Control: single TF32 products in the same order break that gate."""
    x, w, plain, _ = _k6_case(seed)
    got = _k6_model(x, w, mm_1xtf32)
    spread = (plain - plain.mean()).abs().max().item()
    assert (got - plain).abs().max().item() > K6_RTOL * spread
