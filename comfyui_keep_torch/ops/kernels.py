"""The port's hand-written CUDA kernels, each beside its plain version:
GMFlow's three, the nearest-codebook search of KEEP training, StyleGAN2's
fused bias + leaky ReLU and the phase-packed convolution.

| wrapper | CUDA source | replaces (comfyui_keep_tpu/ops/pallas_kernels.py) |
| `attention` | csrc/attention.cu (bf16 D_v=128: `flash_attention_bf16_kernel`; bf16 D_v=2: `flash_narrow_bf16_kernel`; f32: `flash_attention_f32_kernel`); backward csrc/attention_bwd.cu | `attention_pallas` |
| `global_correlation_expectation` | csrc/attention.cu (bf16: `flash_narrow_bf16_kernel`; f32: `flash_attention_f32_kernel`); backward csrc/attention_bwd.cu | `global_correlation_expectation_pallas` |
| `mlp_fused` | csrc/mlp.cu (backward `mlp_bwd_prep_kernel`, bf16 `mlp_fused_bwd_kernel` / f32 `mlp_bwd_gemm_kernel`, `mlp_bwd_reduce_kernel`) | `mlp_fused_pallas` |
| `vq_nearest_indices` | csrc/vq.cu | `vq_nearest_indices_pallas` |
| `fused_bias_lrelu` | csrc/fused_act.cu | `fused_bias_lrelu_pallas` |
| `packed_conv2x2` | csrc/packed_conv.cu (bf16: `packed_conv_wgmma_kernel`, `packed_conv_cp_async_kernel`; f32: `packed_conv_w_split_kernel` + `packed_conv_tf32_kernel`) | `pallas_conv` (tools/_prof_packedconv.py) |

A wrapper given CPU tensors computes its plain version (the CPU tests run
there). Given CUDA tensors it launches its kernel, or raises on anything the
kernel does not take: there is no switch and no fallback. Under grad mode,
with an input that requires grad, `attention`, `global_correlation_expectation`
and `mlp_fused` go through their autograd Functions (`AttentionFn`,
`CorrelationFn`, `MlpFn`): the forward kernel, which then also writes what
the backward needs (K1 and K3: each query row's log2-sum-exp2, (B, L) f32;
K2: the LayerNorm's input, (rows, C) f32), and in the backward the
hand-written backward kernels
(csrc/attention_bwd.cu: two kernels a call, Delta then dQ and dK / dV
blocks in one grid, warp-specialized on wgmma with TMA, bf16 and f32 by
3xTF32 with the streamed tiles split and transposed on chip, the 2-wide
products in FMAs; no (L, L) tensor in memory and no atomics; csrc/mlp.cu:
the LayerNorm's backward, the products on wgmma, then a fixed-order
reduce: in bf16 row blocks for d[src | msg] and weight blocks for dW1 and
dW2 in one grid, whose weight blocks recompute a and dh so that nothing
(rows, H) wide reaches memory, three kernels a call; in f32 three
launches of one 3xTF32 GEMM kernel, a and dh to da^T and h^T (H, rows),
then d[src | msg], then dW1 and dW2, five kernels a call). The JAX
package has no Pallas backward: it
differentiates its plain branch, and these kernels compute the gradient of
the function each forward kernel computes. Each Function takes its forward
and backward launchers as arguments, so the CPU tests run it with the plain
versions (`attention_stats_plain` / `attention_backward_plain` and the
like). Without grad the wrappers launch the forward kernel alone, as
serving does. `packed_conv2x2` serves only and refuses an input that
records a gradient; `vq_nearest_indices` returns indices;
`fused_bias_lrelu` has its own autograd Function (ops/native.py). Each
launch adds one to its entry of `LAUNCHES`; the plain versions count
nothing. `attention` keeps one entry per form, whichever dtype's kernel it
launches: `attention[dv128]` (V as wide as q/k), `attention[dv128+bias]`
(the same with a bias) and `attention[dv2]` (the 2-wide V), and its
backward the same three as `attention_bwd[...]`; the other backwards count
as `global_correlation_expectation_bwd` and `mlp_fused_bwd`.
`LAUNCHES_BY_SHAPE` counts the same launches of K1 to K4 and of the
backwards by the shape they ran at, "<LAUNCHES key> B<batch> L<length>"
for attention and the correlation, "mlp_fused[_bwd] rows<n>" and
"vq_nearest_indices T<tokens>", each key from its first launch on.
`PACKED_CONV_SHAPES` counts K6's launches by shape, whatever the batch:
"<Hi>x<Wi>x<Cin> k<kh>x<kw> -> <Cout> pads <top><bottom><left><right>".
"""
import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from comfyui_keep_torch.ops._build import library

LAUNCHES: Dict[str, int] = {
    "attention[dv128]": 0, "attention[dv128+bias]": 0, "attention[dv2]": 0,
    "global_correlation_expectation": 0, "mlp_fused": 0,
    "vq_nearest_indices": 0, "fused_bias_lrelu": 0, "packed_conv2x2": 0,
    "attention_bwd[dv128]": 0, "attention_bwd[dv128+bias]": 0,
    "attention_bwd[dv2]": 0, "global_correlation_expectation_bwd": 0,
    "mlp_fused_bwd": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WIDTH = 128  # q/k width of attention, C of the MLP
VQ_CODE_TILE = 64   # the codebook size must be a multiple of this
VQ_MAX_WIDTH = 512
VQ_MAX_SPLITS = 16  # csrc/vq.cu kMaxSplits
MAX_GRID_Y = 65535  # the attention launchers put the batch in gridDim.y
LAUNCHES_BY_SHAPE: Dict[str, int] = {}
PACKED_CONV_SHAPES: Dict[str, int] = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()
    PACKED_CONV_SHAPES.clear()


def packed_conv_shape(hi: int, wi: int, cin: int, kh: int, kw: int,
                      cout: int, pads) -> str:
    """K6's PACKED_CONV_SHAPES key of an input (B, hi, wi, cin), a (kh, kw,
    cin, cout) weight and pads ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = pads
    return f"{hi}x{wi}x{cin} k{kh}x{kw} -> {cout} pads {pt}{pb}{pl}{pr}"


def _count(counter: str, shape: Optional[str] = None):
    LAUNCHES[counter] += 1
    if shape is not None:
        key = f"{counter} {shape}"
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_batch(what: str, b: int):
    if not 1 <= b <= MAX_GRID_Y:
        raise ValueError(f"{what}: batch {b} outside [1, {MAX_GRID_Y}] (the "
                         f"kernel's grid holds the batch in its y dimension)")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's card as a raw handle (the public
    torch.cuda.current_stream(device).cuda_stream builds a Stream object
    first, on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _device(t: torch.Tensor):
    """t's card made current for a launch; a no-op when it already is."""
    if t.device.index in (None, torch.cuda.current_device()):
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: f32, or float64 for an f64 input
    (which the kernels do not take)."""
    return torch.promote_types(t.dtype, torch.float32)


def _records_grad(*tensors) -> bool:
    """Whether a call on these inputs records a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class AttentionFn(torch.autograd.Function):
    """apply(forward, backward, q, k, v, scale, bias): out, lse =
    forward(q, k, v, scale, bias) (lse the (B, L) f32 row statistics);
    the backward is backward(q, k, v, scale, bias, out, lse, dout) ->
    (dq, dk, dv). The bias gets no gradient. On the card the two are the
    kernels' launchers; the CPU tests pass the plain versions."""

    @staticmethod
    def forward(ctx, fwd, bwd, q, k, v, scale, bias):
        out, lse = fwd(q, k, v, scale, bias)
        ctx.bwd, ctx.scale = bwd, scale
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, ctx.scale, bias, out, lse,
                             dout.contiguous())
        return None, None, dq, dk, dv, None, None


class CorrelationFn(torch.autograd.Function):
    """apply(forward, backward, f0, f1, grid): out, lse = forward(f0, f1,
    grid); the backward is backward(f0, f1, grid, out, lse, dout) -> (df0,
    df1). The grid gets no gradient."""

    @staticmethod
    def forward(ctx, fwd, bwd, f0, f1, grid):
        out, lse = fwd(f0, f1, grid)
        ctx.bwd = bwd
        ctx.save_for_backward(f0, f1, grid, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        f0, f1, grid, out, lse = ctx.saved_tensors
        df0, df1 = ctx.bwd(f0, f1, grid, out, lse, dout.contiguous())
        return None, None, df0, df1, None


class MlpFn(torch.autograd.Function):
    """apply(forward, backward, src, msg, w1, w2, gamma, beta,
    approximate): out, o = forward(...) (o the LayerNorm's (rows, C) f32
    input); the backward is backward(src, msg, w1, w2, gamma, beta,
    approximate, out, o, dout) -> the six tensors' gradients."""

    @staticmethod
    def forward(ctx, fwd, bwd, src, msg, w1, w2, gamma, beta, approximate):
        out, o = fwd(src, msg, w1, w2, gamma, beta, approximate)
        ctx.bwd, ctx.approximate = bwd, approximate
        ctx.save_for_backward(src, msg, w1, w2, gamma, beta, out, o)
        return out

    @staticmethod
    def backward(ctx, dout):
        *inputs, out, o = ctx.saved_tensors
        grads = ctx.bwd(*inputs, ctx.approximate, out, o, dout.contiguous())
        return (None, None) + tuple(grads) + (None,)


# ---------------------------------------------------------------------------
# K1: single-head attention
# ---------------------------------------------------------------------------

LOG2E = math.log2(math.e)


def _attention_logits(q, k, scale: float, bias=None):
    """q k^T * scale [+ bias[b % Bm]] in the plain versions' working type."""
    acc_t = _acc_dtype(q)
    s = torch.matmul(q.to(acc_t), k.to(acc_t).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(acc_t).repeat(q.shape[0] // bias.shape[0], 1, 1)
    return s


def attention_plain(q, k, v, scale: float, bias=None):
    """softmax(q k^T * scale [+ bias[b % Bm]]) v with the kernel's rounding:
    f32 scores, probabilities cast to v's dtype for the PV product, f32
    accumulation, normalised after PV (float64 throughout on f64 inputs)."""
    acc_t = _acc_dtype(q)
    s = _attention_logits(q, k, scale, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(acc_t), v.to(acc_t))
    return (acc / denom).to(v.dtype)


def attention_stats_plain(q, k, v, scale: float, bias=None):
    """(attention_plain(...), lse): lse the (B, L) row statistics the
    kernels' backward reads, log2 sum_j 2^(x_j log2 e) of each row's logits
    x (the log-sum-exp times log2 e), f32 (float64 on f64 inputs)."""
    lse = torch.logsumexp(_attention_logits(q, k, scale, bias), -1) * LOG2E
    return attention_plain(q, k, v, scale, bias), lse


def _softmax_backward_plain(x, v, out, lse, dout):
    """(P, dS) of softmax(x) v from the saved statistics: P = 2^(x log2 e -
    lse), dS = P (dout v^T - rowsum(dout * out)), in x's type."""
    acc_t = x.dtype
    p = torch.exp2(x * LOG2E - lse.to(acc_t)[..., None])
    do = dout.to(acc_t)
    delta = (do * out.to(acc_t)).sum(-1, keepdim=True)
    dp = torch.matmul(do, v.to(acc_t).transpose(-1, -2))
    return p, p * (dp - delta)


def attention_backward_plain(q, k, v, scale: float, bias, out, lse, dout):
    """The kernels' backward, written out: P rebuilt from the logits and
    lse, dS = P (dP - Delta), dQ = scale dS K, dK = scale dS^T Q, dV = P^T
    dO with P rounded to v's dtype as the forward rounds it before P V; f32
    (float64 on f64 inputs), each gradient cast to its input's dtype. The
    bias gets none."""
    acc_t = _acc_dtype(q)
    x = _attention_logits(q, k, scale, bias)
    p, ds = _softmax_backward_plain(x, v, out, lse, dout)
    dv = torch.matmul(p.to(v.dtype).to(acc_t).transpose(-1, -2),
                      dout.to(acc_t))
    dq = torch.matmul(ds, k.to(acc_t)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc_t)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention(q, k, v, scale: float, bias: Optional[torch.Tensor] = None):
    """q, k: (B, L, D); v: (B, L, Dv); bias: (Bm, L, L) f32 with Bm dividing
    B, or None. Returns (B, L, Dv) in v's dtype. On CUDA: D = 128 and Dv in
    {128, 2}, f32 or bf16, B at most 65,535, q, k and v 16-byte aligned
    (the kernels read them by TMA, and at Dv = 128 the backward dO too); a
    call that records a gradient saves the row statistics and its backward
    is the backward kernels'."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale, bias)
    if _records_grad(q, k, v):
        return AttentionFn.apply(_attention_stats_launch,
                                 _attention_bwd_launch, q, k, v, scale, bias)
    return _attention_launch(q, k, v, scale, bias)


def _attention_key(dv: int, bias) -> str:
    return f"dv{dv}{'' if bias is None else '+bias'}"


def _attention_launch(q, k, v, scale: float, bias=None, stats=False):
    b, l, d = q.shape
    _check_batch("attention", b)
    dv = v.shape[-1]
    if d != KERNEL_WIDTH or dv not in (KERNEL_WIDTH, 2):
        raise ValueError(f"attention kernel takes D=128 and Dv in (128, 2), "
                         f"got D={d}, Dv={dv}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernel: unsupported dtype {q.dtype}")
    for n, t, shp in (("q", q, (b, l, d)), ("k", k, (b, l, d)),
                      ("v", v, (b, l, dv))):
        _check(f"attention {n}", t, shp, q.dtype, q.device)
    bm = 0
    if bias is not None:
        bm = bias.shape[0]
        _check("attention bias", bias, (bm, l, l), torch.float32, q.device)
        if b % bm:
            raise ValueError(f"attention: Bm={bm} does not divide B={b}")
    out = torch.empty_like(v)
    lse = (torch.empty((b, l), dtype=torch.float32, device=q.device)
           if stats else None)
    lib = library("attention")
    with _device(q):
        err = lib.keep_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None if bias is None else bias.data_ptr(),
                                 out.data_ptr(),
                                 None if lse is None else lse.data_ptr(), b,
                                 l, d, dv, bm, float(scale),
                                 _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, "attention kernel launch")
    _count(f"attention[{_attention_key(dv, bias)}]", f"B{b} L{l}")
    return (out, lse) if stats else out


def _attention_stats_launch(q, k, v, scale: float, bias=None):
    return _attention_launch(q, k, v, scale, bias, stats=True)


def _attention_bwd_launch(q, k, v, scale: float, bias, out, lse, dout):
    b, l, d = q.shape
    dv = v.shape[-1]
    _check("attention out", out, (b, l, dv), v.dtype, q.device)
    _check("attention dout", dout, (b, l, dv), v.dtype, q.device)
    _check("attention lse", lse, (b, l), torch.float32, q.device)
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, l), dtype=torch.float32, device=q.device)
    lib = library("attention_bwd")
    with _device(q):
        err = lib.keep_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), b, l, d, dv,
            0 if bias is None else bias.shape[0], float(scale),
            _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, "attention backward kernel launch")
    _count(f"attention_bwd[{_attention_key(dv, bias)}]", f"B{b} L{l}")
    return dq, dk, dvv


# ---------------------------------------------------------------------------
# K3: global correlation softmax expectation
# ---------------------------------------------------------------------------

def global_correlation_expectation_plain(f0, f1, grid):
    """softmax(f0 f1^T / sqrt(C)) @ grid, all in f32 (float64 on f64
    inputs)."""
    c = f0.shape[-1]
    acc_t = _acc_dtype(f0)
    s = torch.matmul(f0.to(acc_t),
                     f1.to(acc_t).transpose(-1, -2)) / math.sqrt(c)
    return torch.matmul(torch.softmax(s, dim=-1), grid.to(acc_t))


def global_correlation_expectation_stats_plain(f0, f1, grid):
    """(global_correlation_expectation_plain(...), lse), lse as
    attention_stats_plain's at scale 1 / sqrt(C)."""
    x = _attention_logits(f0, f1, 1.0 / math.sqrt(f0.shape[-1]))
    return (global_correlation_expectation_plain(f0, f1, grid),
            torch.logsumexp(x, -1) * LOG2E)


def global_correlation_expectation_backward_plain(f0, f1, grid, out, lse,
                                                  dout):
    """The correlation kernel's backward, written out as
    attention_backward_plain's with V the grid (no gradient, P kept in
    f32): (df0, df1) in f0's dtype."""
    scale = 1.0 / math.sqrt(f0.shape[-1])
    acc_t = _acc_dtype(f0)
    x = _attention_logits(f0, f1, scale)
    _, ds = _softmax_backward_plain(x, grid, out, lse, dout)
    df0 = torch.matmul(ds, f1.to(acc_t)) * scale
    df1 = torch.matmul(ds.transpose(-1, -2), f0.to(acc_t)) * scale
    return df0.to(f0.dtype), df1.to(f1.dtype)


def global_correlation_expectation(f0, f1, grid):
    """f0, f1: (B, L, C); grid: (L, 2) f32 pixel coordinates. Returns the
    (B, L, 2) f32 softmax-weighted correspondence without the (B, L, L)
    correlation. On CUDA: C = 128, f32 or bf16, B at most 65,535; a call
    that records a gradient has the backward kernels' backward."""
    if not f0.is_cuda:
        return global_correlation_expectation_plain(f0, f1, grid)
    if _records_grad(f0, f1):
        return CorrelationFn.apply(_correlation_stats_launch,
                                   _correlation_bwd_launch, f0, f1, grid)
    return _correlation_launch(f0, f1, grid)


def _correlation_launch(f0, f1, grid, stats=False):
    b, l, c = f0.shape
    _check_batch("correlation", b)
    if c != KERNEL_WIDTH or f0.dtype not in _DTYPE_CODE:
        raise ValueError(f"correlation kernel takes C=128 in f32/bf16, got "
                         f"C={c} {f0.dtype}")
    _check("correlation f0", f0, (b, l, c), f0.dtype, f0.device)
    _check("correlation f1", f1, (b, l, c), f0.dtype, f0.device)
    _check("correlation grid", grid, (l, 2), torch.float32, f0.device)
    out = torch.empty((b, l, 2), dtype=torch.float32, device=f0.device)
    lse = (torch.empty((b, l), dtype=torch.float32, device=f0.device)
           if stats else None)
    lib = library("attention")
    with _device(f0):
        err = lib.keep_corr_expectation(
            f0.data_ptr(), f1.data_ptr(), grid.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, l, c,
            1.0 / math.sqrt(c), _DTYPE_CODE[f0.dtype], _stream(f0))
    _raise_on(err, "correlation kernel launch")
    _count("global_correlation_expectation", f"B{b} L{l}")
    return (out, lse) if stats else out


def _correlation_stats_launch(f0, f1, grid):
    return _correlation_launch(f0, f1, grid, stats=True)


def _correlation_bwd_launch(f0, f1, grid, out, lse, dout):
    b, l, c = f0.shape
    _check("correlation out", out, (b, l, 2), torch.float32, f0.device)
    _check("correlation dout", dout, (b, l, 2), torch.float32, f0.device)
    _check("correlation lse", lse, (b, l), torch.float32, f0.device)
    df0, df1 = torch.empty_like(f0), torch.empty_like(f1)
    delta = torch.empty((b, l), dtype=torch.float32, device=f0.device)
    lib = library("attention_bwd")
    with _device(f0):
        err = lib.keep_corr_expectation_bwd(
            f0.data_ptr(), f1.data_ptr(), grid.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            df0.data_ptr(), df1.data_ptr(), b, l, c, 1.0 / math.sqrt(c),
            _DTYPE_CODE[f0.dtype], _stream(f0))
    _raise_on(err, "correlation backward kernel launch")
    _count("global_correlation_expectation_bwd", f"B{b} L{l}")
    return df0, df1


# ---------------------------------------------------------------------------
# K2: fused transformer MLP tail
# ---------------------------------------------------------------------------

def mlp_fused_plain(src, msg, w1, w2, gamma, beta, approximate: bool):
    """src + LN(gelu([src | msg] @ W1^T) @ W2^T) * gamma + beta with the
    kernel's rounding: f32 hidden, rounded to src's dtype before W2, f32
    LayerNorm (eps 1e-5) and residual, cast to src's dtype (float64
    throughout on f64 inputs)."""
    acc_t = _acc_dtype(src)
    x = torch.cat([src, msg], dim=-1).to(acc_t)
    h = F.gelu(torch.matmul(x, w1.to(acc_t).t()),
               approximate="tanh" if approximate else "none")
    o = torch.matmul(h.to(src.dtype).to(acc_t), w2.to(acc_t).t())
    o = F.layer_norm(o, (o.shape[-1],), gamma.to(acc_t), beta.to(acc_t),
                     eps=1e-5)
    return (src.to(acc_t) + o).to(src.dtype)


def mlp_fused_stats_plain(src, msg, w1, w2, gamma, beta, approximate: bool):
    """(mlp_fused_plain(...), o): o the LayerNorm's input [src | msg] W1^T
    -> gelu -> W2^T as (rows, C), f32 (float64 on f64 inputs), which the
    kernel's backward reads."""
    acc_t = _acc_dtype(src)
    c = src.shape[-1]
    x = torch.cat([src, msg], dim=-1).to(acc_t).reshape(-1, 2 * c)
    h = F.gelu(torch.matmul(x, w1.to(acc_t).t()),
               approximate="tanh" if approximate else "none")
    o = torch.matmul(h.to(src.dtype).to(acc_t), w2.to(acc_t).t())
    return mlp_fused_plain(src, msg, w1, w2, gamma, beta, approximate), o


def gelu_grad(a, approximate: bool):
    """d gelu / d a (the erf form, or the tanh form as torch writes it)."""
    if approximate:
        c, k = math.sqrt(2.0 / math.pi), 0.044715
        t = torch.tanh(c * (a + k * a * a * a))
        return 0.5 * (1 + t) + 0.5 * a * ((1 - t * t) * c * (1 + 3 * k * a * a))
    return (0.5 * (1 + torch.erf(a * math.sqrt(0.5)))
            + a * (torch.exp(-0.5 * a * a) / math.sqrt(2 * math.pi)))


def mlp_fused_backward_plain(src, msg, w1, w2, gamma, beta,
                             approximate: bool, out, o, dout):
    """The kernel's backward, written out in f32 (float64 on f64 inputs):
    a = [src | msg] W1^T and h = gelu(a) rounded to src's dtype
    recomputed; the LayerNorm statistics of the saved o (its input, out
    unused); dO' = rs (g - mean(g) - ohat mean(g ohat)) with g = dout
    gamma; dW2 = dO'^T h, dh = dO' W2, da = dh gelu'(a), dW1 = da^T [src |
    msg], d[src | msg] = da W1 plus dout for src (the residual), dgamma =
    sum(dout ohat), dbeta = sum(dout). Each gradient cast to its input's
    dtype."""
    acc_t = _acc_dtype(src)
    c = src.shape[-1]
    x = torch.cat([src, msg], dim=-1).to(acc_t).reshape(-1, 2 * c)
    w1a, w2a = w1.to(acc_t), w2.to(acc_t)
    a = torch.matmul(x, w1a.t())
    h = F.gelu(a, approximate="tanh" if approximate else "none")
    h = h.to(src.dtype).to(acc_t)
    o = o.to(acc_t)
    mean = o.mean(-1, keepdim=True)
    rs = torch.rsqrt((o - mean).square().mean(-1, keepdim=True) + 1e-5)
    oh = (o - mean) * rs
    dy = dout.to(acc_t).reshape(-1, c)
    g = dy * gamma.to(acc_t)
    do = rs * (g - g.mean(-1, keepdim=True)
               - oh * (g * oh).mean(-1, keepdim=True))
    da = torch.matmul(do, w2a) * gelu_grad(a, approximate)
    dx = torch.matmul(da, w1a)
    dsrc = (dx[:, :c] + dy).reshape(src.shape)
    dmsg = dx[:, c:].reshape(msg.shape)
    return (dsrc.to(src.dtype), dmsg.to(msg.dtype),
            torch.matmul(da.t(), x).to(w1.dtype),
            torch.matmul(do.t(), h).to(w2.dtype),
            (dy * oh).sum(0).to(gamma.dtype), dy.sum(0).to(beta.dtype))


def mlp_fused(src, msg, w1, w2, gamma, beta, approximate: bool):
    """src, msg: (B, L, C); w1: (H, 2C) and w2: (C, H), as nn.Linear holds
    them (w1's first C columns act on src, the rest on msg); gamma, beta:
    (C,). approximate=True is the tanh gelu, False the erf gelu. On CUDA:
    C = 128, H a multiple of 64, every tensor in src's dtype (f32 or bf16),
    contiguous and 16-byte aligned; a call that records a gradient has the
    backward kernel's backward."""
    if not src.is_cuda:
        return mlp_fused_plain(src, msg, w1, w2, gamma, beta, approximate)
    if _records_grad(src, msg, w1, w2, gamma, beta):
        return MlpFn.apply(_mlp_stats_launch, _mlp_bwd_launch, src, msg, w1,
                           w2, gamma, beta, approximate)
    return _mlp_launch(src, msg, w1, w2, gamma, beta, approximate)


def _mlp_check(src, msg, w1, w2, gamma, beta):
    b, l, c = src.shape
    h = w1.shape[0]
    if c != KERNEL_WIDTH or h % 64 or src.dtype not in _DTYPE_CODE:
        raise ValueError(f"mlp kernel takes C=128, H%64==0 in f32/bf16, got "
                         f"C={c} H={h} {src.dtype}")
    args = (("src", src, (b, l, c)), ("msg", msg, (b, l, c)),
            ("w1", w1, (h, 2 * c)), ("w2", w2, (c, h)), ("gamma", gamma, (c,)),
            ("beta", beta, (c,)))
    for n, t, shp in args:
        _check(f"mlp {n}", t, shp, src.dtype, src.device)
        if t.data_ptr() % 16:
            raise ValueError(f"mlp {n}: must be 16-byte aligned")
    return b * l, c, h


def _mlp_launch(src, msg, w1, w2, gamma, beta, approximate: bool,
                stats=False):
    rows, c, h = _mlp_check(src, msg, w1, w2, gamma, beta)
    out = torch.empty_like(src)
    o = (torch.empty((rows, c), dtype=torch.float32, device=src.device)
         if stats else None)
    lib = library("mlp")
    with _device(src):
        err = lib.keep_mlp_fused(src.data_ptr(), msg.data_ptr(), w1.data_ptr(),
                                 w2.data_ptr(), gamma.data_ptr(),
                                 beta.data_ptr(), out.data_ptr(),
                                 None if o is None else o.data_ptr(), rows, c,
                                 h, int(bool(approximate)),
                                 _DTYPE_CODE[src.dtype], _stream(src))
    _raise_on(err, "mlp kernel launch")
    _count("mlp_fused", f"rows{rows}")
    return (out, o) if stats else out


def _mlp_stats_launch(src, msg, w1, w2, gamma, beta, approximate: bool):
    return _mlp_launch(src, msg, w1, w2, gamma, beta, approximate, stats=True)


def mlp_bwd_scratch_bytes(rows: int, c: int, h: int, dtype) -> list:
    """The bytes of each scratch buffer K2's backward kernels take for
    `rows` rows: dO' (bf16: hi and lo), W2^T (f32: then W1^T), the
    LayerNorm backward's block sums, the weight products' slice partials,
    and da^T and h^T (f32 only, (H, rows rounded up to 4); 0 in bf16), as
    csrc/mlp.cu's tiling decides them (`keep_mlp_fused_bwd_scratch`)."""
    sizes = (ctypes.c_longlong * 6)()
    _raise_on(library("mlp").keep_mlp_fused_bwd_scratch(
        rows, c, h, _DTYPE_CODE[dtype], sizes), "mlp backward scratch query")
    return list(sizes)


def _mlp_bwd_launch(src, msg, w1, w2, gamma, beta, approximate: bool, out,
                    o, dout):
    """The backward kernels from the forward's saved LayerNorm input o:
    every gradient, the weight products included (csrc/mlp.cu: the
    LayerNorm's backward, row and weight blocks, a fixed-order reduce of
    the weight blocks' slice partials)."""
    rows, c, h = _mlp_check(src, msg, w1, w2, gamma, beta)
    _check("mlp dout", dout, src.shape, src.dtype, src.device)
    _check("mlp o", o, (rows, c), torch.float32, src.device)
    dsrc, dmsg = torch.empty_like(src), torch.empty_like(msg)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    dgb = torch.empty((2, c), dtype=src.dtype, device=src.device)
    # dO', W2^T, part, ws, and in f32 da and h
    scratch = [torch.empty(n, dtype=torch.uint8, device=src.device)
               if n else None
               for n in mlp_bwd_scratch_bytes(rows, c, h, src.dtype)]
    lib = library("mlp")
    with _device(src):
        err = lib.keep_mlp_fused_bwd(
            src.data_ptr(), msg.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            gamma.data_ptr(), dout.data_ptr(), o.data_ptr(), dsrc.data_ptr(),
            dmsg.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dgb.data_ptr(),
            *[None if t is None else t.data_ptr() for t in scratch], rows, c,
            h,
            int(bool(approximate)), _DTYPE_CODE[src.dtype], _stream(src))
    _raise_on(err, "mlp backward kernel launch")
    _count("mlp_fused_bwd", f"rows{rows}")
    return dsrc, dmsg, dw1, dw2, dgb[0], dgb[1]


# ---------------------------------------------------------------------------
# K4: nearest-codebook search
# ---------------------------------------------------------------------------

def codebook_sq_norms(codebook):
    """||e_n||^2 in f32, (N,)."""
    e = codebook.float()
    return (e * e).sum(dim=-1)


def vq_nearest_indices_plain(z, codebook):
    """argmin_n(||e_n||^2 - 2 z.e_n) -> (T,) int32 with the kernel's
    arithmetic: ||e||^2 and the products in f32 (a bf16 product is exact in
    f32), ties to the lowest index."""
    d = codebook_sq_norms(codebook) - 2.0 * torch.matmul(
        z.float(), codebook.float().t())
    return d.argmin(dim=-1).to(torch.int32)


def vq_nearest_indices(z, codebook):
    """z: (T, C), codebook: (N, C) in one dtype -> (T,) int32 index of the
    nearest code. On CUDA: f32 or bf16, N a multiple of 64, C a multiple of
    16 up to 512, both 16-byte aligned. A call counts one launch and runs
    two device kernels: the search over codebook splits, which computes
    ||e||^2 itself, and the merge of the splits."""
    if not z.is_cuda:
        return vq_nearest_indices_plain(z, codebook)
    t, c = z.shape
    n = codebook.shape[0]
    if (z.dtype not in _DTYPE_CODE or t < 1 or n % VQ_CODE_TILE or n < 1
            or c % 16 or not 16 <= c <= VQ_MAX_WIDTH):
        raise ValueError(f"vq kernel takes f32/bf16, T >= 1, N % "
                         f"{VQ_CODE_TILE} == 0 and C % 16 == 0 <= "
                         f"{VQ_MAX_WIDTH}, got T={t} N={n} C={c} {z.dtype}")
    _check("vq z", z, (t, c), z.dtype, z.device)
    _check("vq codebook", codebook, (n, c), z.dtype, z.device)
    if z.data_ptr() % 16 or codebook.data_ptr() % 16:
        raise ValueError("vq: z and the codebook must be 16-byte aligned")
    # one allocation: the (T,) result, then the per-split (distance, index)
    # pairs, (2, VQ_MAX_SPLITS, T)
    buf = torch.empty((1 + 2 * VQ_MAX_SPLITS) * t, dtype=torch.int32,
                      device=z.device)
    out = buf[:t]
    lib = library("vq")
    with _device(z):
        err = lib.keep_vq_nearest(z.data_ptr(), codebook.data_ptr(),
                                  buf[t:].data_ptr(), out.data_ptr(), t, n, c,
                                  _DTYPE_CODE[z.dtype], _stream(z))
    _raise_on(err, "vq kernel launch")
    _count("vq_nearest_indices", f"T{t}")
    return out


# ---------------------------------------------------------------------------
# K5: fused bias + scaled leaky ReLU
# ---------------------------------------------------------------------------

def fused_bias_lrelu_plain(x, bias, negative_slope: float = 0.2,
                           scale: float = 2 ** 0.5):
    """where(h >= 0, h, h * slope) * scale with h = x + bias (on dim 1) in
    f32, rounded once to x's dtype: the kernel's arithmetic, operation for
    operation (an f64 input, which the kernel does not take, stays f64)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    h = x.to(dt) + bias.to(dt).reshape((1, -1) + (1,) * (x.dim() - 2))
    return (torch.where(h >= 0, h, h * negative_slope) * scale).to(x.dtype)


def fused_bias_lrelu(x, bias, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5):
    """x: (N, C, *spatial) or (N, C); bias: (C,). Returns leaky_relu(x +
    bias, slope) * scale in x's dtype. On CUDA: x f32 or bf16 and
    contiguous, the bias f32 or of x's dtype (read as f32)."""
    if not x.is_cuda:
        return fused_bias_lrelu_plain(x, bias, negative_slope, scale)
    if x.dtype not in _DTYPE_CODE or x.dim() < 2:
        raise ValueError(f"fused_bias_lrelu kernel takes (N, C, ...) in "
                         f"f32/bf16, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_bias_lrelu x: must be contiguous")
    c = x.shape[1]
    if bias.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"fused_bias_lrelu bias: dtype {bias.dtype}")
    b = bias.float().contiguous()
    _check("fused_bias_lrelu bias", b, (c,), torch.float32, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = library("fused_act")
    with _device(x):
        err = lib.keep_fused_bias_lrelu(
            x.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel(),
            x[0, 0].numel(), c, float(negative_slope), float(scale),
            _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(err, "fused_bias_lrelu kernel launch")
    _count("fused_bias_lrelu")
    return out


# ---------------------------------------------------------------------------
# K6: phase-packed convolution
# ---------------------------------------------------------------------------

def mask_parity1_(x, c: int):
    """In place: zero the half-cells of a parity-1 phase-packed NHWC tensor
    (B, Hc, Wc, 4c) that stand for the SAME-padding rows / columns -1 and H
    (phase block qy * 2 + qx is channels [(qy * 2 + qx) * c, +c): the first
    cell row holds row -1 in blocks 0, 1, the last holds row H in blocks 2,
    3; columns likewise in blocks 0, 2 and 1, 3). K6's fused mask."""
    x[:, 0, :, :2 * c] = 0
    x[:, -1, :, 2 * c:] = 0
    for q in (0, 2):
        x[:, :, 0, q * c:(q + 1) * c] = 0
        x[:, :, -1, (q + 1) * c:(q + 2) * c] = 0
    return x


def packed_conv2x2_plain(x, w, pads, bias=None, mask_c: Optional[int] = None):
    """The kernel's function: the shifted matmuls of each tap summed in
    promote_types(dtype, f32), plus the bias in that type, the parity-1 pad
    half-cells zeroed when mask_c is given, rounded once to x's dtype (an
    f64 input, which the kernel does not take, stays f64). Reads outside x
    are zeros."""
    (pt, pb), (pl, pr) = pads
    kh, kw = w.shape[:2]
    ct = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    ho, wo = xp.shape[1] - kh + 1, xp.shape[2] - kw + 1
    acc = None
    for ty in range(kh):
        for tx in range(kw):
            term = torch.matmul(xp[:, ty:ty + ho, tx:tx + wo].to(ct),
                                w[ty, tx].to(ct))
            acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.to(ct)
    if mask_c is not None:
        mask_parity1_(acc, mask_c)
    return acc.to(x.dtype)


# K6's launch plans (csrc/packed_conv.cu keep_packed_conv): the route's
# code, the shared memory a block may take on the H100, its SM count
PACKED_CONV_ROUTES = {"tma": 0, "cp.async": 1, "tf32": 2}
SMEM_LIMIT = 232448
H100_SMS = 132
# the TMA kernel's tiles (BM pixels, BN outputs) and the rate of each per
# output element relative to 128 x 256's, from the device times of every
# tile at K6's own shape, the LQ encoder's batch of 20 and the encoder's
# level-2 res conv2 (H100 80GB HBM3; `tools/torch_k6_check.py --tiles`)
PACKED_CONV_TILES = {(128, 256): 1.0, (256, 128): 0.9, (128, 128): 0.86,
                     (256, 64): 0.6, (128, 64): 0.57}
# the f32 (3xTF32) kernel's tiles and rates relative to 128 x 128's, the
# same way (`tools/torch_k6_check.py --dtype float32 --tiles`)
PACKED_CONV_F32_TILES = {(128, 128): 1.0, (128, 64): 0.82, (128, 32): 0.5}
PACKED_CONV_MAX_STAGES = 8   # packed_conv.cu kTMaxStages
K_STEP = 64                  # input channels a K step, every bf16 route
K_STEP_F32 = 32              # the f32 route's: 128 bytes, as bf16's 64
TMA_FIXED_SMEM = 1024 + 1024 + 2 * 16384  # barriers, alignment, epilogue


@dataclasses.dataclass(frozen=True)
class PackedConvPlan:
    """How K6 runs one call: `route` ("tma": the bf16 kernel fed by TMA,
    Cin and Cout multiples of 8; "cp.async": the bf16 kernel for other
    channel counts; "tf32": the f32 kernel, 3xTF32 fed by TMA), its tile of
    `bm` output pixels x `bn` output channels and `stages` ring stages;
    `m_tiles` x `n_tiles` tiles, walked by `grid` blocks (TMA and tf32:
    persistent blocks, block b takes tiles b, b + grid, ..., tile t pixel
    tile t % m_tiles of output tile t // m_tiles; cp.async one tile a
    block); `smem_bytes` a block's shared memory."""
    route: str
    bm: int
    bn: int
    stages: int
    m_tiles: int
    n_tiles: int
    grid: int
    smem_bytes: int


def _tma_stage_bytes(bm: int, bn: int, dtype=torch.bfloat16) -> int:
    """A ring stage's bytes: bf16, the patch and the weights (K_STEP
    channels); f32, the raw patch and the weights' TF32 hi and lo tiles
    (K_STEP_F32 channels)."""
    if dtype == torch.float32:
        return (bm + 2 * bn) * K_STEP_F32 * 4
    return (bm + bn) * K_STEP * 2


def _tma_plan(m: int, cout: int, bm: int, bn: int, sms: int,
              dtype=torch.bfloat16) -> PackedConvPlan:
    stage = _tma_stage_bytes(bm, bn, dtype)
    stages = min(PACKED_CONV_MAX_STAGES, (SMEM_LIMIT - TMA_FIXED_SMEM) // stage)
    mt, nt = -(-m // bm), -(-cout // bn)
    route = "tf32" if dtype == torch.float32 else "tma"
    return PackedConvPlan(route, bm, bn, stages, mt, nt, min(mt * nt, sms),
                          TMA_FIXED_SMEM + stages * stage)


def _cheapest_tile(m: int, cout: int, tiles: dict, step: int):
    """Of `tiles` ({(bm, bn): rate}) no wider than Cout rounded up to
    `step`, the tile whose rounds of H100_SMS tiles, times its area over its
    rate, cost least (the card's last round runs whole tiles however few),
    ties to the first listed."""
    widest = -(-cout // step) * step
    best = None
    for (bm, bn), rate in tiles.items():
        if bn > widest:
            continue
        n = -(-m // bm) * -(-cout // bn)
        cost = -(-n // H100_SMS) * bm * bn / rate
        if best is None or cost < best[0]:
            best = (cost, bm, bn)
    return best[1], best[2]


@functools.lru_cache(maxsize=512)
def packed_conv_plan(b: int, hi: int, wi: int, cin: int, cout: int, kh: int,
                     kw: int, pads, dtype=torch.bfloat16) -> PackedConvPlan:
    """K6's plan for an input (b, hi, wi, cin), a (kh, kw, cin, cout) weight
    and pads ((top, bottom), (left, right)), picked by geometry alone. bf16
    with Cin and Cout multiples of 8 (TMA needs 16-byte strides) takes the
    TMA route: of PACKED_CONV_TILES no wider than Cout rounded up to 64, the
    tile whose rounds of H100_SMS tiles, times its area over its rate, cost
    least; as many ring stages as the shared memory holds. Other bf16
    channel counts take the cp.async route with its fixed tiling. f32 (Cin
    and Cout multiples of 4: 16-byte strides) takes the tf32 route: of
    PACKED_CONV_F32_TILES no wider than Cout rounded up to 32, picked the
    same way."""
    (pt, pb), (pl, pr) = pads
    m = b * (hi + pt + pb - kh + 1) * (wi + pl + pr - kw + 1)
    if dtype == torch.float32:
        bm, bn = _cheapest_tile(m, cout, PACKED_CONV_F32_TILES, 32)
        return _tma_plan(m, cout, bm, bn, H100_SMS, dtype)
    if cin % 8 or cout % 8:
        bn = 64 if cout <= 64 else 256
        mt, nt = -(-m // 128), -(-cout // bn)
        # packed_conv.cu WgLayout, + the same per-pixel arrays and bias_s
        smem = 4 * _tma_stage_bytes(128, bn) + 1024 + 2560 + 4 * bn
        return PackedConvPlan("cp.async", 128, bn, 4, mt, nt, mt * nt, smem)
    bm, bn = _cheapest_tile(m, cout, PACKED_CONV_TILES, 64)
    return _tma_plan(m, cout, bm, bn, H100_SMS)


@functools.lru_cache(maxsize=512)
def _packed_conv_call(x_shape, w_shape, pads, dtype, bias_bf16, mask_c):
    """What the calls of one geometry share, checked once: the output's
    shape, the C entry's 18 int arguments (B, Hi, Wi, Cin, Cout, kh, kw, pt,
    pb, pl, pr, bias_bf16, mask_c, dtype, then the plan's route, bm, bn,
    stages) as one ctypes array, and the PACKED_CONV_SHAPES key. Raises
    ValueError on a geometry the kernels do not take. A call then passes
    six arguments (ctypes converts every argument of every call; the host's
    time a call: tools/torch_k6_check.py --host)."""
    (pt, pb), (pl, pr) = pads
    b, hi, wi, cin = x_shape
    kh, kw, cout = w_shape[0], w_shape[1], w_shape[3]
    ho, wo = hi + pt + pb - kh + 1, wi + pl + pr - kw + 1
    if (kh not in (1, 2) or kw not in (1, 2)
            or any(p not in (0, 1) for p in (pt, pb, pl, pr))
            or cin % 4 or cout % 4 or min(b, cin, cout, ho, wo) < 1):
        raise ValueError(f"packed_conv2x2 kernel takes 1-2 taps, pads of 0 "
                         f"or 1 and channels a multiple of 4, got w "
                         f"{w_shape}, pads {pads}, x {x_shape}")
    if w_shape != (kh, kw, cin, cout):
        raise ValueError(f"packed_conv2x2 w: shape {w_shape} != "
                         f"{(kh, kw, cin, cout)}")
    if mask_c is not None and (mask_c < 1 or 4 * mask_c != cout):
        raise ValueError(f"packed_conv2x2: mask_c={mask_c} needs Cout = "
                         f"4 mask_c, got Cout={cout}")
    plan = packed_conv_plan(b, hi, wi, cin, cout, kh, kw, pads, dtype)
    args = (ctypes.c_int * 18)(
        b, hi, wi, cin, cout, kh, kw, pt, pb, pl, pr, bias_bf16, mask_c or 0,
        _DTYPE_CODE[dtype], PACKED_CONV_ROUTES[plan.route], plan.bm, plan.bn,
        plan.stages)
    return ((b, ho, wo, cout), args,
            packed_conv_shape(hi, wi, cin, kh, kw, cout, pads))


def packed_conv2x2(x, w, pads, bias: Optional[torch.Tensor] = None,
                   mask_c: Optional[int] = None):
    """x: (B, Hi, Wi, Cin) NHWC; w: (kh, kw, Cin, Cout) HWIO; pads:
    ((top, bottom), (left, right)) zero pads. Returns the stride-1
    convolution (B, Hi + top + bottom - kh + 1, ..., Cout) in x's dtype,
    plus bias (Cout,) if given, with the parity-1 pad half-cells of phase
    blocks mask_c wide zeroed if mask_c is given (Cout = 4 mask_c); the sum
    is taken in f32 and rounded once. On CUDA: kh, kw in {1, 2}, pads in
    {0, 1}, Cin and Cout multiples of 4, x and w contiguous, 16-byte aligned
    and of one dtype (f32 or bf16), the bias contiguous in f32 or x's
    dtype (f32 for f32 x). The kernel and its tiles follow
    packed_conv_plan (f32: two device kernels a call, the weights' TF32
    split and the convolution). It serves
    only: a CUDA input that records a gradient (grad mode on, any tensor
    requiring grad) raises rather than detach."""
    if not x.is_cuda:
        return packed_conv2x2_plain(x, w, pads, bias, mask_c)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            bias is not None and bias.requires_grad)):
        raise RuntimeError("packed_conv2x2: the kernel has no backward; call "
                           "it under torch.no_grad() (serving only)")
    if x.dim() != 4 or w.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"packed_conv2x2 takes NHWC x and HWIO w in "
                         f"f32/bf16, got {tuple(x.shape)}, {tuple(w.shape)} "
                         f"{x.dtype}")
    (pt, pb), (pl, pr) = pads
    bias_bf16 = bias is not None and bias.dtype == torch.bfloat16
    out_shape, args, key = _packed_conv_call(
        tuple(x.shape), tuple(w.shape), ((pt, pb), (pl, pr)), x.dtype,
        int(bias_bf16), mask_c)
    _check("packed_conv2x2 x", x, x.shape, x.dtype, x.device)
    _check("packed_conv2x2 w", w, w.shape, x.dtype, x.device)
    xp, wp = x.data_ptr(), w.data_ptr()
    if xp % 16 or wp % 16:
        raise ValueError("packed_conv2x2: x and w must be 16-byte aligned")
    if bias is not None:
        if bias.dtype not in (torch.float32, x.dtype):
            raise ValueError(f"packed_conv2x2 bias: dtype {bias.dtype}")
        _check("packed_conv2x2 bias", bias, (out_shape[3],), bias.dtype,
               x.device)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    # f32: the weights' TF32 hi and lo planes, (2, taps, Cout, Cin)
    wt = (torch.empty(2 * w.numel(), dtype=torch.float32, device=x.device)
          if x.dtype == torch.float32 else None)
    lib = library("packed_conv")
    with _device(x):
        err = lib.keep_packed_conv(
            xp, wp, None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if wt is None else wt.data_ptr(), args,
            _stream(x))
    _raise_on(err, "packed_conv2x2 kernel launch")
    _count("packed_conv2x2")
    PACKED_CONV_SHAPES[key] = PACKED_CONV_SHAPES.get(key, 0) + 1
    return out


PLAIN = {"attention": attention_plain,
         "global_correlation_expectation":
             global_correlation_expectation_plain,
         "mlp_fused": mlp_fused_plain,
         "vq_nearest_indices": vq_nearest_indices_plain,
         "fused_bias_lrelu": fused_bias_lrelu_plain,
         "packed_conv2x2": packed_conv2x2_plain}
# the backward kernels' plain versions, by the wrapper they differentiate
PLAIN_BACKWARD = {"attention": attention_backward_plain,
                  "global_correlation_expectation":
                      global_correlation_expectation_backward_plain,
                  "mlp_fused": mlp_fused_backward_plain}
# the launchers each autograd Function is given on the card: (the forward
# that saves what the backward reads, the backward)
LAUNCHERS = {"attention": (_attention_stats_launch, _attention_bwd_launch),
             "global_correlation_expectation": (_correlation_stats_launch,
                                                _correlation_bwd_launch),
             "mlp_fused": (_mlp_stats_launch, _mlp_bwd_launch)}
