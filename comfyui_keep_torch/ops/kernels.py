"""The port's hand-written CUDA kernels, each beside its plain version:
GMFlow's three, the nearest-codebook search of KEEP training, StyleGAN2's
fused bias + leaky ReLU and the phase-packed convolution.

| wrapper | CUDA source | replaces (comfyui_keep_tpu/ops/pallas_kernels.py) |
| `attention` | csrc/attention.cu (bf16 D_v=128: `flash_attention_bf16_kernel`; bf16 D_v=2: `flash_narrow_bf16_kernel`; f32: `flash_attention_f32_kernel`) | `attention_pallas` |
| `global_correlation_expectation` | csrc/attention.cu (bf16: `flash_narrow_bf16_kernel`; f32: `flash_attention_f32_kernel`) | `global_correlation_expectation_pallas` |
| `mlp_fused` | csrc/mlp.cu | `mlp_fused_pallas` |
| `vq_nearest_indices` | csrc/vq.cu | `vq_nearest_indices_pallas` |
| `fused_bias_lrelu` | csrc/fused_act.cu | `fused_bias_lrelu_pallas` |
| `packed_conv2x2` | csrc/packed_conv.cu | `pallas_conv` (tools/_prof_packedconv.py) |

A wrapper given CPU tensors computes its plain version (the CPU tests run
there). Given CUDA tensors it launches its kernel, or raises on anything the
kernel does not take: there is no switch and no fallback. Under grad mode,
with an input that requires grad, `attention`, `global_correlation_expectation`
and `mlp_fused` go through `PlainBackward`: the kernel's forward, and in the
backward the plain version's gradient, recomputed from the saved inputs
(the JAX package differentiates its plain branch too: no Pallas kernel
there has a backward). `packed_conv2x2` serves only and refuses such an
input; `vq_nearest_indices` returns indices; `fused_bias_lrelu` has its own
autograd Function (ops/native.py). Each launch adds
one to its entry of `LAUNCHES`; the plain versions count nothing. `attention`
keeps one entry per form, whichever dtype's kernel it launches:
`attention[dv128]` (V as wide as q/k), `attention[dv128+bias]` (the same
with a bias) and `attention[dv2]` (the 2-wide V). `LAUNCHES_BY_SHAPE` counts
the same launches of K1 to K4 by the shape they ran at, "<LAUNCHES key>
B<batch> L<length>" for attention and the correlation, "mlp_fused rows<n>"
and "vq_nearest_indices T<tokens>", each key from its first launch on.
`PACKED_CONV_SHAPES` counts K6's launches by shape, whatever the batch:
"<Hi>x<Wi>x<Cin> k<kh>x<kw> -> <Cout> pads <top><bottom><left><right>".
"""
import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from comfyui_keep_torch.ops._build import library

LAUNCHES: Dict[str, int] = {
    "attention[dv128]": 0, "attention[dv128+bias]": 0, "attention[dv2]": 0,
    "global_correlation_expectation": 0, "mlp_fused": 0,
    "vq_nearest_indices": 0, "fused_bias_lrelu": 0, "packed_conv2x2": 0}
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
    return torch.cuda.current_stream(t.device).cuda_stream


def _device(t: torch.Tensor):
    """t's card made current for a launch; a no-op when it already is."""
    if t.device.index in (None, torch.cuda.current_device()):
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: f32, or float64 for an f64 input
    (which the kernels do not take)."""
    return torch.promote_types(t.dtype, torch.float32)


class PlainBackward(torch.autograd.Function):
    """apply(launch, plain, diff, *args): the forward is launch(*args) (the
    kernel, counted as any launch); the backward differentiates
    plain(*args) at the saved inputs, recomputed under enable_grad, and
    returns its gradient for the inputs at positions `diff` (None for the
    rest). One call's recompute lives only inside its own backward."""

    @staticmethod
    def forward(ctx, launch, plain, diff, *args):
        ctx.plain, ctx.diff = plain, diff
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        ctx.args = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*[a for a in args if torch.is_tensor(a)])
        return launch(*args)

    @staticmethod
    def backward(ctx, grad):
        saved = iter(ctx.saved_tensors)
        args = [next(saved) if t else a
                for a, t in zip(ctx.args, ctx.is_tensor)]
        want = [i for i in ctx.diff if ctx.needs_input_grad[3 + i]]
        for i in want:
            args[i] = args[i].detach().requires_grad_(True)
        with torch.enable_grad():
            out = ctx.plain(*args)
        got = dict(zip(want, torch.autograd.grad(
            out, [args[i] for i in want], grad, allow_unused=True)))
        return (None, None, None) + tuple(got.get(i) for i in
                                          range(len(args)))


def _with_grad(launch, plain, diff, *args):
    """launch(*args), through PlainBackward when grad mode is on and an
    input at a position in `diff` requires grad."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(args[i]) and args[i].requires_grad for i in diff):
        return PlainBackward.apply(launch, plain, diff, *args)
    return launch(*args)


# ---------------------------------------------------------------------------
# K1: single-head attention
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, scale: float, bias=None):
    """softmax(q k^T * scale [+ bias[b % Bm]]) v with the kernel's rounding:
    f32 scores, probabilities cast to v's dtype for the PV product, f32
    accumulation, normalised after PV (float64 throughout on f64 inputs)."""
    acc_t = _acc_dtype(q)
    s = torch.matmul(q.to(acc_t), k.to(acc_t).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(acc_t).repeat(q.shape[0] // bias.shape[0], 1, 1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(acc_t), v.to(acc_t))
    return (acc / denom).to(v.dtype)


def attention(q, k, v, scale: float, bias: Optional[torch.Tensor] = None):
    """q, k: (B, L, D); v: (B, L, Dv); bias: (Bm, L, L) f32 with Bm dividing
    B, or None. Returns (B, L, Dv) in v's dtype. On CUDA: D = 128 and Dv in
    {128, 2}, f32 or bf16, B at most 65,535."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale, bias)
    return _with_grad(_attention_launch, attention_plain, (0, 1, 2), q, k, v,
                      scale, bias)


def _attention_launch(q, k, v, scale: float, bias=None):
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
    lib = library("attention")
    with _device(q):
        err = lib.keep_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), b, l, d, dv, bm, float(scale),
                                 _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, "attention kernel launch")
    _count(f"attention[dv{dv}{'' if bias is None else '+bias'}]",
           f"B{b} L{l}")
    return out


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


def global_correlation_expectation(f0, f1, grid):
    """f0, f1: (B, L, C); grid: (L, 2) f32 pixel coordinates. Returns the
    (B, L, 2) f32 softmax-weighted correspondence without the (B, L, L)
    correlation. On CUDA: C = 128, f32 or bf16, B at most 65,535."""
    if not f0.is_cuda:
        return global_correlation_expectation_plain(f0, f1, grid)
    return _with_grad(_correlation_launch,
                      global_correlation_expectation_plain, (0, 1), f0, f1,
                      grid)


def _correlation_launch(f0, f1, grid):
    b, l, c = f0.shape
    _check_batch("correlation", b)
    if c != KERNEL_WIDTH or f0.dtype not in _DTYPE_CODE:
        raise ValueError(f"correlation kernel takes C=128 in f32/bf16, got "
                         f"C={c} {f0.dtype}")
    _check("correlation f0", f0, (b, l, c), f0.dtype, f0.device)
    _check("correlation f1", f1, (b, l, c), f0.dtype, f0.device)
    _check("correlation grid", grid, (l, 2), torch.float32, f0.device)
    out = torch.empty((b, l, 2), dtype=torch.float32, device=f0.device)
    lib = library("attention")
    with _device(f0):
        err = lib.keep_corr_expectation(
            f0.data_ptr(), f1.data_ptr(), grid.data_ptr(), out.data_ptr(), b,
            l, c, 1.0 / math.sqrt(c), _DTYPE_CODE[f0.dtype], _stream(f0))
    _raise_on(err, "correlation kernel launch")
    _count("global_correlation_expectation", f"B{b} L{l}")
    return out


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


def mlp_fused(src, msg, w1, w2, gamma, beta, approximate: bool):
    """src, msg: (B, L, C); w1: (H, 2C) and w2: (C, H), as nn.Linear holds
    them (w1's first C columns act on src, the rest on msg); gamma, beta:
    (C,). approximate=True is the tanh gelu, False the erf gelu. On CUDA:
    C = 128, H a multiple of 64, every tensor in src's dtype (f32 or bf16),
    contiguous and 16-byte aligned."""
    if not src.is_cuda:
        return mlp_fused_plain(src, msg, w1, w2, gamma, beta, approximate)
    return _with_grad(_mlp_launch, mlp_fused_plain, (0, 1, 2, 3, 4, 5), src,
                      msg, w1, w2, gamma, beta, approximate)


def _mlp_launch(src, msg, w1, w2, gamma, beta, approximate: bool):
    b, l, c = src.shape
    h = w1.shape[0]
    if c != KERNEL_WIDTH or h % 64 or src.dtype not in _DTYPE_CODE:
        raise ValueError(f"mlp kernel takes C=128, H%64==0 in f32/bf16, got "
                         f"C={c} H={h} {src.dtype}")
    dt = src.dtype
    args = (("src", src, (b, l, c)), ("msg", msg, (b, l, c)),
            ("w1", w1, (h, 2 * c)), ("w2", w2, (c, h)), ("gamma", gamma, (c,)),
            ("beta", beta, (c,)))
    for n, t, shp in args:
        _check(f"mlp {n}", t, shp, dt, src.device)
        if t.data_ptr() % 16:
            raise ValueError(f"mlp {n}: must be 16-byte aligned")
    out = torch.empty_like(src)
    lib = library("mlp")
    with _device(src):
        err = lib.keep_mlp_fused(src.data_ptr(), msg.data_ptr(), w1.data_ptr(),
                                 w2.data_ptr(), gamma.data_ptr(),
                                 beta.data_ptr(), out.data_ptr(), b * l, c, h,
                                 int(bool(approximate)), _DTYPE_CODE[dt],
                                 _stream(src))
    _raise_on(err, "mlp kernel launch")
    _count("mlp_fused", f"rows{b * l}")
    return out


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
    dtype. It serves only: a CUDA input that records a gradient (grad mode
    on, any tensor requiring grad) raises rather than detach."""
    if not x.is_cuda:
        return packed_conv2x2_plain(x, w, pads, bias, mask_c)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        raise RuntimeError("packed_conv2x2: the kernel has no backward; call "
                           "it under torch.no_grad() (serving only)")
    (pt, pb), (pl, pr) = pads
    if x.dim() != 4 or w.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"packed_conv2x2 takes NHWC x and HWIO w in "
                         f"f32/bf16, got {tuple(x.shape)}, {tuple(w.shape)} "
                         f"{x.dtype}")
    b, hi, wi, cin = x.shape
    kh, kw, cout = w.shape[0], w.shape[1], w.shape[3]
    ho, wo = hi + pt + pb - kh + 1, wi + pl + pr - kw + 1
    if (kh not in (1, 2) or kw not in (1, 2)
            or any(p not in (0, 1) for p in (pt, pb, pl, pr))
            or cin % 4 or cout % 4 or min(b, cin, cout, ho, wo) < 1):
        raise ValueError(f"packed_conv2x2 kernel takes 1-2 taps, pads of 0 "
                         f"or 1 and channels a multiple of 4, got w "
                         f"{tuple(w.shape)}, pads {pads}, x {tuple(x.shape)}")
    _check("packed_conv2x2 x", x, (b, hi, wi, cin), x.dtype, x.device)
    _check("packed_conv2x2 w", w, (kh, kw, cin, cout), x.dtype, x.device)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("packed_conv2x2: x and w must be 16-byte aligned")
    if bias is not None:
        if bias.dtype not in (torch.float32, x.dtype):
            raise ValueError(f"packed_conv2x2 bias: dtype {bias.dtype}")
        _check("packed_conv2x2 bias", bias, (cout,), bias.dtype, x.device)
    if mask_c is not None and (mask_c < 1 or 4 * mask_c != cout):
        raise ValueError(f"packed_conv2x2: mask_c={mask_c} needs Cout = "
                         f"4 mask_c, got Cout={cout}")
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib = library("packed_conv")
    with _device(x):
        err = lib.keep_packed_conv(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), b, hi,
            wi, cin, cout, kh, kw, pt, pb, pl, pr,
            int(bias is not None and bias.dtype == torch.bfloat16),
            mask_c or 0, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(err, "packed_conv2x2 kernel launch")
    _count("packed_conv2x2")
    key = packed_conv_shape(hi, wi, cin, kh, kw, cout, pads)
    PACKED_CONV_SHAPES[key] = PACKED_CONV_SHAPES.get(key, 0) + 1
    return out


PLAIN = {"attention": attention_plain,
         "global_correlation_expectation":
             global_correlation_expectation_plain,
         "mlp_fused": mlp_fused_plain,
         "vq_nearest_indices": vq_nearest_indices_plain,
         "fused_bias_lrelu": fused_bias_lrelu_plain,
         "packed_conv2x2": packed_conv2x2_plain}
