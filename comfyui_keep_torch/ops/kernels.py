"""GMFlow's three hand-written CUDA kernels, each beside its plain version.

| wrapper | CUDA source | replaces (comfyui_keep_tpu/ops/pallas_kernels.py) |
| `attention` | csrc/attention.cu | `attention_pallas` |
| `global_correlation_expectation` | csrc/attention.cu | `global_correlation_expectation_pallas` |
| `mlp_fused` | csrc/mlp.cu | `mlp_fused_pallas` |

A wrapper given CPU tensors computes its plain version (the CPU tests run
there). Given CUDA tensors it launches its kernel, or raises on anything the
kernel does not take: there is no switch and no fallback. Each launch adds
one to its entry of `LAUNCHES`; the plain versions count nothing. `attention`
keeps one entry per kernel it launches: `attention[dv128]` (V as wide as
q/k), `attention[dv128+bias]` (the same with a bias) and `attention[dv2]`
(the 2-wide V instantiation).
"""
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from comfyui_keep_torch.ops._build import library

LAUNCHES: Dict[str, int] = {
    "attention[dv128]": 0, "attention[dv128+bias]": 0, "attention[dv2]": 0,
    "global_correlation_expectation": 0, "mlp_fused": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WIDTH = 128  # q/k width of attention, C of the MLP


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: single-head attention
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, scale: float, bias=None):
    """softmax(q k^T * scale [+ bias[b % Bm]]) v with the kernel's rounding:
    f32 scores, probabilities cast to v's dtype for the PV product, f32
    accumulation, normalised after PV."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float().repeat(q.shape[0] // bias.shape[0], 1, 1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / denom).to(v.dtype)


def attention(q, k, v, scale: float, bias: Optional[torch.Tensor] = None):
    """q, k: (B, L, D); v: (B, L, Dv); bias: (Bm, L, L) f32 with Bm dividing
    B, or None. Returns (B, L, Dv) in v's dtype. On CUDA: D = 128 and Dv in
    {128, 2}, f32 or bf16."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale, bias)
    b, l, d = q.shape
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
    with torch.cuda.device(q.device):
        err = lib.keep_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None if bias is None else bias.data_ptr(),
                                 out.data_ptr(), b, l, d, dv, bm, float(scale),
                                 _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, "attention kernel launch")
    LAUNCHES[f"attention[dv{dv}{'' if bias is None else '+bias'}]"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: global correlation softmax expectation
# ---------------------------------------------------------------------------

def global_correlation_expectation_plain(f0, f1, grid):
    """softmax(f0 f1^T / sqrt(C)) @ grid, all in f32."""
    c = f0.shape[-1]
    s = torch.matmul(f0.float(), f1.float().transpose(-1, -2)) / math.sqrt(c)
    return torch.matmul(torch.softmax(s, dim=-1), grid.float())


def global_correlation_expectation(f0, f1, grid):
    """f0, f1: (B, L, C); grid: (L, 2) f32 pixel coordinates. Returns the
    (B, L, 2) f32 softmax-weighted correspondence without the (B, L, L)
    correlation. On CUDA: C = 128, f32 or bf16."""
    if not f0.is_cuda:
        return global_correlation_expectation_plain(f0, f1, grid)
    b, l, c = f0.shape
    if c != KERNEL_WIDTH or f0.dtype not in _DTYPE_CODE:
        raise ValueError(f"correlation kernel takes C=128 in f32/bf16, got "
                         f"C={c} {f0.dtype}")
    _check("correlation f0", f0, (b, l, c), f0.dtype, f0.device)
    _check("correlation f1", f1, (b, l, c), f0.dtype, f0.device)
    _check("correlation grid", grid, (l, 2), torch.float32, f0.device)
    out = torch.empty((b, l, 2), dtype=torch.float32, device=f0.device)
    lib = library("attention")
    with torch.cuda.device(f0.device):
        err = lib.keep_corr_expectation(
            f0.data_ptr(), f1.data_ptr(), grid.data_ptr(), out.data_ptr(), b,
            l, c, 1.0 / math.sqrt(c), _DTYPE_CODE[f0.dtype], _stream(f0))
    _raise_on(err, "correlation kernel launch")
    LAUNCHES["global_correlation_expectation"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: fused transformer MLP tail
# ---------------------------------------------------------------------------

def mlp_fused_plain(src, msg, w1a, w1b, w2, gamma, beta,
                    approximate: bool):
    """src + LN(gelu(src@W1a + msg@W1b) @ W2) * gamma + beta with the
    kernel's rounding: f32 hidden, rounded to src's dtype before W2, f32
    LayerNorm (eps 1e-5) and residual, cast to src's dtype."""
    h = (torch.matmul(src.float(), w1a.float())
         + torch.matmul(msg.float(), w1b.float()))
    h = F.gelu(h, approximate="tanh" if approximate else "none")
    o = torch.matmul(h.to(src.dtype).float(), w2.float())
    o = F.layer_norm(o, (o.shape[-1],), gamma.float(), beta.float(), eps=1e-5)
    return (src.float() + o).to(src.dtype)


def mlp_fused(src, msg, w1a, w1b, w2, gamma, beta, approximate: bool):
    """src, msg: (B, L, C); w1a, w1b: (C, H); w2: (H, C); gamma, beta: (C,).
    approximate=True is the tanh gelu, False the erf gelu. On CUDA: C = 128,
    H a multiple of 64, every tensor in src's dtype (f32 or bf16)."""
    if not src.is_cuda:
        return mlp_fused_plain(src, msg, w1a, w1b, w2, gamma, beta,
                               approximate)
    b, l, c = src.shape
    h = w1a.shape[-1]
    if c != KERNEL_WIDTH or h % 64 or src.dtype not in _DTYPE_CODE:
        raise ValueError(f"mlp kernel takes C=128, H%64==0 in f32/bf16, got "
                         f"C={c} H={h} {src.dtype}")
    dt = src.dtype
    for n, t, shp in (("src", src, (b, l, c)), ("msg", msg, (b, l, c)),
                      ("w1a", w1a, (c, h)), ("w1b", w1b, (c, h)),
                      ("w2", w2, (h, c)), ("gamma", gamma, (c,)),
                      ("beta", beta, (c,))):
        _check(f"mlp {n}", t, shp, dt, src.device)
    out = torch.empty_like(src)
    lib = library("mlp")
    with torch.cuda.device(src.device):
        err = lib.keep_mlp_fused(src.data_ptr(), msg.data_ptr(),
                                 w1a.data_ptr(), w1b.data_ptr(), w2.data_ptr(),
                                 gamma.data_ptr(), beta.data_ptr(),
                                 out.data_ptr(), b * l, c, h,
                                 int(bool(approximate)), _DTYPE_CODE[dt],
                                 _stream(src))
    _raise_on(err, "mlp kernel launch")
    LAUNCHES["mlp_fused"] += 1
    return out


PLAIN = {"attention": attention_plain,
         "global_correlation_expectation":
             global_correlation_expectation_plain,
         "mlp_fused": mlp_fused_plain}
