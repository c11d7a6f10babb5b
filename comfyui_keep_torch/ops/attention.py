"""Attention for the KEEP side: plain PyTorch, softmax in at least f32.

The token counts there are small (256 to 1024), so the scores are formed
whole, as the JAX package leaves them to XLA. GMFlow's large attentions go
through the hand-written kernel in ops/kernels.py instead.
"""
from typing import Optional

import torch
import torch.nn.functional as F


def softmax_attention(q, k, v, scale: Optional[float] = None,
                                 bias=None):
    """q: (..., Lq, D), k: (..., Lk, D), v: (..., Lk, Dv) -> (..., Lq, Dv).
    Scores and softmax in promote_types(dtype, f32) (f32 for bf16, f64
    stays f64), probabilities cast to v's dtype for PV."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def multi_head_attention(query, key, value, in_proj_weight, in_proj_bias,
                         out_proj_weight, out_proj_bias, num_heads: int):
    """nn.MultiheadAttention's forward, batch first (B, L, E), with torch's
    packed in_proj_weight (3E, E) layout."""
    wq, wk, wv = in_proj_weight.chunk(3)
    bq, bk, bv = in_proj_bias.chunk(3)
    q = F.linear(query, wq, bq)
    k = F.linear(key, wk, bk)
    v = F.linear(value, wv, bv)
    b, lq, e = q.shape
    dh = e // num_heads

    def heads(t):
        return t.reshape(b, -1, num_heads, dh).transpose(1, 2)

    out = softmax_attention(heads(q), heads(k), heads(v))
    out = out.transpose(1, 2).reshape(b, lq, e)
    return F.linear(out, out_proj_weight, out_proj_bias)
