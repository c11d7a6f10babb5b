"""Transformer and fusion blocks of the KEEP arch (reference keep_arch.py),
ported from comfyui_keep_tpu/models/layers.py: what KEEP's forward
reaches, and the AdaIN DFDNet uses. Token tensors are (B, L, C); feature maps NCHW. Parameter names
are the reference's.
"""

import torch
from torch import nn

from comfyui_keep_torch.models.vqgan import ResBlock
from comfyui_keep_torch.ops import (conv2d, gelu, layer_norm, leaky_relu,
                                    linear, multi_head_attention,
                                    softmax_attention)


def _ln(m: nn.LayerNorm, x):
    return layer_norm(x, m.weight, m.bias)


def _split_heads(t, heads: int):
    b, l, inner = t.shape
    return t.reshape(b, l, heads, inner // heads).transpose(1, 2)


def _merge_heads(t):
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


# Tensor parallelism (parallel/tensor.py:shard_params): a split layer's
# `_tp` holds its model group; None (the class default) leaves it whole.

def _tp_in(x, tp):
    """x entering a column-parallel layer: tp.copy(x) (the identity
    forward, the gradient summed over the model group), x itself when the
    layer is whole."""
    return x if tp is None else tp.copy(x)


def _tp_out(x, lin: nn.Linear, tp):
    """A row-parallel nn.Linear on x: the partial products summed over the
    model group (tp.reduce) before the bias is added once; the plain
    linear when the layer is whole."""
    if tp is None:
        return linear(x, lin.weight, lin.bias)
    return tp.reduce(linear(x, lin.weight)) + lin.bias


class CrossAttention(nn.Module):
    """diffusers-0.11 CrossAttention: separate q/k/v, scale dim_head^-0.5.
    Split by heads (`_tp`): to_q / to_k / to_v column-, to_out.0
    row-parallel."""
    _tp = None

    def __init__(self, query_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim),
                                     nn.Dropout(0.0)])

    def project_out(self, out):
        return _tp_out(_merge_heads(out), self.to_out[0], self._tp)

    def forward(self, x, context=None):
        x = _tp_in(x, self._tp)
        ctx = x if context is None else _tp_in(context, self._tp)
        q = linear(x, self.to_q.weight)
        k = linear(ctx, self.to_k.weight)
        v = linear(ctx, self.to_v.weight)
        dh = q.shape[-1] // self.heads
        out = softmax_attention(
            _split_heads(q, self.heads), _split_heads(k, self.heads),
            _split_heads(v, self.heads), scale=dh ** -0.5)
        return self.project_out(out)

    def sparse_causal(self, x, video_length: int):
        """x: (B*F, D, C). Keys/values of frame i are frame 0's and frame
        (i-1)'s tokens (SparseCausalAttention)."""
        bf, d, _ = x.shape
        b = bf // video_length
        x = _tp_in(x, self._tp)
        q = linear(x, self.to_q.weight)
        k = linear(x, self.to_k.weight)
        v = linear(x, self.to_v.weight)
        inner = q.shape[-1]
        former = torch.clamp(torch.arange(video_length, device=x.device) - 1,
                             min=0)
        first = torch.zeros(video_length, dtype=torch.long, device=x.device)

        def gather_ctx(t):  # (B*F, D, inner) -> (B*F, 2D, inner)
            t = t.reshape(b, video_length, d, inner)
            t = torch.cat([t[:, first], t[:, former]], dim=2)
            return t.reshape(bf, 2 * d, inner)

        dh = inner // self.heads
        out = softmax_attention(
            _split_heads(q, self.heads),
            _split_heads(gather_ctx(k), self.heads),
            _split_heads(gather_ctx(v), self.heads), scale=dh ** -0.5)
        return self.project_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """diffusers FeedForward(activation_fn="geglu"): GEGLU -> Linear. Split
    by hidden units (`_tp`): GEGLU's proj column-parallel (each rank its
    values and their gates), net.2 row-parallel."""
    _tp = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0),
                                  nn.Linear(inner, dim)])

    def forward(self, x):
        proj = self.net[0].proj
        h, gate = linear(_tp_in(x, self._tp), proj.weight,
                         proj.bias).chunk(2, dim=-1)
        return _tp_out(h * gelu(gate), self.net[2], self._tp)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj_weight), computed
    with the port's plain attention. Split by heads (`_tp`): this rank's
    heads' rows of each third of in_proj (column-parallel) and out_proj's
    matching columns (row-parallel)."""
    _tp = None

    def __init__(self, embed_dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, num_heads: int):
        tp = self._tp
        if tp is None:
            return multi_head_attention(
                query, key, value, self.in_proj_weight, self.in_proj_bias,
                self.out_proj.weight, self.out_proj.bias, num_heads)
        q = tp.copy(query)
        k = q if key is query else tp.copy(key)
        out = multi_head_attention(q, k, tp.copy(value), self.in_proj_weight,
                                   self.in_proj_bias, self.out_proj.weight,
                                   None, num_heads // tp.size)
        return tp.reduce(out) + self.out_proj.bias


class TransformerSALayer(nn.Module):
    """Pre-LN multi-head self-attention + GELU MLP. The MLP splits by
    hidden units (`_tp`: linear1 column-, linear2 row-parallel), the
    attention by heads (self_attn's own `_tp`)."""
    _tp = None

    def __init__(self, embed_dim: int, dim_mlp: int):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim)
        self.linear1 = nn.Linear(embed_dim, dim_mlp)
        self.linear2 = nn.Linear(dim_mlp, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim)

    def forward(self, x, query_pos=None, num_heads: int = 8):
        h = _ln(self.norm1, x)
        qk = h if query_pos is None else h + query_pos
        x = x + self.self_attn(qk, qk, h, num_heads)
        h = _ln(self.norm2, x)
        h = gelu(linear(_tp_in(h, self._tp), self.linear1.weight,
                        self.linear1.bias))
        return x + _tp_out(h, self.linear2, self._tp)


class _ConvSeq(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, 1, 1), nn.LeakyReLU(0.2),
                         nn.Conv2d(cout, cout, 3, 1, 1))

    def forward(self, x):
        x = leaky_relu(conv2d(x, self[0].weight, self[0].bias, padding=1), 0.2)
        return conv2d(x, self[2].weight, self[2].bias, padding=1)


class CFTBlock(nn.Module):
    """Fuse_sft_block: controllable feature transform of a decoder feature
    by the encoder skip, dec + w * (dec * scale + shift)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.encode_enc = ResBlock(2 * in_ch, out_ch)
        self.scale = _ConvSeq(in_ch, out_ch)
        self.shift = _ConvSeq(in_ch, out_ch)

    def forward(self, enc_feat, dec_feat, w: float = 1.0):
        h = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))
        return dec_feat + w * (dec_feat * self.scale(h) + self.shift(h))


class CFALayer(nn.Module):
    """CrossFrameFusionLayer: attention from the current frame's features
    to the previous frame's, then a GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)
        self.attn = CrossAttention(dim, heads, dim_head)

    def forward(self, curr, prev, residual: bool = True):
        """curr/prev: (B, C, H, W)."""
        b, c, h, w = curr.shape
        x = curr.flatten(2).transpose(1, 2)
        ctx = prev.flatten(2).transpose(1, 2)
        res = x
        x = _ln(self.norm1, self.attn(x, ctx))
        if residual:
            x = x + res
            res = x
        x = _ln(self.norm2, self.ff(x))
        if residual:
            x = x + res
        return x.transpose(1, 2).reshape(b, c, h, w)


class BasicTransformerBlock(nn.Module):
    """Sparse-causal attention, feed-forward and zero-initialised temporal
    attention (the Kalman uncertainty estimator's block)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.attn_temp = CrossAttention(dim, heads, dim_head)
        self.norm_temp = nn.LayerNorm(dim)

    def forward(self, x, video_length: int):
        """x: (B*F, D, C) -> same."""
        x = self.attn1.sparse_causal(_ln(self.norm1, x), video_length) + x
        x = self.ff(_ln(self.norm3, x)) + x
        bf, d, c = x.shape
        b = bf // video_length
        xt = x.reshape(b, video_length, d, c).transpose(1, 2).reshape(
            b * d, video_length, c)
        xt = self.attn_temp(_ln(self.norm_temp, xt)) + xt
        return xt.reshape(b, d, video_length, c).transpose(1, 2).reshape(
            bf, d, c)


def adaptive_instance_normalization(content, style, eps: float = 1e-5):
    """AdaIN colour transfer (keep_arch.py), NCHW: content normalised by its
    per-(N, C) mean and standard deviation over H and W, then given
    style's. The variance is the biased one (the JAX package's jnp.var),
    not torch.var's unbiased default."""
    def stats(f):
        var, mean = torch.var_mean(f, dim=(-2, -1), keepdim=True,
                                   correction=0)
        return mean, torch.sqrt(var + eps)

    cm, cs = stats(content)
    sm, ss = stats(style)
    return (content - cm) / cs * ss + sm
