"""The port's CUDA kernels on a card, against their plain versions, and the
port's models on the card against the port on the CPU. Every test here is
marked `cuda` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerance: max|kernel - plain| <= rtol * max(1, max|plain|), with rtol 1e-4
in f32 (summation order, exp2 against exp) and 1.6e-2 in bf16 (4 ulps of
an 8-bit mantissa: the online softmax rounds P at other points; the
packed convolution rounds its f32 sum, bias included, once in both). The
fused bias + leaky ReLU does the plain version's operations in its order,
so it is held bitwise. The backward kernels are held to float64 against
the plain backward's own distance (BWD_RATIO, below), as chip_smoke.py
holds them.
"""
import copy
import functools
import threading

import numpy as np
import pytest
import torch

from comfyui_keep_torch.ops import kernels as K

RTOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 2), res_blocks=2,
            attn_resolutions=(16,), codebook_size=64, emb_dim=32, dim_embd=64,
            n_head=8, n_layers=2, latent_size=256, cft_list=("32", "64"),
            cfa_list=("16",), cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
            num_uncertainty_layers=1, temp_reg_list=())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1.0)).item()


def _mlp_inputs(dev, dtype, rows=(3, 1000), c=128, h=1024, seed=9):
    """(src, msg, w1 (H, 2C), w2 (C, H), gamma, beta): nn.Linear's layouts."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    return (rnd(*rows, c), rnd(*rows, c), rnd(h, 2 * c, scale=0.05),
            rnd(c, h, scale=0.05), rnd(c), rnd(c))


# The kernels tile 128 query rows (bf16 D_v = 128 and every f32 form: two
# 64-row warpgroups) and 64 keys (bf16 D_v = 128: 128, through a ring of
# two K and two V buffers, so three and more key tiles reuse them; f32: 32
# at D_v = 128 and 64 at D_v = 2 and in K3, through a ring of two stages,
# F32_KEY_EDGES). D_v = 128 at those
# edges, with the (4, L, L) mask (an L that is not a multiple of 4 takes the
# unaligned mask paths) and with a per-batch bias (Bm = B); the 2-wide V of
# the global flow attention at the same edges and at its path's L = 4096
TILE_EDGES = (63, 64, 65, 127, 128, 129, 200, 1000)
DENSE_EDGES = (191, 192, 193, 255, 256, 257, 383, 384, 385)
ATTN_CASES = ([(l, 128, bias) for l in (16,) + TILE_EDGES + (1024,)
               for bias in (False, True)]
              + [(200, 128, "per_batch")]
              + [(l, 2, False) for l in TILE_EDGES + (4096,)]
              + [(l, 128, bias) for l in DENSE_EDGES
                 for bias in (False, True, "per_batch")])


def _matched_keys(q, strength, g):
    """Keys for queries q (B, L, C) as chip_smoke.py's matched_keys makes
    them: key perm[i] is strength * q[i] plus unit noise, so each softmax
    row is peaked on one key and the running max moves between key tiles
    (the online rescale matters)."""
    perm = torch.randperm(q.shape[1], generator=g, device=q.device)
    k = torch.empty_like(q)
    k[:, perm] = (strength * q.float() + torch.randn(
        q.shape, generator=g, device=q.device)).to(q.dtype)
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,dv,bias", ATTN_CASES)
def test_attention_matches_plain(cuda, dtype, l, dv, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    b = 8
    q, k = (torch.randn(b, l, 128, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn(b, l, dv, generator=g, device=cuda).to(dtype)
    m = None
    if bias == "per_batch":
        m = torch.randn(b, l, l, generator=g, device=cuda) * 3.0
    elif bias:
        m = torch.where(torch.rand(4, l, l, generator=g, device=cuda) > 0.5,
                        0.0, -100.0)
    counter = f"attention[dv{dv}{'' if m is None else '+bias'}]"
    before = dict(K.LAUNCHES)
    got = K.attention(q, k, v, 0.088, m)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, counter: before[counter] + 1}
    assert got.dtype == dtype and got.shape == (b, l, dv)
    assert _rel_err(got, K.attention_plain(q, k, v, 0.088, m)) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_refine_windows_with_64_window_mask(cuda, dtype):
    """GMFlow refinement's fine scale: 16 x 16 windows (L = 256) of a
    128 x 128 map split 8 x 8, shifted on odd layers by the (64, 256, 256)
    Swin mask, over B = 2 images x 2 directions x 64 windows; the bias is
    indexed b % 64."""
    from comfyui_keep_torch.models.gmflow import shifted_window_mask
    g = torch.Generator(device=cuda).manual_seed(5)
    b, l = 256, 256
    q = torch.randn(b, l, 128, generator=g, device=cuda).to(dtype)
    k = _matched_keys(q, 0.7, g)
    v = torch.randn(b, l, 128, generator=g, device=cuda).to(dtype)
    m = torch.as_tensor(shifted_window_mask(128, 128, 8), device=cuda)
    assert m.shape == (64, l, l)
    for bias, counter in ((None, "attention[dv128]"),
                          (m, "attention[dv128+bias]")):
        before = dict(K.LAUNCHES)
        key = f"{counter} B{b} L{l}"
        before_shape = K.LAUNCHES_BY_SHAPE.get(key, 0)
        got = K.attention(q, k, v, 1.0 / 128 ** 0.5, bias)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {**before, counter: before[counter] + 1}
        assert K.LAUNCHES_BY_SHAPE[key] == before_shape + 1
        assert got.dtype == dtype and got.shape == (b, l, 128)
        ref = K.attention_plain(q, k, v, 1.0 / 128 ** 0.5, bias)
        assert _rel_err(got, ref) <= RTOL[dtype]


@pytest.mark.cuda
def test_attention_refuses_a_batch_past_the_grid(cuda):
    """The batch rides in gridDim.y: past 65,535 the wrappers raise before
    any launch."""
    q = torch.zeros(K.MAX_GRID_Y + 1, 1, 128, device=cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="batch"):
        K.attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="batch"):
        K.global_correlation_expectation(q, q, torch.zeros(1, 2, device=cuda))
    assert K.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_refuses_a_bias_with_a_2_wide_v(cuda, dtype):
    """No model biases the 2-wide global attention and no kernel takes
    that form: the launch is refused before it runs and counts nothing."""
    q = torch.randn(2, 64, 128, device=cuda).to(dtype)
    v = torch.randn(2, 64, 2, device=cuda).to(dtype)
    m = torch.zeros(1, 64, 64, device=cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="attention kernel launch"):
        K.attention(q, q, v, 0.088, m)
    assert K.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,dv,bias", [(l, 128, b) for l in (129, 1024)
                                       for b in (False, True)]
                         + [(l, 2, False) for l in (65, 1000, 4096)])
def test_attention_peaked_matches_plain(cuda, dtype, l, dv, bias):
    """Keys near the queries (GMFlow's correlations are peaked): the row
    max jumps between key tiles, so a wrong rescale of O, l or the 2-wide
    partial sums shows."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b = 4
    q = torch.randn(b, l, 128, generator=g, device=cuda).to(dtype)
    k = _matched_keys(q, 0.8, g)
    v = (torch.randn(b, l, dv, generator=g, device=cuda) * 8.0).to(dtype)
    m = None
    if bias:
        m = torch.where(torch.rand(2, l, l, generator=g, device=cuda) > 0.5,
                        0.0, -100.0)
    counter = f"attention[dv{dv}{'' if m is None else '+bias'}]"
    before = dict(K.LAUNCHES)
    got = K.attention(q, k, v, 1.0 / 128 ** 0.5, m)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, counter: before[counter] + 1}
    assert got.dtype == dtype and got.shape == (b, l, dv)
    ref = K.attention_plain(q, k, v, 1.0 / 128 ** 0.5, m)
    assert _rel_err(got, ref) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("l", (16, 129, 257, 385, 1024))
def test_attention_bias_row_of_each_batch_entry(cuda, l):
    """The bias of batch entry b is bias[b % Bm]: entries b and b + Bm read
    one bias, and a bias that differs by entry shows a wrong index. Bm = 3
    strongly different masks over B = 9 entries, bf16 and f32."""
    g = torch.Generator(device=cuda).manual_seed(l)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(9, l, 128, generator=g, device=cuda).to(dtype)
                   for _ in range(3))
        m = torch.where(torch.rand(3, l, l, generator=g, device=cuda) > 0.5,
                        0.0, -100.0)
        m[1] = torch.randn(l, l, generator=g, device=cuda) * 4.0
        got = K.attention(q, k, v, 0.088, m)
        torch.cuda.synchronize()
        ref = K.attention_plain(q, k, v, 0.088, m)
        assert _rel_err(got, ref) <= RTOL[dtype]
        # entry b against entry b % 3 with the same q, k, v
        same = K.attention(q[:3].repeat(3, 1, 1), k[:3].repeat(3, 1, 1),
                           v[:3].repeat(3, 1, 1), 0.088, m)
        torch.cuda.synchronize()
        assert torch.equal(same[:3], same[3:6]) and torch.equal(same[:3],
                                                                same[6:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,bias", [(l, b) for l in (65, 192, 257, 385, 768)
                                    for b in (False, True)])
def test_attention_stats_lse_matches_plain(cuda, dtype, l, bias):
    """The forward a gradient records writes each query row's lse (log2
    units) beside its output: both against attention_stats_plain's, on
    peaked keys, with and without the (4, L, L) mask."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(8, l, 128, generator=g, device=cuda).to(dtype)
    k = _matched_keys(q, 0.8, g)
    v = torch.randn(8, l, 128, generator=g, device=cuda).to(dtype)
    m = (torch.where(torch.rand(4, l, l, generator=g, device=cuda) > 0.5,
                     0.0, -100.0) if bias else None)
    out, lse = K._attention_stats_launch(q, k, v, 0.088, m)
    torch.cuda.synchronize()
    ref, ref_lse = K.attention_stats_plain(q, k, v, 0.088, m)
    assert lse.dtype == torch.float32 and lse.shape == (8, l)
    assert _rel_err(out, ref) <= RTOL[dtype]
    assert _rel_err(lse, ref_lse) <= RTOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,bias", [(l, b) for l in (129, 385)
                                    for b in (False, True)])
def test_attention_negative_scale_matches_plain(cuda, dtype, l, bias):
    """A negative scale flips which raw score is a row's largest (the bf16
    kernel takes the row max on the raw scores when there is no bias); the
    ragged last key tile is masked either way."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(4, l, 128, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    m = (torch.where(torch.rand(2, l, l, generator=g, device=cuda) > 0.5,
                     0.0, -100.0) if bias else None)
    got = K.attention(q, k, v, -0.088, m)
    torch.cuda.synchronize()
    assert _rel_err(got, K.attention_plain(q, k, v, -0.088, m)) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("l,bias", [(l, b) for l in (200, 385, 1024)
                                    for b in (False, True)])
def test_attention_two_launches_are_bitwise_equal(cuda, l, bias):
    """No atomics and a fixed order: two launches on the same inputs give
    the same bits, bf16 and f32."""
    g = torch.Generator(device=cuda).manual_seed(11)
    m = (torch.where(torch.rand(4, l, l, generator=g, device=cuda) > 0.5,
                     0.0, -100.0) if bias else None)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(8, l, 128, generator=g, device=cuda).to(dtype)
                   for _ in range(3))
        a, b = K.attention(q, k, v, 0.088, m), K.attention(q, k, v, 0.088, m)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


# f32 key tiles' edges: one tile, the ring's two stages and its wrap (32-
# and 64-key tiles)
F32_KEY_EDGES = (31, 32, 33, 95, 96, 97, 191, 192, 193, 320)


@pytest.mark.cuda
@pytest.mark.parametrize("l", F32_KEY_EDGES)
@pytest.mark.parametrize("form", ["dv128", "dv128+mask", "dv128+per_batch",
                                  "dv2", "correlation"])
def test_f32_forms_at_key_tile_edges(cuda, l, form):
    """Every f32 form at and around its key tile (32 keys at D_v = 128, 64
    at D_v = 2 and in K3) and the three-stage ring's wrap, on peaked keys:
    the output and the lse a gradient records against the plain versions
    (the mask with Bm = 4 < B = 8, a per-batch bias with Bm = B), and two
    launches bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(l)
    b = 8
    q = torch.randn(b, l, 128, generator=g, device=cuda)
    k = _matched_keys(q, 0.8, g)
    if form == "correlation":
        grid = torch.randn(l, 2, generator=g, device=cuda) * 8.0
        args = (q, k, grid)
        fn, stats = (K.global_correlation_expectation,
                     K._correlation_stats_launch)
        plain = K.global_correlation_expectation_stats_plain
    else:
        dv = 2 if form == "dv2" else 128
        v = torch.randn(b, l, dv, generator=g, device=cuda)
        m = None
        if form == "dv128+mask":
            m = torch.where(torch.rand(4, l, l, generator=g, device=cuda)
                            > 0.5, 0.0, -100.0)
        elif form == "dv128+per_batch":
            m = torch.randn(b, l, l, generator=g, device=cuda) * 3.0
        args = (q, k, v, 0.088, m)
        fn, stats = K.attention, K._attention_stats_launch
        plain = K.attention_stats_plain
    got, again = fn(*args), fn(*args)
    out, lse = stats(*args)
    torch.cuda.synchronize()
    ref, ref_lse = plain(*args)
    assert torch.equal(got, again) and torch.equal(got, out)
    assert _rel_err(got, ref) <= RTOL[torch.float32]
    assert _rel_err(lse, ref_lse) <= RTOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", TILE_EDGES + (333, 4096))
def test_correlation_matches_plain(cuda, dtype, l):
    g = torch.Generator(device=cuda).manual_seed(1)
    f0, f1 = (torch.randn(3, l, 128, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    grid = torch.rand(l, 2, generator=g, device=cuda) * 63
    before = dict(K.LAUNCHES)
    got = K.global_correlation_expectation(f0, f1, grid)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, "global_correlation_expectation":
                          before["global_correlation_expectation"] + 1}
    assert got.dtype == torch.float32
    assert _rel_err(got, K.global_correlation_expectation_plain(
        f0, f1, grid)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", (65, 1000, 4096))
def test_correlation_peaked_matches_plain(cuda, dtype, l):
    """f1 near f0 (GMFlow's global matching is peaked): P stays f32 in
    both dtypes, so the f32 tolerance holds."""
    g = torch.Generator(device=cuda).manual_seed(3)
    f0 = torch.randn(3, l, 128, generator=g, device=cuda).to(dtype)
    f1 = _matched_keys(f0, 0.8, g)
    grid = torch.rand(l, 2, generator=g, device=cuda) * 63
    got = K.global_correlation_expectation(f0, f1, grid)
    torch.cuda.synchronize()
    assert _rel_err(got, K.global_correlation_expectation_plain(
        f0, f1, grid)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_matches_plain(cuda, dtype, approximate):
    args = _mlp_inputs(cuda, dtype)
    got = K.mlp_fused(*args, approximate=approximate)
    torch.cuda.synchronize()
    assert _rel_err(got, K.mlp_fused_plain(*args, approximate)) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("n_rows", [1, 15, 63, 64, 65, 127, 128, 129, 191,
                                    192, 193, 255, 256, 257, 333, 1000])
@pytest.mark.parametrize("h", [64, 128, 256, 1024])
def test_mlp_ragged_rows_and_hidden_widths(cuda, dtype, approximate, n_rows,
                                           h):
    """Row counts at and around the 128-row block, its 64-row warpgroups
    (bf16) and 16-row warp slices, and ones that no block divides (the
    ragged rows are zero-filled and never written); one hidden chunk (H =
    64), two (H = 128: the weight stream runs into a second chunk), four (H
    = 256: the three-stage ring wraps) and the path's 16 (H = 1024); one
    launch counted per call."""
    args = _mlp_inputs(cuda, dtype, rows=(1, n_rows), h=h, seed=n_rows + h)
    before = K.LAUNCHES["mlp_fused"]
    got = K.mlp_fused(*args, approximate=approximate)
    torch.cuda.synchronize()
    assert K.LAUNCHES["mlp_fused"] == before + 1
    assert got.dtype == dtype and got.shape == (1, n_rows, 128)
    assert _rel_err(got, K.mlp_fused_plain(*args, approximate)) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_two_launches_are_bitwise_equal(cuda, dtype, approximate):
    """No atomics and a fixed order: two launches give the same bits, with
    and without the LayerNorm input a gradient records."""
    args = _mlp_inputs(cuda, dtype, rows=(1, 1000), seed=12)
    a = K.mlp_fused(*args, approximate=approximate)
    b = K.mlp_fused(*args, approximate=approximate)
    (c, o1), (d, o2) = (K._mlp_stats_launch(*args, approximate)
                        for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(o1, o2)
    assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,c", [(4096, 1024, 256), (333, 64, 32),
                                   (1, 128, 512), (70, 192, 16)])
def test_vq_nearest_indices_matches_plain(cuda, dtype, t, n, c):
    """Picks equal the plain version's wherever its best-to-second gap
    exceeds 1e-5 of max|d| (both accumulate in f32); elsewhere the kernel's
    pick is within that of the minimum. Repeated codes tie: the lowest
    index wins."""
    g = torch.Generator(device=cuda).manual_seed(2)
    e = torch.randn(n, c, generator=g, device=cuda) * (
        0.5 + torch.rand(n, 1, generator=g, device=cuda))
    e[n // 2:n // 2 + 8] = e[:8]
    z = e[torch.randint(0, n, (t,), generator=g, device=cuda)] + torch.randn(
        t, c, generator=g, device=cuda)
    z, e = z.to(dtype), e.to(dtype)
    before = K.LAUNCHES["vq_nearest_indices"]
    got = K.vq_nearest_indices(z, e)
    torch.cuda.synchronize()
    assert K.LAUNCHES["vq_nearest_indices"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (t,)
    ref = K.vq_nearest_indices_plain(z, e)
    d = K.codebook_sq_norms(e) - 2.0 * z.float() @ e.float().t()
    tol = 1e-5 * d.abs().max()
    top2 = (-d).topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    assert torch.equal(got[clear], ref[clear])
    excess = d.gather(1, got.long()[:, None]) - d.gather(1, ref.long()[:, None])
    assert excess.abs().max() <= tol
    assert not ((got >= n // 2) & (got < n // 2 + 8)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [64, 1024, 8192])
def test_vq_ties_across_codebook_splits_go_to_the_lowest_index(cuda, dtype,
                                                                n):
    """The kernel splits the codebook across blocks (64 or 128 codes a
    tile, whole tiles a split) and merges the splits. Codes 0..7 repeat at
    n/2, n - 8 and 1/4 of the way: every token drawn at a repeated code ties
    exactly across tiles and splits, and must get the first copy. Tokens
    away from any repeat must match the plain version's picks."""
    g = torch.Generator(device=cuda).manual_seed(n)
    c, t = 256, 4096
    e = torch.randn(n, c, generator=g, device=cuda).to(dtype)
    copies = sorted({n // 4, n // 2, n - 8} - {0})
    for at in copies:
        e[at:at + 8] = e[:8]
    pick = torch.randint(0, 8, (t,), generator=g, device=cuda)
    z = e[pick].clone()
    single = torch.tensor([i for i in range(8, n)
                           if not any(a <= i < a + 8 for a in copies)],
                          device=cuda)
    near = single[torch.randint(0, len(single), (t - t // 2,), generator=g,
                                device=cuda)]
    z[t // 2:] = (e[near].float() + 0.1 * torch.randn(
        t - t // 2, c, generator=g, device=cuda)).to(dtype)
    got = K.vq_nearest_indices(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got[:t // 2], pick[:t // 2].to(torch.int32))
    ref = K.vq_nearest_indices_plain(z, e)
    d = K.codebook_sq_norms(e) - 2.0 * z.float() @ e.float().t()
    top2 = (-d[t // 2:]).topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * d.abs().max()
    assert clear.float().mean() > 0.9
    assert torch.equal(got[t // 2:][clear], ref[t // 2:][clear])


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 64, 64, device=cuda)
    with pytest.raises(ValueError):
        K.attention(q, q, q, 0.1)                      # D = 64
    q = torch.randn(2, 64, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        K.attention(q, q, q, 0.1)                      # fp16
    q = torch.randn(2, 128, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        K.global_correlation_expectation(q, q, torch.zeros(64, 2,
                                                           device=cuda))
    f = torch.randn(2, 64, 128, device=cuda)
    with pytest.raises(ValueError):
        K.global_correlation_expectation(f, f, torch.zeros(64, 2))  # CPU grid
    args = list(_mlp_inputs(cuda, torch.float32, h=96))
    with pytest.raises(ValueError):
        K.mlp_fused(*args, approximate=True)           # H % 64 != 0
    args = list(_mlp_inputs(cuda, torch.bfloat16))
    with pytest.raises(ValueError):
        K.mlp_fused(*args[:2], args[2].t(), *args[3:], approximate=True)
    off = torch.empty(3 * 1000 * 128 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                    # off the 16-byte grid
        K.mlp_fused(args[0], off[1:].view(3, 1000, 128), *args[2:],
                    approximate=True)
    z = torch.randn(10, 32, device=cuda)
    with pytest.raises(ValueError):
        K.vq_nearest_indices(z, torch.randn(100, 32, device=cuda))  # N % 64
    with pytest.raises(ValueError):
        K.vq_nearest_indices(z, torch.randn(64, 32, device=cuda,
                                            dtype=torch.bfloat16))  # dtypes
    with pytest.raises(ValueError):
        K.vq_nearest_indices(torch.randn(10, 24, device=cuda),
                             torch.randn(64, 24, device=cuda))  # C % 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [
    ((4, 32, 64, 64), 0),    # 16-byte vectors
    ((4, 512), 0),           # the linear layers: one value per channel
    ((3, 5, 7, 9), 0),       # spatial size not a multiple of the vector
    ((2, 8, 16, 16), 1)])    # a pointer off the 16-byte grid
def test_fused_bias_lrelu_matches_plain_bitwise(cuda, dtype, shape, offset):
    g = torch.Generator(device=cuda).manual_seed(3)
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=g, device=cuda).to(dtype)
    x = x[offset:].reshape(shape)
    x.view(-1)[::5] = 0.0
    bias = torch.randn(shape[1], generator=g, device=cuda)
    before = K.LAUNCHES["fused_bias_lrelu"]
    for b in (bias, bias.to(dtype)):
        got = K.fused_bias_lrelu(x, b)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, K.fused_bias_lrelu_plain(x, b))
    assert K.LAUNCHES["fused_bias_lrelu"] == before + 2


@pytest.mark.cuda
def test_fused_leaky_relu_grads_on_card_match_cpu(cuda):
    """ops/native.py fused_leaky_relu on the card (K5 forward, plain-torch
    backward) against the CPU: the value bitwise, the x- and bias-gradients
    and a second-order term (R1's and the path penalty's) to f32 summation
    order."""
    from comfyui_keep_torch.ops.native import fused_leaky_relu
    gen = torch.Generator().manual_seed(4)
    x0, w, v = (torch.randn(2, 16, 8, 8, generator=gen) for _ in range(3))
    b0 = torch.randn(16, generator=gen)
    res = {}
    for dev in ("cpu", cuda):
        x = x0.to(dev).requires_grad_(True)
        b = b0.to(dev).requires_grad_(True)
        out = fused_leaky_relu(x, b)
        gx, gb = torch.autograd.grad((out ** 2 * w.to(dev)).sum(), (x, b),
                                     create_graph=True)
        hx, hb = torch.autograd.grad((gx * v.to(dev)).sum(), (x, b))
        res[str(dev)] = [t.detach().cpu() for t in (out, gx, gb, hx, hb)]
    cpu, card = res["cpu"], res[str(cuda)]
    assert torch.equal(card[0], cpu[0])
    for a, r in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_fused_bias_lrelu_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        K.fused_bias_lrelu(x.transpose(2, 3), b)            # not contiguous
    with pytest.raises(ValueError):
        K.fused_bias_lrelu(x.half(), b)                     # fp16
    with pytest.raises(ValueError):
        K.fused_bias_lrelu(x, torch.zeros(4, device=cuda))  # bias shape
    with pytest.raises(ValueError):
        K.fused_bias_lrelu(x, torch.zeros(8))               # CPU bias
    with pytest.raises(ValueError):
        K.fused_bias_lrelu(x.reshape(-1), b)                # no channel dim


@pytest.mark.cuda
def test_tiny_stylegan2_on_card_matches_cpu(cuda):
    """A tiny generator and discriminator, f32: the card (K5) against the
    CPU (its plain version), within the golden tolerance 2e-3 / 1e-2, and
    K5's launches per forward: 2 mapping layers + 1 + 2 per resolution for
    G, 1 + 2 per ResBlock + 1 + 1 for D."""
    from comfyui_keep_torch.models.stylegan2 import (StyleGAN2Discriminator,
                                                     StyleGAN2Generator)
    g_net = StyleGAN2Generator(32, num_style_feat=16, num_mlp=2,
                               channel_multiplier=1, narrow=0.25,
                               device="cpu")
    d_net = StyleGAN2Discriminator(32, channel_multiplier=1, narrow=0.25,
                                   device="cpu")
    z = torch.randn(4, 16, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        img, _ = g_net([z])
        logits = d_net(img)
        K.reset_launch_counts()
        img_g, _ = copy.deepcopy(g_net).to(cuda)([z.to(cuda)])
        g_launches = K.LAUNCHES["fused_bias_lrelu"]
        logits_g = copy.deepcopy(d_net).to(cuda)(img.to(cuda))
        torch.cuda.synchronize()
    assert g_launches == 2 + 1 + 2 * 3
    assert K.LAUNCHES["fused_bias_lrelu"] - g_launches == 1 + 2 * 3 + 1 + 1
    torch.testing.assert_close(img_g.cpu(), img, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(logits_g.cpu(), logits, atol=2e-3, rtol=1e-2)


@pytest.mark.cuda
def test_tiny_restore_on_card_matches_cpu(cuda):
    """GMFlow (64x64 frames: 4x4 windows, L = 16) and KEEP at a tiny width,
    f32: the card (kernels) against the CPU (plain versions)."""
    from comfyui_keep_torch.models.gmflow import GMFlow, flow_from_clip
    from comfyui_keep_torch.models.keep import KEEP
    gm = GMFlow(num_layers=2, device="cpu",
                generator=torch.Generator().manual_seed(1))
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(2),
               **TINY)
    x = torch.as_tensor(np.random.default_rng(0).random(
        (1, 3, 64, 64, 3), dtype=np.float32) * 2 - 1)
    flows = flow_from_clip(gm, x)
    flows_gpu = flow_from_clip(copy.deepcopy(gm).to(cuda), x.to(cuda))
    for a, b in zip(flows_gpu, flows):
        assert (a.cpu() - b).abs().max().item() <= 5e-2
    out, aux = net.apply(x, flows=flows, return_aux=True)
    picks = aux["logits"].argmax(-1).reshape(1, 3, -1)
    out_g = copy.deepcopy(net).to(cuda).apply(
        x.to(cuda), flows=tuple(f.to(cuda) for f in flows),
        force_indices=picks.to(cuda))
    torch.testing.assert_close(out_g.cpu(), out, atol=5e-3, rtol=1e-2)


PACKED_PADS = [((pt, pb), (pl, pr)) for pt in (0, 1) for pb in (0, 1)
               for pl in (0, 1) for pr in (0, 1)]


def _epilogues(g, cout, dtype, dev):
    """(bias, mask_c) forms of the fused epilogue: none, an f32 bias with
    the parity-1 mask, a bias in x's dtype alone."""
    bias = torch.randn(cout, generator=g, device=dev)
    return ((None, None), (bias, cout // 4), (bias.to(dtype), None))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("taps", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_packed_conv_matches_plain(cuda, dtype, taps):
    """Every taps and pads combination the kernel takes, each with and
    without the fused bias and parity-1 mask, at channel counts that are
    multiples of 4 but not of 8 (8-byte copies), of 64 (ragged K steps) or
    of the 64 / 128 / 256 output tile (masked columns), and at odd grids
    that no 128-pixel tile divides; Cin below one K step (12) and over
    several (512), Cout below the 64-wide tile (12), at it (64) and over the
    128-wide one (256), in batches of 2; one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for (b, h, w_, cin, cout) in ((2, 9, 13, 12, 20), (1, 17, 5, 36, 12),
                                  (3, 11, 11, 256, 68), (1, 19, 23, 64, 256),
                                  (2, 13, 17, 12, 256), (2, 9, 11, 512, 64),
                                  (2, 23, 7, 256, 12), (2, 12, 12, 512, 256),
                                  (2, 11, 14, 256, 128)):
        x = torch.randn(b, h, w_, cin, generator=g, device=cuda).to(dtype)
        w = (torch.randn(*taps, cin, cout, generator=g, device=cuda)
             * 0.1).to(dtype)
        for pads in PACKED_PADS:
            for bias, mask_c in _epilogues(g, cout, dtype, cuda):
                before = K.LAUNCHES["packed_conv2x2"]
                got = K.packed_conv2x2(x, w, pads, bias, mask_c)
                torch.cuda.synchronize()
                assert K.LAUNCHES["packed_conv2x2"] == before + 1
                ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
                assert got.dtype == dtype and got.shape == ref.shape, pads
                assert _rel_err(got, ref) <= RTOL[dtype], (pads, b, h, cin,
                                                           mask_c)


# the packed path's K6 shapes (chip_smoke.py K6_CASES): (B, Hi, Cin, Cout,
# pads); the output grids (256^2, 257^2) are not multiples of 128 pixels
PATH_SAME, PATH_VALID = ((1, 1), (1, 1)), ((0, 0), (0, 0))
K6_PATH_SHAPES = ((1, 256, 12, 256, PATH_SAME), (1, 256, 256, 256, PATH_SAME),
                  (1, 257, 256, 256, PATH_VALID),
                  (1, 257, 512, 256, PATH_VALID),
                  (1, 257, 256, 12, PATH_VALID), (1, 257, 256, 64, PATH_VALID),
                  (1, 256, 128, 512, PATH_SAME),
                  (20, 257, 256, 256, PATH_VALID))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_conv_at_the_path_shapes(cuda, dtype):
    """Every K6 shape of the packed path (its own, (257, 257, 256) VALID,
    its mirror with pad 1, the first (Cin 12) and last (Cout 12)
    convolutions, the LQ encoder's batch of 20), each with and without the
    fused bias and mask."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for b, hi, cin, cout, pads in K6_PATH_SHAPES:
        x = torch.randn(b, hi, hi, cin, generator=g, device=cuda).to(dtype)
        w = (torch.randn(2, 2, cin, cout, generator=g, device=cuda)
             * 0.05).to(dtype)
        for bias, mask_c in _epilogues(g, cout, dtype, cuda):
            got = K.packed_conv2x2(x, w, pads, bias, mask_c)
            torch.cuda.synchronize()
            ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
            assert _rel_err(got, ref) <= RTOL[dtype], (b, hi, cin, cout,
                                                       mask_c)
            del got, ref
        del x, w
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_packed_conv_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda)
    w = torch.randn(2, 2, 16, 8, device=cuda)
    same = ((1, 1), (1, 1))
    before = K.LAUNCHES["packed_conv2x2"]
    for bad_x, bad_w, pads in (
            (x.half(), w.half(), same),                        # fp16
            (x, w.to(torch.bfloat16), same),                   # dtypes differ
            (x.transpose(1, 2), w, same),                      # not contiguous
            (x[..., :14].contiguous(), w[:, :, :14].contiguous(), same),
            (x, w[..., :6].contiguous(), same),                # Cout % 4
            (x, torch.randn(3, 3, 16, 8, device=cuda), same),  # 3 taps
            (x, w, ((2, 0), (0, 0))),                          # pad 2
            (x, w.cpu(), same),                                # CPU weight
            (torch.randn(1025, device=cuda)[1:].view(1, 8, 8, 16), w, same),
            (x[:, :1, :1], w, ((0, 0), (0, 0)))):              # empty output
        with pytest.raises(ValueError):
            K.packed_conv2x2(bad_x, bad_w, pads)
    for bias, mask_c in ((torch.zeros(4, device=cuda), None),  # bias shape
                         (torch.zeros(8), None),                # CPU bias
                         (torch.zeros(8, device=cuda).half(), None),
                         (None, 3), (None, 0)):                 # 4 mask_c
        with pytest.raises(ValueError):
            K.packed_conv2x2(x, w, same, bias, mask_c)
    assert K.LAUNCHES["packed_conv2x2"] == before


@pytest.mark.cuda
def test_packed_keep_on_card_matches_unpacked_cpu(cuda):
    """A narrow KEEP at 512 px, f32: the card's phase-packed forward (K6)
    against the CPU's unpacked one, picks forced from the CPU, within the
    golden tolerance. With one ResBlock per level a packed stack pass is 4
    K6 launches (its first conv or upconv, 2 in the ResBlock, the
    Downsample or final conv): the LQ encoder once over both frames, the
    HQ encoder for frame 1, the generator tail per frame, 16 at T = 2."""
    from comfyui_keep_torch.models.keep import KEEP
    cfg = dict(img_size=512, nf=32, ch_mult=(1, 2, 2, 2, 2, 2), res_blocks=1,
               attn_resolutions=(16,), codebook_size=64, emb_dim=32,
               dim_embd=64, n_head=4, n_layers=1, latent_size=256,
               cft_list=("32", "64"), cfa_list=("16",), cfa_nhead=2,
               cfa_dim=16, kalman_attn_head_dim=8, num_uncertainty_layers=1,
               temp_reg_list=())
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(8),
               **cfg)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.random((1, 2, 512, 512, 3), dtype=np.float32)
                        * 2 - 1)
    out, aux = net.apply(x, return_aux=True)
    picks = aux["logits"].argmax(-1).reshape(1, 2, -1)
    packed = copy.deepcopy(net).to(cuda).prepare_phase512()
    before = K.LAUNCHES["packed_conv2x2"]
    out_g = packed.apply(x.to(cuda), force_indices=picks.to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["packed_conv2x2"] - before == 16
    torch.testing.assert_close(out_g.cpu(), out, atol=5e-3, rtol=1e-2)


@pytest.mark.cuda
def test_packed_conv_refuses_a_cuda_input_that_requires_grad(cuda):
    """K6 serves only: a CUDA input that records a gradient raises rather
    than detach; under no_grad it launches."""
    x = torch.randn(1, 4, 4, 8, device="cuda", requires_grad=True)
    w = torch.randn(2, 2, 8, 8, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        K.packed_conv2x2(x, w, ((0, 1), (0, 1)))
    with torch.no_grad():
        assert K.packed_conv2x2(x, w, ((0, 1), (0, 1))).shape == (1, 4, 4, 8)


# K6's bf16 routes (ops/kernels.py:packed_conv_plan): every tile of the
# TMA kernel, forced through the plan
TMA_TILES = list(K.PACKED_CONV_TILES)


def _force_tma_plan(monkeypatch, bm, bn):
    real = K.packed_conv_plan

    def plan(b, hi, wi, cin, cout, kh, kw, pads, dtype=torch.bfloat16):
        p = real(b, hi, wi, cin, cout, kh, kw, pads, dtype)
        if p.route != "tma":
            return p
        (pt, pb), (pl, pr) = pads
        m = b * (hi + pt + pb - kh + 1) * (wi + pl + pr - kw + 1)
        return K._tma_plan(m, cout, bm, bn, K.H100_SMS)
    monkeypatch.setattr(K, "packed_conv_plan", plan)
    # the wrapper's per-geometry arguments, cached apart from the real ones
    monkeypatch.setattr(K, "_packed_conv_call", functools.lru_cache()(
        K._packed_conv_call.__wrapped__))


def _packed_case(g, dev, dtype, b, h, w_, cin, cout, taps, scale=0.1):
    x = torch.randn(b, h, w_, cin, generator=g, device=dev).to(dtype)
    w = (torch.randn(*taps, cin, cout, generator=g, device=dev)
         * scale).to(dtype)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TMA_TILES,
                         ids=[f"{a}x{b}" for a, b in TMA_TILES])
def test_packed_conv_tma_forms_match_plain(cuda, monkeypatch, tile):
    """Each TMA tile, forced, at every taps and pads form, with and without
    the fused bias (f32 and bf16) and mask: outputs narrower than the tile
    (24, 136 of 256), Cout = 128, Cin below one K step (16) and over
    several (512), batches whose pixel tiles cross rows and images, one
    launch a call."""
    bm, bn = tile
    _force_tma_plan(monkeypatch, bm, bn)
    g = torch.Generator(device=cuda).manual_seed(25)
    for b, h, w_, cin, cout in ((3, 7, 30, 16, 24), (2, 11, 14, 256, 128),
                                (1, 33, 33, 128, 136), (2, 12, 12, 512, 64)):
        for taps in ((1, 1), (1, 2), (2, 1), (2, 2)):
            x, w = _packed_case(g, cuda, torch.bfloat16, b, h, w_, cin, cout,
                                taps)
            for pads in PACKED_PADS:
                for bias, mask_c in _epilogues(g, cout, torch.bfloat16, cuda):
                    assert (K.packed_conv_plan(b, h, w_, cin, cout, *taps,
                                               pads).bn == bn)
                    before = K.LAUNCHES["packed_conv2x2"]
                    got = K.packed_conv2x2(x, w, pads, bias, mask_c)
                    torch.cuda.synchronize()
                    assert K.LAUNCHES["packed_conv2x2"] == before + 1
                    ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
                    assert _rel_err(got, ref) <= RTOL[torch.bfloat16], (
                        pads, taps, b, h, cin, cout, mask_c)


@pytest.mark.cuda
def test_packed_conv_cout_128_at_every_pads_form(cuda):
    """Cout = 128 (the downsample p0 convolutions' width: a 128-wide tile
    where the grid is not small) through the plan at every taps and pads
    form, bias and mask."""
    g = torch.Generator(device=cuda).manual_seed(26)
    for taps in ((1, 1), (1, 2), (2, 1), (2, 2)):
        x, w = _packed_case(g, cuda, torch.bfloat16, 3, 64, 64, 512, 128,
                            taps, 0.05)
        for pads in PACKED_PADS:
            plan = K.packed_conv_plan(3, 64, 64, 512, 128, *taps, pads)
            assert plan.route == "tma" and plan.bn == 128
            for bias, mask_c in _epilogues(g, 128, torch.bfloat16, cuda):
                got = K.packed_conv2x2(x, w, pads, bias, mask_c)
                torch.cuda.synchronize()
                ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
                assert _rel_err(got, ref) <= RTOL[torch.bfloat16], (pads,
                                                                    taps)


@pytest.mark.cuda
def test_packed_conv_tiles_across_images(cuda):
    """A batch of 7 images of 9 x 11 outputs (99 pixels: every pixel tile
    crosses images, the last runs past the batch) through the plan."""
    g = torch.Generator(device=cuda).manual_seed(27)
    x, w = _packed_case(g, cuda, torch.bfloat16, 7, 10, 12, 256, 256, (2, 2))
    for pads in (((0, 0), (0, 0)), ((1, 1), (1, 1)), ((0, 1), (0, 1))):
        got = K.packed_conv2x2(x, w, pads)
        torch.cuda.synchronize()
        ref = K.packed_conv2x2_plain(x, w, pads)
        assert _rel_err(got, ref) <= RTOL[torch.bfloat16], pads


@pytest.mark.cuda
def test_packed_conv_small_grids_are_repeatable(cuda):
    """The generator's B = 1 levels (65^2 and 129^2, the plans that narrow
    the tile for a small grid): against the plain version, and two calls
    bitwise equal (no atomics: every output is one block's f32 sum)."""
    import chip_smoke as cs
    g = torch.Generator(device=cuda).manual_seed(28)
    for label, b, hi, cin, cout, kh, kw, pads in cs.K6_LEVEL_CASES:
        if b != 1:
            continue
        x, w = _packed_case(g, cuda, torch.bfloat16, b, hi, hi, cin, cout,
                            (kh, kw), 0.02)
        one = K.packed_conv2x2(x, w, pads)
        two = K.packed_conv2x2(x, w, pads)
        torch.cuda.synchronize()
        assert torch.equal(one, two), label
        ref = K.packed_conv2x2_plain(x, w, pads)
        assert _rel_err(one, ref) <= RTOL[torch.bfloat16], label


@pytest.mark.cuda
def test_packed_conv_narrow_channels_take_cp_async(cuda):
    """Cin = 12 (the encoder's first conv) and Cout = 12 (the generator's
    last): 8-byte strides, the cp.async route, bias and mask."""
    g = torch.Generator(device=cuda).manual_seed(29)
    same, valid = ((1, 1), (1, 1)), ((0, 0), (0, 0))
    for cin, cout, pads in ((12, 256, same), (256, 12, valid),
                            (12, 12, same)):
        plan = K.packed_conv_plan(2, 33, 33, cin, cout, 2, 2, pads)
        assert plan.route == "cp.async"
        x, w = _packed_case(g, cuda, torch.bfloat16, 2, 33, 33, cin, cout,
                            (2, 2), 0.1)
        for bias, mask_c in _epilogues(g, cout, torch.bfloat16, cuda):
            got = K.packed_conv2x2(x, w, pads, bias, mask_c)
            torch.cuda.synchronize()
            ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
            assert _rel_err(got, ref) <= RTOL[torch.bfloat16], (cin, cout)


F32_TILES = list(K.PACKED_CONV_F32_TILES)


def _force_tf32_plan(monkeypatch, bm, bn):
    real = K.packed_conv_plan

    def plan(b, hi, wi, cin, cout, kh, kw, pads, dtype=torch.bfloat16):
        p = real(b, hi, wi, cin, cout, kh, kw, pads, dtype)
        if p.route != "tf32":
            return p
        (pt, pb), (pl, pr) = pads
        m = b * (hi + pt + pb - kh + 1) * (wi + pl + pr - kw + 1)
        return K._tma_plan(m, cout, bm, bn, K.H100_SMS, torch.float32)
    monkeypatch.setattr(K, "packed_conv_plan", plan)
    monkeypatch.setattr(K, "_packed_conv_call", functools.lru_cache()(
        K._packed_conv_call.__wrapped__))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", F32_TILES,
                         ids=[f"{a}x{b}" for a, b in F32_TILES])
def test_packed_conv_tf32_forms_match_plain(cuda, monkeypatch, tile):
    """Each f32 (3xTF32) tile, forced, at every taps and pads form, with
    and without the fused bias and mask: 12 channels in and out (TMA's
    zero fill pads K, the store clips N; an odd phase-block width, mask_c
    = 3), outputs narrower than the tile (24, 136), Cin over several K
    steps (512), batches whose pixel tiles cross rows and images (ragged
    M), one launch a call, two calls bitwise equal."""
    bm, bn = tile
    _force_tf32_plan(monkeypatch, bm, bn)
    g = torch.Generator(device=cuda).manual_seed(31)
    for b, h, w_, cin, cout in ((3, 7, 30, 12, 24), (2, 11, 14, 256, 12),
                                (1, 33, 33, 128, 136), (2, 12, 12, 512, 64),
                                (2, 9, 13, 12, 12)):
        for taps in ((1, 1), (1, 2), (2, 1), (2, 2)):
            x, w = _packed_case(g, cuda, torch.float32, b, h, w_, cin, cout,
                                taps)
            for pads in PACKED_PADS:
                for bias, mask_c in _epilogues(g, cout, torch.float32, cuda):
                    plan = K.packed_conv_plan(b, h, w_, cin, cout, *taps,
                                              pads, torch.float32)
                    assert plan.route == "tf32" and plan.bn == bn
                    before = K.LAUNCHES["packed_conv2x2"]
                    got = K.packed_conv2x2(x, w, pads, bias, mask_c)
                    again = K.packed_conv2x2(x, w, pads, bias, mask_c)
                    torch.cuda.synchronize()
                    assert K.LAUNCHES["packed_conv2x2"] == before + 2
                    assert torch.equal(got, again)
                    ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
                    assert _rel_err(got, ref) <= RTOL[torch.float32], (
                        pads, taps, b, h, cin, cout, mask_c)


@pytest.mark.cuda
def test_packed_conv_f32_narrow_channels_take_tf32(cuda):
    """f32 at the packed path's 12-channel convolutions (the encoder's first,
    Cin 12, and the generator's last, Cout 12, at their path shapes) and
    12 in and out: the tf32 route through TMA (16-byte strides), bias and
    mask, against the plain version and bitwise repeatable."""
    g = torch.Generator(device=cuda).manual_seed(32)
    same, valid = ((1, 1), (1, 1)), ((0, 0), (0, 0))
    for b, hi, cin, cout, pads in ((1, 256, 12, 256, same),
                                   (1, 257, 256, 12, valid),
                                   (2, 33, 12, 12, same)):
        plan = K.packed_conv_plan(b, hi, hi, cin, cout, 2, 2, pads,
                                  torch.float32)
        assert plan.route == "tf32"
        x, w = _packed_case(g, cuda, torch.float32, b, hi, hi, cin, cout,
                            (2, 2), 0.1)
        for bias, mask_c in _epilogues(g, cout, torch.float32, cuda):
            got = K.packed_conv2x2(x, w, pads, bias, mask_c)
            again = K.packed_conv2x2(x, w, pads, bias, mask_c)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (cin, cout)
            ref = K.packed_conv2x2_plain(x, w, pads, bias, mask_c)
            assert _rel_err(got, ref) <= RTOL[torch.float32], (cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_conv_at_the_level_shapes_batch_2(cuda, dtype):
    """Every geometry of chip_smoke.py's K6_LEVEL_CASES (the multi-level
    forms and GMFlow's packed layer1) at batch 2."""
    import chip_smoke as cs
    g = torch.Generator(device=cuda).manual_seed(30)
    for label, _, hi, cin, cout, kh, kw, pads in cs.K6_LEVEL_CASES:
        x, w = _packed_case(g, cuda, dtype, 2, hi, hi, cin, cout, (kh, kw),
                            0.02)
        got = K.packed_conv2x2(x, w, pads)
        torch.cuda.synchronize()
        ref = K.packed_conv2x2_plain(x, w, pads)
        assert _rel_err(got, ref) <= RTOL[dtype], label
        del x, w, got, ref


# each backward kernel against float64 (the plain version's autograd on
# the same values in float64): its max|d| over the largest float64
# gradient within BWD_RATIO times the plain backward's own (the same
# formula in torch ops on the same saved statistics) or the floor, as
# chip_smoke.py's phase flow_kernel holds them; the f32 floor is 2e-6, not
# chip_smoke.py's 1e-6: at these small shapes cuBLAS splits the plain
# backward's sums where K2's kernel sums its 512 hidden units in order
BWD_RATIO, BWD_FLOOR = 3.0, {torch.float32: 2e-6, torch.bfloat16: 1e-6}
PLAIN_NAMES = ("attention_plain", "attention_stats_plain",
               "attention_backward_plain",
               "global_correlation_expectation_plain",
               "global_correlation_expectation_stats_plain",
               "global_correlation_expectation_backward_plain",
               "mlp_fused_plain", "mlp_fused_stats_plain",
               "mlp_fused_backward_plain")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["window", "window+bias", "global", "corr",
                                  "mlp"])
# the backward kernels tile 128 own rows (64 on the f32 D_v = 128 dK / dV
# side), 64 a warpgroup, and 16 (f32) or 64 (bf16) streamed ones: L at a
# multiple of 128, ragged L (the mask's too), the warpgroups' edges 64 k
# +- 1 (129 and 193 leave a last streamed tile one row wide at both tile
# sizes), and the GMFlow step's window L = 768 at B = 2; at B = 4 the mask
# has Bm = 2 < B
@pytest.mark.parametrize("b,l", [(4, 256), (4, 200), (4, 1000), (2, 768),
                                 (4, 127), (4, 129), (4, 193)])
def test_kernel_gradients_on_the_card_equal_the_plain_versions(
        cuda, monkeypatch, b, l, form, dtype):
    """On a CUDA tensor that requires grad, each of K1-K3 launches its
    forward kernel and, in the backward, its backward kernel once (counted
    by its own LAUNCHES entry) and never a plain version (each made to
    raise here); the gradients stand off float64 no further than BWD_RATIO
    times the plain backward's, and two identical calls give equal bits.
    Without grad the forward kernel alone launches and builds no graph."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device="cuda") * scale).to(dtype)

    if form == "corr":
        grid = torch.rand(l, 2, generator=g, device="cuda") * 16
        args, diff = (r(b, l, 128), r(b, l, 128), grid), (0, 1)
        fn, counter = (K.global_correlation_expectation,
                       "global_correlation_expectation")
    elif form == "mlp":
        args = (r(b, l, 128), r(b, l, 128), r(512, 256, scale=0.05),
                r(128, 512, scale=0.05), r(128), r(128),
                dtype == torch.bfloat16)
        diff, fn, counter = (0, 1, 2, 3, 4, 5), K.mlp_fused, "mlp_fused"
    else:
        dv = 2 if form == "global" else 128
        bias = (torch.where(torch.rand(2, l, l, generator=g,
                                       device="cuda") < 0.3, -100.0, 0.0)
                if form == "window+bias" else None)
        args = (r(b, l, 128), r(b, l, 128), r(b, l, dv), 0.088, bias)
        diff, fn = (0, 1, 2), K.attention
        counter = f"attention[dv{dv}{'' if bias is None else '+bias'}]"
    fname = counter.split("[")[0]
    bwd_counter = counter.replace(fname, f"{fname}_bwd", 1)
    plain = {n: getattr(K, n) for n in PLAIN_NAMES}

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for n in PLAIN_NAMES:
        monkeypatch.setattr(K, n, refuse)
    leaves = [a.detach().clone().requires_grad_(True) if i in diff else a
              for i, a in enumerate(args)]
    inputs = [leaves[i] for i in diff]
    probe = fn(*args)   # no input requires grad: the forward kernel alone
    up = torch.randn(probe.shape, generator=g, device="cuda").to(probe.dtype)
    runs = []
    for _ in range(2):
        before = dict(K.LAUNCHES)
        out = fn(*leaves)
        assert out.grad_fn is not None
        assert K.LAUNCHES == {**before, counter: before[counter] + 1}
        runs.append(torch.autograd.grad(out, inputs, up))
        torch.cuda.synchronize()
        assert K.LAUNCHES == {**before, counter: before[counter] + 1,
                              bwd_counter: before[bwd_counter] + 1}
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    with torch.no_grad():       # serving: the forward kernel alone, no graph
        before = dict(K.LAUNCHES)
        assert fn(*leaves).grad_fn is None
        assert K.LAUNCHES == {**before, counter: before[counter] + 1}
    monkeypatch.undo()
    if fn is K.attention:
        stats = plain["attention_stats_plain"](*args)
        want = plain["attention_backward_plain"](*args, *stats, up)
    elif fn is K.mlp_fused:
        stats = plain["mlp_fused_stats_plain"](*args)
        want = plain["mlp_fused_backward_plain"](*args, *stats, up)
    else:
        stats = plain["global_correlation_expectation_stats_plain"](*args)
        want = plain["global_correlation_expectation_backward_plain"](
            *args, *stats, up)
    a64 = [a.detach().double().requires_grad_(i in diff)
           if torch.is_tensor(a) else a for i, a in enumerate(args)]
    ref = torch.autograd.grad(plain[f"{fn.__name__}_plain"](*a64),
                              [a64[i] for i in diff], up.double())
    for got, p_, r64 in zip(runs[0], want, ref):
        assert got.dtype == p_.dtype == dtype
        k_off = ((got.double() - r64).abs().max() / r64.abs().max()).item()
        p_off = ((p_.double() - r64).abs().max() / r64.abs().max()).item()
        assert k_off <= max(BWD_RATIO * p_off, BWD_FLOOR[dtype])


def _mlp_bwd_bytes(rows, c, h, dtype):
    """What K2's backward may allocate beyond its inputs: the gradients and
    the scratch csrc/mlp.cu sizes (K.mlp_bwd_scratch_bytes: dO', W2^T, the
    LayerNorm's block sums, the weight blocks' slice partials, and in f32
    only da and h, (rows, H) each). Each tensor rounds up to the caching
    allocator's 512 bytes, and one over 1 MiB may take a cached block up to
    1 MiB larger (the allocator splits no smaller remainder off)."""
    es = 2 if dtype == torch.bfloat16 else 4
    sizes = [rows * c * es] * 2 + [2 * c * h * es, c * h * es, 2 * c * es]
    sizes += [n for n in K.mlp_bwd_scratch_bytes(rows, c, h, dtype) if n]
    return sum(-(-n // 512) * 512 + (2 ** 20 if n > 2 ** 20 else 0)
               for n in sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("h", [64, 512, 1024])
# K2's backward tiles rows in 128 a row block (f32: a row tile of its GEMM
# launches) and sums the weight products over slices of 2,048 rows: one
# row, three, one past a row block, and 5,000 (slices of 2,048, 2,048 and
# 904 rows)
@pytest.mark.parametrize("rows", [1, 3, 129, 5000])
def test_mlp_gradients_on_the_card_at_the_partitions_edges(
        cuda, monkeypatch, rows, h, tanh, dtype):
    """K2's backward kernels at the edges of their partition: each gradient
    off float64 within BWD_RATIO times the plain backward's distance (or
    the floor), two calls equal bit for bit, one mlp_fused_bwd launch a
    backward and no plain version, and no more memory than the gradients
    and the documented scratch (in bf16 nothing (rows, H) wide)."""
    g = torch.Generator(device="cuda").manual_seed(rows + h)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device="cuda") * scale).to(dtype)

    args = (r(1, rows, 128), r(1, rows, 128), r(h, 256, scale=0.05),
            r(128, h, scale=0.05), r(128), r(128), tanh)
    plain = {n: getattr(K, n) for n in PLAIN_NAMES}

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for n in PLAIN_NAMES:
        monkeypatch.setattr(K, n, refuse)
    leaves = [a.detach().clone().requires_grad_(True) for a in args[:6]]
    up = torch.randn((1, rows, 128), generator=g, device="cuda").to(dtype)
    out = K.mlp_fused(*leaves, tanh)
    runs, extra = [], None
    for _ in range(2):
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs.append(torch.autograd.grad(out, leaves, up, retain_graph=True))
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert K.LAUNCHES == {**before, "mlp_fused_bwd":
                              before["mlp_fused_bwd"] + 1}
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    assert extra <= _mlp_bwd_bytes(rows, 128, h, dtype)
    if dtype == torch.bfloat16:  # no da or h in memory
        assert K.mlp_bwd_scratch_bytes(rows, 128, h, dtype)[4:] == [0, 0]
    monkeypatch.undo()
    stats = plain["mlp_fused_stats_plain"](*args)
    want = plain["mlp_fused_backward_plain"](*args, *stats, up)
    a64 = [a.detach().double().requires_grad_(True) for a in args[:6]]
    ref = torch.autograd.grad(plain["mlp_fused_plain"](*a64, tanh), a64,
                              up.double())
    for got, p_, r64 in zip(runs[0], want, ref):
        assert got.dtype == p_.dtype == dtype
        k_off = ((got.double() - r64).abs().max() / r64.abs().max()).item()
        p_off = ((p_.double() - r64).abs().max() / r64.abs().max()).item()
        assert k_off <= max(BWD_RATIO * p_off, BWD_FLOOR[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 192])
@pytest.mark.parametrize("rows", [2, 31, 33, 127, 255])
def test_mlp_f32_backward_at_small_ragged_rows(cuda, rows, h):
    """K2's f32 backward (3xTF32 wgmma: its GEMM launches' 128-row tiles,
    32-row K steps and the padded da^T / h^T rows) at small ragged row
    counts: each gradient off float64 within BWD_RATIO times the plain
    backward's distance (or the floor), two calls equal bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(500 + rows + h)

    def r(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    args = (r(1, rows, 128), r(1, rows, 128), r(h, 256, scale=0.05),
            r(128, h, scale=0.05), r(128), r(128), False)
    leaves = [a.detach().clone().requires_grad_(True) for a in args[:6]]
    up = torch.randn((1, rows, 128), generator=g, device="cuda")
    out = K.mlp_fused(*leaves, False)
    one = torch.autograd.grad(out, leaves, up, retain_graph=True)
    two = torch.autograd.grad(out, leaves, up, retain_graph=True)
    torch.cuda.synchronize()
    for a, b_ in zip(one, two):
        assert torch.equal(a, b_)
    stats = K.mlp_fused_stats_plain(*args)
    want = K.mlp_fused_backward_plain(*args, *stats, up)
    a64 = [a.detach().double().requires_grad_(True) for a in args[:6]]
    ref = torch.autograd.grad(K.mlp_fused_plain(*a64, False), a64,
                              up.double())
    for got, p_, r64 in zip(one, want, ref):
        k_off = ((got.double() - r64).abs().max() / r64.abs().max()).item()
        p_off = ((p_.double() - r64).abs().max() / r64.abs().max()).item()
        assert k_off <= max(BWD_RATIO * p_off, BWD_FLOOR[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["forward", "backward"])
@pytest.mark.parametrize("fn_name", ["attention", "mlp_fused"])
def test_launch_from_a_thread_with_no_cuda_call_yet(cuda, fn_name, which):
    """A launcher called from a thread that has made no CUDA call, its
    tensors served by the caching allocator without one (autograd's device
    thread in a process that has run other kernels): its first CUDA work
    is a tensor map's encode, which binds the device's context first; the
    result equals the main thread's bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(41)

    def r(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale
    if fn_name == "attention":
        args = (r(4, 256, 128), r(4, 256, 128), r(4, 256, 128), 0.088, None)
    else:
        args = (r(1, 300, 128), r(1, 300, 128), r(512, 256, scale=0.05),
                r(128, 512, scale=0.05), r(128), r(128), False)
    fwd, bwd = K.LAUNCHERS[fn_name]
    saved = fwd(*args)
    up = torch.randn(saved[0].shape, generator=g, device="cuda")
    call = (lambda: fwd(*args)) if which == 0 else (
        lambda: bwd(*args, *saved, up))
    want = call()           # the main thread's
    spare = call()          # freed: its blocks serve the thread's call
    del spare
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = call()
            torch.cuda.synchronize()
        except Exception as exc:  # reported below, on the test's thread
            got["error"] = exc
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in got, got.get("error")
    for a, b_ in zip(want, got["out"]):
        if torch.is_tensor(a):
            assert torch.equal(a, b_)
