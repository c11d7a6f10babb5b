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
so it is held bitwise.
"""
import copy

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


# Every kernel tiles 128 query rows and 64 keys. D_v = 128 at those edges,
# with the (4, L, L) mask (an L that is not a multiple of 4 takes the f32
# kernel's unaligned mask path) and with a per-batch bias (Bm = B); the
# 2-wide V of the global flow attention at the same edges and at its path's
# L = 4096
TILE_EDGES = (63, 64, 65, 127, 128, 129, 200, 1000)
ATTN_CASES = ([(l, 128, bias) for l in (16,) + TILE_EDGES + (1024,)
               for bias in (False, True)]
              + [(200, 128, "per_batch")]
              + [(l, 2, False) for l in TILE_EDGES + (4096,)])


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
@pytest.mark.parametrize("n_rows", [1, 15, 63, 64, 65, 127, 129, 333, 1000])
@pytest.mark.parametrize("h", [64, 128, 1024])
def test_mlp_ragged_rows_and_hidden_widths(cuda, dtype, approximate, n_rows,
                                           h):
    """Row counts at and around the 128-row block and its 16-row warp
    slices, and ones that no block divides (the ragged rows are zero-filled
    and never written); one hidden chunk (H = 64), two (H = 128: the weight
    stream runs into a second chunk) and the path's 16 (H = 1024); one
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
