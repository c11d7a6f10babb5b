"""The port's CUDA kernels on a card, against their plain versions, and the
port's models on the card against the port on the CPU. Every test here is
marked `cuda` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerance: max|kernel - plain| <= rtol * max(1, max|plain|), with rtol 1e-4
in f32 (summation order, exp2 against exp) and 1.6e-2 in bf16 (4 ulps of
an 8-bit mantissa: the online softmax rounds P at other points).
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
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    return (rnd(*rows, c), rnd(*rows, c), rnd(c, h, scale=0.05),
            rnd(c, h, scale=0.05), rnd(h, c, scale=0.05), rnd(c), rnd(c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,dv,bias", [(1024, 128, False), (1024, 128, True),
                                       (200, 128, True), (16, 128, False),
                                       (1000, 2, False), (4096, 2, False)])
def test_attention_matches_plain(cuda, dtype, l, dv, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    b = 8
    q, k = (torch.randn(b, l, 128, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn(b, l, dv, generator=g, device=cuda).to(dtype)
    m = None
    if bias:
        m = torch.where(torch.rand(4, l, l, generator=g, device=cuda) > 0.5,
                        0.0, -100.0)
    counter = f"attention[dv{dv}{'+bias' if bias else ''}]"
    before = dict(K.LAUNCHES)
    got = K.attention(q, k, v, 0.088, m)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, counter: before[counter] + 1}
    assert got.dtype == dtype and got.shape == (b, l, dv)
    assert _rel_err(got, K.attention_plain(q, k, v, 0.088, m)) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [4096, 333])
def test_correlation_matches_plain(cuda, dtype, l):
    g = torch.Generator(device=cuda).manual_seed(1)
    f0, f1 = (torch.randn(3, l, 128, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    grid = torch.rand(l, 2, generator=g, device=cuda) * 63
    got = K.global_correlation_expectation(f0, f1, grid)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
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
