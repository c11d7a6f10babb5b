"""K6's launch plans (comfyui_keep_torch/ops/kernels.py:packed_conv_plan)
and a torch model of the walk of its TMA kernels
(csrc/packed_conv.cu:packed_conv_wgmma_kernel, bf16, and
packed_conv_tf32_kernel, f32), on the CPU at small shapes.

(a) At every geometry of chip_smoke.py's K6_CASES and K6_LEVEL_CASES and
every taps x pads form of tests/test_torch_kernels_cuda.py's
test_packed_conv_matches_plain, in both dtypes: the plan's tiles, walked
by its blocks, cover each output pixel and channel exactly once; a block's
shared memory stays within the H100's 232,448 bytes; the TMA boxes and
strides keep TMA's limits (f32: 16-byte strides at 12 channels too); the
cp.async route is taken exactly where a bf16 Cin or Cout is not a
multiple of 8, and f32 always takes the tf32 route.
(b) The walk emulated: per tile, per (tap, 64-channel block; f32: 32), the
im2col box (the bounding box's traversal from the tile's first pixel, each
pixel read shifted by the tap, zero out of range) and the weight box (zero
past Cin and Cout), f32 sums (f32: each K step's product as 3xTF32, added
in f32), then the bias, the parity-1 mask and one rounding; held against
packed_conv2x2_plain and, at K6's own form, against JAX's pallas_conv in
interpret mode (as tests/test_torch_kernels.py runs it), from one numpy
seed.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from comfyui_keep_torch.ops import kernels as K
from tests.test_torch_kernels import _pallas_conv, _jx
from tests.torch_port_helpers import mm_3xtf32

PADS = [((pt, pb), (pl, pr)) for pt in (0, 1) for pb in (0, 1)
        for pl in (0, 1) for pr in (0, 1)]
TAPS = [(1, 1), (1, 2), (2, 1), (2, 2)]
# tests/test_torch_kernels_cuda.py test_packed_conv_matches_plain's shapes
CARD_SHAPES = ((2, 9, 13, 12, 20), (1, 17, 5, 36, 12), (3, 11, 11, 256, 68),
               (1, 19, 23, 64, 256), (2, 13, 17, 12, 256), (2, 9, 11, 512, 64),
               (2, 23, 7, 256, 12), (2, 12, 12, 512, 256),
               (2, 11, 14, 256, 128))


def _geometries():
    """(label, B, Hi, Wi, Cin, Cout, kh, kw, pads) of both case lists."""
    for label, b, hi, cin, cout, pads, _ in cs.K6_CASES:
        yield label, b, hi, hi, cin, cout, 2, 2, pads
    for label, b, hi, cin, cout, kh, kw, pads in cs.K6_LEVEL_CASES:
        yield label, b, hi, hi, cin, cout, kh, kw, pads


GEOMETRIES = list(_geometries())


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _out_hw(hi, wi, kh, kw, pads):
    (pt, pb), (pl, pr) = pads
    return hi + pt + pb - kh + 1, wi + pl + pr - kw + 1


def _walk(plan):
    """Each block's tiles in the order it takes them: (pixel tile, output
    tile). The TMA route's persistent blocks take tiles b, b + grid, ...,
    the others one tile each."""
    tiles = plan.m_tiles * plan.n_tiles
    return [[(t % plan.m_tiles, t // plan.m_tiles)
             for t in range(blk, tiles, plan.grid)]
            for blk in range(plan.grid)]


def _check_plan(b, hi, wi, cin, cout, kh, kw, pads, dtype=torch.bfloat16):
    plan = K.packed_conv_plan(b, hi, wi, cin, cout, kh, kw, pads, dtype)
    ho, wo = _out_hw(hi, wi, kh, kw, pads)
    m = b * ho * wo
    f32 = dtype == torch.float32
    narrow = bool(cin % 8 or cout % 8)
    assert plan.route == ("tf32" if f32 else "cp.async" if narrow else "tma")
    assert plan.smem_bytes <= K.SMEM_LIMIT
    # every output pixel and channel covered exactly once: the tiles tile
    # (m, cout) with one partial row and column at most, each taken once
    assert plan.m_tiles * plan.bm >= m > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= cout > (plan.n_tiles - 1) * plan.bn
    cover = np.zeros((plan.m_tiles, plan.n_tiles), int)
    for tiles in _walk(plan):
        for mt, nt in tiles:
            cover[mt, nt] += 1
    assert (cover == 1).all()
    if plan.route == "tf32":
        assert plan.grid == min(plan.m_tiles * plan.n_tiles, K.H100_SMS)
        assert (plan.bm, plan.bn) in K.PACKED_CONV_F32_TILES
        assert plan.bn <= -(-cout // 32) * 32
        assert 2 <= plan.stages <= K.PACKED_CONV_MAX_STAGES
        # the raw patch and the weights' TF32 hi and lo tiles, 128-byte rows
        stage = (plan.bm + 2 * plan.bn) * K.K_STEP_F32 * 4
        assert plan.smem_bytes == 2048 + 2 * 16384 + plan.stages * stage
        assert stage < 2 ** 20 and plan.stages * stage + 2048 + 32768 \
            <= K.SMEM_LIMIT
        # im2col map: 32 f32 channels (the 128-byte swizzle span) x bm
        # pixels, its corners as the bf16 kernel's
        assert K.K_STEP_F32 * 4 == 128 and plan.bm <= 256
        # x (B, Hi, Wi, Cin), the split weights (2, taps, Cout, Cin) and
        # the output (M, Cout): every stride a multiple of 16 bytes (Cin
        # and Cout multiples of 4, 12 included)
        strides = (cin * 4, cin * wi * 4, cin * wi * hi * 4, cin * 4,
                   cin * cout * 4, cout * 4)
        assert all(s % 16 == 0 and s < 2 ** 40 for s in strides)
        assert max(cin, wi, hi, b, cout, 2 * kh * kw, m) < 2 ** 31
    if plan.route == "tma":
        assert plan.grid == min(plan.m_tiles * plan.n_tiles, K.H100_SMS)
        assert (plan.bm, plan.bn) in K.PACKED_CONV_TILES
        assert plan.bn <= -(-cout // 64) * 64
        assert 2 <= plan.stages <= K.PACKED_CONV_MAX_STAGES
        stage = (plan.bm + plan.bn) * K.K_STEP * 2
        # barriers, alignment, two 16 KB epilogue tiles, the ring
        assert plan.smem_bytes == 2048 + 2 * 16384 + plan.stages * stage
        assert stage < 2 ** 20            # an mbarrier's transaction count
        # im2col map: 64 channels (128 bytes: the swizzle span) x bm pixels
        assert K.K_STEP * 2 == 128 and plan.bm <= 1024
        (pt, pb), (pl, pr) = pads
        corners = (-pl, -pt, wo - wi - pl, ho - hi - pt)
        assert corners == (-pl, -pt, pr - (kw - 1), pb - (kh - 1))
        assert all(-128 <= c <= 127 for c in corners)   # a 4-D map's range
        strides = (cin * 2, cin * wi * 2, cin * wi * hi * 2)
        # tiled weight map over (taps, Cin, Cout): 64 x 64 x 1 boxes
        strides += (cout * 2, cout * cin * 2)
        assert all(s % 16 == 0 and s < 2 ** 40 for s in strides)
        assert max(cin, wi, hi, b, cout, kh * kw) < 2 ** 32
    return plan


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_plan_at_the_path_shapes(geom):
    """Each K6 geometry of chip_smoke.py's case lists: coverage, shared
    memory, TMA's limits, the route; a Cout of 128 takes a 128-wide tile
    (a 256-wide one would be half zero columns), a multiple of 256 with
    more than four waves of tiles a 256-wide one."""
    _, b, hi, wi, cin, cout, kh, kw, pads = geom
    plan = _check_plan(b, hi, wi, cin, cout, kh, kw, pads)
    if plan.route == "tma" and cout == 128:
        assert plan.bn == 128
    if plan.route == "tma" and cout % 256 == 0 and \
            plan.m_tiles * plan.n_tiles > 4 * K.H100_SMS:
        assert plan.bn == 256


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_f32_plan_at_the_path_shapes(geom):
    """Each K6 geometry of chip_smoke.py's case lists in f32: the tf32
    route (both 12-channel convolutions included), coverage, shared memory,
    TMA's limits; a Cout of 12 takes the 32-wide tile."""
    _, b, hi, wi, cin, cout, kh, kw, pads = geom
    plan = _check_plan(b, hi, wi, cin, cout, kh, kw, pads, torch.float32)
    if cout == 12:
        assert plan.bn == 32


@pytest.mark.parametrize("taps", TAPS)
def test_plan_at_the_card_tests_forms(taps):
    """Every taps x pads form of the card tests' shapes, and the dtypes'
    routes: f32 always the tf32 kernel."""
    for b, h, w, cin, cout in CARD_SHAPES:
        for pads in PADS:
            _check_plan(b, h, w, cin, cout, *taps, pads)
            _check_plan(b, h, w, cin, cout, *taps, pads, torch.float32)


def test_plan_route_by_channels():
    """cp.async exactly where Cin or Cout is not a multiple of 8."""
    same = ((1, 1), (1, 1))
    for cin in (4, 8, 12, 16, 20, 64, 68, 256):
        for cout in (4, 8, 12, 24, 64, 68, 128, 256):
            plan = K.packed_conv_plan(1, 9, 9, cin, cout, 2, 2, same)
            assert (plan.route == "cp.async") == bool(cin % 8 or cout % 8)


def test_plan_narrows_the_tile_of_a_small_grid():
    """At the generator's B = 1 65^2 shapes a 128 x 256 tile leaves most of
    a wave idle: the plan takes a narrower one where its rounds cost less;
    at a 20-frame batch it keeps the widest."""
    plan = K.packed_conv_plan(1, 65, 65, 512, 512, 2, 2, ((0, 0), (0, 0)))
    assert (plan.bm, plan.bn) == (128, 128)
    assert plan.m_tiles * plan.n_tiles <= K.H100_SMS
    big = K.packed_conv_plan(20, 129, 129, 512, 512, 2, 2, ((0, 0), (0, 0)))
    assert (big.bm, big.bn) == (128, 256)


def test_call_arguments_follow_the_plan():
    """The C entry's 18 int arguments a geometry's calls share, in the
    order csrc/packed_conv.cu:keep_packed_conv reads them, and its
    PACKED_CONV_SHAPES key."""
    pads = ((0, 1), (1, 0))
    for dtype, bias_bf16, mask_c in ((torch.bfloat16, 1, 0),
                                     (torch.bfloat16, 0, 64),
                                     (torch.float32, 0, 0),
                                     (torch.float32, 0, 64)):
        shape, args, key = K._packed_conv_call(
            (20, 128, 96, 512), (2, 1, 512, 256), pads, dtype, bias_bf16,
            mask_c or None)
        plan = K.packed_conv_plan(20, 128, 96, 512, 256, 2, 1, pads, dtype)
        assert shape == (20, 128, 97, 256)
        assert list(args) == [
            20, 128, 96, 512, 256, 2, 1, 0, 1, 1, 0, bias_bf16, mask_c,
            K._DTYPE_CODE[dtype], K.PACKED_CONV_ROUTES[plan.route], plan.bm,
            plan.bn, plan.stages]
        assert key == "128x96x512 k2x1 -> 256 pads 0110"
    # f32 at 12 channels: the tf32 route (code 2), the 32-wide tile
    same = ((1, 1), (1, 1))
    shape, args, key = K._packed_conv_call((1, 256, 256, 12), (2, 2, 12, 12),
                                           same, torch.float32, 0, 3)
    plan = K.packed_conv_plan(1, 256, 256, 12, 12, 2, 2, same, torch.float32)
    assert shape == (1, 257, 257, 12) and (plan.bm, plan.bn) == (128, 32)
    assert list(args) == [1, 256, 256, 12, 12, 2, 2, 1, 1, 1, 1, 0, 3, 0, 2,
                          128, 32, plan.stages]


def _emulate(x, w, pads, plan, bias=None, mask_c=None):
    """The TMA kernels' output, computed as their blocks compute it: per
    tile and K step (64 channels of one tap; the tf32 route 32) the im2col
    box and the weight box with TMA's zero-fill, f32 sums (tf32: each K
    step's product as 3xTF32 from zero, added in f32), then the epilogue.
    x (B, Hi, Wi, Cin), w (kh, kw, Cin, Cout)."""
    b, hi, wi, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pads
    ho, wo = _out_hw(hi, wi, kh, kw, pads)
    m, taps = b * ho * wo, kh * kw
    # the bounding box of the map (packed_conv.cu launch_packed_conv_tma)
    lo_w, lo_h, up_w, up_h = -pl, -pt, wo - wi - pl, ho - hi - pt
    xf, wf = x.float(), w.float().reshape(taps, cin, cout)
    out = torch.full((m, cout), float("nan"))
    kc = K.K_STEP_F32 if plan.route == "tf32" else K.K_STEP
    mm = mm_3xtf32 if plan.route == "tf32" else torch.matmul
    ksteps = taps * -(-cin // kc)
    for tiles in _walk(plan):
        for mt, nt in tiles:
            m0, n0 = mt * plan.bm, nt * plan.bn
            # the traversal's start: the tile's first pixel as (w, h, n)
            img, rem = divmod(m0, ho * wo)
            wc, hc = rem % wo - pl, rem // wo - pt
            pix = []
            for _ in range(plan.bm):
                pix.append((img, hc, wc))
                wc += 1
                if wc > wi - 1 + up_w:
                    wc, hc = lo_w, hc + 1
                    if hc > hi - 1 + up_h:
                        hc, img = lo_h, img + 1
            pix = torch.tensor(pix)
            acc = torch.zeros(plan.bm, plan.bn)
            for s in range(ksteps):
                tap, c0 = s % taps, (s // taps) * kc
                n_, h_, w_ = pix[:, 0], pix[:, 1] + tap // kw, \
                    pix[:, 2] + tap % kw
                ok = (n_ < b) & (h_ >= 0) & (h_ < hi) & (w_ >= 0) & (w_ < wi)
                a = torch.zeros(plan.bm, kc)
                cs_ = min(kc, cin - c0)
                a[ok, :cs_] = xf[n_[ok], h_[ok], w_[ok], c0:c0 + cs_]
                bt = torch.zeros(kc, plan.bn)
                ns = min(plan.bn, cout - n0)
                bt[:cs_, :ns] = wf[tap, c0:c0 + cs_, n0:n0 + ns]
                acc += mm(a, bt)
            rows = min(plan.bm, m - m0)
            ns = min(plan.bn, cout - n0)
            out[m0:m0 + rows, n0:n0 + ns] = acc[:rows, :ns]
    out = out.reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias.float()
    if mask_c is not None:
        K.mask_parity1_(out, mask_c)
    return out.to(x.dtype)


def _plan_with(b, hi, wi, cout, kh, kw, pads, bm, bn, sms,
               dtype=torch.bfloat16):
    """A TMA plan (f32: tf32) with tile bm x bn, walked by at most sms
    blocks (more tiles a block than on the card)."""
    ho, wo = _out_hw(hi, wi, kh, kw, pads)
    return K._tma_plan(b * ho * wo, cout, bm, bn, sms, dtype)


@pytest.mark.parametrize("tile", list(K.PACKED_CONV_TILES),
                         ids=[f"{a}x{b}" for a, b in K.PACKED_CONV_TILES])
@pytest.mark.parametrize("taps", TAPS)
def test_walk_matches_plain(tile, taps):
    """Each TMA tile at every pads form, f32 inputs (the walk's indexing
    exact: the sums differ in order only, 1e-5), over a batch whose pixel
    tiles cross rows and images and a grid of 3 blocks (several tiles a
    block); with the fused bias and parity-1 mask at pad 1."""
    rng = np.random.default_rng(40)
    with one_thread():
        for b, h, w_, cin, cout in ((2, 11, 14, 72, 136), (3, 6, 9, 8, 24)):
            x = torch.as_tensor(rng.standard_normal((b, h, w_, cin),
                                                    dtype=np.float32))
            w = torch.as_tensor(rng.standard_normal((*taps, cin, cout),
                                                    dtype=np.float32) * 0.1)
            bias = torch.as_tensor(rng.standard_normal(cout,
                                                       dtype=np.float32))
            for pads in PADS:
                plan = _plan_with(b, h, w_, cout, *taps, pads, *tile, 3)
                mc = cout // 4 if pads == ((1, 1), (1, 1)) else None
                got = _emulate(x, w, pads, plan, bias, mc)
                ref = K.packed_conv2x2_plain(x, w, pads, bias, mc)
                torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5,
                                           msg=str((pads, b, h, w_)))


@pytest.mark.parametrize("tile", list(K.PACKED_CONV_F32_TILES),
                         ids=[f"{a}x{b}" for a, b in K.PACKED_CONV_F32_TILES])
@pytest.mark.parametrize("taps", TAPS)
def test_walk_f32_matches_plain(tile, taps):
    """Each tf32 tile at every pads form, f32 (the 3xTF32 K steps): within
    chip_smoke.py's KERNEL_RTOL["float32"] times the plain output's spread,
    over pixel tiles that cross rows and images and a grid of 3 blocks;
    with the bias and the parity-1 mask at pad 1, at 12 channels too (an
    odd phase-block width, mask_c = 3)."""
    rng = np.random.default_rng(43)
    with one_thread():
        for b, h, w_, cin, cout in ((2, 11, 14, 72, 136), (3, 6, 9, 12, 12)):
            x = torch.as_tensor(rng.standard_normal((b, h, w_, cin),
                                                    dtype=np.float32))
            w = torch.as_tensor(rng.standard_normal((*taps, cin, cout),
                                                    dtype=np.float32) * 0.1)
            bias = torch.as_tensor(rng.standard_normal(cout,
                                                       dtype=np.float32))
            for pads in PADS:
                plan = _plan_with(b, h, w_, cout, *taps, pads, *tile, 3,
                                  torch.float32)
                mc = cout // 4 if pads == ((1, 1), (1, 1)) else None
                got = _emulate(x, w, pads, plan, bias, mc)
                ref = K.packed_conv2x2_plain(x, w, pads, bias, mc)
                tol = cs.KERNEL_RTOL["float32"] * (ref - ref.mean()).abs().max()
                assert (got - ref).abs().max() <= tol, (pads, b, h, w_)


@pytest.mark.parametrize("label", [cs.K6_OWN, "enc L2 downsample p0"])
def test_walk_of_the_plan_bf16(label):
    """The plan the path takes (its own tile and ring), at the geometry's
    form cut to a small grid, bf16: the kernel's exact bf16 products summed
    in f32 in another order than the plain version's, both rounded once:
    within 2 ** -7 of each value plus 1e-5 of the largest."""
    geom = [g for g in GEOMETRIES if g[0] == label][0]
    _, _, _, _, cin, cout, kh, kw, pads = geom
    rng = np.random.default_rng(41)
    b, h = 2, 17
    with one_thread():
        x = torch.as_tensor(rng.standard_normal((b, h, h, cin),
                                                dtype=np.float32)).bfloat16()
        w = torch.as_tensor(rng.standard_normal((kh, kw, cin, cout),
                                                dtype=np.float32)
                            * 0.05).bfloat16()
        plan = K.packed_conv_plan(b, h, h, cin, cout, kh, kw, pads)
        assert plan.route == "tma"
        got = _emulate(x, w, pads, plan)
        ref = K.packed_conv2x2_plain(x, w, pads)
    scale = ref.float().abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", [np.float32, "bf16", "f32 tf32"])
def test_walk_vs_pallas_interpret(dtype):
    """K6's own form (a parity-1 packed input, VALID 2x2) cut to (17, 17,
    64) -> 32: the emulated walk of its plan against tools/_prof_packedconv.py's
    pallas_conv in interpret mode. f32 through the bf16 plan's walk: order
    of summation (1e-5); bf16: both round the f32 sum once (1 ulp, 2 **
    -7); f32 through its own (tf32) plan: within KERNEL_RTOL["float32"]
    times the output's spread."""
    rng = np.random.default_rng(42)
    h, ci, co = 17, 64, 32
    x = (rng.standard_normal((h, h, ci))).astype(np.float32)
    w = (rng.standard_normal((2, 2, ci, co)) * 0.05).astype(np.float32)
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)
    if dtype == "bf16":
        tx, tw = tx.bfloat16(), tw.bfloat16()
    valid = ((0, 0), (0, 0))
    f32 = dtype == "f32 tf32"
    plan = K.packed_conv_plan(1, h, h, ci, co, 2, 2, valid,
                              torch.float32 if f32 else torch.bfloat16)
    assert plan.route == ("tf32" if f32 else "tma")
    with one_thread():
        ours = _emulate(tx[None], tw, valid, plan)[0]
    jdt = np.float32 if f32 else dtype
    ref = np.asarray(_pallas_conv(_jx(x, jdt), _jx(w, jdt), 8)
                     .astype(np.float32))
    if f32:
        spread = np.abs(ref - ref.mean()).max()
        assert np.abs(ours.numpy() - ref).max() <= \
            cs.KERNEL_RTOL["float32"] * spread
        return
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == np.float32
           else dict(atol=1e-2, rtol=2 ** -7))
    np.testing.assert_allclose(ours.float().numpy(), ref, **tol)
