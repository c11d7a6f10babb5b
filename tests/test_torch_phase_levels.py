"""The JAX package's last serving forms in the port, against the JAX
package on the CPU (every 2x2 convolution takes K6's plain version here):
multi-level phase packing of KEEP's encoders and generator
(`phase_enc_levels` / `phase_levels`, JAX's KEEP_TPU_PHASE_ENC_LEVELS /
KEEP_TPU_PHASE_LEVELS), GMFlow's packed backbone (`pack_gmflow`,
KEEP_TPU_PACK_GMFLOW) and int8 activation storage (`int8_acts`,
KEEP_TPU_INT8_ACTS). The JAX side is switched by its own environment
variables (monkeypatch.setenv); nothing in the JAX package changes.

Tolerances: the packers bit for bit; each packed op 2e-5 against JAX in
f32 (tests/test_torch_phase_pack.py's) and 1e-10 against the unpacked op
in float64 (tests/test_phase_pack.py's); the multi-level prefix and tail
1e-10 in float64 and 2e-5 in f32 against JAX's packed run; GMFlow's
backbone 1e-10 in float64 and the golden feature tolerance 2e-4 / 1e-3 in
f32 (tests/test_torch_gmflow.py's); KEEP at 512 px, teacher-forced, the
golden 5e-3 / 1e-2; _quant_boundary bit for bit; KEEP with int8 storage
as derived in test_int8_keep_matches_jax.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import gmflow as jg
from comfyui_keep_tpu.models import keep as jkeep
from comfyui_keep_tpu.models import vqgan as jv
from comfyui_keep_tpu.ops import phase_pack as jpp
from comfyui_keep_torch import api
from comfyui_keep_torch.models import gmflow as tg
from comfyui_keep_torch.models import vqgan as tv
from comfyui_keep_torch.models.init import shared_copy
from comfyui_keep_torch.models.keep import KEEP, arch_tables, config
from comfyui_keep_torch.models.vqgan import (BlockStack, encoder_plan,
                                             generator_plan,
                                             packed_generator_tail,
                                             phase512_prepare,
                                             phase_encoder_end,
                                             phase_generator_start)
from comfyui_keep_torch.ops import conv2d, instance_norm, upsample_nearest_2x
from comfyui_keep_torch.ops import phase_pack as pp
from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
from comfyui_keep_torch.utils.convert import params_from_jax
from tests.test_torch_phase_pack import NARROW_512, _perturbed

torch.set_num_threads(2)

B, H, C = 2, 32, 8
# the plans of tests/test_phase_pack.py's multi-level cases: three
# Downsamples / Upsamples, attention at the 8 level
SMALL = dict(nf=32, emb_dim=32, ch_mult=(1, 2, 2, 4), res_blocks=2,
             resolution=64, attn=(8,))
LEVELS = (1, 2, 3, 4, 5, 99)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _conv_weights(rng, cin, cout, dtype=np.float32):
    return ((rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(dtype),
            rng.standard_normal(cout).astype(dtype))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _small_plans():
    s = SMALL
    return (encoder_plan(3, s["nf"], s["emb_dim"], s["ch_mult"],
                         s["res_blocks"], s["resolution"], s["attn"]),
            generator_plan(s["nf"], s["emb_dim"], s["ch_mult"],
                           s["res_blocks"], s["resolution"], s["attn"]))


def _keep_plans_and_fuse(**overrides):
    cfg = config("KEEP", **overrides)
    enc = encoder_plan(3, cfg["nf"], cfg["emb_dim"], cfg["ch_mult"],
                       cfg["res_blocks"], cfg["img_size"],
                       cfg["attn_resolutions"])
    gen = generator_plan(cfg["nf"], cfg["emb_dim"], cfg["ch_mult"],
                         cfg["res_blocks"], cfg["img_size"],
                         cfg["attn_resolutions"])
    _, _, gen_tap = arch_tables(cfg)
    fuse = {gen_tap[f] for f in (tuple(cfg["cft_list"])
                                 + tuple(cfg["cfa_list"])
                                 + tuple(cfg["temp_reg_list"]))}
    return enc, gen, fuse


# -- the packers ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["pack_downsample3x3_p0",
                                  "pack_upconv3x3_p2p"])
def test_new_packers_equal_jax(name, dtype):
    """Bit for bit, in the weights' own dtype: the p2p planes sum up to
    four taps in float64 and round once, as JAX's numpy does."""
    rng = np.random.default_rng(0)
    w, b = _conv_weights(rng, 8, 12)
    jw, jb = w, b
    tw, tb = torch.as_tensor(w), torch.as_tensor(b)
    if dtype == "bfloat16":
        jw, jb = w.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
        tw, tb = tw.to(torch.bfloat16), tb.to(torch.bfloat16)
    ours = getattr(pp, name)(tw, tb)
    ref = getattr(jpp, name)(jw, jb)
    if name == "pack_upconv3x3_p2p":
        assert ours[0].keys() == ref[0].keys() == set(pp.P2P_PLANES)
        pairs = [(ours[0][k], ref[0][k]) for k in pp.P2P_PLANES]
    else:
        pairs = [(ours[0], ref[0])]
    pairs.append((ours[1], ref[1]))
    for o, r in pairs:
        assert o.dtype == getattr(torch, dtype) and o.shape == r.shape
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r, np.float32))


# -- the packed ops ------------------------------------------------------------

def _new_op_case(name, rng, dtype=np.float32):
    """(port op, JAX op, unpacked NCHW port reference) on shared inputs: x
    an unpacked (B, H, W, C) map, p0 its parity-0 packing, p1 the masked
    parity-1 output of a packed conv of it (h its unpacked form)."""
    x = rng.standard_normal((B, H, H, C)).astype(dtype)
    w, b = _conv_weights(rng, C, C, dtype)
    pw, pb = jpp.pack_conv3x3(w, b)
    p0 = np.asarray(jpp.space_to_depth(x))
    p1 = np.asarray(jpp.packed_conv(p0, pw, pb, parity=0))
    h = conv2d(_nchw(x), _t(w).permute(3, 2, 0, 1), _t(b), padding=1)
    wd, bd = _conv_weights(rng, C, C + 4, dtype)
    wo = _t(wd).permute(3, 2, 0, 1)
    if name == "down_p0":
        dw, db = jpp.pack_downsample3x3_p0(wd, bd)
        return (lambda: pp.packed_downsample_p0(_t(p0), _t(dw), _t(db)),
                lambda: jpp.packed_downsample_p0(p0, dw, db),
                lambda t: t.permute(0, 3, 1, 2),
                conv2d(_nchw(x), wo, _t(bd), stride=2,
                       padding=[(0, 1), (0, 1)]))
    if name == "upconv_p2p":
        ks, kb = jpp.pack_upconv3x3_p2p(wd, bd)
        return (lambda: pp.packed_upconv_p2p(
                    _t(p1), {k: _t(v) for k, v in ks.items()}, _t(kb)),
                lambda: jpp.packed_upconv_p2p(p1, ks, kb),
                lambda t: pp.depth_to_space(t, 1),
                conv2d(upsample_nearest_2x(h), wo, _t(bd), padding=1))
    parity = int(name[-1])
    src = p1 if parity else p0
    ref = instance_norm(h if parity else _nchw(x)).clamp_min(0)
    return (lambda: pp.packed_instance_norm(_t(src), (H, H), parity=parity,
                                            relu_after=True),
            lambda: jpp.packed_instance_norm(src, (H, H), parity=parity,
                                             relu_after=True),
            lambda t: pp.depth_to_space(t, parity), ref)


NEW_OPS = ["down_p0", "upconv_p2p", "in_p0", "in_p1"]


@pytest.mark.parametrize("name", NEW_OPS)
def test_new_packed_op_matches_jax(name):
    """Whole packed outputs, pad half-cells included (the p2p output's
    parity-1 mask after the interleave, the norm's re-mask)."""
    ours, ref, _, _ = _new_op_case(name, np.random.default_rng(2))
    got, ref = ours(), np.asarray(ref())
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", NEW_OPS)
def test_new_packed_op_in_float64(x64, name):
    """In float64 the packed op equals the unpacked one (the port's conv2d,
    nearest upsample, instance norm) to rounding, and JAX's packed op."""
    ours, ref, unpack, plain = _new_op_case(name, np.random.default_rng(3),
                                            np.float64)
    got = ours()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref()), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(unpack(got).numpy(), plain.numpy(),
                               atol=1e-10, rtol=0)


# -- the level plans -----------------------------------------------------------

@pytest.mark.parametrize("plans", ["keep", "small"])
def test_phase_level_bounds_equal_jax(plans):
    """phase_encoder_end and phase_generator_start at levels 1-5 and 99
    (and the generator's None: every valid level), with and without KEEP's
    fusion taps, against the JAX package's."""
    if plans == "keep":
        enc, gen, fuse = _keep_plans_and_fuse()
    else:
        (enc, gen), fuse = _small_plans(), set()
        ups = [i for i, s in enumerate(gen) if s[0] == "up"]
        fuse = {ups[0] + 1}
    for lv in LEVELS:
        assert phase_encoder_end(enc, lv) == jv.phase_encoder_end(enc, lv)
        for f in ((), fuse):
            assert phase_generator_start(gen, f, lv) == \
                jv.phase_generator_start(gen, f, max_levels=lv), (lv, f)
    for f in ((), fuse):
        assert phase_generator_start(gen, f) == \
            jv.phase_generator_start(gen, f)
    downs = [i for i, s in enumerate(enc) if s[0] == "down"]
    assert phase_encoder_end(enc, 99) == downs[-1]
    if plans == "keep":
        # KEEP's defaults: 5 encoder levels, 3 generator levels past its taps
        assert len(downs) == 5
        valid = {phase_generator_start(gen, fuse, lv) for lv in LEVELS}
        assert len(valid) == 3 and None not in valid
        assert phase_generator_start(gen, fuse, 3) == \
            phase_generator_start(gen, fuse, 99)


# -- multi-level prefix and tail -------------------------------------------------

def _stack(tree, plan, dtype):
    st = BlockStack(plan)
    st.load_state_dict(params_from_jax(tree, st))
    return st.to(dtype).eval()


def _multilevel_case(kind, levels, dtype):
    """(port packed, JAX packed, port unpacked) outputs, each with its taps
    (the encoder's first six res blocks), for the small plan at `levels`."""
    enc, gen = _small_plans()
    plan = enc if kind == "encoder" else gen
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                          jv.blocks_init(jax.random.PRNGKey(0), plan))
    st = _stack(jax.tree.map(np.asarray, params), plan, dtype)
    rng = np.random.default_rng(5)
    ndt = np.float64 if dtype == torch.float64 else np.float32
    if kind == "encoder":
        x = rng.standard_normal((2, 64, 64, 3)).astype(ndt)
        taps = [i for i, s in enumerate(plan) if s[0] == "res"][:6]
        end = phase_encoder_end(plan, levels)
        assert end == jv.phase_encoder_end(plan, levels)
        jprep = jv.phase512_prepare(params, plan, "encoder", enc_end=end)
        ref = jv.blocks_apply(jprep, plan, jnp.asarray(x), tap_indices=taps)
        prepared = phase512_prepare(shared_copy(st), range(end + 1))
        assert prepared.packed_prefix_end() == end
        with torch.no_grad():
            got = prepared(_nchw(x), tap_indices=taps)
            plain = st(_nchw(x), tap_indices=taps)
        return got, ref, plain
    x = rng.standard_normal((2, 8, 8, 32)).astype(ndt)
    start = phase_generator_start(plan, (), levels)
    assert start == jv.phase_generator_start(plan, (), max_levels=levels)
    jprep = jv.phase512_prepare(params, plan, "generator", gen_start=start)
    xj = jnp.asarray(x)
    for j in range(start):
        xj = jv._block_apply(plan[j], jprep["blocks"][j], xj)
    ref = jv.packed_generator_tail(jprep, plan, xj, start)
    prepared = phase512_prepare(shared_copy(st), range(start, len(plan)))
    assert prepared.packed_tail_start() == start
    with torch.no_grad():
        h = _nchw(x)
        for j in range(start):
            h = prepared.blocks[j](h)
        got = packed_generator_tail(prepared, h, start)
        plain = st(_nchw(x))
    return (got, {}), (ref, {}), (plain, {})


def _check_multilevel(got, ref, plain, atol):
    (g, gt), (r, rt), (p, pt) = got, ref, plain
    np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=atol, rtol=0)
    np.testing.assert_allclose(_nhwc(g), _nhwc(p), atol=atol, rtol=0)
    assert gt.keys() == rt.keys() == pt.keys()
    for k in rt:
        np.testing.assert_allclose(_nhwc(gt[k]), np.asarray(rt[k]),
                                   atol=atol, rtol=0, err_msg=f"tap {k}")
        np.testing.assert_allclose(_nhwc(gt[k]), _nhwc(pt[k]), atol=atol,
                                   rtol=0, err_msg=f"tap {k}")


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("kind", ["encoder", "generator"])
def test_multilevel_packing_in_float64(x64, kind, levels):
    """The encoder prefix over 2-3 levels (parity-0 deeper levels, their
    parity-0 Downsamples, taps inside unpacked at tap time) and the
    generator tail over 2-3 levels (packed -> packed Upsamples) in float64:
    against JAX's packed run and the port's unpacked stack."""
    got, ref, plain = _multilevel_case(kind, levels, torch.float64)
    assert got[0].dtype == torch.float64
    _check_multilevel(got, ref, plain, 1e-10)


@pytest.mark.parametrize("kind", ["encoder", "generator"])
def test_multilevel_packing_matches_jax_f32(kind):
    """Three levels in f32 against JAX's packed run, taps included. Only
    the order of summation differs (K6's plain version sums its taps as
    the packed XLA convolution's rewrite does not)."""
    got, ref, _ = _multilevel_case(kind, 3, torch.float32)
    (g, gt), (r, rt) = got, ref
    np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=2e-5, rtol=0)
    for k in rt:
        np.testing.assert_allclose(_nhwc(gt[k]), np.asarray(rt[k]),
                                   atol=2e-5, rtol=0, err_msg=f"tap {k}")


# -- GMFlow's packed backbone ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_packed_gmflow_backbone_matches_jax(request, dtype):
    """CNNEncoder.prepare_packed against JAX's backbone_apply on
    backbone_prepare_packed params (and the port's unpacked backbone),
    f32 within the golden feature tolerance, float64 within 1e-10. The
    copy shares the parameters, and GMFlow.prepare_packed leaves its
    network unpacked."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jg.GMFlow.init(jax.random.PRNGKey(1), num_layers=1))
    net = tg.GMFlow(num_layers=1, device="cpu")
    net.load_state_dict(params_from_jax(tree, net))
    net = net.to(getattr(torch, dtype))
    packed = net.prepare_packed()
    assert packed.backbone.layer1[0].p512 is not None
    assert getattr(net.backbone.layer1[0], "p512", None) is None
    assert packed.state_dict().keys() == net.state_dict().keys()
    assert all(p is q for p, q in zip(net.parameters(), packed.parameters()))
    bb = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree["backbone"])
    x = rng.standard_normal((2, 64, 64, 3)).astype(
        np.float64 if dtype == "float64" else np.float32)
    ref = jg.backbone_apply(jg.backbone_prepare_packed(bb), jnp.asarray(x))
    with torch.no_grad():
        got = packed.backbone(_nchw(x))
        plain = net.backbone(_nchw(x))
    tol = (dict(atol=1e-10, rtol=0) if dtype == "float64"
           else dict(atol=2e-4, rtol=1e-3))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **tol)
    np.testing.assert_allclose(_nhwc(got), _nhwc(plain), **tol)
    with pytest.raises(RuntimeError, match="serves only"):
        packed.backbone(_nchw(x))   # gradients recorded


# -- KEEP at 512 px -----------------------------------------------------------------

def _jax_packed(stack_params):
    """{(block, leaf path): array} of every packed leaf of a prepared JAX
    stack: p512, p512_p0 and p512_p2p."""
    out = {}
    for i, blk in enumerate(stack_params["blocks"]):
        for key in ("p512", "p512_p0", "p512_p2p"):
            for n, a in jax.tree_util.tree_flatten_with_path(
                    blk.get(key, {}))[0]:
                out[i, "/".join((key,) + tuple(k.key for k in n))] = a
    return out


def _port_packed(stack):
    out = {}
    for i, blk in enumerate(stack.blocks):
        for key in ("p512", "p512_p0", "p512_p2p"):
            p = getattr(blk, key, None)
            if p is None:
                continue
            for n, t in p.named_buffers():
                if t is not None:
                    out[i, f"{key}/" + n.replace("_", "/")] = t
    return out


def test_levels_processor_packed_weights_equal_jax_bitwise(monkeypatch):
    """A bf16 KEEP's processor at phase_levels=3, phase_enc_levels=2: every
    packed leaf (p512, the Downsamples' p512_p0, the Upsamples' p512_p2p,
    whose planes sum up to four bf16 taps) equal to the JAX processor's at
    KEEP_TPU_PHASE_LEVELS=3, KEEP_TPU_PHASE_ENC_LEVELS=2."""
    tree = _perturbed(jkeep.KEEP.init(jax.random.PRNGKey(0), **NARROW_512),
                      0)
    net = KEEP(device="cpu", **NARROW_512)
    net.load_state_dict(params_from_jax(tree, net))
    net = net.to(torch.bfloat16)
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    proc = KEEPFaceProcessor(net, dtype=torch.bfloat16, device="cpu",
                             phase512=True, phase_levels=3,
                             phase_enc_levels=2)
    monkeypatch.setenv("KEEP_TPU_PHASE_LEVELS", "3")
    monkeypatch.setenv("KEEP_TPU_PHASE_ENC_LEVELS", "2")
    jprep = jkeep.KEEP.prepare_phase512(tree, **NARROW_512)
    kinds = set()
    for name in ("encoder", "hq_encoder", "generator"):
        ours = _port_packed(getattr(proc.keep, name))
        ref = _jax_packed(jprep[name])
        assert ours.keys() == ref.keys() and ours, name
        for k, t in ours.items():
            assert t.dtype == torch.bfloat16, (name, k)
            r = torch.as_tensor(np.asarray(ref[k], np.float32))
            assert torch.equal(t.float(), r), (name, k)
            kinds.add(k[1].split("/")[0])
    assert kinds == {"p512", "p512_p0", "p512_p2p"}
    ups = [i for i, s in enumerate(net.gen_plan) if s[0] == "up"]
    assert proc.keep.generator.packed_tail_start() == ups[-3]
    downs = [i for i, s in enumerate(net.enc_plan) if s[0] == "down"]
    assert proc.keep.encoder.packed_prefix_end() == downs[1]


# the unpacked int8 case's KEEP: NARROW_512 at 64 px (three levels)
NARROW_64 = dict(NARROW_512, img_size=64, ch_mult=(1, 2, 2))


def _keep_pair(cfg=NARROW_512, frames=2, dtype=np.float32):
    """(JAX tree, the port's KEEP on it, a clip (1, frames, S, S, 3), flow
    planes) in `dtype`, the tree perturbed off its init."""
    tree = _perturbed(jkeep.KEEP.init(jax.random.PRNGKey(0), **cfg), 0)
    net = KEEP(device="cpu", **cfg)
    net.load_state_dict(params_from_jax(tree, net))
    size = cfg["img_size"]
    rng = np.random.default_rng(4)
    x = (rng.random((1, frames, size, size, 3)) * 2 - 1).astype(dtype)
    flows = tuple((rng.standard_normal((1, frames - 1, size, size))
                   * 2).astype(dtype) for _ in range(2))
    if dtype != np.float32:
        tree = jax.tree.map(lambda a: np.asarray(a, dtype), tree)
        net = net.to(torch.float64)
    return tree, net, x, flows


def _jax_keep(tree, x, flows, packed, cfg=NARROW_512):
    """JAX's KEEP.apply (jitted) -> (output, logits) as numpy."""
    params = jkeep.KEEP.prepare_phase512(tree, **cfg) if packed else tree
    ref, aux = jax.jit(lambda p, z, f: jkeep.KEEP.apply(
        p, z, flows=f, remat=False, return_aux=True, **cfg))(
            params, jnp.asarray(x), tuple(map(jnp.asarray, flows)))
    return np.asarray(ref), np.asarray(aux["logits"])


def _port_keep(net, x, flows, picks):
    out, aux = net.apply(torch.as_tensor(x),
                         flows=tuple(map(torch.as_tensor, flows)),
                         return_aux=True,
                         force_indices=torch.as_tensor(picks))
    return out.numpy(), aux["logits"].numpy()


def _boundaries():
    """The port's INT8_BOUNDARIES count, reset."""
    n = tv.INT8_BOUNDARIES["count"]
    tv.INT8_BOUNDARIES["count"] = 0
    return n


def int8_boundaries(net, packed_enc_end, packed_gen_start, frames):
    """Boundaries a forward of `frames` frames stores as int8: the LQ
    encoder once (all frames in one batch), the HQ encoder on each frame
    after the first, the generator's packed tail on each frame. A stack
    takes one before each block but the first one run in each of its
    walkers (the packed prefix, then the rest; the tail), never before a
    norm."""
    enc = net.enc_plan
    norms = sum(s[0] == "norm" for s in enc)
    per_enc = len(enc) - 1 - norms - (packed_enc_end is not None)
    gen = 0
    if packed_gen_start is not None:
        tail = net.gen_plan[packed_gen_start:]
        gen = len(tail) - 1 - sum(s[0] == "norm" for s in tail)
    return per_enc * frames + gen * frames


@pytest.mark.parametrize("packed", [False, True])
def test_int8_keep_matches_jax(x64, monkeypatch, packed):
    """KEEP with int8 storage (int8_acts_copy; JAX KEEP_TPU_INT8_ACTS=1),
    the JAX picks forced, in float64: packed at one level at 512 px
    (NARROW_512, one frame: the LQ encoder's packed prefix and the packed
    tail), unpacked at 64 px (three frames: the LQ and HQ encoders and the
    recurrence).

    The tolerance, derived. Both packages quantize the same tensor on the
    same grid (test_quant_boundary_equals_jax_bitwise), so an element lands
    on another level only where the two inputs sit on either side of a
    rounding midpoint, and then moves by one step s = max|x| / 127 where
    the unquantized paths would have moved it by their own rounding gap.
    In f32 that gap is ~1e-6 of the activation: flips happen at every
    boundary and each one widens the gap for the next (measured on
    NARROW_512's LQ encoder: 0.2 % of the elements apart after the first
    boundary, 99 % at the latent 16 boundaries on), so an f32 comparison
    admits no tolerance short of the output's range. In float64 (which
    _quant_boundary reads through f32 in both packages) the gap is ~1e-16
    of the activation: a flip needs the two f32 roundings of an input to
    differ and then straddle a midpoint, which expects far under one flip
    over this forward's ~1e8 quantized elements. So no element flips, and
    the outputs and logits are held to float64's 1e-10. The boundaries
    counted are the plans' (int8_boundaries), and int8 storage moves the
    unpacked output away from the int8-free one."""
    cfg, frames = (NARROW_512, 1) if packed else (NARROW_64, 3)
    tree, net, x, flows = _keep_pair(cfg, frames, np.float64)
    monkeypatch.setenv("KEEP_TPU_INT8_ACTS", "1")
    ref, logits = _jax_keep(tree, x, flows, packed, cfg)
    monkeypatch.delenv("KEEP_TPU_INT8_ACTS")
    picks = logits.argmax(-1).reshape(1, frames, -1)
    served = net.prepare_phase512() if packed else net
    _boundaries()
    out, ours = _port_keep(served.int8_acts_copy(), x, flows, picks)
    end = served.encoder.packed_prefix_end()
    start = served.generator.packed_tail_start()
    assert (end is not None) == (start is not None) == packed
    assert _boundaries() == int8_boundaries(net, end, start, frames)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(ours, logits, atol=1e-10, rtol=0)
    if not packed:
        plain, _ = _port_keep(served, x, flows, picks)
        assert np.abs(out - plain).max() > 1e-3    # int8 storage did act


def test_quant_boundaries_follow_jax_placement():
    """Where the boundaries go: the unpacked generator loop
    (decode_frame's) takes none, as JAX's _decode_frame does not, so its
    output equals the int8-free one bit for bit; the encoder stack takes
    one before each block but the first and the norm; a packed tail one
    before each of its blocks but its first Upsample and the norm."""
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(0),
               **dict(NARROW_512, img_size=64, ch_mult=(1, 2, 2)))
    q = net.int8_acts_copy()
    assert not any(s.int8_acts for s in (net.encoder, net.hq_encoder,
                                         net.generator))
    _boundaries()
    g = torch.Generator().manual_seed(1)
    quant = torch.randn(1, 32, 16, 16, generator=g)
    with torch.no_grad():
        z = torch.randn(1, 3, 64, 64, generator=g)
        qz = q.encoder(z)
        pz = net.encoder(z)
    norms = sum(s[0] == "norm" for s in net.enc_plan)
    assert _boundaries() == len(net.enc_plan) - 1 - norms
    assert not torch.equal(qz, pz)
    # the generator's unpacked loop, with the CFT taps it needs
    with torch.no_grad():
        _, enc, _, _ = net.encode_clip(torch.randn(1, 1, 64, 64, 3,
                                                   generator=g))
        enc0 = {f: v[:, 0] for f, v in enc.items()}
        dq = q.decode_frame(quant, enc0, {}, True)[0]
        dp = net.decode_frame(quant, enc0, {}, True)[0]
    assert _boundaries() == 0 and torch.equal(dq, dp)
    # a generator prepared at 512 px packs its tail: boundaries inside it
    big = KEEP(device="cpu", generator=torch.Generator().manual_seed(0),
               **NARROW_512)
    tail = big.prepare_phase512(levels=2).int8_acts_copy()
    start = tail.generator.packed_tail_start()
    with torch.no_grad():
        x = torch.randn(1, big.gen_plan[start][1], 128, 128, generator=g)
        packed_generator_tail(tail.generator, x, start)
    plan = big.gen_plan[start:]
    assert _boundaries() == len(plan) - 1 - sum(s[0] == "norm"
                                                for s in plan)


@pytest.mark.parametrize("case", ["f32", "bf16", "zeros", "half_steps"])
def test_quant_boundary_equals_jax_bitwise(case):
    """_quant_boundary against the JAX package's on identical inputs: f32
    and bf16 noise, an all-zero tensor (the 1e-8 floor of the scale), and
    values on .5 steps (max|x| = 127, so s = 1: round half to even)."""
    rng = np.random.default_rng(6)
    if case == "zeros":
        x = np.zeros((2, 4, 5, 3), np.float32)
    elif case == "half_steps":
        x = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                      126.5, -126.5, 0.49999997], np.float32)
    else:
        x = (rng.standard_normal((2, 8, 6, 16)) * 3).astype(np.float32)
    jx = jnp.asarray(x)
    tx = torch.as_tensor(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    ref = np.asarray(jv._quant_boundary(jx), np.float32)
    with torch.no_grad():
        got = tv._quant_boundary(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if case == "half_steps":
        np.testing.assert_array_equal(
            got.numpy(), [127, -127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0])


# -- the keywords ----------------------------------------------------------------

def test_serving_keywords_rules():
    """Levels above 1 without phase512 raise, naming it; the processor's
    forms are copies, so the pack's KEEP and GMFlow stay unpacked and
    int8-free with unchanged state_dict keys; levels below 1 raise; an
    int8 forward that records gradients raises; the defaults serve the
    pack's own networks."""
    pack = api.load_models(seed=1, cfg_overrides=NARROW_512)
    keys = (pack.keep.state_dict().keys(), pack.gmflow.state_dict().keys())
    for kw in (dict(phase_levels=2), dict(phase_enc_levels=3)):
        with pytest.raises(ValueError, match="phase512"):
            pack.processor(device="cpu", **kw)
    with pytest.raises(ValueError, match="levels start at 1"):
        pack.processor(device="cpu", phase512=True, phase_levels=0)
    proc = pack.processor(device="cpu", phase512=True, phase_levels=3,
                          phase_enc_levels=5, pack_gmflow=True,
                          int8_acts=True)
    assert proc.keep is not pack.keep and proc.gmflow is not pack.gmflow
    assert proc.keep.encoder.int8_acts and proc.keep.generator.int8_acts
    assert proc.gmflow.backbone.layer1[0].p512 is not None
    downs = [i for i, s in enumerate(pack.keep.enc_plan) if s[0] == "down"]
    assert proc.keep.encoder.packed_prefix_end() == downs[-1]
    for net in (pack.keep, pack.gmflow):
        assert not [n for n, _ in net.named_buffers() if "p512" in n]
    assert not any(s.int8_acts for s in (pack.keep.encoder,
                                         pack.keep.hq_encoder,
                                         pack.keep.generator))
    assert (pack.keep.state_dict().keys(),
            pack.gmflow.state_dict().keys()) == keys
    assert proc.keep.state_dict().keys() == keys[0]
    only_int8 = pack.processor(device="cpu", int8_acts=True)
    assert only_int8.keep is not pack.keep
    assert only_int8.keep.encoder.packed_prefix_end() is None
    only_gm = pack.processor(device="cpu", pack_gmflow=True)
    assert only_gm.keep is pack.keep and only_gm.gmflow is not pack.gmflow
    plain = pack.processor(device="cpu")
    assert plain.keep is pack.keep and plain.gmflow is pack.gmflow
    with pytest.raises(ValueError, match="GMFlow"):
        KEEPFaceProcessor(pack.keep, None, device="cpu", pack_gmflow=True)
    z = torch.zeros(1, 3, 512, 512)
    with pytest.raises(RuntimeError, match="serves only"):
        only_int8.keep.encoder(z)       # gradients recorded
