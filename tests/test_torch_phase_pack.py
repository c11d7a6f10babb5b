"""The port's phase-packed 512-level path (comfyui_keep_torch/ops/phase_pack.py,
the packed walkers of models/vqgan.py, KEEP.prepare_phase512 and the
processor's phase512) against the JAX package, on the CPU, where every 2x2
convolution takes K6's plain version.

Packed tensors are NHWC (B, Hc, Wc, 4C), phase-major, in both packages, so
they compare with no transposes. Tolerances: the packers exactly; each
packed op 1e-5 (tests/test_phase_pack.py's); the packed prefix and tail of
a 64-px plan 2e-5, and 1e-10 in float64, where only the order of summation
differs; KEEP at 512 px, teacher-forced, 5e-3 / 1e-2
(tests/test_keep_golden.py's).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import keep as jkeep
from comfyui_keep_tpu.models import vqgan as jv
from comfyui_keep_tpu.ops import phase_pack as jpp
from comfyui_keep_torch import api
from comfyui_keep_torch.models.init import shared_copy
from comfyui_keep_torch.models.keep import KEEP
from comfyui_keep_torch.models.vqgan import (BlockStack, encoder_plan,
                                             generator_plan,
                                             packed_generator_tail,
                                             phase512_prepare,
                                             phase_encoder_end,
                                             phase_generator_start)
from comfyui_keep_torch.ops import phase_pack as pp
from comfyui_keep_torch.pipeline.processor import KEEPFaceProcessor
from comfyui_keep_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

B, H, C = 2, 32, 8
PACKERS = ("pack_conv3x3", "pack_upconv3x3", "pack_downsample3x3")
# a KEEP at 512 px narrow enough for the CPU: nf 32, one transformer layer;
# ch_mult's first step (1 -> 2) gives the packed tail a 1x1 skip conv
NARROW_512 = dict(img_size=512, nf=32, ch_mult=(1, 2, 2, 2, 2, 2),
                  res_blocks=1, attn_resolutions=(16,), codebook_size=64,
                  emb_dim=32, dim_embd=64, n_head=4, n_layers=1,
                  latent_size=256, cft_list=("32", "64"), cfa_list=("16",),
                  cfa_nhead=2, cfa_dim=16, kalman_attn_head_dim=8,
                  num_uncertainty_layers=1, temp_reg_list=())


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _conv_weights(rng, cin, cout):
    return (rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.1,
            rng.standard_normal(cout).astype(np.float32))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", PACKERS)
def test_packers_equal_jax(name):
    rng = np.random.default_rng(0)
    w, b = _conv_weights(rng, 8, 12)
    ours = getattr(pp, name)(torch.as_tensor(w), torch.as_tensor(b))
    for o, r in zip(ours, getattr(jpp, name)(w, b)):
        assert o.dtype == torch.float32 and r.dtype == np.float32
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("parity", [0, 1])
def test_space_to_depth_depth_to_space_and_mask_exact(parity):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    packed = pp.space_to_depth(_nchw(x))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpp.space_to_depth(x)))
    p1 = rng.standard_normal((B, H // 2 + parity, H // 2 + parity,
                              4 * C)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(pp.depth_to_space(_t(p1), parity)),
                                  np.asarray(jpp.depth_to_space(p1, parity)))
    masked = pp.mask_parity1(_t(p1), C)
    np.testing.assert_array_equal(masked.numpy(),
                                  np.asarray(jpp.mask_parity1(p1, C)))
    assert not torch.equal(masked, _t(p1))   # a copy: the input is kept


def _packed_op_case(name, rng):
    """(port result, JAX result) of one packed op on shared inputs: x is an
    unpacked (B, H, W, C) map, p0 its parity-0 packing and p1 the masked
    parity-1 output of a packed conv of it."""
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    w, b = _conv_weights(rng, C, C)
    pw, pb = jpp.pack_conv3x3(w, b)
    p0 = np.asarray(jpp.space_to_depth(x))
    p1 = np.asarray(jpp.packed_conv(p0, pw, pb, parity=0))
    kind, _, parity = name.partition("_p")
    parity = int(parity or 0)
    src = p1 if parity else p0
    if kind == "conv":
        return (pp.packed_conv(_t(src), _t(pw), _t(pb), parity),
                jpp.packed_conv(src, pw, pb, parity))
    if kind == "upconv":
        uw, ub = jpp.pack_upconv3x3(w, b)
        return (pp.packed_upconv(_t(x), _t(uw), _t(ub)),
                jpp.packed_upconv(x, uw, ub))
    if kind == "down":
        dw, db = jpp.pack_downsample3x3(w, b)
        return (pp.packed_downsample(_t(p1), _t(dw), _t(db)),
                jpp.packed_downsample(p1, dw, db))
    if kind == "conv1x1":
        sw = rng.standard_normal((1, 1, C, C + 8)).astype(np.float32) * 0.1
        sb = rng.standard_normal(C + 8).astype(np.float32)
        return (pp.packed_conv1x1(_t(src), _t(sw.transpose(3, 2, 0, 1)),
                                  _t(sb), parity),
                jpp.packed_conv1x1(src, sw, sb, parity))
    assert kind == "gn"
    g = {"scale": rng.standard_normal(C).astype(np.float32),
         "bias": rng.standard_normal(C).astype(np.float32)}
    return (pp.packed_group_norm(_t(src), _t(g["scale"]), _t(g["bias"]),
                                 (H, H), num_groups=4, parity=parity,
                                 swish_after=True),
            jpp.packed_group_norm(src, g, (H, H), num_groups=4,
                                  parity=parity, swish_after=True))


@pytest.mark.parametrize("name", [
    "conv_p0", "conv_p1", "upconv", "down_p1", "conv1x1_p0", "conv1x1_p1",
    "gn_p0", "gn_p1"])
def test_packed_op_matches_jax(name):
    """Whole packed outputs, pad half-cells included: a parity-1 output the
    port left unmasked, or masked before its bias, differs from the JAX
    twin's zeros there; its normalisation statistics would differ too."""
    ours, ref = _packed_op_case(name, np.random.default_rng(2))
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def _stack(tree, plan, dtype=torch.float32):
    st = BlockStack(plan)
    st.load_state_dict(params_from_jax(tree, st))
    return st.to(dtype).eval()


def test_packed_encoder_prefix_matches_jax():
    """A 64-px encoder plan, the tap inside the packed region (block 2)
    unpacked at tap time, against the JAX package's prepared blocks_apply
    and the port's unpacked stack."""
    plan = encoder_plan(3, 64, 32, (1, 2), 2, 64, (16,))
    params = jv.blocks_init(jax.random.PRNGKey(0), plan)
    tree = jax.tree.map(np.asarray, params)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 64, 64, 3)))
    ref, rtaps = jv.blocks_apply(jv.phase512_prepare(params, plan, "encoder"),
                                 plan, x, tap_indices=[2, 5])
    st = _stack(tree, plan)
    end = phase_encoder_end(plan)
    assert end == jv.phase512_encoder_end(plan) == 3
    prepared = phase512_prepare(shared_copy(st), range(end + 1))
    assert prepared.packed_prefix_end() == 3 and st.packed_prefix_end() is None
    with torch.no_grad():
        got, gtaps = prepared(_nchw(x), tap_indices=[2, 5])
        plain, ptaps = st(_nchw(x), tap_indices=[2, 5])
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(_nhwc(got), _nhwc(plain), atol=2e-5)
    assert gtaps.keys() == rtaps.keys() == {2, 5}
    for k in rtaps:
        np.testing.assert_allclose(_nhwc(gtaps[k]), np.asarray(rtaps[k]),
                                   atol=2e-5)
        np.testing.assert_allclose(_nhwc(gtaps[k]), _nhwc(ptaps[k]),
                                   atol=2e-5)
    with pytest.raises(RuntimeError, match="serves only"):
        prepared(_nchw(x))      # gradients recorded: packed weights refuse


def test_packed_generator_tail_matches_jax():
    plan = generator_plan(64, 32, (1, 2), 2, 64, (16,))
    params = jv.blocks_init(jax.random.PRNGKey(0), plan)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 32)))
    start = jv.phase512_generator_start(plan)
    assert phase_generator_start(plan) == start
    jprep = jv.phase512_prepare(params, plan, "generator")
    xj = z
    for j in range(start):
        xj = jv._block_apply(plan[j], jprep["blocks"][j], xj)
    ref = jv.packed_generator_tail(jprep, plan, xj, start)
    st = _stack(jax.tree.map(np.asarray, params), plan)
    prepared = phase512_prepare(shared_copy(st), range(start, len(plan)))
    assert prepared.packed_tail_start() == start
    with torch.no_grad():
        x = _nchw(z)
        for j in range(start):
            x = prepared.blocks[j](x)
        got = packed_generator_tail(prepared, x, start)
        plain = st(_nchw(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(_nhwc(got), _nhwc(plain), atol=2e-5)


@pytest.mark.parametrize("kind", ["encoder", "generator"])
def test_packing_in_float64(x64, kind):
    """The packed encoder prefix and generator tail of a deeper plan in
    float64, where the packed form differs from the unpacked one by
    rounding only: against the JAX package's packed run and the port's
    unpacked stack, taps included."""
    rng = np.random.default_rng(3)
    if kind == "encoder":
        plan = encoder_plan(3, 32, 32, (1, 2, 2, 4), 2, 64, (8,))
        x = rng.standard_normal((2, 64, 64, 3))
        taps = [i for i, s in enumerate(plan) if s[0] == "res"][:4]
    else:
        plan = generator_plan(32, 32, (1, 2, 2, 4), 2, 64, (8,))
        x = rng.standard_normal((2, 8, 8, 32))
        taps = None
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jv.blocks_init(jax.random.PRNGKey(0), plan))
    st = _stack(jax.tree.map(np.asarray, params), plan, torch.float64)
    prepared = shared_copy(st)
    if kind == "encoder":
        end = phase_encoder_end(plan)
        assert end == jv.phase512_encoder_end(plan)
        jprep = jv.phase512_prepare(params, plan, "encoder")
        ref, rtaps = jv.blocks_apply(jprep, plan, jnp.asarray(x),
                                     tap_indices=taps)
        phase512_prepare(prepared, range(end + 1))
        with torch.no_grad():
            got, gtaps = prepared(_nchw(x), tap_indices=taps)
            plain, ptaps = st(_nchw(x), tap_indices=taps)
        for k in rtaps:
            np.testing.assert_allclose(_nhwc(gtaps[k]), np.asarray(rtaps[k]),
                                       atol=1e-10, err_msg=f"tap {k}")
            np.testing.assert_allclose(_nhwc(gtaps[k]), _nhwc(ptaps[k]),
                                       atol=1e-10, err_msg=f"tap {k}")
    else:
        start = phase_generator_start(plan)
        assert start == jv.phase512_generator_start(plan)
        jprep = jv.phase512_prepare(params, plan, "generator")
        xj = jnp.asarray(x)
        for j in range(start):
            xj = jv._block_apply(plan[j], jprep["blocks"][j], xj)
        ref = jv.packed_generator_tail(jprep, plan, xj, start)
        phase512_prepare(prepared, range(start, len(plan)))
        with torch.no_grad():
            h = _nchw(x)
            for j in range(start):
                h = prepared.blocks[j](h)
            got = packed_generator_tail(prepared, h, start)
            plain = st(_nchw(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-10)
    np.testing.assert_allclose(_nhwc(got), _nhwc(plain), atol=1e-10)


def test_prepare_phase512_is_a_noop_off_512_and_keeps_the_state_dict():
    tiny = KEEP(device="cpu", **dict(NARROW_512, img_size=64, ch_mult=(1, 2, 2)))
    assert tiny.prepare_phase512() is tiny
    net = KEEP(device="cpu", generator=torch.Generator().manual_seed(0),
               **NARROW_512)
    prepared = net.prepare_phase512()
    assert prepared is not net
    assert prepared.state_dict().keys() == net.state_dict().keys()
    for (n, p), (m, q) in zip(net.named_parameters(),
                              prepared.named_parameters()):
        assert n == m and p is q          # shared, not copied
    assert net.encoder.packed_prefix_end() is None
    assert net.generator.packed_tail_start() is None
    assert prepared.encoder.packed_prefix_end() == \
        jv.phase512_encoder_end(net.enc_plan)
    assert prepared.hq_encoder.packed_prefix_end() is not None
    assert prepared.generator.packed_tail_start() == \
        jv.phase512_generator_start(net.gen_plan)
    packed = [n for n, _ in prepared.named_buffers() if ".p512" in n]
    assert packed and not [n for n, _ in net.named_buffers()]
    # a reference state dict still loads, strictly, into the prepared copy
    prepared.load_state_dict(net.state_dict())
    # a fusion tap at or after the final Upsample leaves the generator
    # unpacked, as in JAX
    last = prepared.generator.packed_tail_start()
    for fuse in ({net.gen_tap[f] for f in ("32", "64")}, {last}, {last + 1}):
        assert phase_generator_start(net.gen_plan, fuse) == \
            jv.phase_generator_start(net.gen_plan, fuse, max_levels=1)
    assert phase_generator_start(net.gen_plan, {last}) is None


def test_processor_packs_a_copy_and_leaves_the_pack_unpacked():
    """phase512=True packs a copy; the default (phase512=False, the faster
    chunk on the H100) runs the pack's own unpacked KEEP."""
    pack = api.load_models(seed=1, cfg_overrides=NARROW_512)
    proc = pack.processor(device="cpu", phase512=True)
    assert proc.keep is not pack.keep
    assert proc.keep.encoder.packed_prefix_end() is not None
    assert pack.keep.encoder.packed_prefix_end() is None
    assert proc.gmflow is pack.gmflow
    for plain in (pack.processor(device="cpu", phase512=False),
                  pack.processor(device="cpu")):
        assert plain.keep is pack.keep


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def test_packed_keep_at_512_matches_jax_teacher_forced():
    """KEEP at 512 px (narrow), both packages prepared, 2 frames through the
    recurrence with flows: the packed encoders, the packed HQ encoder and
    the packed generator tail. The JAX run's code picks are forced on the
    port; outputs and logits within the golden tolerance."""
    tree = _perturbed(jkeep.KEEP.init(jax.random.PRNGKey(0), **NARROW_512),
                      0)
    net = KEEP(device="cpu", **NARROW_512)
    net.load_state_dict(params_from_jax(tree, net))
    prepared = net.prepare_phase512()
    rng = np.random.default_rng(4)
    x = rng.random((1, 2, 512, 512, 3), dtype=np.float32) * 2 - 1
    flows = tuple(rng.standard_normal((1, 1, 512, 512), dtype=np.float32)
                  * 2 for _ in range(2))
    jprep = jkeep.KEEP.prepare_phase512(tree, **NARROW_512)
    ref, aux = jkeep.KEEP.apply(jprep, jnp.asarray(x),
                                flows=tuple(map(jnp.asarray, flows)),
                                remat=False, return_aux=True, **NARROW_512)
    picks = np.asarray(aux["logits"]).argmax(-1).reshape(1, 2, -1)
    out, ours = prepared.apply(torch.as_tensor(x),
                               flows=tuple(map(torch.as_tensor, flows)),
                               return_aux=True,
                               force_indices=torch.as_tensor(picks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(ours["logits"].numpy(),
                               np.asarray(aux["logits"]), atol=5e-3,
                               rtol=1e-2)


def _packed_buffers(stack):
    """{(block, name): tensor} of a prepared port stack, named as the JAX
    package's p512 leaves."""
    out = {}
    for i, blk in enumerate(stack.blocks):
        p = getattr(blk, "p512", None)
        if p is None:
            continue
        for n, t in p.named_buffers():
            out[i, n.replace("_", "/")] = t
    return out


def _jax_packed(stack_params):
    out = {}
    for i, blk in enumerate(stack_params["blocks"]):
        for n, a in jax.tree_util.tree_flatten_with_path(
                blk.get("p512", {}))[0]:
            out[i, "/".join(k.key for k in n)] = a
    return out


@pytest.mark.parametrize("keep_dtype", ["float32", "bfloat16"])
def test_processor_packed_weights_equal_jax_bitwise(keep_dtype):
    """The bf16 processor's packed buffers (phase512=True) against the JAX
    processor's: KEEP.prepare_phase512 on the params in their own dtype,
    then the cast to bf16. An f32 KEEP served in bf16, and a KEEP already in
    bf16 (load_device(bf16), the main path's case), whose packed Upsample
    weight JAX sums in bf16, rounding after each tap."""
    tree = _perturbed(jkeep.KEEP.init(jax.random.PRNGKey(0), **NARROW_512),
                      0)
    net = KEEP(device="cpu", **NARROW_512)
    net.load_state_dict(params_from_jax(tree, net))
    if keep_dtype == "bfloat16":
        net = net.to(torch.bfloat16)
        tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    proc = KEEPFaceProcessor(net, dtype=torch.bfloat16, device="cpu",
                             phase512=True)
    jprep = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                         jkeep.KEEP.prepare_phase512(tree, **NARROW_512))
    n_summed = 0
    for name in ("encoder", "hq_encoder", "generator"):
        ours = _packed_buffers(getattr(proc.keep, name))
        ref = _jax_packed(jprep[name])
        assert ours.keys() == ref.keys() and ours, name
        for k, t in ours.items():
            assert t.dtype == torch.bfloat16, (name, k)
            r = torch.as_tensor(np.asarray(ref[k], np.float32))
            assert torch.equal(t.float(), r), (name, k)
        n_summed += sum(proc.keep.generator.plan[i][0] == "up"
                        for i, _ in ours) if name == "generator" else 0
    assert n_summed  # the packed tail holds an Upsample, whose taps are summed
