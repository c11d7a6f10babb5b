"""The port's upscalers against the JAX package's, on the CPU in f32:
models/sr_basic.py (RRDBNet, SRVGGNetCompact, MSRResNet, EDSR) and
models/swinir.py at narrow widths, pipeline/tiled.py (ComfyUI's tiled_scale
with ragged edge tiles, make_upscaler_fn), pipeline/realesrganer.py
(RealESRGANer.enhance on uint8 RGB / RGBA / gray and uint16, whole and
tiled, with and without outscale), and the processor with a background and
a face upscaler on whole frames.

Weights: the port's seeded init carried into a JAX tree by the JAX
package's converters (convert_state_dict, convert_swinir_checkpoint: the
oracle; PReLU weights renamed prelu_w, as the JAX package's own golden test
does), and back by params_from_jax; one JAX init tree per family goes the
other way.

Tolerances: network outputs within 1e-4 of their largest magnitude
(measured <= 5e-7); tiled_scale bitwise with a model both frameworks
compute exactly, 1e-5 with an SR net. A uint8 output may differ from the
JAX one by 1 level only where the JAX float value in [0, 1] lies within
1e-4 of the truncation (make_upscaler_fn) or rounding (enhance) boundary,
and the test asserts that; the outscale resize is bitwise over the port's
own output (LANCZOS4, tests/test_torch_resize.py and test_torch_cvops.py).
The processor's frames as in tests/test_torch_pipeline.py: within 3 levels,
mean <= 0.05.
"""
import sys

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.models import sr_basic as jsr
from comfyui_keep_tpu.models import swinir as jswin
from comfyui_keep_tpu.pipeline import realesrganer as jesr
from comfyui_keep_tpu.pipeline import tiled as jtiled
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch.facelib import factory
from comfyui_keep_torch.models import sr_basic as tsr
from comfyui_keep_torch.models import swinir as tswin
from comfyui_keep_torch.pipeline import realesrganer as tesr
from comfyui_keep_torch.pipeline import tiled as ttiled
from comfyui_keep_torch.utils.convert import params_from_jax
from comfyui_keep_torch.utils.resize import resize
from tests.test_torch_pipeline import (_close, _with_helpers,  # noqa
                                       forced_procs, models)
from tests.test_torch_facelib import detection_row, face_landmarks_at
from tests.torch_port_helpers import assert_trees_equal, rel, state_numpy

torch.set_num_threads(2)

SWIN = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4,
            mlp_ratio=2.0, upscale=2)
# (name, JAX class, port class, constructor / apply keywords)
NETS = [
    ("rrdb_x4", jsr.RRDBNet, tsr.RRDBNet,
     dict(scale=4, num_feat=16, num_block=2, num_grow_ch=8)),
    ("rrdb_x2", jsr.RRDBNet, tsr.RRDBNet,
     dict(scale=2, num_feat=16, num_block=2, num_grow_ch=8)),
    ("rrdb_x1", jsr.RRDBNet, tsr.RRDBNet,
     dict(scale=1, num_feat=16, num_block=2, num_grow_ch=8)),
    ("srvgg_prelu", jsr.SRVGGNetCompact, tsr.SRVGGNetCompact,
     dict(num_feat=16, num_conv=3, upscale=4, act_type="prelu")),
    ("srvgg_relu", jsr.SRVGGNetCompact, tsr.SRVGGNetCompact,
     dict(num_feat=16, num_conv=2, upscale=2, act_type="relu")),
    ("srvgg_lrelu", jsr.SRVGGNetCompact, tsr.SRVGGNetCompact,
     dict(num_feat=16, num_conv=2, upscale=3, act_type="lrelu")),
    ("msrresnet_x4", jsr.MSRResNet, tsr.MSRResNet,
     dict(num_feat=16, num_block=2, upscale=4)),
    ("msrresnet_x3", jsr.MSRResNet, tsr.MSRResNet,
     dict(num_feat=16, num_block=2, upscale=3)),
    ("edsr_x4", jsr.EDSR, tsr.EDSR, dict(num_feat=16, num_block=2,
                                         upscale=4)),
    ("edsr_x3", jsr.EDSR, tsr.EDSR, dict(num_feat=16, num_block=2,
                                         upscale=3)),
] + [(f"swinir_{u or 'residual'}", jswin.SwinIR, tswin.SwinIR,
      dict(upsampler=u, **SWIN))
     for u in ("pixelshuffle", "pixelshuffledirect", "nearest+conv", "")]
# the keywords JAX's apply takes (the rest are the init's)
APPLY = {jsr.RRDBNet: ("scale",), jsr.SRVGGNetCompact: ("upscale",
                                                         "act_type"),
         jsr.MSRResNet: ("upscale",), jsr.EDSR: ("upscale",),
         jswin.SwinIR: tuple(SWIN) + ("upsampler",)}


def jax_tree(jcls, model):
    """The port's weights as the JAX package's converters lay them out."""
    sd = state_numpy(model)
    if jcls is jswin.SwinIR:
        return jswin.convert_swinir_checkpoint(sd)
    tree = convert_state_dict(sd)
    if jcls is jsr.SRVGGNetCompact:
        tree["body"] = [{"prelu_w": p["scale"]} if p and "scale" in p else p
                        for p in tree["body"]]
    return tree


def jax_apply(jcls, kw):
    return jax.jit(lambda p, x: jcls.apply(
        p, x, **{k: v for k, v in kw.items() if k in APPLY[jcls]}))


def port_net(tcls, kw, seed=0):
    return tcls(device="cpu", generator=torch.Generator().manual_seed(seed),
                **kw)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name,jcls,tcls,kw", NETS, ids=[n[0] for n in NETS])
def test_sr_net_matches_jax_and_round_trips(name, jcls, tcls, kw):
    model = port_net(tcls, kw)
    if tcls is tsr.SRVGGNetCompact and kw["act_type"] == "prelu":
        with torch.no_grad():   # per-channel slopes, not the init's 0.25
            for m in model.body[1::2]:
                m.weight.uniform_(0.05, 0.5)
    tree = jax_tree(jcls, model)
    x = np.random.default_rng(1).random((2, 16, 24, 3), dtype=np.float32)
    ref = jax_apply(jcls, kw)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert rel(got, ref) <= 1e-4
    again = tcls(device="cpu", **kw)
    again.load_state_dict(params_from_jax(tree, again))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert_trees_equal(jax_tree(jcls, again), tree)


@pytest.mark.parametrize("jcls,tcls,kw", [
    (jsr.RRDBNet, tsr.RRDBNet, dict(scale=2, num_feat=8, num_block=1,
                                    num_grow_ch=4)),
    (jsr.SRVGGNetCompact, tsr.SRVGGNetCompact, dict(num_feat=8, num_conv=2,
                                                    upscale=4)),
    (jsr.EDSR, tsr.EDSR, dict(num_feat=8, num_block=1, upscale=2)),
    (jswin.SwinIR, tswin.SwinIR, dict(upsampler="pixelshuffle", **SWIN))],
    ids=["rrdb", "srvgg", "edsr", "swinir"])
def test_jax_init_trees_load(jcls, tcls, kw):
    tree = jax.tree.map(np.asarray, jcls.init(jax.random.PRNGKey(2), **kw))
    model = tcls(device="cpu", **kw)
    model.load_state_dict(params_from_jax(tree, model))
    x = np.random.default_rng(3).random((1, 8, 16, 3), dtype=np.float32)
    ref = jax_apply(jcls, kw)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert rel(got, ref) <= 1e-4


def test_swinir_reference_pth_loads(tmp_path):
    """The reference names, and a reference .pth (params_ema, with the
    computed buffers the JAX converter drops: relative_position_index and
    the shifted blocks' attn_mask) through factory.load_reference."""
    model = port_net(tswin.SwinIR, dict(upsampler="pixelshuffle", **SWIN))
    sd = model.state_dict()
    for key in ("patch_embed.norm.weight",
                "layers.1.residual_group.blocks.1.attn."
                "relative_position_bias_table",
                "layers.0.residual_group.blocks.0.mlp.fc2.bias",
                "layers.0.conv.weight", "conv_before_upsample.0.weight",
                "upsample.0.weight", "conv_last.bias"):
        assert key in sd, key
    ref_sd = dict(sd)
    ref_sd["layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(
        16, 16, 16)
    ref_sd["layers.0.residual_group.blocks.0.attn.relative_position_index"] \
        = torch.zeros(16, 16, dtype=torch.int64)
    assert_trees_equal(
        jswin.convert_swinir_checkpoint({k: v.numpy()
                                         for k, v in ref_sd.items()}),
        jax_tree(jswin.SwinIR, model))
    torch.save({"params_ema": ref_sd}, tmp_path / "swinir.pth")
    again = factory.load_reference(
        tswin.SwinIR(device="cpu", upsampler="pixelshuffle", **SWIN),
        str(tmp_path / "swinir.pth"))
    for k, v in sd.items():
        assert torch.equal(again.state_dict()[k], v), k


def test_swinir_window_tables_equal_jax():
    for ws in (4, 8):
        np.testing.assert_array_equal(tswin.rel_pos_index(ws, ws),
                                      jswin._rel_pos_index(ws, ws))
        for h, w in ((16, 24), (64, 32)):
            np.testing.assert_array_equal(tswin.attn_mask(h, w, ws, ws // 2),
                                          jswin._attn_mask(h, w, ws, ws // 2))
    x = np.random.default_rng(4).random((2, 16, 24, 5), dtype=np.float32)
    win = tswin.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(
        win.numpy(), jswin._window_partition(jnp.asarray(x), 8))
    np.testing.assert_array_equal(
        tswin.window_merge(win, 8, 16, 24).numpy(), x)


def _jax_swinir_padded(tree, kw):
    """JAX's SwinIR (window multiples only) on the input reflect-padded at
    the bottom and right by np.pad, its output cropped: the reference's
    check_image_size, as an oracle for the port's padding."""
    ws, s = kw["window_size"], kw["upscale"] if kw["upsampler"] else 1
    net = jax_apply(jswin.SwinIR, kw)

    def fn(p, x):
        h, w = x.shape[1:3]
        xp = np.pad(np.asarray(x), ((0, 0), (0, -h % ws), (0, -w % ws),
                                    (0, 0)), mode="reflect")
        return np.asarray(net(p, jnp.asarray(xp)))[:, :h * s, :w * s]
    return fn


def test_swinir_ragged_tile_is_refused_in_both():
    """A ragged size (37 x 53 against a window of 4): JAX's SwinIR refuses
    it; the port's reflect-pads at the bottom and right to window
    multiples and crops its output, as the reference's check_image_size
    does, and equals JAX's on the np.pad-ed input, cropped (within 1e-4
    of the largest magnitude). At window multiples the port pads nothing
    (F.pad is not called), so its output is the unpadded network's."""
    _swinir_pads_and_crops("pixelshuffle")


def test_swinir_pads_ragged_sizes_without_an_upsampler():
    """As test_swinir_ragged_tile_is_refused_in_both for the denoising form
    (no upsampler: the input plus a residual, cropped at scale 1)."""
    _swinir_pads_and_crops("")


def _swinir_pads_and_crops(upsampler):
    kw = dict(upsampler=upsampler, **SWIN)
    s = SWIN["upscale"] if upsampler else 1
    model = port_net(tswin.SwinIR, kw)
    tree = jax_tree(jswin.SwinIR, model)
    x = np.random.default_rng(5).random((1, 37, 53, 3), dtype=np.float32)
    with pytest.raises(Exception):
        jax_apply(jswin.SwinIR, kw)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    ref = _jax_swinir_padded(tree, kw)(tree, x)
    assert got.shape == ref.shape == (1, 37 * s, 53 * s, 3)
    assert rel(got, ref) <= 1e-4
    # the per-block check still refuses an unpadded ragged size
    with pytest.raises(ValueError, match="multiples of the window"):
        model.layers[0](torch.zeros(1, 37 * 53, SWIN["embed_dim"]),
                        (37, 53), {})

    def no_pad(*a, **k):
        raise AssertionError("padded a window multiple")
    x = x[:, :36, :52]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tswin.F, "pad", no_pad)
        with torch.no_grad():
            got = model(nchw(np.ascontiguousarray(x))).permute(0, 2, 3, 1)
    ref = jax_apply(jswin.SwinIR, kw)(tree, jnp.asarray(x))
    assert rel(got.numpy(), np.asarray(ref)) <= 1e-4


def test_swinir_upscales_a_frame_with_a_ragged_edge_tile():
    """make_upscaler_fn (tile 512, overlap 64) over a 30 x 854 frame: the
    edge tile is 406 px wide, not a window multiple. The tiles' sum
    within 1e-5 of JAX's tiled_scale over its SwinIR on pre-padded tiles,
    the truncated uint8 within 1 level at boundaries, as in
    test_make_upscaler_fn_matches_jax."""
    kw = dict(upsampler="pixelshuffle", **SWIN)
    model = port_net(tswin.SwinIR, kw)
    tree = jax_tree(jswin.SwinIR, model)
    assert ttiled.tile_origins(854, 512, 64) == [0, 448]
    assert (854 - 448) % SWIN["window_size"] and 30 % SWIN["window_size"]
    img = np.random.default_rng(17).integers(0, 256, (30, 854, 3),
                                             dtype=np.uint8)
    x = img[..., ::-1].astype(np.float32) / 255.0
    fn = _jax_swinir_padded(tree, kw)
    ref01 = np.clip(jtiled.tiled_scale(x, lambda t: fn(tree, t), 2, 512, 64),
                    0, 1)[..., ::-1]
    with torch.no_grad():
        got01 = ttiled.tiled_scale(
            torch.from_numpy(np.ascontiguousarray(x)), lambda t: model(
                t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), 2, 512,
            64).clamp(0, 1)
    np.testing.assert_allclose(got01.flip(-1).numpy(), ref01, atol=1e-5,
                               rtol=0)
    got = ttiled.make_upscaler_fn(model, 2)(img)
    ref = jtiled.make_upscaler_fn(fn, tree, 2, jit=False)(img)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (60, 1708, 3)
    assert_uint8_near_boundary(got, ref, ref01, "trunc")


# -- tiled_scale and make_upscaler_fn --------------------------------------------

def _nearest2_np(x):
    return np.repeat(np.repeat(x, 2, axis=1), 2, axis=2) * np.float32(0.75)


def _nearest2_torch(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2) * 0.75


@pytest.mark.parametrize("shape,tile,overlap", [((45, 70), 16, 4),
                                                ((40, 56), 24, 8),
                                                ((33, 19), 16, 6),
                                                ((20, 30), 8, 6)])
def test_tiled_scale_bitwise_with_an_exact_model(shape, tile, overlap):
    """Ragged edge tiles (and, at tile < 2 overlap, repeated clamped
    origins) accumulate in the JAX order: bitwise with a model both
    frameworks compute exactly."""
    img = np.random.default_rng(6).random(shape + (3,), dtype=np.float32)
    ref = jtiled.tiled_scale(img, _nearest2_np, 2, tile, overlap)
    got = ttiled.tiled_scale(torch.from_numpy(img), _nearest2_torch, 2, tile,
                             overlap)
    assert got.shape == ref.shape == (shape[0] * 2, shape[1] * 2, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ttiled.feather_mask(9, 13, 5),
                                  jtiled._comfy_feather_mask(9, 13, 5))


def assert_uint8_near_boundary(got, ref, ref01, boundary):
    """got == ref except by 1 level where the JAX float value ref01 in
    [0, 1] lies within 1e-4 of the conversion's boundary: an integer
    multiple of 1/255 (truncation) or a half one (rounding)."""
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1
    off = ref01 * 255.0 - (0.0 if boundary == "trunc" else 0.5)
    dist = np.abs(off - np.round(off)) / 255.0
    assert (dist[d > 0] < 1e-4).all(), dist[d > 0].max()


def test_make_upscaler_fn_matches_jax():
    """SRVGG x2 tiled (tile 32, overlap 8) on a 50 x 75 frame: the tiles'
    sum within 1e-5, the truncated uint8 within 1 level at boundaries."""
    kw = dict(num_feat=16, num_conv=2, upscale=2)
    model = port_net(tsr.SRVGGNetCompact, kw)
    tree = jax_tree(jsr.SRVGGNetCompact, model)

    def apply_fn(p, x):
        return jsr.SRVGGNetCompact.apply(p, x, upscale=2)

    img = np.random.default_rng(7).integers(0, 256, (50, 75, 3),
                                            dtype=np.uint8)
    x = img[..., ::-1].astype(np.float32) / 255.0
    net = jax.jit(lambda z: apply_fn(tree, z))
    ref01 = np.clip(jtiled.tiled_scale(x, lambda t: np.asarray(
        net(jnp.asarray(t))), 2, 32, 8), 0, 1)[..., ::-1]
    up = ttiled.make_upscaler_fn(model, 2, tile=32, overlap=8)
    got01 = ttiled.tiled_scale(torch.from_numpy(np.ascontiguousarray(x)),
                               lambda t: model(t.permute(0, 3, 1, 2)).permute(
                                   0, 2, 3, 1), 2, 32, 8).clamp(0, 1)
    np.testing.assert_allclose(got01.flip(-1).detach().numpy(), ref01,
                               atol=1e-5, rtol=0)
    ref = jtiled.make_upscaler_fn(apply_fn, tree, 2, tile=32, overlap=8)(img)
    got = up(img)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (100, 150, 3)
    assert_uint8_near_boundary(got, ref, ref01, "trunc")
    t = up(torch.from_numpy(img))
    np.testing.assert_array_equal(t.numpy(), got)
    assert up.calls == 2 and up.model is model


# -- RealESRGANer -----------------------------------------------------------------

def _jax_enhancer(tree, kw, **opts):
    return jesr.RealESRGANer(kw.get("scale", kw.get("upscale")),
                             lambda p, z: jsr.RRDBNet.apply(
                                 p, z, scale=kw["scale"]), tree, **opts)


def _jax_float_output(enh, img):
    """JAX enhance's float output in [0, 1] before its uint8 / uint16
    conversion (BGR, alpha appended through the model)."""
    x = img.astype(np.float32)
    x = x / (65535 if x.max() > 256 else 255)
    if x.ndim == 2:
        x = np.repeat(x[:, :, None], 3, 2)
    alpha = x[:, :, 3] if x.shape[2] == 4 else None
    rgb = x[:, :, :3][:, :, ::-1].copy()

    def up(z):
        pre = enh.pre_process(z)
        out = enh.tile_process(pre) if enh.tile_size > 0 else enh._model(pre)
        return enh.post_process(out)[0]

    out = up(rgb)[:, :, ::-1]
    if alpha is not None:
        out = np.dstack([out, up(np.stack([alpha] * 3, -1))[:, :, 0]])
    return np.clip(out, 0, 1)


IMAGES = {
    "rgb": lambda r: r.integers(0, 256, (21, 30, 3), dtype=np.uint8),
    "rgba": lambda r: r.integers(0, 256, (21, 30, 4), dtype=np.uint8),
    "gray": lambda r: r.integers(0, 256, (21, 30), dtype=np.uint8),
    "rgb16": lambda r: r.integers(0, 65536, (21, 30, 3), dtype=np.uint16),
}


@pytest.mark.parametrize("tile", [0, 16])
@pytest.mark.parametrize("kind", list(IMAGES))
def test_realesrganer_enhance_matches_jax(kind, tile):
    """RRDBNet x2 (pixel_unshuffle: the mod pad matters): the uint8 /
    uint16 output within 1 level at rounding boundaries; gray through
    BGR2GRAY; outscale 1.5 the port's own output resized by LANCZOS4."""
    kw = dict(scale=2, num_feat=8, num_block=1, num_grow_ch=4)
    model = port_net(tsr.RRDBNet, kw)
    tree = jax_tree(jsr.RRDBNet, model)
    opts = dict(tile=tile, tile_pad=4, pre_pad=3)
    img = IMAGES[kind](np.random.default_rng(8))
    ours = tesr.RealESRGANer(2, model, **opts)
    ref_enh = _jax_enhancer(tree, kw, **opts)
    got, mode = ours.enhance(img)
    want, want_mode = ref_enh.enhance(img)
    assert mode == want_mode and got.dtype == want.dtype
    assert got.shape == want.shape
    ref01 = _jax_float_output(ref_enh, img)
    if kind == "gray":
        # the gray value follows its three channels: compare those
        d = np.abs(got.astype(int) - want.astype(int))
        near = np.abs(ref01 * 255 - 0.5 - np.round(ref01 * 255 - 0.5)) < \
            255e-4
        assert d.max() <= 1 and near[d > 0].any(axis=-1).all()
    elif kind == "rgb16":
        d = np.abs(got.astype(int) - want.astype(int))
        off = ref01 * 65535.0 - 0.5
        dist = np.abs(off - np.round(off)) / 65535.0
        assert d.max() <= 1 and (dist[d > 0] < 1e-4).all()
    else:
        assert_uint8_near_boundary(got, want, ref01, "round")
    scaled, _ = ours.enhance(img, outscale=1.5)
    h, w = img.shape[:2]
    assert scaled.shape[:2] == (int(h * 1.5), int(w * 1.5))
    np.testing.assert_array_equal(scaled, resize(got, (int(w * 1.5),
                                                       int(h * 1.5)),
                                                 "lanczos4"))
    jscaled, _ = ref_enh.enhance(img, outscale=1.5)
    np.testing.assert_array_equal(
        jscaled, cv2.resize(want, (int(w * 1.5), int(h * 1.5)),
                            interpolation=cv2.INTER_LANCZOS4))


def test_realesrganer_linear_alpha_and_half():
    kw = dict(scale=2, num_feat=8, num_block=1, num_grow_ch=4)
    model = port_net(tsr.RRDBNet, kw)
    tree = jax_tree(jsr.RRDBNet, model)
    img = IMAGES["rgba"](np.random.default_rng(9))
    got, _ = tesr.RealESRGANer(2, model, pre_pad=0).enhance(
        img, alpha_upsampler="linear")
    want, _ = _jax_enhancer(tree, kw, pre_pad=0).enhance(
        img, alpha_upsampler="linear")
    # the alpha by INTER_LINEAR on float32 (within 2e-5 of OpenCV's)
    alpha01 = cv2.resize(img[:, :, 3].astype(np.float32) / 255,
                         (60, 42), interpolation=cv2.INTER_LINEAR)
    assert_uint8_near_boundary(got[..., 3], want[..., 3], alpha01, "round")
    assert np.abs(got[..., :3].astype(int) - want[..., :3]).max() <= 1
    half = tesr.RealESRGANer(2, model, half=True)
    assert next(model.parameters()).dtype == torch.float32
    out, _ = half.enhance(img[..., :3])
    assert out.shape == (42, 60, 3) and out.dtype == np.uint8


# -- the processor with both upscalers -----------------------------------------------

@pytest.mark.parametrize("factor", [2.0, 1.5])
def test_processor_with_upscalers_matches_jax(forced_procs, monkeypatch,
                                              factor):
    """Whole frames (stub detector and parser, KEEP's picks forced) with a
    SRVGG x2 background upscaler (tiled, ragged edges) and a SRVGG x4 face
    upscaler: process_image and a 3-frame process_image_sequence, the port
    with cv2 unimportable, against the JAX processor with the same
    upscalers; each face upscaled once, each frame's background once."""
    nets = {}
    for s, seed in ((2, 0), (4, 1)):
        kw = dict(num_feat=8, num_conv=2, upscale=s)
        model = port_net(tsr.SRVGGNetCompact, kw, seed)
        tree = jax_tree(jsr.SRVGGNetCompact, model)
        nets[s] = (ttiled.make_upscaler_fn(model, s, tile=96, overlap=16),
                   jtiled.make_upscaler_fn(
                       lambda p, z, s=s: jsr.SRVGGNetCompact.apply(
                           p, z, upscale=s), tree, s, tile=96, overlap=16))
    rng = np.random.default_rng(23)
    frames = [rng.integers(0, 256, (520, 560, 3), dtype=np.uint8)
              for _ in range(3)]
    rows = [np.stack([
        detection_row(face_landmarks_at(0.45, 5.0, 260 + 3 * i, 250)),
        detection_row(face_landmarks_at(0.3, -10.0, 440, 130 + i))])
        for i in range(3)]
    ref_proc, proc = _with_helpers(forced_procs, [rows[0]] + rows)
    proc.bg_upscaler, proc.face_upscaler = nets[2][0], nets[4][0]
    ref_proc.bg_upscaler, ref_proc.face_upscaler = nets[2][1], nets[4][1]
    faces = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
             for _ in range(2)]
    try:
        ref_img = ref_proc.process_image(frames[0], factor)
        ref_seq = ref_proc.process_image_sequence(frames, factor,
                                                  only_center_face=False)
        ref_face = ref_proc.process_image(faces[0], factor, has_aligned=True)
        ref_aligned = ref_proc.process_image_sequence(
            faces, factor, has_aligned_frames=True)
        monkeypatch.setitem(sys.modules, "cv2", None)
        img = proc.process_image(frames[0], factor)
        seq = proc.process_image_sequence(frames, factor,
                                          only_center_face=False)
        face = proc.process_image(faces[0], factor, has_aligned=True)
        aligned = proc.process_image_sequence(faces, factor,
                                              has_aligned_frames=True)
    finally:
        ref_proc.face_helper = proc.face_helper = None
        ref_proc.bg_upscaler = ref_proc.face_upscaler = None
        proc.bg_upscaler = proc.face_upscaler = None
    # an aligned face: the face upscaler, then LANCZOS4 to 64 x factor;
    # aligned frames: each frame's background (the bg upscaler's output)
    assert face.shape == (int(64 * factor),) * 2 + (3,)
    for o, r in zip([img] + seq + [face] + aligned,
                    [ref_img] + ref_seq + [ref_face] + ref_aligned):
        _close(o, r)
    assert nets[4][0].calls == 2 + 2 * 3 + 1
    assert nets[2][0].calls == 1 + 3 + 2
    bg = nets[2][0](frames[0])
    if factor != 2.0:
        bg = resize(bg, img.shape[1::-1], "lanczos4")
    assert bg.shape == img.shape and not np.array_equal(img, bg)
