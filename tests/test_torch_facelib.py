"""The port's face toolkit against the JAX package's, on the CPU in f32:
RetinaFace (both networks) and ParseNet on JAX trees carried over by
params_from_jax, with BatchNorm statistics drawn at random from a seed
(the init's mean 0 / var 1 would hide a swapped mean and var); the priors,
the decode and the NMS; detect_batch against per-frame detection; the
state-dict round trip through the JAX converters; FaceRestoreHelper's
crops and paste-back against the JAX helper, which runs on OpenCV here;
the landmark tracking.

Tolerances: network outputs within 1e-4 of their largest magnitude (the
frameworks differ in summation order only; measured ~2e-6); the decode
within 1e-6; NMS rows equal. Crops: bitwise given OpenCV's matrices, and
within 1 level at <= 1 % of the pixels through the port's own LMedS (the
refined matrix moves a crop's corners by ~1e-5 px against OpenCV's,
tests/test_torch_cvops.py, which flips the rounding of ~0.2 % of the
pixels). Paste-back within 1 level at <= 0.1 % of the pixels (the Gaussian
blurs differ from OpenCV's by <= 1e-6).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comfyui_keep_tpu.facelib.helper import FaceRestoreHelper as JHelper
from comfyui_keep_tpu.models import parsenet as jparse
from comfyui_keep_tpu.models import retinaface as jret
from comfyui_keep_tpu.pipeline import tracking as jtrack
from comfyui_keep_tpu.utils.checkpoint import convert_state_dict
from comfyui_keep_torch.facelib import factory
from comfyui_keep_torch.facelib.helper import (BORDER_GRAY, FFHQ_TEMPLATE_512,
                                               FaceRestoreHelper)
from comfyui_keep_torch.models import retinaface as tret
from comfyui_keep_torch.models.parsenet import ParseNet, make_parser_fn
from comfyui_keep_torch.models.retinaface import RetinaFace
from comfyui_keep_torch.pipeline import tracking as ttrack
from comfyui_keep_torch.utils import cvops
from comfyui_keep_torch.utils.convert import params_from_jax

torch.set_num_threads(2)
SMALL_PARSE = dict(in_size=64, out_size=64, min_feat_size=8, res_depth=2)


def random_bn(tree, rng):
    """The tree with every BatchNorm's scale, bias, mean and var drawn at
    random (var in [0.5, 2])."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = np.shape(tree["mean"])[0]
            f = np.float32
            return {"scale": rng.uniform(0.5, 1.5, c).astype(f),
                    "bias": rng.normal(0, 0.1, c).astype(f),
                    "mean": rng.normal(0, 0.1, c).astype(f),
                    "var": rng.uniform(0.5, 2.0, c).astype(f)}
        return {k: random_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [random_bn(v, rng) for v in tree]
    return None if tree is None else np.asarray(tree, np.float32)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module", params=["mobile0.25", "resnet50"])
def retina(request):
    net = request.param
    init = jax.jit(jret.RetinaFace.init, static_argnames="network")
    tree = random_bn(init(jax.random.PRNGKey(0), network=net),
                     np.random.default_rng(0))
    model = RetinaFace(net, device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    return net, tree, model


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def test_retinaface_heads_match_jax(retina):
    net, tree, model = retina
    x = np.random.default_rng(1).uniform(-120, 130, (1, 64, 96, 3)
                                         ).astype(np.float32)
    ref = jax.jit(jret.RetinaFace.apply, static_argnames="network")(
        tree, jnp.asarray(x), network=net)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert _rel(g.numpy(), r) <= 1e-4


def test_retinaface_state_dict_round_trip(retina):
    """Port state dict -> the JAX package's convert_state_dict -> the tree
    the port was loaded from; the reference module names."""
    net, tree, model = retina
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _tree_equal(convert_state_dict(sd), tree)
    body = ("body.layer1.0.downsample.0.weight" if net == "resnet50"
            else "body.stage1.1.3.weight")
    for key in (body, "fpn.output1.0.weight", "fpn.merge2.1.running_var",
                "ssh3.conv7x7_3.1.running_mean", "ClassHead.2.conv1x1.bias",
                "LandmarkHead.0.conv1x1.weight"):
        assert key in sd, key


def test_priors_decode_and_nms_match_jax():
    cfg = tret.CFG["resnet50"]
    pb = tret.prior_box(cfg, (70, 101))
    np.testing.assert_array_equal(pb, jret.prior_box(cfg, (70, 101)))
    rng = np.random.default_rng(2)
    loc = rng.normal(0, 1, (len(pb), 4)).astype(np.float32)
    pre = rng.normal(0, 1, (len(pb), 10)).astype(np.float32)
    p = torch.from_numpy(pb)
    np.testing.assert_allclose(
        tret.decode_boxes(torch.from_numpy(loc), p, cfg["variance"]).numpy(),
        np.asarray(jret.decode_boxes(jnp.asarray(loc), jnp.asarray(pb),
                                     cfg["variance"])), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tret.decode_landms(torch.from_numpy(pre), p, cfg["variance"]).numpy(),
        np.asarray(jret.decode_landms(jnp.asarray(pre), jnp.asarray(pb),
                                      cfg["variance"])), atol=1e-6, rtol=0)
    boxes = rng.uniform(0, 50, (60, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 30, (60, 2))], 1)
    scores = rng.uniform(0.5, 1.0, 60).astype(np.float32)
    landms = rng.uniform(0, 80, (60, 10)).astype(np.float32)
    dets = np.hstack([boxes, scores[:, None]])
    assert tret.nms_numpy(dets, 0.4) == jret.nms_numpy(dets, 0.4)
    np.testing.assert_array_equal(
        tret.filter_sort_nms(boxes, scores, landms, 0.8, 0.4),
        jret._filter_sort_nms(boxes, scores, landms, 0.8, 0.4))


def test_detector_rows_match_jax_and_detect_batch_matches_frames(retina):
    """A low threshold lets random weights through: the port's rows equal
    the JAX detector's within 1e-3 px, in order; detect_batch gives each
    frame's rows within 1e-3 px (the batched convolutions sum in another
    order: measured 1.5e-5 px for ResNet50, scores within 6e-8 for
    MobileNet). Among ~250 candidates above 0.3, scores lie as close as
    2e-7, so the batch may order two near-equal rows otherwise: each
    batch row is matched to the frame's row with the nearest box first."""
    net, tree, model = retina
    frames = np.random.default_rng(3).integers(0, 256, (2, 64, 96, 3),
                                               dtype=np.uint8)
    det = tret.make_detector_fn(model)
    jdet = jret.make_detector_fn(tree, network=net)
    single = [det(f, 0.3) for f in frames]
    batch = det.detect_batch(frames, 0.3)
    ref = jdet(frames[0], 0.3)
    assert single[0].shape == ref.shape and len(ref) > 0
    np.testing.assert_allclose(single[0], ref, atol=1e-3, rtol=1e-4)
    for s, b in zip(single, batch):
        assert b.shape == s.shape
        near = np.abs(s[:, None, :4] - b[None, :, :4]).sum(-1).argmin(1)
        assert sorted(near) == list(range(len(b)))
        np.testing.assert_allclose(b[near], s, atol=1e-3, rtol=1e-5)
        assert s.dtype == np.float32 and s.shape[1] == 15


def test_score_order_breaks_ties_by_index():
    """Equal scores keep their index order in the sort and in the NMS, so
    inputs that tie order alike whichever frame or batch they came from;
    unequal scores order as the JAX package's argsort does."""
    scores = np.array([0.5, 0.9, 0.5, 0.7, 0.9, 0.5], np.float32)
    assert tret.score_order(scores).tolist() == [1, 4, 3, 0, 2, 5]
    rng = np.random.default_rng(8)
    distinct = rng.permutation(64).astype(np.float32) / 64
    np.testing.assert_array_equal(tret.score_order(distinct),
                                  distinct.argsort()[::-1])
    # disjoint boxes, all kept, in score order then index order
    x = np.arange(6, dtype=np.float32)[:, None] * 10
    dets = np.hstack([x, x, x + 5, x + 5, scores[:, None]])
    assert tret.nms_numpy(dets, 0.4) == [1, 4, 3, 0, 2, 5]
    # one box twice at one score: the first index survives
    dets2 = np.array([[0, 0, 10, 10, 0.8], [0, 0, 10, 10, 0.8]], np.float32)
    assert tret.nms_numpy(dets2, 0.4) == [0]
    rows = tret.filter_sort_nms(dets[:, :4], scores, np.zeros((6, 10),
                                                              np.float32),
                                0.6, 0.4)
    np.testing.assert_array_equal(rows[:, 4], scores[[1, 4, 3]])
    np.testing.assert_array_equal(rows[:, 0], [10, 40, 30])


def test_parsenet_matches_jax_and_round_trips():
    init = jax.jit(jparse.ParseNet.init, static_argnames=tuple(SMALL_PARSE))
    tree = random_bn(init(jax.random.PRNGKey(1), **SMALL_PARSE),
                     np.random.default_rng(4))
    model = ParseNet(device="cpu", **SMALL_PARSE)
    model.load_state_dict(params_from_jax(tree, model))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 64, 64, 3)
                                         ).astype(np.float32)
    apply = jax.jit(jparse.ParseNet.apply, static_argnames=tuple(SMALL_PARSE))
    mask, img = apply(tree, jnp.asarray(x), **SMALL_PARSE)
    with torch.no_grad():
        got_mask, got_img = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(got_mask.permute(0, 2, 3, 1).numpy(), mask) <= 1e-4
    assert _rel(got_img.permute(0, 2, 3, 1).numpy(), img) <= 1e-4
    logits = make_parser_fn(model)(x)
    assert _rel(logits.numpy(), mask) <= 1e-4
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _tree_equal(jparse.convert_parsenet_checkpoint(sd), tree)
    for key in ("encoder.0.conv2d.bias",
                "encoder.1.shortcut_func.conv2d.weight",
                "body.0.conv1.norm.norm.running_var",
                "out_mask_conv.conv2d.bias"):
        assert key in sd, key


@pytest.mark.slow
def test_parsenet_512_matches_jax():
    tree = random_bn(jparse.ParseNet.init(jax.random.PRNGKey(2)),
                     np.random.default_rng(6))
    model = ParseNet(device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    x = np.random.default_rng(7).uniform(-1, 1, (1, 512, 512, 3)
                                         ).astype(np.float32)
    ref = jparse.make_parser_fn(tree)(jnp.asarray(x))
    assert _rel(make_parser_fn(model)(x).numpy(), ref) <= 1e-4


@pytest.mark.slow
def test_retinaface_full_frame_matches_jax():
    """ResNet50 at the detection size of a 720p frame."""
    tree = random_bn(jret.RetinaFace.init(jax.random.PRNGKey(3)),
                     np.random.default_rng(8))
    model = RetinaFace(device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    x = np.random.default_rng(9).uniform(-120, 130, (1, 640, 1137, 3)
                                         ).astype(np.float32)
    ref = jax.jit(jret.RetinaFace.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for r, g in zip(ref, got):
        assert _rel(g.numpy(), r) <= 1e-4


def test_factory_random_reference_pth_and_unported_names(tmp_path):
    det = factory.init_detection_model("retinaface_mobile0.25",
                                       require_weights=False, seed=3,
                                       device="cpu")
    again = factory.init_detection_model("retinaface_mobile0.25",
                                         require_weights=False, seed=3,
                                         device="cpu")
    for a, b in zip(det.model.state_dict().values(),
                    again.model.state_dict().values()):
        assert torch.equal(a, b)
    sd = {"module." + k: v for k, v in det.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    torch.save({"state_dict": sd},
               tmp_path / "detection_mobilenet0.25_Final.pth")
    loaded = factory.init_detection_model(
        "retinaface_mobile0.25", model_rootpath=str(tmp_path), device="cpu")
    for k, v in loaded.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, det.model.state_dict()[k]), k
    parser = factory.init_parsing_model("parsenet", require_weights=False,
                                        half=True, device="cpu")
    assert next(parser.model.parameters()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="require_weights"):
        factory.init_detection_model("retinaface_resnet50", device="cpu")
    with pytest.raises(FileNotFoundError):
        factory.init_parsing_model("parsenet", model_rootpath=str(tmp_path),
                                   device="cpu")
    # the names once refused (YOLOv5l, YOLOv5n, bisenet) build now
    for name in ("YOLOv5l", "YOLOv5n"):
        assert factory.init_detection_model(
            name, require_weights=False, device="cpu").model.config == \
            name.lower()
    assert factory.init_parsing_model("bisenet", require_weights=False,
                                      device="cpu").model is not None
    with pytest.raises(NotImplementedError, match="not implemented"):
        factory.init_detection_model("dlib", require_weights=False)


# ---------------------------------------------------------------------------
# the helper against the JAX helper (stub detector and parser of
# tests/test_e2e_configs.py)
# ---------------------------------------------------------------------------

def face_landmarks_at(scale, angle_deg, cx, cy):
    t = FFHQ_TEMPLATE_512 - FFHQ_TEMPLATE_512.mean(0)
    th = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (t @ rot.T) * scale + np.array([cx, cy])


def detection_row(landmarks, score=0.999):
    lm = np.asarray(landmarks, np.float32)
    x1, y1 = lm.min(0) - 10
    x2, y2 = lm.max(0) + 10
    return np.concatenate([[x1, y1, x2, y2, score],
                           lm.reshape(-1)]).astype(np.float32)


def synth_parse_logits(h=512, w=512):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    inside = (((xx - w / 2) / (w * 0.33)) ** 2 +
              ((yy - h / 2) / (h * 0.38)) ** 2) < 1.0
    logits = np.zeros((1, h, w, 19), np.float32)
    logits[0, :, :, 0] = 5.0
    logits[0, inside, 1] = 10.0
    return logits


def stub_parser(x):
    return synth_parse_logits()


def _helpers(rows, face_size=64, parser=stub_parser):
    def det(img, conf):
        return np.asarray(rows, np.float32).reshape(-1, 15)
    ours = FaceRestoreHelper(face_size=face_size, detector=det, parser=parser,
                             use_parse=parser is not None, device="cpu")
    ref = JHelper(face_size=face_size, detector=det, parser=parser,
                  use_parse=parser is not None)
    return ours, ref


def _level_diff(a, b):
    return np.abs(a.astype(int) - b.astype(int))


@pytest.mark.parametrize("noise", [0.0, 1.5])
def test_helper_crops_match_jax(noise):
    """Detection rows -> landmarks -> LMedS -> the face-size crop, on a
    600x700 frame (three faces, one partly outside the frame): bitwise
    through the JAX helper's (OpenCV's) matrices, within 1 level at
    <= 1 % of the pixels through the port's own LMedS (measured 0.2 %)."""
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (600, 700, 3), dtype=np.uint8)
    rows = [detection_row(face_landmarks_at(s, a, cx, cy)
                          + rng.standard_normal((5, 2)) * noise * s)
            for s, a, cx, cy in ((0.9, 8.0, 310, 280), (0.4, -20.0, 560, 130),
                                 (0.6, 35.0, 40, 540))]
    ours, ref = _helpers(rows)
    for h in (ours, ref):
        h.read_image(img)
        assert h.get_face_landmarks_5(eye_dist_threshold=5) == 3
        h.align_warp_face()
    assert len(ours.cropped_faces) == 3
    for a, b in zip(ours.cropped_faces, ref.cropped_faces):
        assert a.dtype == np.uint8 and a.shape == b.shape == (64, 64, 3)
        d = _level_diff(a, b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-2
    for m, b in zip(ref.affine_matrices, ref.cropped_faces):
        crop = cvops.warp_affine(torch.from_numpy(ours.input_img), m,
                                 ours.face_size, border_value=BORDER_GRAY)
        np.testing.assert_array_equal(crop.numpy(), b)


@pytest.mark.parametrize("parse,draw_box,factor", [
    (True, False, 2.0), (False, False, 2.0), (False, True, 1.0),
    (True, True, 1.5)])
def test_helper_paste_matches_jax(parse, draw_box, factor):
    """The same restored faces and matrices pasted by both helpers: the
    erosion-and-blur mask or the parse soft mask, boxes drawn or not."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (520, 600, 3), dtype=np.uint8)
    rows = [detection_row(face_landmarks_at(s, a, cx, cy))
            for s, a, cx, cy in ((0.8, 10.0, 300, 260),
                                 (0.3, -25.0, 520, 120))]
    ours, ref = _helpers(rows, parser=stub_parser if parse else None)
    ref.read_image(img)
    ref.get_face_landmarks_5(eye_dist_threshold=5)
    ref.align_warp_face()
    faces = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
             for _ in range(2)]
    for h in (ours, ref):
        h.read_image(img)
        h.upscale_factor = factor
        h.affine_matrices = list(ref.affine_matrices)
        h.restored_faces = list(faces)
        h.get_inverse_affine()
    bg = rng.integers(0, 256, (int(520 * factor), int(600 * factor), 3),
                      dtype=np.uint8)
    got = ours.paste_faces_to_input_image(upsample_img=bg, draw_box=draw_box)
    want = ref.paste_faces_to_input_image(upsample_img=bg, draw_box=draw_box)
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = _level_diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_helper_read_image_and_detection_resize_match_jax():
    """A 300x400 frame is upscaled to a 512 short side (fx/fy LINEAR), a
    720p one shrunk for detection to 640 (INTER_AREA); gray frames become
    BGR."""
    rng = np.random.default_rng(12)
    ours, ref = _helpers([], parser=None)
    for shape in ((300, 400, 3), (720, 1280, 3), (530, 530)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ours.read_image(img)
        ref.read_image(img)
        np.testing.assert_array_equal(ours.input_img, ref.input_img)
        assert ours.is_gray == ref.is_gray
        small, back = ours.resize_for_detection(resize=640)
        jsmall, jback = JHelper.resize_for_detection(ref.input_img, 640)
        np.testing.assert_array_equal(small.numpy(), jsmall)
        assert back == jback


def test_tracking_matches_jax():
    rng = np.random.default_rng(13)
    frames = []
    for i in range(9):
        lms = []
        if i != 4:   # a frame without detections
            lms.append(face_landmarks_at(0.5, 0, 100 + 3 * i, 120)
                       + rng.normal(0, 1, (5, 2)))
        if i % 3:
            lms.append(face_landmarks_at(0.4, 10, 400 - 2 * i, 300))
        if i == 7:
            lms.append(face_landmarks_at(0.3, 0, 700, 600))
        frames.append(lms)
    ours = ttrack.track_faces(frames)
    ref = jtrack.track_faces(frames)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.array(ours[k]), np.array(ref[k]))
    sm, rsm = (ttrack.smooth_landmark_tracks(ours, 9),
               jtrack.smooth_landmark_tracks(ref, 9))
    for k in rsm:
        np.testing.assert_array_equal(sm[k], rsm[k])
    seq = np.array([1.0, np.nan, 3.0, np.nan, np.nan, 9.0])
    np.testing.assert_array_equal(ttrack.interpolate_sequence(seq),
                                  jtrack.interpolate_sequence(seq))
