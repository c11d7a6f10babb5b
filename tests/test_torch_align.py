"""The port's alignment helpers against the JAX package's, which run on
OpenCV here: facelib/align_trans.py (the cp2tform similarity solves, the
reference points, warp_and_crop_face), facelib/face_utils.py (bbox
growing, the FFHQ oriented-quad crop, paste_face_back), FaceAligner (the
training-time aligner) and models/retinaface.py's align_multi.

Tolerances. The numpy solves equal. Warps through the same matrix are
bitwise (uint8 and float32; utils/cvops.py's warp is OpenCV 5's). Where
the JAX side solves by cv2.estimateAffinePartial2D(LMEDS) and the port by
its own LMedS, the bound of tests/test_torch_cvops.py holds: crops within
1 level at <= 1 % of the pixels (the refined matrix moves a crop's corners
by ~1e-5 px); the same crops through OpenCV's own matrices (the port's
estimate_affine swapped for cv2's in the test) are bitwise, or, where the
crop is float32 and resized by INTER_LINEAR, within 2e-5 of 255 (OpenCV's
float resize, cvops.resize_linear_f32). paste_face_back's float32 output
within 1e-3 levels (its Gaussian blur sums within 1e-6 of OpenCV's).
"""
import cv2
import numpy as np
import pytest
import torch

from comfyui_keep_tpu.facelib import align_trans as jat
from comfyui_keep_tpu.facelib import face_utils as jfu
from comfyui_keep_tpu.facelib.helper import FaceAligner as JAligner
from comfyui_keep_tpu.models import retinaface as jret
from comfyui_keep_torch.facelib import align_trans as tat
from comfyui_keep_torch.facelib import face_utils as tfu
from comfyui_keep_torch.facelib import helper as thelper
from comfyui_keep_torch.facelib.helper import FFHQ_TEMPLATE_512, FaceAligner
from comfyui_keep_torch.models import retinaface as tret

torch.set_num_threads(2)


def landmarks_at(scale, angle_deg, cx, cy, template=FFHQ_TEMPLATE_512):
    t = template - template.mean(0)
    th = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (t @ rot.T) * scale + np.array([cx, cy])


def cv2_lmeds(landmark, template):
    """The JAX helper's estimate_affine on OpenCV (LMedS)."""
    return cv2.estimateAffinePartial2D(landmark, template,
                                       method=cv2.LMEDS)[0]


def levels(a, b):
    return np.abs(a.astype(np.float64) - b.astype(np.float64))


def assert_lmeds_bound(got, ref):
    """Within 1 level at <= 1 % of the pixels."""
    d = levels(got, ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2


# -- align_trans --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(default_square=True), dict(), dict(output_size=(96, 112)),
    dict(output_size=(112, 112), default_square=True),
    dict(inner_padding_factor=0.25, outer_padding=(0, 0)),
    dict(inner_padding_factor=0.5, outer_padding=(0, 0),
         default_square=True)])
def test_reference_points_equal_jax(kw):
    np.testing.assert_array_equal(tat.get_reference_facial_points(**kw),
                                  jat.get_reference_facial_points(**kw))


def test_reference_points_errors_match():
    for kw in (dict(output_size=(100, 100)),
               dict(inner_padding_factor=2.0, output_size=(50, 50)),
               dict(inner_padding_factor=0.0, outer_padding=(8, 8))):
        with pytest.raises(tat.FaceWarpException):
            tat.get_reference_facial_points(**kw)
        with pytest.raises(jat.FaceWarpException):
            jat.get_reference_facial_points(**kw)


def test_similarity_solves_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        src = rng.uniform(0, 200, (5, 2))
        dst = rng.uniform(0, 112, (5, 2))
        for reflective in (True, False):
            a = tat.get_similarity_transform_for_cv2(src.copy(), dst.copy(),
                                                     reflective)
            b = jat.get_similarity_transform_for_cv2(src.copy(), dst.copy(),
                                                     reflective)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tat.get_affine_transform_matrix(np.float32(src), np.float32(dst)),
            jat.get_affine_transform_matrix(np.float32(src), np.float32(dst)))
        t = rng.normal(size=(3, 3))
        t[:, 2] = [0, 0, 1]
        np.testing.assert_array_equal(tat.tforminv(t, src),
                                      jat.tforminv(t, src))


@pytest.mark.parametrize("align_type", ["smilarity", "affine", "cv2_affine"])
@pytest.mark.parametrize("crop_size,square", [((112, 112), True),
                                              ((96, 112), False)])
def test_warp_and_crop_face_bitwise(align_type, crop_size, square):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (240, 300, 3), dtype=np.uint8)
    pts = landmarks_at(0.35, 12.0, 150, 120) + rng.normal(0, 1.0, (5, 2))
    ref_pts = jat.get_reference_facial_points(default_square=square) \
        if square else None
    got = tat.warp_and_crop_face(img, pts, ref_pts, crop_size, align_type,
                                 device="cpu")
    want = jat.warp_and_crop_face(img, pts, ref_pts, crop_size, align_type)
    assert got.shape == want.shape == (crop_size[1], crop_size[0], 3)
    np.testing.assert_array_equal(got, want)


def test_align_multi_bitwise():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (260, 340, 3), dtype=np.uint8)
    rows = [np.concatenate([[10, 10, 100, 100, 0.99], landmarks_at(
        s, a, cx, cy).reshape(-1)]).astype(np.float32)
        for s, a, cx, cy in ((0.3, 5.0, 90, 110), (0.25, -15.0, 240, 150))]

    def det(frame, conf):
        return np.stack(rows)

    got_rows, got = tret.align_multi(det, img, limit=2, device="cpu")
    want_rows, want = jret.align_multi(det, img, limit=2)
    np.testing.assert_array_equal(got_rows, want_rows)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == (112, 112, 3)
        np.testing.assert_array_equal(a, b)
    none_rows, none = tret.align_multi(lambda f, c: np.zeros((0, 15)), img,
                                       device="cpu")
    assert none_rows.shape == (0, 15) and none == []


# -- face_utils -----------------------------------------------------------------

def test_bbox_helpers_equal_jax():
    for bbox, inc, keep in (((10, 20, 110, 160), 0.2, True),
                            ((5, 5, 200, 60), 0.1, True),
                            ((30, 40, 70, 90), 0.3, False)):
        assert tfu.compute_increased_bbox(bbox, inc, keep) == \
            jfu.compute_increased_bbox(bbox, inc, keep)
        grown = tfu.compute_increased_bbox(bbox, inc, keep)
        assert tfu.get_valid_bboxes(grown, 100, 150) == \
            jfu.get_valid_bboxes(grown, 100, 150)
    lm98 = np.random.default_rng(3).uniform(0, 100, (98, 2))
    for lm, kind in ((lm98, "retinaface_5"), (lm98[:68], "retinaface_5"),
                     (lm98[:5], "dlib_5")):
        for a, b in zip(tfu._parse_landmarks(lm, kind),
                        jfu._parse_landmarks(lm, kind)):
            np.testing.assert_array_equal(a, b)


# (frame shape, face scale, angle, centre, output size): inside the frame
# (uint8 crop), partly outside (reflect padding, float32 crop), and large
# enough to shrink first (INTER_AREA)
CROPS = [((300, 360), 0.3, 10.0, (180, 150), 64),
         ((300, 360), 0.35, -20.0, (40, 60), 64),
         ((600, 700), 0.9, 5.0, (350, 300), 32)]


@pytest.mark.parametrize("shape,scale,angle,centre,size", CROPS)
def test_align_crop_face_landmarks(monkeypatch, shape, scale, angle, centre,
                                   size):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    lm = landmarks_at(scale, angle, *centre) + rng.normal(0, 0.5, (5, 2))
    want, want_inv = jfu.align_crop_face_landmarks(
        img, lm, size, return_inverse_affine=True)
    got, got_inv = tfu.align_crop_face_landmarks(
        img, lm, size, return_inverse_affine=True, device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got_inv, want_inv, atol=1e-3, rtol=0)
    if got.dtype == np.uint8:
        assert_lmeds_bound(got, want)
    # OpenCV's own matrices: the rest of the recipe matches exactly
    monkeypatch.setattr(tfu, "estimate_affine", cv2_lmeds)
    got, got_inv = tfu.align_crop_face_landmarks(
        img, lm, size, return_inverse_affine=True, device="cpu")
    np.testing.assert_array_equal(got_inv, want_inv)
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        assert levels(got, want).max() <= 2e-5 * 255


def test_paste_face_back():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (200, 240, 3), dtype=np.uint8)
    face = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    _, inv = jfu.align_crop_face_landmarks(
        img, landmarks_at(0.3, 8.0, 120, 100), 64,
        return_inverse_affine=True)
    want = jfu.paste_face_back(img, face, inv)
    got = tfu.paste_face_back(img, face, inv, device="cpu")
    assert got.dtype == want.dtype == np.float32
    assert levels(got, want).max() <= 1e-3
    # a face so small that the centre erosion is OpenCV's 3 x 3 default
    tiny = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    inv_small = np.array([[1.0, 0.0, 20.0], [0.0, 1.0, 30.0]])
    want = jfu.paste_face_back(img, tiny, inv_small)
    got = tfu.paste_face_back(img, tiny, inv_small, device="cpu")
    assert levels(got, want).max() <= 1e-3


# -- FaceAligner ------------------------------------------------------------------

@pytest.mark.parametrize("border", ["constant", "reflect101", "reflect"])
def test_face_aligner_matches_jax(monkeypatch, border):
    rng = np.random.default_rng(6)
    lm = landmarks_at(0.15, 15.0, 64, 60) + rng.normal(0, 0.5, (5, 2))
    gt = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    lq = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    ours = FaceAligner(1, face_size=128, device="cpu")
    ref = JAligner(1, face_size=128)
    got = ours.align_warp_face(lq, gt, lm, border)
    want = ref.align_warp_face(lq, gt, lm, border)
    for a, b in zip(got, want):
        assert_lmeds_bound(a, b)
    img = rng.random((128, 128, 3))
    assert_lmeds_bound(
        np.round(ours.align_single_face(img, lm, border) * 255),
        np.round(ref.align_single_face(img, lm, border) * 255))
    monkeypatch.setattr(thelper, "estimate_affine", cv2_lmeds)
    for a, b in zip(ours.align_warp_face(lq, gt, lm, border), want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.align_single_face(img, lm, border),
                                  ref.align_single_face(img, lm, border))
    pair = ours.align_pair_face(lq / 255.0, gt / 255.0, lm)
    for a, b in zip(pair, ref.align_pair_face(lq / 255.0, gt / 255.0, lm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(det_model="dlib"),
                                dict(template_3points=True),
                                dict(crop_ratio=(1.5, 1.25)),
                                dict(pad_blur=True, template_3points=True)])
def test_face_aligner_templates_equal_jax(kw):
    ours = FaceAligner(2, face_size=256, device="cpu", **kw)
    ref = JAligner(2, face_size=256, **kw)
    np.testing.assert_array_equal(ours.face_template, ref.face_template)
    assert ours.face_size == ref.face_size
    assert ours.template_3points == ref.template_3points
    with pytest.raises(ValueError):
        FaceAligner(1, crop_ratio=(0.5, 1), device="cpu")
