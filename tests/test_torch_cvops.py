"""comfyui_keep_torch/utils/cvops.py (and the fx/fy form of utils/resize.py)
against OpenCV on seeded inputs. OpenCV is the oracle here only; the port
never imports it.

Bitwise: the warps (uint8 and float32, linear and nearest, every border),
erosion at k = 1...6, the box filter, INTER_AREA at integer and
non-integer factors, the fx/fy LINEAR resize, GRAY->BGR, BGR->GRAY at 8
and 16 bits, copyMakeBorder (BORDER_CONSTANT) and the 16-bit LANCZOS4
resize. Within 1e-6
on [0, 1] masks: the Gaussian blurs (OpenCV sums with FMAs in its vector
code). The float32 LINEAR resize (the parse mask to a face size other than
512) within 1 ulp at an integer factor and 2e-5 otherwise: OpenCV 5's
float resize rounds its weights or sums in a way this does not reproduce
(measured 1.45e-5 at 512 -> 96 x 80).

LMedS (`cv2.estimateAffinePartial2D(method=cv2.LMEDS)`) on 600 seeded
landmark sets, the FFHQ template under random similarities, clean and with
Gaussian noise of 0.5, 1 and 3 px times the scale: the inlier masks and the
unrefined LMedS model are OpenCV's exactly. The refined matrix is not: its
linear part agrees within 1e-6 in 96 % of the sets and within 1.8e-5 in
all (measured), so the test holds it to 1e-6 in 90 % and 5e-5 in all;
what that moves is the crop, whose four corners map into the frame within
9.8e-5 px of OpenCV's (held to 2e-4). The translation alone differs by up
to 2.6e-2 px, along the ill-conditioned coupling of rotation and
translation for landmarks far from the origin. OpenCV's refinement takes
steps that depart from a damped least-squares step by its own rounding.
The closed-form least squares of the JAX helper's cv2-free fallback, on
the same sets, moves the crop corners by more than 0.5 px in 48 of them
(8 %; 11 % of the noisy ones); the test asks for at least 5 %.
"""
import cv2
import numpy as np
import pytest
import torch

from comfyui_keep_torch.utils import cvops
from comfyui_keep_torch.utils.resize import resize

torch.set_num_threads(2)
BORDERS = {"constant": cv2.BORDER_CONSTANT,
           "replicate": cv2.BORDER_REPLICATE,
           "reflect101": cv2.BORDER_REFLECT101,
           "reflect": cv2.BORDER_REFLECT}
FFHQ = np.array([[192.98138, 239.94708], [318.90277, 240.1936],
                 [256.63416, 314.01935], [201.26117, 371.41043],
                 [313.08905, 371.15118]], np.float64)


def _similarity(rng, scale=(0.5, 2.0)):
    s = rng.uniform(*scale)
    th = rng.uniform(-0.7, 0.7)
    return np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-40, 40)],
                     [s * np.sin(th), s * np.cos(th), rng.uniform(-40, 40)]])


def _image(rng, shape, dtype):
    img = rng.integers(0, 256, shape).astype(dtype)
    if dtype == np.float32:
        img = img / 255 + rng.random(shape).astype(np.float32)
    return img


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
def test_warp_affine_bitwise(dtype, channels, border, interpolation):
    """Destinations narrower than, equal to and wider than one 16-pixel step
    of OpenCV's vector body, so both coordinate forms show; the helper's
    border value (135, 133, 132)."""
    rng = np.random.default_rng(hash((dtype.__name__, channels, border,
                                      interpolation)) % 2 ** 32)
    flag = (cv2.INTER_LINEAR if interpolation == "linear"
            else cv2.INTER_NEAREST)
    shape = (57, 63) if channels == 1 else (57, 63, channels)
    for dsize in ((50, 30), (16, 30), (7, 5), (100, 9)):
        img = _image(rng, shape, dtype)
        m = _similarity(rng)
        ref = cv2.warpAffine(img, m, dsize, flags=flag,
                             borderMode=BORDERS[border],
                             borderValue=(135, 133, 132))
        got = cvops.warp_affine(torch.as_tensor(img), m, dsize,
                                interpolation, border, (135, 133, 132))
        assert got.dtype == torch.from_numpy(img).dtype
        np.testing.assert_array_equal(got.numpy(), ref)


def test_warp_affine_face_crop_and_paste_bitwise():
    """The helper's two warps at their sizes: a 512^2 crop of a 720p frame
    with the gray border, and a float mask pasted back into a 2x frame."""
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (180, 320, 3), dtype=np.uint8)
    m = np.array([[2.1, -0.4, -180.0], [0.4, 2.1, -90.0]])
    ref = cv2.warpAffine(frame, m, (128, 128), borderValue=(135, 133, 132))
    got = cvops.warp_affine(torch.as_tensor(frame), m, (128, 128),
                            border_value=(135, 133, 132))
    np.testing.assert_array_equal(got.numpy(), ref)
    inv = cv2.invertAffineTransform(m) * 2
    mask = rng.random((128, 128)).astype(np.float32)
    ref = cv2.warpAffine(mask, inv, (640, 360))
    got = cvops.warp_affine(torch.as_tensor(mask), inv, (640, 360))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_erode_bitwise(k):
    rng = np.random.default_rng(k)
    mask = rng.random((40, 53)).astype(np.float32)
    mask[rng.random(mask.shape) < 0.3] = 0
    ref = cv2.erode(mask, np.ones((k, k), np.uint8))
    np.testing.assert_array_equal(
        cvops.erode(torch.as_tensor(mask), k).numpy(), ref)
    img = rng.integers(0, 256, (21, 17, 3), dtype=np.uint8)
    ref = cv2.erode(img, np.ones((k, k), np.uint8))
    np.testing.assert_array_equal(
        cvops.erode(torch.as_tensor(img), k).numpy(), ref)


def test_erode_wide_window_on_a_warped_mask():
    """The paste's inner erosion: a window wider than 40 px on the warp of
    a face mask (k even, so its anchor is off centre)."""
    ones = np.ones((64, 64), np.float32)
    m = np.array([[1.9, 0.3, 20.0], [-0.3, 1.9, 15.0]])
    mask = cv2.warpAffine(ones, m, (200, 180))
    for k in (4, 42, 43):
        ref = cv2.erode(mask, np.ones((k, k), np.uint8))
        np.testing.assert_array_equal(
            cvops.erode(torch.as_tensor(mask), k).numpy(), ref)


@pytest.mark.parametrize("ksize,sigma", [(3, 0), (5, 0), (7, 0), (9, 0),
                                         (51, 11), (101, 11), (21, 0)])
def test_gaussian_kernel_and_blur(ksize, sigma):
    """The kernel equals getGaussianKernel's (the fixed tables for sigma 0
    and ksize <= 7); the blur of a [0, 1] mask, ksize 101 on a 512^2 one as
    the parse mask's, is within 1e-6."""
    np.testing.assert_array_equal(
        cvops.gaussian_kernel(ksize, sigma),
        cv2.getGaussianKernel(ksize, sigma, ktype=cv2.CV_32F).ravel())
    rng = np.random.default_rng(ksize)
    side = 512 if ksize == 101 else 90
    mask = (rng.random((side, side + 7)) < 0.5).astype(np.float32)
    mask[side // 4: side // 2, side // 3:] = 1.0
    ref = cv2.GaussianBlur(mask, (ksize, ksize), sigma)
    got = cvops.gaussian_blur(torch.as_tensor(mask), ksize, sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_parse_mask_double_blur():
    """The parse soft mask's chain: a 0/255 mask blurred twice at 101 px,
    sigma 11, then divided by 255, within 1e-6."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:512, :512]
    mask = np.where(((xx - 250) / 170.0) ** 2 + ((yy - 260) / 190.0) ** 2 < 1,
                    255.0, 0.0).astype(np.float32)
    mask[rng.random(mask.shape) < 0.01] = 0
    ref = cv2.GaussianBlur(cv2.GaussianBlur(mask, (101, 101), 11),
                           (101, 101), 11) / 255.0
    t = torch.as_tensor(mask)
    got = cvops.gaussian_blur(cvops.gaussian_blur(t, 101, 11), 101, 11) / 255.0
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 11, 21])
def test_box_filter_bitwise(ksize):
    rng = np.random.default_rng(ksize)
    img = rng.integers(0, 256, (45, 38, 3), dtype=np.uint8)
    ref = cv2.boxFilter(img, 0, ksize=(ksize, ksize))
    np.testing.assert_array_equal(
        cvops.box_filter(torch.as_tensor(img), ksize).numpy(), ref)


@pytest.mark.parametrize("src,dst", [
    ((720, 1280), (640, 1137)),   # resize_for_detection of a 720p frame
    ((1080, 1920), (640, 1137)),  # of a 1080p frame (a factor of 1.6875)
    ((1280, 1280), (640, 640)),   # a factor of 2
    ((960, 963), (320, 321)),     # a factor of 3
    ((700, 1000), (640, 914)),
    ((97, 61), (41, 33))])
def test_resize_area_bitwise(src, dst):
    rng = np.random.default_rng(src[0])
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    img[: src[0] // 3] = 255
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = cvops.resize_area(torch.as_tensor(img), dst[::-1]).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(480, 640), (300, 200), (511, 700),
                                   (100, 101), (384, 510)])
def test_resize_by_factor_bitwise(shape):
    """read_image's upscale of a frame whose short side is under 512:
    cv2.resize(img, (0, 0), fx=f, fy=f): the size rounds w f, the mapping
    is by 1 / f."""
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    f = 512.0 / min(shape)
    ref = cv2.resize(img, (0, 0), fx=f, fy=f, interpolation=cv2.INTER_LINEAR)
    got = resize(img, (0, 0), "linear", fx=f, fy=f)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,dst,atol", [((512, 512), (64, 64), 6e-8),
                                          ((512, 512), (96, 80), 2e-5),
                                          ((64, 64), (512, 512), 2e-5)])
def test_resize_linear_f32(src, dst, atol):
    """The parse mask's resize to the face size, on [0, 1] values."""
    rng = np.random.default_rng(1)
    img = rng.random(src).astype(np.float32)
    ref = cv2.resize(img, dst[::-1])
    got = cvops.resize_linear_f32(torch.as_tensor(img), dst[::-1]).numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_gray_to_bgr():
    img = np.random.default_rng(0).integers(0, 256, (9, 7), dtype=np.uint8)
    np.testing.assert_array_equal(cvops.gray_to_bgr(img),
                                  cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_bgr_to_gray_bitwise(dtype):
    """OpenCV 5's fixed-point luma (15-bit coefficients) at both depths,
    the extremes included; numpy and tensors."""
    hi = np.iinfo(dtype).max
    rng = np.random.default_rng(2)
    img = rng.integers(0, hi + 1, (61, 83, 3)).astype(dtype)
    img[0, :4] = [[hi, hi, hi], [0, 0, 0], [hi, 0, 0], [0, hi, hi]]
    ref = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    got = cvops.bgr_to_gray(img)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    t = cvops.bgr_to_gray(torch.from_numpy(img.astype(np.int32)))
    np.testing.assert_array_equal(t.numpy(), ref)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("pads,value", [((3, 4, 5, 6), (114, 114, 114)),
                                        ((0, 0, 7, 0), (1, 2, 3)),
                                        ((140, 140, 0, 0), 114)])
def test_copy_make_border_bitwise(channels, pads, value):
    shape = (30, 40) if channels == 1 else (30, 40, 3)
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    ref = cv2.copyMakeBorder(img, *pads, cv2.BORDER_CONSTANT, value=value)
    got = cvops.copy_make_border(torch.from_numpy(img), *pads, value)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("src,dst,channels", [
    ((100, 130), (173, 251), 3), ((100, 130), (60, 70), None),
    ((64, 48), (256, 192), 4), ((31, 17), (5, 9), 3),
    ((37, 53), (148, 212), 3), ((720, 1280), (360, 640), None)])
def test_resize_lanczos4_uint16_bitwise(src, dst, channels):
    """OpenCV's LANCZOS4 for 16-bit images (float weights and sums, RealESRGANer's
    16-bit outscale), up and down, 1 / 3 / 4 channels."""
    shape = src if channels is None else src + (channels,)
    img = np.random.default_rng(4).integers(0, 65536, shape, dtype=np.uint16)
    img[:3, :3] = 65535
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LANCZOS4)
    got = resize(img, dst[::-1], "lanczos4")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ref)


def _landmark_sets(n=600, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        s = rng.uniform(0.1, 2.0)
        th = rng.uniform(-0.6, 0.6)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        lm = ((FFHQ - FFHQ.mean(0)) @ rot.T * s
              + rng.uniform(0, 1500, 2))
        noise = (0.0, 0.5, 1.0, 3.0)[k % 4]
        out.append((noise, lm + rng.standard_normal(lm.shape) * noise * s))
    return out


def test_lmeds_matches_opencv():
    lin, corner, masks, unrefined, ls_far = [], [], 0, 0, 0
    corners = np.array([[0, 0, 1], [511, 0, 1], [0, 511, 1],
                        [511, 511, 1]], np.float64)

    def crop_corners(m):
        return cv2.invertAffineTransform(m) @ corners.T

    sets = _landmark_sets()
    for noise, lm in sets:
        ref, ref_mask = cv2.estimateAffinePartial2D(lm, FFHQ,
                                                    method=cv2.LMEDS)
        got, mask = cvops.estimate_affine_partial_lmeds(lm, FFHQ)
        masks += np.array_equal(mask, ref_mask)
        lin.append(np.abs(got[:, :2] - ref[:, :2]).max())
        corner.append(np.abs(crop_corners(got) - crop_corners(ref)).max())
        ref0 = cv2.estimateAffinePartial2D(lm, FFHQ, method=cv2.LMEDS,
                                           refineIters=0)[0]
        got0 = cvops.estimate_affine_partial_lmeds(lm, FFHQ,
                                                   refine_iters=0)[0]
        unrefined += np.array_equal(got0, ref0)
        ls = cvops.similarity_transform(lm, FFHQ)
        ls_far += np.abs(crop_corners(ls) - crop_corners(ref)).max() > 0.5
    n = len(sets)
    lin = np.array(lin)
    assert masks == n and unrefined == n
    assert (lin <= 1e-6).mean() >= 0.9, (lin <= 1e-6).mean()
    assert lin.max() <= 5e-5, lin.max()
    assert max(corner) <= 2e-4, max(corner)
    assert ls_far >= n // 20, ls_far


def test_lmeds_rng_and_iteration_count():
    """cv::RNG from state 2^64 - 1, and 13 subsets at confidence 0.99 with
    an outlier ratio of 0.45 for a 2-point model."""
    rng = cvops._CvRNG()
    state = 2 ** 64 - 1
    for _ in range(5):
        state = ((state & 0xFFFFFFFF) * 4164903690 + (state >> 32)) % 2 ** 64
        assert rng.next() == state & 0xFFFFFFFF
    assert cvops._ransac_iters(0.99, 0.45, 2, 2000) == 13
    got, mask = cvops.estimate_affine_partial_lmeds(FFHQ[:1], FFHQ[:1])
    assert got is None and mask.shape == (1, 1)
