"""comfyui_keep_torch/utils/resize.py against cv2.resize, bitwise: INTER_LINEAR
and INTER_LANCZOS4 on uint8 images, up and down, square and not, at 1-pixel
and odd sizes, with 3 channels, 1 channel and none. OpenCV is the oracle
here only; the port never imports it.
"""
import cv2
import numpy as np
import pytest

from comfyui_keep_torch.utils.resize import resize

MODES = {"linear": cv2.INTER_LINEAR, "lanczos4": cv2.INTER_LANCZOS4}
# (source h, w) -> (target h, w)
SIZES = [((50, 64), (512, 512)),     # the single-image face, up
         ((400, 400), (512, 512)),   # chip_smoke.py's non-aligned face
         ((512, 512), (768, 768)),   # the upscale factor 1.5
         ((512, 512), (1024, 1024)),
         ((512, 512), (256, 256)),   # exactly half
         ((300, 200), (17, 31)),     # down, non-square
         ((7, 9), (13, 4)),          # odd, up one way and down the other
         ((1, 1), (5, 3)),           # from one pixel
         ((33, 65), (1, 1)),         # to one pixel
         ((13, 1), (1, 13)),
         ((2, 3), (3, 2))]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_equals_cv2_bitwise(mode, src, dst):
    rng = np.random.default_rng(hash((src, dst)) % 2 ** 32)
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    img[: src[0] // 2, : src[1] // 3] = 255        # flat and saturated areas,
    img[src[0] // 2:, src[1] // 2:] = 0             # where Lanczos overshoots
    got = resize(img, dst[::-1], mode)
    ref = cv2.resize(img, dst[::-1], interpolation=MODES[mode])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [(37, 23), (37, 23, 1), (37, 23, 4)])
def test_resize_channels_equal_cv2(mode, shape):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = resize(img, (50, 19), mode)
    ref = cv2.resize(img, (50, 19), interpolation=MODES[mode])
    np.testing.assert_array_equal(got, ref.reshape(got.shape))


def test_resize_same_size_is_a_copy_and_bad_input_raises():
    img = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)
    out = resize(img, (5, 4), "lanczos4")
    np.testing.assert_array_equal(out, img)
    assert out is not img
    with pytest.raises(ValueError):
        resize(img.astype(np.float32), (3, 3))
    with pytest.raises(ValueError):
        resize(img, (3, 3), "cubic")
    with pytest.raises(ValueError):
        resize(img, (0, 3))
