"""Reference-point alignment and MATLAB cp2tform's similarity solve
(reference wm_facelib/detection/align_trans.py:19-219 and
matlab_cp2tform.py:13-317), ported from comfyui_keep_tpu/facelib/
align_trans.py. The solves are host numpy (a tiny least squares a face);
the warp is utils/cvops.py's cv2.warpAffine on the caller's device.

Conventions are MATLAB's: transforms are 3x3 matrices acting on row
vectors, ``[x, y, 1] = [u, v, 1] @ trans``; ``cvt_tform_mat_for_cv2``
turns one into the 2x3 column-vector form cv2.warpAffine takes.
"""
from typing import Optional, Sequence, Tuple

import numpy as np

# reference facial points, a list of (x, y) coordinates on the default
# 96x112 crop (align_trans.py:7-10)
REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.3655014],
    [62.72990036, 92.20410156]], dtype=np.float64)

DEFAULT_CROP_SIZE = (96, 112)


class FaceWarpException(Exception):
    def __str__(self):
        return f"In File {__file__}:{super().__str__()}"


def tformfwd(trans: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Apply 3x3 affine ``trans`` to Kx2 points (matlab_cp2tform.py:13-34)."""
    uv = np.hstack((uv, np.ones((uv.shape[0], 1))))
    return (uv @ trans)[:, :-1]


def tforminv(trans: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Apply the inverse of ``trans`` (matlab_cp2tform.py:37-57)."""
    return tformfwd(np.linalg.inv(trans), uv)


def find_nonreflective_similarity(uv: np.ndarray, xy: np.ndarray
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """4-DOF similarity (scale/rotation/translation) by least squares, the
    MATLAB cp2tform 'nonreflective similarity' solve
    (matlab_cp2tform.py:60-91). Returns (T, Tinv), both 3x3 row-vector form.
    """
    m = xy.shape[0]
    x = xy[:, 0:1]
    y = xy[:, 1:2]
    tmp1 = np.hstack((x, y, np.ones((m, 1)), np.zeros((m, 1))))
    tmp2 = np.hstack((y, -x, np.zeros((m, 1)), np.ones((m, 1))))
    X = np.vstack((tmp1, tmp2))
    U = np.vstack((uv[:, 0:1], uv[:, 1:2]))
    if np.linalg.matrix_rank(X) < 4:
        raise FaceWarpException("cp2tform:twoUniquePointsReq")
    r = np.linalg.lstsq(X, U, rcond=-1)[0].squeeze()
    sc, ss, tx, ty = r[0], r[1], r[2], r[3]
    tinv = np.array([[sc, -ss, 0.0], [ss, sc, 0.0], [tx, ty, 1.0]])
    t = np.linalg.inv(tinv)
    t[:, 2] = [0.0, 0.0, 1.0]
    return t, tinv


def find_similarity(uv: np.ndarray, xy: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Reflective similarity: solve both orientations, keep the lower
    residual (matlab_cp2tform.py:94-127). NB the reference mutates its
    ``xy`` argument when building the reflected copy
    (matlab_cp2tform.py:106-107) — reproduced here by reflecting in place so
    trans1's residual is measured against the reflected points exactly as
    the original does."""
    trans1, trans1_inv = find_nonreflective_similarity(uv, xy)
    xy_r = xy  # aliased, same as the reference
    xy_r[:, 0] = -xy_r[:, 0]
    trans2r, _ = find_nonreflective_similarity(uv, xy_r)
    reflect_y = np.array([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    trans2 = trans2r @ reflect_y
    norm1 = np.linalg.norm(tformfwd(trans1, uv) - xy)
    norm2 = np.linalg.norm(tformfwd(trans2, uv) - xy)
    if norm1 <= norm2:
        return trans1, trans1_inv
    return trans2, np.linalg.inv(trans2)


def get_similarity_transform(src_pts: np.ndarray, dst_pts: np.ndarray,
                             reflective: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """cp2tform similarity: (trans, trans_inv) mapping src->dst in
    row-vector form (matlab_cp2tform.py:130-167)."""
    if reflective:
        return find_similarity(src_pts, dst_pts)
    return find_nonreflective_similarity(src_pts, dst_pts)


def cvt_tform_mat_for_cv2(trans: np.ndarray) -> np.ndarray:
    """Row-vector 3x3 -> cv2.warpAffine 2x3 (matlab_cp2tform.py:170-195)."""
    return trans[:, 0:2].T


def get_similarity_transform_for_cv2(src_pts: np.ndarray,
                                     dst_pts: np.ndarray,
                                     reflective: bool = True) -> np.ndarray:
    """(matlab_cp2tform.py:198-232)."""
    trans, _ = get_similarity_transform(src_pts, dst_pts, reflective)
    return cvt_tform_mat_for_cv2(trans)


def get_reference_facial_points(output_size: Optional[Sequence[int]] = None,
                                inner_padding_factor: float = 0.0,
                                outer_padding: Tuple[int, int] = (0, 0),
                                default_square: bool = False) -> np.ndarray:
    """Scale/pad the canonical 5-point template to a crop configuration
    (align_trans.py:19-109)."""
    tmp_5pts = np.array(REFERENCE_FACIAL_POINTS)
    tmp_crop_size = np.array(DEFAULT_CROP_SIZE)

    if default_square:
        size_diff = max(tmp_crop_size) - tmp_crop_size
        tmp_5pts += size_diff / 2
        tmp_crop_size = tmp_crop_size + size_diff

    if (output_size and output_size[0] == tmp_crop_size[0]
            and output_size[1] == tmp_crop_size[1]):
        return tmp_5pts

    if inner_padding_factor == 0 and outer_padding == (0, 0):
        if output_size is None:
            return tmp_5pts
        raise FaceWarpException(
            f"No paddings to do, output_size must be None or {tmp_crop_size}")

    if not 0 <= inner_padding_factor <= 1.0:
        raise FaceWarpException("Not (0 <= inner_padding_factor <= 1.0)")

    if ((inner_padding_factor > 0 or outer_padding[0] > 0
         or outer_padding[1] > 0) and output_size is None):
        output_size = tmp_crop_size * (1 + inner_padding_factor * 2)
        output_size = output_size.astype(np.int32) + np.array(outer_padding)
    if not (outer_padding[0] < output_size[0]
            and outer_padding[1] < output_size[1]):
        raise FaceWarpException("Not (outer_padding[0] < output_size[0] and "
                                "outer_padding[1] < output_size[1])")

    if inner_padding_factor > 0:
        size_diff = tmp_crop_size * inner_padding_factor * 2
        tmp_5pts += size_diff / 2
        tmp_crop_size = tmp_crop_size + np.round(size_diff).astype(np.int32)

    size_bf_outer_pad = np.array(output_size) - np.array(outer_padding) * 2
    if size_bf_outer_pad[0] * tmp_crop_size[1] != \
            size_bf_outer_pad[1] * tmp_crop_size[0]:
        raise FaceWarpException("Must have (output_size - outer_padding) "
                                "= some_scale * (crop_size * (1.0 + "
                                "inner_padding_factor)")

    scale_factor = size_bf_outer_pad[0].astype(np.float32) / tmp_crop_size[0]
    tmp_5pts = tmp_5pts * scale_factor
    return tmp_5pts + np.array(outer_padding)


def get_affine_transform_matrix(src_pts: np.ndarray,
                                dst_pts: np.ndarray) -> np.ndarray:
    """Full-affine lstsq solve -> 2x3 (align_trans.py:112-142)."""
    tfm = np.float32([[1, 0, 0], [0, 1, 0]])
    n_pts = src_pts.shape[0]
    ones = np.ones((n_pts, 1), src_pts.dtype)
    src_pts_ = np.hstack([src_pts, ones])
    dst_pts_ = np.hstack([dst_pts, ones])
    a, _, rank, _ = np.linalg.lstsq(src_pts_, dst_pts_, rcond=-1)
    if rank == 3:
        tfm = np.float32([[a[0, 0], a[1, 0], a[2, 0]],
                          [a[0, 1], a[1, 1], a[2, 1]]])
    elif rank == 2:
        tfm = np.float32([[a[0, 0], a[1, 0], 0], [a[0, 1], a[1, 1], 0]])
    return tfm


def warp_and_crop_face(src_img: np.ndarray, facial_pts,
                       reference_pts=None, crop_size: Tuple[int, int] = (96, 112),
                       align_type: str = "smilarity",
                       device="cuda") -> np.ndarray:
    """Warp ``src_img`` (numpy HWC) so ``facial_pts`` land on
    ``reference_pts`` (align_trans.py:145-219; the 'smilarity' typo'd
    default is the reference's own), on `device`; numpy out."""
    from comfyui_keep_torch.facelib.helper import warp_image

    if reference_pts is None:
        if crop_size[0] == 96 and crop_size[1] == 112:
            reference_pts = REFERENCE_FACIAL_POINTS
        else:
            reference_pts = get_reference_facial_points(
                output_size=crop_size, inner_padding_factor=0,
                outer_padding=(0, 0), default_square=False)

    ref_pts = np.float32(reference_pts)
    if max(ref_pts.shape) < 3 or min(ref_pts.shape) != 2:
        raise FaceWarpException(
            "reference_pts.shape must be (K,2) or (2,K) and K>2")
    if ref_pts.shape[0] == 2:
        ref_pts = ref_pts.T

    src_pts = np.float32(facial_pts)
    if max(src_pts.shape) < 3 or min(src_pts.shape) != 2:
        raise FaceWarpException(
            "facial_pts.shape must be (K,2) or (2,K) and K>2")
    if src_pts.shape[0] == 2:
        src_pts = src_pts.T
    if src_pts.shape != ref_pts.shape:
        raise FaceWarpException(
            "facial_pts and reference_pts must have the same shape")

    if align_type == "cv2_affine":
        # exact 3-point affine (cv2.getAffineTransform equivalent)
        tfm = get_affine_transform_matrix(src_pts[0:3], ref_pts[0:3])
    elif align_type == "affine":
        tfm = get_affine_transform_matrix(src_pts, ref_pts)
    else:
        tfm = get_similarity_transform_for_cv2(src_pts, ref_pts)

    return warp_image(src_img, tfm, (crop_size[0], crop_size[1]),
                      device=device)
