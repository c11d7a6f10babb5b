"""FFHQ-style landmark alignment utilities (reference wm_facelib/utils/
face_utils.py:6-248), ported from comfyui_keep_tpu/facelib/face_utils.py
without OpenCV: bbox growing, the FFHQ oriented-quad crop, and the simple
paste-back. The geometry is host numpy; the pixel work (INTER_AREA, the
box filter, the warps, the LINEAR resize, erosion, the Gaussian blur) is
utils/cvops.py's and utils/resize.py's on `device`.
"""
import numpy as np
import torch

from comfyui_keep_torch.facelib.helper import (BORDER_GRAY, estimate_affine,
                                               invert_affine)
from comfyui_keep_torch.utils import cvops
from comfyui_keep_torch.utils.resize import resize


def compute_increased_bbox(bbox, increase_area, preserve_aspect=True):
    """Grow an (l, t, r, b) bbox by ``increase_area`` of its size, the
    aspect equalised if asked (face_utils.py:6-20)."""
    left, top, right, bot = bbox
    width = right - left
    height = bot - top
    if preserve_aspect:
        width_increase = max(
            increase_area,
            ((1 + 2 * increase_area) * height - width) / (2 * width))
        height_increase = max(
            increase_area,
            ((1 + 2 * increase_area) * width - height) / (2 * height))
    else:
        width_increase = height_increase = increase_area
    left = int(left - width_increase * width)
    top = int(top - height_increase * height)
    right = int(right + width_increase * width)
    bot = int(bot + height_increase * height)
    return (left, top, right, bot)


def get_valid_bboxes(bboxes, h, w):
    """Clip an (l, t, r, b) bbox to the image (face_utils.py:23-28)."""
    return (max(bboxes[0], 0), max(bboxes[1], 0),
            min(bboxes[2], w), min(bboxes[3], h))


def _parse_landmarks(landmarks: np.ndarray, lm_type: str = "retinaface_5"):
    """5 / 68 / 98 landmarks -> (eye_left, eye_right, mouth_avg)
    (face_utils.py:66-89)."""
    lm = np.array(landmarks)
    if lm.shape[0] == 5 and lm_type == "retinaface_5":
        eye_left, eye_right = lm[0], lm[1]
        mouth_avg = (lm[3] + lm[4]) * 0.5
    elif lm.shape[0] == 5 and lm_type == "dlib_5":
        eye_left = np.mean(lm[2:4], axis=0)
        eye_right = np.mean(lm[0:2], axis=0)
        mouth_avg = lm[4]
    elif lm.shape[0] == 68:
        eye_left = np.mean(lm[36:42], axis=0)
        eye_right = np.mean(lm[42:48], axis=0)
        mouth_avg = (lm[48] + lm[54]) * 0.5
    elif lm.shape[0] == 98:
        eye_left = np.mean(lm[60:68], axis=0)
        eye_right = np.mean(lm[68:76], axis=0)
        mouth_avg = (lm[76] + lm[82]) * 0.5
    else:
        raise ValueError(f"unsupported landmark count {lm.shape[0]}")
    return eye_left, eye_right, mouth_avg


def _t(img, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img)).to(device)


def align_crop_face_landmarks(img: np.ndarray, landmarks: np.ndarray,
                              output_size: int, transform_size: int = None,
                              enable_padding: bool = True,
                              return_inverse_affine: bool = False,
                              shrink_ratio=(1, 1), device="cuda"):
    """Align and crop a face by the FFHQ oriented-quad recipe
    (face_utils.py:31-187, from NVlabs/ffhq-dataset): a rotated crop
    rectangle from the eyes and mouth, oversized sources shrunk by
    INTER_AREA, out-of-frame parts reflect-padded and feathered (box blur
    and the median; the image turns float32 there, as in the reference),
    the LMedS similarity from the quad's corners to the output rectangle,
    the warp, and the LINEAR resize to output_size. Returns (the crop,
    numpy, uint8 or float32, and the inverse affine or None)."""
    if isinstance(shrink_ratio, (float, int)):
        shrink_ratio = (shrink_ratio, shrink_ratio)
    if transform_size is None:
        transform_size = output_size * 4

    eye_left, eye_right, mouth_avg = _parse_landmarks(landmarks)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    x *= shrink_ratio[1]
    y *= shrink_ratio[0]

    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2
    quad_ori = np.copy(quad)

    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        h, w = img.shape[0:2]
        rsize = (int(np.rint(float(w) / shrink)),
                 int(np.rint(float(h) / shrink)))
        img = cvops.resize_area(_t(img, device), rsize).cpu().numpy()
        quad /= shrink
        qsize /= shrink

    h, w = img.shape[0:2]
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
            int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, w), min(crop[3] + border, h))
    if crop[2] - crop[0] < w or crop[3] - crop[1] < h:
        img = img[crop[1]:crop[3], crop[0]:crop[2], :]
        quad -= crop[0:2]

    h, w = img.shape[0:2]
    pad = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
           int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - w + border, 0), max(pad[3] - h + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        img = np.pad(img, ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)),
                     "reflect")
        h, w = img.shape[0:2]
        y_g, x_g, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(x_g) / pad[0],
                             np.float32(w - 1 - x_g) / pad[2]),
            1.0 - np.minimum(np.float32(y_g) / pad[1],
                             np.float32(h - 1 - y_g) / pad[3]))
        blur = int(qsize * 0.02)
        if blur % 2 == 0:
            blur += 1
        blur_img = cvops.box_filter(_t(img, device), blur).cpu().numpy()
        img = img.astype("float32")
        img += (blur_img - img) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        img += (np.median(img, axis=(0, 1)) - img) * np.clip(mask, 0.0, 1.0)
        img = np.clip(img, 0, 255)
        quad += pad[:2]

    h_ratio = shrink_ratio[0] / shrink_ratio[1]
    dst_h, dst_w = int(transform_size * h_ratio), transform_size
    template = np.array([[0, 0], [0, dst_h], [dst_w, dst_h], [dst_w, 0]],
                        dtype=np.float64)
    affine_matrix = estimate_affine(quad.astype(np.float64), template)
    face = cvops.warp_affine(_t(img, device), affine_matrix, (dst_w, dst_h),
                             border_value=BORDER_GRAY)
    if output_size < transform_size:
        size = (output_size, int(output_size * h_ratio))
        face = (resize(face, size, "linear") if face.dtype == torch.uint8
                else cvops.resize_linear_f32(face, size))
    cropped_face = face.cpu().numpy()

    inverse_affine = None
    if return_inverse_affine:
        dst_h, dst_w = int(output_size * h_ratio), output_size
        affine_matrix = estimate_affine(
            quad_ori.astype(np.float64),
            np.array([[0, 0], [0, output_size], [dst_w, dst_h], [dst_w, 0]],
                     dtype=np.float64))
        inverse_affine = invert_affine(affine_matrix)
    return cropped_face, inverse_affine


def paste_face_back(img: np.ndarray, face: np.ndarray,
                    inverse_affine: np.ndarray, device="cuda") -> np.ndarray:
    """Inverse-warp a restored face into the frame under a soft edge that
    grows with the face's area (face_utils.py:190-208): the warped mask
    eroded by 2, then by 2 w_edge (OpenCV's 3 x 3 default when that is 0),
    and blurred by a (2 w_edge + 1)^2 Gaussian, w_edge = sqrt(area) // 20.
    Returns float32 [0, 255], numpy."""
    h, w = img.shape[0:2]
    face_h, face_w = face.shape[0:2]
    inv_restored = cvops.warp_affine(_t(face, device), inverse_affine, (w, h))
    mask = torch.ones((face_h, face_w, 3), dtype=torch.float32, device=device)
    inv_mask = cvops.warp_affine(mask, inverse_affine, (w, h))
    inv_mask_erosion = cvops.erode(inv_mask, 2)
    remove_border = inv_mask_erosion * inv_restored.to(torch.float32)
    # numpy's float32 sum, as the reference takes it
    total_face_area = np.sum(inv_mask_erosion.cpu().numpy()) // 3
    w_edge = int(total_face_area ** 0.5) // 20
    erosion_radius = w_edge * 2
    inv_mask_center = cvops.erode(inv_mask_erosion, erosion_radius or 3)
    inv_soft_mask = cvops.gaussian_blur(inv_mask_center, w_edge * 2 + 1, 0)
    out = inv_soft_mask * remove_border + (1 - inv_soft_mask) * _t(
        img, device).to(torch.float32)
    return out.cpu().numpy()
