"""Face crop / restore / paste orchestration (reference wm_facelib/utils/
face_restoration_helper.py), ported from comfyui_keep_tpu/facelib/helper.py
without OpenCV.

The pixel work is utils/cvops.py's on the helper's `device` ("cuda" unless
the caller asks for the CPU): the detection resize (INTER_AREA), the 512^2
crop warps with the gray border, and the whole paste-back (inverse warps,
erosions, blurs, the parse soft mask, the blend) on the upscaled frame.
The similarity solve is OpenCV's LMedS (`estimate_affine_partial_lmeds`)
on the host. The neural pieces are plug-ins:

  detector(img_bgr_u8, conf_threshold) -> (N, 15) [x1,y1,x2,y2,score,lm x10]
  parser(face_rgb_pm1 (1,512,512,3)) -> (1,512,512,19) class logits

(models/retinaface.py's and facelib/yolov5face.py's detectors,
models/parsenet.py's and models/bisenet.py's parsers; a plug-in may also
return numpy). Images in and out are numpy HWC uint8 BGR. FaceAligner is
the training-time aligner (landmarks given, no detection).
"""
from typing import Callable, List, Optional

import numpy as np
import torch

from comfyui_keep_torch.utils import cvops
from comfyui_keep_torch.utils.image import (adain_npy, bgr2gray,
                                            bgr_u8_to_rgb_pm1, is_gray)
from comfyui_keep_torch.utils.resize import resize

# FFHQ 5-point template for 512 crops (face_restoration_helper.py:52-54)
FFHQ_TEMPLATE_512 = np.array([
    [192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
    [201.26117, 371.41043], [313.08905, 371.15118]], dtype=np.float64)

# parse-class keep mask: background/neck/ears/hat excluded
# (face_restoration_helper.py:430)
MASK_COLORMAP = [0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                 255, 255, 0, 255, 0, 0, 0]
BORDER_GRAY = (135, 133, 132)


def estimate_affine(landmark: np.ndarray, template: np.ndarray
                    ) -> Optional[np.ndarray]:
    """cv2.estimateAffinePartial2D(landmark, template, method=cv2.LMEDS),
    and, where it finds no model, the closed-form least squares (the JAX
    helper's order)."""
    m = cvops.estimate_affine_partial_lmeds(landmark, template)[0]
    return m if m is not None else cvops.similarity_transform(landmark,
                                                              template)


def invert_affine(m: np.ndarray) -> np.ndarray:
    rot, t = m[:, :2], m[:, 2]
    inv_rot = np.linalg.inv(rot)
    return np.concatenate([inv_rot, (-inv_rot @ t)[:, None]], axis=1)


def warp_image(img: np.ndarray, m: np.ndarray, dsize, border="constant",
               border_value=None, device="cuda") -> np.ndarray:
    """cv2.warpAffine(img, m, dsize, borderMode=border,
    borderValue=border_value) of a numpy uint8 or float32 image, computed
    on `device` (utils/cvops.py); numpy out."""
    t = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    return cvops.warp_affine(t, m, dsize, "linear", border,
                             border_value).cpu().numpy()


class FaceRestoreHelper:
    def __init__(self, upscale_factor: float = 1, face_size: int = 512,
                 crop_ratio=(1, 1), detector: Optional[Callable] = None,
                 parser: Optional[Callable] = None, use_parse: bool = True,
                 pad_blur: bool = False, template_3points: bool = False,
                 device="cuda"):
        self.upscale_factor = int(upscale_factor)
        self.crop_ratio = crop_ratio
        self.face_size = (int(face_size * crop_ratio[1]),
                          int(face_size * crop_ratio[0]))
        self.detector = detector
        self.parser = parser
        self.use_parse = use_parse
        self.pad_blur = pad_blur
        self.device = torch.device(device)
        if template_3points:
            self.face_template = np.array([[192, 240], [319, 240], [257, 371]],
                                          np.float64)
        else:
            self.face_template = FFHQ_TEMPLATE_512.copy()
        self.face_template *= face_size / 512.0
        if crop_ratio[0] > 1:
            self.face_template[:, 1] += face_size * (crop_ratio[0] - 1) / 2
        if crop_ratio[1] > 1:
            self.face_template[:, 0] += face_size * (crop_ratio[1] - 1) / 2
        self.is_gray = False
        self.clean_all()

    def clean_all(self):
        self.all_landmarks_5: List[np.ndarray] = []
        self.det_faces: List[np.ndarray] = []
        self.affine_matrices: List[Optional[np.ndarray]] = []
        self.inverse_affine_matrices: List[Optional[np.ndarray]] = []
        self.cropped_faces: List[np.ndarray] = []
        self.restored_faces: List[np.ndarray] = []
        self.pad_input_imgs: List[np.ndarray] = []
        self._input_t = None

    # -- input ----------------------------------------------------------------

    def read_image(self, img):
        """Gray / alpha handling and the min-side-512 upscale
        (face_restoration_helper.py:172-184), on the host. A 16-bit image is
        scaled to 0-255 and rounded to uint8 (the JAX helper keeps it as
        float64 through OpenCV, whose float paths this port does not
        carry)."""
        img = np.asarray(img)
        if img.max() > 256:
            img = np.round(img / 65535 * 255).astype(np.uint8)
        if img.ndim == 2:
            img = cvops.gray_to_bgr(img.astype(np.uint8))
        elif img.shape[2] == 4:
            img = img[:, :, :3]
        self.input_img = np.ascontiguousarray(img)
        self._input_t = None
        self.is_gray = is_gray(img, threshold=10)
        if min(self.input_img.shape[:2]) < 512:
            f = 512.0 / min(self.input_img.shape[:2])
            self.input_img = resize(self.input_img, (0, 0), "linear",
                                    fx=f, fy=f)

    def _input(self) -> torch.Tensor:
        """The input image on the helper's device (copied once per image)."""
        if self._input_t is None:
            self._input_t = torch.from_numpy(self.input_img).to(self.device)
        return self._input_t

    # -- detection ------------------------------------------------------------

    @staticmethod
    def get_center_face(det_faces, h=0, w=0, center=None):
        if not det_faces:
            return None, -1
        center = (np.array(center) if center is not None
                  else np.array([w / 2, h / 2]))
        dists = [np.linalg.norm(np.array([(f[0] + f[2]) / 2,
                                          (f[1] + f[3]) / 2]) - center)
                 for f in det_faces]
        idx = int(np.argmin(dists))
        return det_faces[idx], idx

    @staticmethod
    def get_largest_face(det_faces, h, w):
        """Largest image-clipped box area (face_restoration_helper.py:
        133-151)."""
        if not det_faces:
            return None, -1

        def clip(v, length):
            return min(max(v, 0), length)

        areas = [(clip(f[2], w) - clip(f[0], w)) * (clip(f[3], h)
                                                    - clip(f[1], h))
                 for f in det_faces]
        idx = int(np.argmax(areas))
        return det_faces[idx], idx

    def set_upscale_factor(self, upscale_factor):
        self.upscale_factor = upscale_factor

    def resize_for_detection(self, img: Optional[np.ndarray] = None,
                             resize: int = 640):
        """The short-side cap before detection (face_restoration_helper.py:
        212-223): (the image as a uint8 tensor on the helper's device, shrunk
        by INTER_AREA to a short side of `resize` when longer, and the
        factor back to its size). `img` defaults to the input image."""
        src = self._input() if img is None else torch.from_numpy(
            np.ascontiguousarray(img)).to(self.device)
        h, w = src.shape[:2]
        if resize is not None and min(h, w) > resize:
            scale = resize / min(h, w)
            small = cvops.resize_area(src, (int(w * scale), int(h * scale)))
            return small, h / small.shape[0]
        return src, 1.0

    @staticmethod
    def select_landmarks_5(bboxes, img_hw, only_center_face=False,
                           eye_dist_threshold=None):
        """Eye-distance filter + centre-face selection over (N, 15) rows
        (face_restoration_helper.py:225-255). Returns (landmarks,
        det_faces), empty when nothing survives."""
        landmarks, det_faces = [], []
        for bbox in np.asarray(bboxes):
            landmark = bbox[5:].reshape(5, 2)
            if eye_dist_threshold is not None:
                if np.linalg.norm(landmark[0] - landmark[1]) < \
                        eye_dist_threshold:
                    continue
            landmarks.append(landmark)
            det_faces.append(bbox[:5])
        if not det_faces:
            return [], []
        if only_center_face:
            h, w = img_hw
            face, idx = FaceRestoreHelper.get_center_face(det_faces, h, w)
            return [landmarks[idx]], [face]
        return landmarks, det_faces

    def get_face_landmarks_5(self, only_center_face=False, resize=640,
                             eye_dist_threshold=None, conf_threshold=0.97):
        if self.detector is None:
            raise RuntimeError("no face detector attached")
        img, scale_back = self.resize_for_detection(resize=resize)
        bboxes = self.detector(img, conf_threshold)
        if bboxes is None or len(bboxes) == 0:
            return 0
        bboxes = np.asarray(bboxes) * scale_back
        landmarks, det_faces = self.select_landmarks_5(
            bboxes, self.input_img.shape[:2],
            only_center_face=only_center_face,
            eye_dist_threshold=eye_dist_threshold)
        if not det_faces:
            return 0
        self.det_faces = det_faces
        self.all_landmarks_5 = landmarks
        return len(self.all_landmarks_5)

    # -- alignment ------------------------------------------------------------

    def _pad_blur_image(self, landmarks: np.ndarray) -> np.ndarray:
        """Reflect-pad + edge-blur + median-fade the input around the FFHQ
        oriented quad of one face (face_restoration_helper.py:259-302,
        blur_ratio 0.01), on the host."""
        eye_left, eye_right = landmarks[0, :], landmarks[1, :]
        eye_avg = (eye_left + eye_right) * 0.5
        mouth_avg = (landmarks[3, :] + landmarks[4, :]) * 0.5
        eye_to_eye = eye_right - eye_left
        eye_to_mouth = mouth_avg - eye_avg
        x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
        x /= np.hypot(*x)
        rect_scale = 1.5
        x *= max(np.hypot(*eye_to_eye) * 2.0 * rect_scale,
                 np.hypot(*eye_to_mouth) * 1.8 * rect_scale)
        y = np.flipud(x) * [-1, 1]
        c = eye_avg + eye_to_mouth * 0.1
        quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
        qsize = np.hypot(*x) * 2
        border = max(int(np.rint(qsize * 0.1)), 3)
        pad = ([int(np.floor(min(quad[:, i]))) for i in range(2)]
               + [int(np.ceil(max(quad[:, i]))) for i in range(2)])
        pad = [max(-pad[0] + border, 1),
               max(-pad[1] + border, 1),
               max(pad[2] - self.input_img.shape[1] + border, 1),
               max(pad[3] - self.input_img.shape[0] + border, 1)]
        if max(pad) <= 1:
            return np.copy(self.input_img)
        pad_img = np.pad(self.input_img,
                         ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)),
                         "reflect")
        h_pad, w_pad, _ = pad_img.shape
        y_grid, x_grid = np.ogrid[:h_pad, :w_pad]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(x_grid) / pad[0],
                             np.float32(w_pad - 1 - x_grid) / pad[2]),
            1.0 - np.minimum(np.float32(y_grid) / pad[1],
                             np.float32(h_pad - 1 - y_grid) / pad[3]))
        blur = int(qsize * 0.01)
        if blur % 2 == 0:
            blur += 1
        blur_img = cvops.box_filter(torch.from_numpy(pad_img), blur).numpy()
        pad_img = pad_img.astype("float32")
        pad_img += (blur_img - pad_img) * np.clip(
            mask[:, :, np.newaxis] * 3.0 + 1.0, 0.0, 1.0)
        pad_img += (np.median(pad_img, axis=(0, 1)) - pad_img) * np.clip(
            mask[:, :, np.newaxis], 0.0, 1.0)
        return np.clip(pad_img, 0, 255).astype(np.uint8)

    def align_warp_face(self, border_mode="constant"):
        """LMedS similarity -> face-size warp with the FFHQ gray border
        (135, 133, 132) (face_restoration_helper.py:257-324); pad_blur first
        pads each face's source image."""
        if border_mode not in ("constant", "reflect101", "reflect"):
            raise ValueError(f"border_mode {border_mode!r}")
        if self.pad_blur:
            self.pad_input_imgs = [self._pad_blur_image(np.asarray(lm))
                                   for lm in self.all_landmarks_5]
        for idx, landmark in enumerate(self.all_landmarks_5):
            src = (torch.from_numpy(self.pad_input_imgs[idx]).to(self.device)
                   if self.pad_blur else self._input())
            m = estimate_affine(landmark, self.face_template)
            self.affine_matrices.append(m)
            crop = cvops.warp_affine(src, m, self.face_size, "linear",
                                     border_mode, BORDER_GRAY)
            self.cropped_faces.append(crop.cpu().numpy())

    def get_inverse_affine(self):
        self.inverse_affine_matrices = [
            None if m is None else invert_affine(m) * self.upscale_factor
            for m in self.affine_matrices]

    def add_restored_face(self, restored_face, input_face=None):
        if self.is_gray:
            restored_face = bgr2gray(restored_face)
            if input_face is not None:
                restored_face = adain_npy(restored_face, input_face)
        self.restored_faces.append(restored_face)

    # -- paste-back -----------------------------------------------------------

    def parse_soft_mask(self, face_bgr_u8: np.ndarray) -> torch.Tensor:
        """ParseNet's 19 classes -> keep mask -> two 101-px Gaussian blurs
        (sigma 11) -> a 10-px zero border -> [0, 1], (512, 512) float32 on
        the helper's device (face_restoration_helper.py:417-442)."""
        face512 = (face_bgr_u8 if face_bgr_u8.shape[:2] == (512, 512)
                   else resize(face_bgr_u8, (512, 512), "linear"))
        logits = self.parser(bgr_u8_to_rgb_pm1(face512)[None])
        logits = torch.as_tensor(logits).to(self.device)[0]
        colors = torch.tensor(MASK_COLORMAP, dtype=torch.float32,
                              device=self.device)
        mask = colors[logits.argmax(dim=-1)]
        mask = cvops.gaussian_blur(mask, 101, 11)
        mask = cvops.gaussian_blur(mask, 101, 11)
        thres = 10
        mask[:thres, :] = 0
        mask[-thres:, :] = 0
        mask[:, :thres] = 0
        mask[:, -thres:] = 0
        return mask / 255.0

    def paste_faces_to_input_image(self, upsample_img=None,
                                   draw_box: bool = False,
                                   face_upsampler: Optional[Callable] = None
                                   ) -> np.ndarray:
        """Blend each restored face back into the upscaled frame
        (face_restoration_helper.py:346-475) on the helper's device: the
        face and its mask warped by the inverse affine; with a parser the
        mask is the parse soft mask, else the mask eroded by 2 x factor,
        then by 2 w_edge, and blurred (w_edge = sqrt(face area) // 20).
        face_upsampler (bgr_u8 -> bgr_u8, e.g. pipeline/tiled.py's
        make_upscaler_fn) upscales each face first, which LANCZOS4 then
        brings back to the face size, as in the JAX helper. Returns the
        frame as numpy HWC uint8 BGR."""
        h, w, _ = self.input_img.shape
        h_up, w_up = int(h * self.upscale_factor), int(w * self.upscale_factor)
        dev = self.device
        if upsample_img is None:
            canvas = resize(self._input(), (w_up, h_up), "linear")
        else:
            canvas = torch.from_numpy(np.ascontiguousarray(upsample_img)).to(
                dev)
            if canvas.shape[:2] != (h_up, w_up):
                canvas = resize(canvas, (w_up, h_up), "lanczos4")
        canvas = canvas.to(torch.float32)
        dsize = (w_up, h_up)
        use_parse = self.use_parse and self.parser is not None
        borders = []
        for face, inv_m in zip(self.restored_faces,
                               self.inverse_affine_matrices):
            if inv_m is None:
                continue
            if face_upsampler is not None:
                up = torch.from_numpy(np.ascontiguousarray(
                    face_upsampler(face))).to(dev)
                face = resize(up, self.face_size, "lanczos4").cpu().numpy()
            face_t = torch.from_numpy(np.ascontiguousarray(face)).to(dev)
            fh, fw = face.shape[:2]
            inv_restored = cvops.warp_affine(face_t, inv_m, dsize).to(
                torch.float32)
            if use_parse and not draw_box:
                soft = self.parse_soft_mask(face)
            else:
                ones = torch.ones((fh, fw), dtype=torch.float32, device=dev)
                inv_mask = cvops.warp_affine(ones, inv_m, dsize)
                erosion = cvops.erode(inv_mask, int(2 * self.upscale_factor))
                area = max(float(erosion.double().sum()), 1.0)
                if draw_box:
                    mb = torch.ones((fh, fw, 3), dtype=torch.float32,
                                    device=dev)
                    bt = int(1400 / np.sqrt(area))
                    bt = max(1, min(bt, min(fh, fw) // 20))
                    mb[bt:fh - bt, bt:fw - bt] = 0
                    borders.append(cvops.warp_affine(mb, inv_m, dsize))
                if use_parse:
                    soft = self.parse_soft_mask(face)
                else:
                    w_edge = int(area ** 0.5) // 20
                    center = cvops.erode(erosion, max(1, w_edge * 2))
                    blur = max(1, w_edge * 2)
                    if blur % 2 == 0:
                        blur += 1
                    soft = cvops.gaussian_blur(center, blur, 0)
            if use_parse:
                if soft.shape != (fh, fw):
                    soft = cvops.resize_linear_f32(soft, (fw, fh))
                soft = cvops.warp_affine(soft, inv_m, dsize)
            soft = soft[..., None]
            canvas = soft * inv_restored + (1 - soft) * canvas
        out = torch.round(canvas.clamp(0, 255)).to(torch.uint8)
        if draw_box:
            green = torch.tensor([0, 255, 0], dtype=torch.uint8, device=dev)
            for b in borders:
                out[(b > 0.5).any(dim=2)] = green
        return out.cpu().numpy()


# -- the training-time aligner (face_restoration_helper.py:486-611) -------------

DLIB_TEMPLATE_1024 = np.array([
    [686.77227723, 488.62376238], [586.77227723, 493.59405941],
    [337.91089109, 488.38613861], [437.95049505, 493.51485149],
    [513.58415842, 678.5049505]], dtype=np.float64)
TEMPLATE_3POINTS = np.array([[192, 240], [319, 240], [257, 371]],
                            dtype=np.float64)


class FaceAligner:
    """Pair or single face alignment from given landmarks, for training
    (face_restoration_helper.py:486-611): no detection, the LMedS
    similarity to the template, then the warp on `device` (gray border, or
    reflect101 / reflect). RGB float images in [0, 1] go through BGR uint8
    before the warp, as in the reference, which quantises them.

    Kept from the reference: the warp's dsize is ``img.shape[0:2]``, (h,
    w) where OpenCV reads (w, h); the same for the square crops of KEEP's
    training."""

    def __init__(self, upscale_factor, face_size: int = 512,
                 crop_ratio=(1, 1), det_model: str = "retinaface_resnet50",
                 template_3points: bool = False, pad_blur: bool = False,
                 device="cuda"):
        self.template_3points = template_3points
        self.upscale_factor = int(upscale_factor)
        self.crop_ratio = crop_ratio
        if crop_ratio[0] < 1 or crop_ratio[1] < 1:
            raise ValueError("crop ratio only supports >=1")
        self.face_size = (int(face_size * crop_ratio[1]),
                          int(face_size * crop_ratio[0]))
        if det_model == "dlib":
            self.face_template = DLIB_TEMPLATE_1024 / (1024 // face_size)
        elif template_3points:
            self.face_template = TEMPLATE_3POINTS.copy()
        else:
            self.face_template = FFHQ_TEMPLATE_512.copy()
        self.face_template = self.face_template * (face_size / 512.0)
        if crop_ratio[0] > 1:
            self.face_template[:, 1] += face_size * (crop_ratio[0] - 1) / 2
        if crop_ratio[1] > 1:
            self.face_template[:, 0] += face_size * (crop_ratio[1] - 1) / 2
        self.pad_blur = pad_blur
        if pad_blur:
            self.template_3points = False
        self.device = torch.device(device)

    def _warp(self, img_u8, m, border_mode):
        if border_mode not in ("constant", "reflect101", "reflect"):
            raise ValueError(f"border_mode {border_mode!r}")
        return warp_image(img_u8, m, img_u8.shape[0:2], border_mode,
                          BORDER_GRAY, self.device)

    def align_single_face(self, img, landmarks, border_mode="constant"):
        """img: RGB float [0, 1] -> the aligned RGB float [0, 1]."""
        u8 = (img[:, :, ::-1] * 255).round().astype(np.uint8)
        m = estimate_affine(np.asarray(landmarks, np.float64),
                            self.face_template)
        return self._warp(u8, m, border_mode)[:, :, ::-1] / 255.0

    def align_warp_face(self, img_lq, img_gt, landmarks,
                        border_mode="constant"):
        """A BGR uint8 pair -> the warped pair. The landmarks are at the
        GT's scale; the LQ warp solves again at landmarks / scale
        (:585-601)."""
        scale = img_gt.shape[0] / img_lq.shape[0]
        lm = np.asarray(landmarks, np.float64)
        m_gt = estimate_affine(lm, self.face_template)
        img_gt = self._warp(img_gt, m_gt, border_mode)
        m_lq = estimate_affine(lm / scale, self.face_template / scale)
        return self._warp(img_lq, m_lq, border_mode), img_gt

    def align_pair_face(self, img_lq, img_gt, landmarks):
        """An RGB float [0, 1] pair -> the aligned pair (:549-558)."""
        lq = (img_lq[:, :, ::-1] * 255).round().astype(np.uint8)
        gt = (img_gt[:, :, ::-1] * 255).round().astype(np.uint8)
        lq, gt = self.align_warp_face(lq, gt, landmarks)
        return lq[:, :, ::-1] / 255.0, gt[:, :, ::-1] / 255.0
