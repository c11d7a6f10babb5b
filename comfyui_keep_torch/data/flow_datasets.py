"""Optical-flow training data (reference archs/gmflow/data/datasets.py,
data/transforms.py, utils/frame_utils.py), ported from
comfyui_keep_tpu/data/flow_datasets.py without OpenCV or PIL.

Items are NHWC numpy dicts, as the JAX package gives them: img1 / img2
(H, W, 3) float32 in [0, 255], flow (H, W, 2), valid (H, W). Frames are read
by utils/ppm.py (FlyingChairs' .ppm) and utils/png.py (8- and 16-bit PNG);
JPEG frames need PIL, which the card machine lacks, and raise. OpenCV's
calls are the port's: cv2.resize with fx / fy is utils/resize.py (uint8,
bit for bit) and cvops.resize_linear_f32 (the float32 flow, bit for bit
with the sandbox's cv2), and the uint8 HSV round trip of the hue jitter is
cvops.rgb_to_hsv_full / hsv_to_rgb_full.

Each dataset owns a np.random.RandomState (and a random.Random, for the
loader's seed_streams) and its augmentor draws from it in the JAX package's
order, where the JAX package draws from numpy's global stream: seeded
alike, the two give the same items. A ConcatFlowDataset shares one stream
among its parts, as the global stream is one.
"""
import glob as _glob
import os
import os.path as osp
import random
import re

import numpy as np
import torch

from comfyui_keep_torch.utils import cvops, png, ppm
from comfyui_keep_torch.utils.resize import resize

TAG_FLOAT = 202021.25  # .flo magic


# ---------------------------------------------------------------------------
# Flow and frame files (frame_utils.py)
# ---------------------------------------------------------------------------

def read_flo(path):
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(TAG_FLOAT):
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow):
    """(H, W, 2) -> .flo, float32."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path):
    """FlyingThings3D's .pfm (PF colour or Pf gray), rows flipped upright."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dim = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim:
            raise ValueError("malformed PFM header")
        width, height = map(int, dim.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape))


def read_flow_kitti(path):
    """KITTI's 16-bit PNG (u, v, valid) -> (flow (H, W, 2), valid (H, W)),
    flow = (sample - 2^15) / 64, float32."""
    raw = png.imread(path)
    if raw.shape[2] == 1:
        raw = np.repeat(raw, 3, axis=2)
    raw = raw[:, :, :3].astype(np.float32)
    return (raw[:, :, :2] - 2 ** 15) / 64.0, raw[:, :, 2]


def write_flow_kitti(path, flow):
    """(H, W, 2) -> KITTI's 16-bit PNG, every pixel valid."""
    uv = 64.0 * np.asarray(flow) + 2 ** 15
    valid = np.ones(uv.shape[:2] + (1,))
    with open(path, "wb") as f:
        f.write(png.encode(np.concatenate([uv, valid], axis=-1).astype(
            np.uint16)))


def read_image(path) -> np.ndarray:
    """A .png or .ppm frame as PIL's np.array(Image.open(path)) gives it:
    (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    ext = osp.splitext(path)[-1].lower()
    if ext == ".ppm":
        return ppm.read(path)
    if ext == ".png":
        img = png.imread(path)
        return img[..., 0] if img.shape[2] == 1 else img
    raise ValueError(f"{path}: JPEG needs PIL, which the port does not use "
                     "(convert the frames to PNG)")


def read_gen(path):
    """An image or flow file by its extension -> numpy."""
    ext = osp.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return read_image(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        flo = read_pfm(path).astype(np.float32)
        return flo if flo.ndim == 2 else flo[:, :, :-1]
    raise ValueError(f"unsupported extension {ext}")


def _resize_u8(img, fx, fy):
    """cv2.resize(img, None, fx=fx, fy=fy) of a uint8 image (LINEAR)."""
    return resize(np.ascontiguousarray(img), (0, 0), "linear", fx=fx, fy=fy)


def _resize_f32(a, fx, fy):
    """cv2.resize(a, None, fx=fx, fy=fy) of a float32 array (LINEAR)."""
    return cvops.resize_linear_f32(torch.from_numpy(np.ascontiguousarray(
        a, np.float32)), (0, 0), fx=fx, fy=fy).numpy()


# ---------------------------------------------------------------------------
# Photometric jitter (transforms.py: torchvision's ColorJitter)
# ---------------------------------------------------------------------------

class ColorJitterNP:
    """torchvision's ColorJitter on uint8 HWC numpy: factors from
    [max(0, 1 - x), 1 + x] (the hue shift from [-h, h]), the four ops in an
    order shuffled by `rng` (a np.random.RandomState)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _blend(a, b, f):
        return np.clip(f * a + (1.0 - f) * b, 0, 255)

    def __call__(self, img, rng):
        img = img.astype(np.float32)
        ops = list(range(4))
        rng.shuffle(ops)
        for op in ops:
            if op == 0 and self.brightness > 0:
                f = rng.uniform(max(0, 1 - self.brightness),
                                1 + self.brightness)
                img = np.clip(img * f, 0, 255)
            elif op == 1 and self.contrast > 0:
                f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
                gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] +
                        0.114 * img[..., 2]).mean()
                img = self._blend(img, gray, f)
            elif op == 2 and self.saturation > 0:
                f = rng.uniform(max(0, 1 - self.saturation),
                                1 + self.saturation)
                gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] +
                        0.114 * img[..., 2])[..., None]
                img = self._blend(img, gray, f)
            elif op == 3 and self.hue > 0:
                f = rng.uniform(-self.hue, self.hue)
                hsv = cvops.rgb_to_hsv_full(img.astype(np.uint8))
                h = hsv[..., 0].astype(np.int32) + int(round(f * 255))
                hsv[..., 0] = (h % 256).astype(np.uint8)
                img = cvops.hsv_to_rgb_full(hsv).astype(np.float32)
        return img.round().astype(np.uint8)


# ---------------------------------------------------------------------------
# Augmentors (transforms.py)
# ---------------------------------------------------------------------------

class FlowAugmentor:
    """Dense-flow augmentation: colour jitter (asymmetric with probability
    0.2), an optional eraser, a random scale and stretch (probability 0.8),
    flips and a random crop. Draws from the RandomState it is given."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 no_eraser_aug=True):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitterNP(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = -1 if no_eraser_aug else 0.5

    def color_transform(self, img1, img2, rng):
        if rng.rand() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1, rng), self.photo_aug(img2, rng)
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0), rng)
        a, b = np.split(stack, 2, axis=0)
        return a, b

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.rand() < self.eraser_aug_prob:
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(rng.randint(1, 3)):
                x0 = rng.randint(0, wd)
                y0 = rng.randint(0, ht)
                dx = rng.randint(bounds[0], bounds[1])
                dy = rng.randint(bounds[0], bounds[1])
                img2 = img2.copy()
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow, rng, occlusion=None):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 8) / float(ht),
                               (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.rand() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if rng.rand() < self.spatial_aug_prob:
            img1 = _resize_u8(img1, scale_x, scale_y)
            img2 = _resize_u8(img2, scale_x, scale_y)
            flow = _resize_f32(flow, scale_x, scale_y)
            flow = flow * [scale_x, scale_y]
            if occlusion is not None:
                occlusion = _resize_f32(occlusion, scale_x, scale_y)

        if self.do_flip:
            if rng.rand() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
                if occlusion is not None:
                    occlusion = occlusion[:, ::-1]
            if rng.rand() < self.v_flip_prob:
                img1, img2 = img1[::-1, :], img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
                if occlusion is not None:
                    occlusion = occlusion[::-1, :]

        y0 = rng.randint(0, img1.shape[0] - self.crop_size[0]) \
            if img1.shape[0] > self.crop_size[0] else 0
        x0 = rng.randint(0, img1.shape[1] - self.crop_size[1]) \
            if img1.shape[1] > self.crop_size[1] else 0
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        if occlusion is not None:
            return img1[sl], img2[sl], flow[sl], occlusion[sl]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow, rng, occlusion=None):
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        out = self.spatial_transform(img1, img2, flow, rng, occlusion)
        return tuple(np.ascontiguousarray(x) for x in out)


class SparseFlowAugmentor:
    """KITTI / HD1K sparse-flow augmentation: symmetric jitter, a random
    scale with the valid vectors scattered to their nearest pixel, an
    optional flip and a random crop with margins."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 no_eraser_aug=True):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.photo_aug = ColorJitterNP(0.3, 0.3, 0.3, 0.3 / 3.14)
        self.eraser_aug_prob = -1 if no_eraser_aug else 0.5

    def color_transform(self, img1, img2, rng):
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0), rng)
        a, b = np.split(stack, 2, axis=0)
        return a, b

    eraser_transform = FlowAugmentor.eraser_transform

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """The valid flow vectors scaled by (fx, fy) and scattered to the
        nearest pixel of the (round(h fy), round(w fx)) map."""
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)),
                          axis=-1).reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1).astype(np.float32)
        coords0, flow0 = coords[valid >= 1], flow[valid >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yy[v], xx[v]] = flow1[v]
        valid_img[yy[v], xx[v]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 1) / float(ht),
                               (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = np.clip(scale, min_scale, None)
        if rng.rand() < self.spatial_aug_prob:
            img1 = _resize_u8(img1, scale_x, scale_y)
            img2 = _resize_u8(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid,
                                                      fx=scale_x, fy=scale_y)
        if self.do_flip and rng.rand() < 0.5:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
        margin_y, margin_x = 20, 50
        y0 = rng.randint(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = rng.randint(-margin_x,
                         img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid, rng):
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid, rng)
        return tuple(np.ascontiguousarray(x)
                     for x in (img1, img2, flow, valid))


# ---------------------------------------------------------------------------
# Datasets (datasets.py)
# ---------------------------------------------------------------------------

class FlowDataset:
    """Base pair dataset: __getitem__ -> {"img1", "img2" (H, W, 3) float32
    in [0, 255], "flow" (H, W, 2), "valid" (H, W)} ("extra_info" instead of
    flow and valid on a test split; "noc_valid" with load_occlusion)."""

    def __init__(self, aug_params=None, sparse=False, load_occlusion=False):
        self.augmentor = None
        self.sparse = sparse
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
        self.is_test = False
        self.flow_list = []
        self.image_list = []
        self.extra_info = []
        self.load_occlusion = load_occlusion
        self.occ_list = []
        self.seed_streams(0)

    def seed_streams(self, seed: int):
        """Seed the dataset's streams (as np.random.seed seeds the global
        one the JAX package draws from)."""
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    def __getitem__(self, index):
        if self.is_test:
            img1 = np.array(read_gen(self.image_list[index][0]),
                            np.uint8)[..., :3]
            img2 = np.array(read_gen(self.image_list[index][1]),
                            np.uint8)[..., :3]
            return {"img1": img1.astype(np.float32),
                    "img2": img2.astype(np.float32),
                    "extra_info": self.extra_info[index]}

        index = index % len(self.image_list)
        valid = None
        if self.sparse:
            flow, valid = read_flow_kitti(self.flow_list[index])
        else:
            flow = read_gen(self.flow_list[index])
        occlusion = None
        if self.load_occlusion:
            occlusion = np.array(read_gen(self.occ_list[index]), np.float32)

        img1 = np.array(read_gen(self.image_list[index][0]), np.uint8)
        img2 = np.array(read_gen(self.image_list[index][1]), np.uint8)
        flow = np.array(flow, np.float32)
        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1, img2 = img1[..., :3], img2[..., :3]

        if self.augmentor is not None:
            rng = self.np_rng
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid, rng)
            elif self.load_occlusion:
                img1, img2, flow, occlusion = self.augmentor(
                    img1, img2, flow, rng, occlusion=occlusion)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)

        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000) &
                     (np.abs(flow[..., 1]) < 1000))
        out = {"img1": img1.astype(np.float32),
               "img2": img2.astype(np.float32),
               "flow": flow.astype(np.float32),
               "valid": np.asarray(valid, np.float32)}
        if self.load_occlusion:
            out["noc_valid"] = 1.0 - occlusion / 255.0
        return out

    def __rmul__(self, v):
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        return self

    def __len__(self):
        return len(self.image_list)


class MpiSintel(FlowDataset):
    """<root>/<split>/<dstype>/<scene>/*.png frames, flow/<scene>/*.flo,
    occlusions/<scene>/*.png."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean", load_occlusion=False):
        super().__init__(aug_params, load_occlusion=load_occlusion)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        occ_root = osp.join(root, split, "occlusions")
        if split == "test":
            self.is_test = True
        for scene in sorted(os.listdir(image_root)):
            images = sorted(_glob.glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.extra_info += [(scene, i)]
            if split != "test":
                self.flow_list += sorted(
                    _glob.glob(osp.join(flow_root, scene, "*.flo")))
                if load_occlusion:
                    self.occ_list += sorted(
                        _glob.glob(osp.join(occ_root, scene, "*.png")))


class FlyingChairs(FlowDataset):
    """<root>/*.ppm pairs and *.flo flows. The official chairs_split.txt (1
    train, 2 validation) through split_file; without one every 10th pair is
    validation, as in the JAX package."""

    def __init__(self, aug_params=None, split="train",
                 root="datasets/FlyingChairs_release/data", split_file=None):
        super().__init__(aug_params)
        images = sorted(_glob.glob(osp.join(root, "*.ppm")))
        flows = sorted(_glob.glob(osp.join(root, "*.flo")))
        if len(images) // 2 != len(flows):
            raise ValueError(f"{root}: {len(images)} frames for {len(flows)} "
                             "flows")
        if split_file and osp.isfile(split_file):
            split_list = np.loadtxt(split_file, dtype=np.int32)
        else:
            split_list = np.ones(len(flows), np.int32)
            split_list[::10] = 2
        want = 1 if split in ("train", "training") else 2
        for i in range(len(flows)):
            if split_list[i] == want:
                self.flow_list += [flows[i]]
                self.image_list += [[images[2 * i], images[2 * i + 1]]]


class FlyingThings3D(FlowDataset):
    """<root>/<dstype>/<TRAIN|TEST>/*/*/left/*.png with optical_flow/.../
    into_future|into_past/left/*.pfm; the test set cut to ~1024 pairs."""

    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass", test_set=False,
                 validate_subset=True):
        super().__init__(aug_params)
        part = "TEST" if test_set else "TRAIN"
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(
                    _glob.glob(osp.join(root, dstype, part, "*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(
                    _glob.glob(osp.join(root, "optical_flow", part, "*/*")))
                flow_dirs = sorted(osp.join(f, direction, cam)
                                   for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(_glob.glob(osp.join(idir, "*.png")))
                    flows = sorted(_glob.glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list += [[images[i], images[i + 1]]]
                            self.flow_list += [flows[i]]
                        else:
                            self.image_list += [[images[i + 1], images[i]]]
                            self.flow_list += [flows[i + 1]]
        if test_set and validate_subset and len(self.image_list) > 1024:
            stride = len(self.image_list) // 1024
            remove = len(self.image_list) % 1024
            self.image_list = self.image_list[:-remove][::stride] \
                if remove else self.image_list[::stride]
            self.flow_list = self.flow_list[:-remove][::stride] \
                if remove else self.flow_list[::stride]


class KITTI(FlowDataset):
    """<root>/<split>/image_2/*_10.png, *_11.png and flow_occ/*_10.png."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(_glob.glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(_glob.glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info += [[osp.basename(img1)]]
            self.image_list += [[img1, img2]]
        if split == "training":
            self.flow_list = sorted(_glob.glob(osp.join(root,
                                                        "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    """<root>/hd1k_flow_gt/flow_occ/%06d_*.png and hd1k_input/image_2."""

    def __init__(self, aug_params=None, root="datasets/HD1K"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(_glob.glob(osp.join(
                root, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(_glob.glob(osp.join(
                root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list += [flows[i]]
                self.image_list += [[images[i], images[i + 1]]]
            seq_ix += 1


class ConcatFlowDataset:
    """The datasets one after another, sharing one stream."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])
        self.seed_streams(0)

    def seed_streams(self, seed: int):
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        for d in self.datasets:
            d.py_rng, d.np_rng = self.py_rng, self.np_rng

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, index):
        i = int(np.searchsorted(self.cum, index, side="right"))
        prev = 0 if i == 0 else int(self.cum[i - 1])
        return self.datasets[i][index - prev]


def build_train_dataset(stage, image_size=(384, 512), roots=None,
                        chairs_split_file=None):
    """A training stage's mix: "chairs", "things" (clean + final), "sintel"
    (100 x Sintel clean and final, 200 x KITTI, 5 x HD1K, things) or
    "kitti"; roots maps each name to its directory."""
    roots = roots or {}
    if stage == "chairs":
        aug = dict(crop_size=image_size, min_scale=-0.1, max_scale=1.0,
                   do_flip=True)
        return FlyingChairs(aug, split="training",
                            root=roots.get("chairs",
                                           "datasets/FlyingChairs_release/data"),
                            split_file=chairs_split_file)
    if stage == "things":
        aug = dict(crop_size=image_size, min_scale=-0.4, max_scale=0.8,
                   do_flip=True)
        root = roots.get("things", "datasets/FlyingThings3D")
        clean = FlyingThings3D(aug, root=root, dstype="frames_cleanpass")
        final = FlyingThings3D(aug, root=root, dstype="frames_finalpass")
        return ConcatFlowDataset([clean, final])
    if stage == "sintel":
        aug = dict(crop_size=image_size, min_scale=-0.2, max_scale=0.6,
                   do_flip=True)
        things = FlyingThings3D(aug, root=roots.get("things",
                                                    "datasets/FlyingThings3D"),
                                dstype="frames_cleanpass")
        sintel_root = roots.get("sintel", "datasets/Sintel")
        clean = 100 * MpiSintel(aug, split="training", root=sintel_root,
                                dstype="clean")
        final = 100 * MpiSintel(aug, split="training", root=sintel_root,
                                dstype="final")
        kitti = 200 * KITTI(dict(crop_size=image_size, min_scale=-0.3,
                                 max_scale=0.5, do_flip=True),
                            root=roots.get("kitti", "datasets/KITTI"))
        hd1k = 5 * HD1K(dict(crop_size=image_size, min_scale=-0.5,
                             max_scale=0.2, do_flip=True),
                        root=roots.get("hd1k", "datasets/HD1K"))
        return ConcatFlowDataset([clean, final, kitti, hd1k, things])
    if stage == "kitti":
        aug = dict(crop_size=image_size, min_scale=-0.2, max_scale=0.4,
                   do_flip=False)
        return KITTI(aug, split="training",
                     root=roots.get("kitti", "datasets/KITTI"))
    raise ValueError(f"unknown stage {stage}")
