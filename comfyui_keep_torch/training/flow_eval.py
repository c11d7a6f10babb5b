"""Optical-flow validation and submissions (reference archs/gmflow/
evaluate.py), ported from comfyui_keep_tpu/training/flow_eval.py.

A `flow_fn` stands for the model: it takes two (1, H, W, 3) float32 numpy
arrays in [0, 255] and returns a (1, H, W, 2) flow (numpy or a tensor);
`make_flow_fn(model)` makes one of a GMFlow on its device. Inputs are
padded to multiples of `padding_factor` as the reference's InputPadder
does ("sintel": evenly on both sides; "kitti": top and sides). Pictures
are written through utils/png.py (the card machine has no PIL).
"""
import os
import os.path as osp

import numpy as np
import torch

from comfyui_keep_torch.data import flow_datasets as fdata
from comfyui_keep_torch.utils import png


class InputPadder:
    """Pad (H, W) of NHWC arrays up to a multiple of `padding_factor`."""

    def __init__(self, shape, mode="sintel", padding_factor=8):
        self.ht, self.wd = shape[-3], shape[-2]
        pad_ht = (((self.ht // padding_factor) + 1) * padding_factor
                  - self.ht) % padding_factor
        pad_wd = (((self.wd // padding_factor) + 1) * padding_factor
                  - self.wd) % padding_factor
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *imgs):
        l, r, t, b = self._pad
        return [np.pad(im, ((0, 0), (t, b), (l, r), (0, 0))) for im in imgs]

    def unpad(self, flow):
        l, r, t, b = self._pad
        h, w = flow.shape[-3], flow.shape[-2]
        return flow[..., t:h - b, l:w - r, :]


def make_flow_fn(model, attn_splits: int = 2, corr_radius: int = -1,
                 prop_radius: int = -1):
    """A flow_fn of a GMFlow: the numpy pair to the model's device, its
    serving forward (GMFlow.apply), the flow back as numpy."""
    dev = next(model.parameters()).device

    def fn(img1, img2):
        flow = model.apply(torch.as_tensor(np.ascontiguousarray(img1),
                                           device=dev),
                           torch.as_tensor(np.ascontiguousarray(img2),
                                           device=dev),
                           attn_splits, corr_radius, prop_radius)
        return flow.float().cpu().numpy()

    return fn


def _flow(flow_fn, img1, img2):
    out = flow_fn(img1, img2)
    return out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)


def _padded_flow(flow_fn, s, padding_factor, mode="sintel"):
    padder = InputPadder(s["img1"][None].shape, mode=mode,
                         padding_factor=padding_factor)
    i1, i2 = padder.pad(s["img1"][None], s["img2"][None])
    return padder.unpad(_flow(flow_fn, i1, i2))[0]


def _epe_map(pred, gt):
    return np.sqrt(np.sum((pred - gt) ** 2, axis=-1))


def compute_out_of_boundary_mask(flow):
    """(H, W, 2) -> (H, W) bool: the correspondence stays in the image and
    |flow| within its size (gmflow utils/utils.py)."""
    h, w = flow.shape[:2]
    xs = np.arange(w, dtype=np.float32)[None, :] + flow[..., 0]
    ys = np.arange(h, dtype=np.float32)[:, None] + flow[..., 1]
    valid = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    flow_ok = (np.abs(flow[..., 0]) <= w - 1) & (np.abs(flow[..., 1]) <= h - 1)
    return valid & flow_ok


def _bucket_mean(lst):
    return float(np.mean(np.concatenate(lst))) if lst else float("nan")


def _speed_buckets(epe, gt, s0, s1, s2):
    """The EPE of pixels moving below 10, 10-40 and above 40 px."""
    speed = np.sqrt(np.sum(gt ** 2, axis=-1))
    for m, out in ((speed < 10, s0), ((speed >= 10) & (speed <= 40), s1),
                   (speed > 40, s2)):
        if m.max() > 0:
            out.append(epe[m])


def _rates(prefix, epe_all):
    return {f"{prefix}_epe": float(np.mean(epe_all)),
            f"{prefix}_1px": float(np.mean(epe_all > 1)),
            f"{prefix}_3px": float(np.mean(epe_all > 3)),
            f"{prefix}_5px": float(np.mean(epe_all > 5))}


def _with_buckets(results, prefix, s0, s1, s2):
    results[f"{prefix}_s0_10"] = _bucket_mean(s0)
    results[f"{prefix}_s10_40"] = _bucket_mean(s1)
    results[f"{prefix}_s40+"] = _bucket_mean(s2)
    return results


def validate_chairs(flow_fn, root="datasets/FlyingChairs_release/data",
                    split_file=None, with_speed_metric=False, max_samples=None):
    """FlyingChairs validation: EPE and the shares above 1, 3, 5 px over
    every pixel of the validation split."""
    ds = fdata.FlyingChairs(split="validation", root=root,
                            split_file=split_file)
    epe_list, s0, s1, s2 = [], [], [], []
    n = len(ds) if max_samples is None else min(len(ds), max_samples)
    for i in range(n):
        s = ds[i]
        pred = _flow(flow_fn, s["img1"][None], s["img2"][None])[0]
        epe = _epe_map(pred, s["flow"])
        epe_list.append(epe.reshape(-1))
        if with_speed_metric:
            _speed_buckets(epe, s["flow"], s0, s1, s2)
    results = _rates("chairs", np.concatenate(epe_list))
    return (_with_buckets(results, "chairs", s0, s1, s2)
            if with_speed_metric else results)


def validate_things(flow_fn, root="datasets/FlyingThings3D",
                    dstype="frames_cleanpass", padding_factor=8,
                    max_val_flow=400, with_speed_metric=False,
                    max_samples=None):
    """FlyingThings3D's test subset, pixels moving max_val_flow or more
    left out."""
    ds = fdata.FlyingThings3D(root=root, dstype=dstype, test_set=True,
                              validate_subset=True)
    epe_list, s0, s1, s2 = [], [], [], []
    n = len(ds) if max_samples is None else min(len(ds), max_samples)
    for i in range(n):
        s = ds[i]
        pred = _padded_flow(flow_fn, s, padding_factor)
        gt = s["flow"]
        mask = np.sqrt(np.sum(gt ** 2, axis=-1)) < max_val_flow
        if not mask.any():
            continue
        epe_list.append(_epe_map(pred, gt)[mask].reshape(-1))
        if with_speed_metric:
            _speed_buckets(_epe_map(pred, gt), gt, s0, s1, s2)
    key = "things_clean" if dstype == "frames_cleanpass" else "things_final"
    results = _rates(key, np.concatenate(epe_list))
    return (_with_buckets(results, key, s0, s1, s2)
            if with_speed_metric else results)


def validate_sintel(flow_fn, root="datasets/Sintel", dstype="clean",
                    padding_factor=8, with_speed_metric=False,
                    evaluate_matched_unmatched=False, max_samples=None):
    """Sintel's training split; with evaluate_matched_unmatched the EPE of
    matched pixels (not occluded, the correspondence in the image) and of
    the rest."""
    ds = fdata.MpiSintel(split="training", root=root, dstype=dstype,
                         load_occlusion=evaluate_matched_unmatched)
    epe_list, matched, unmatched, s0, s1, s2 = [], [], [], [], [], []
    n = len(ds) if max_samples is None else min(len(ds), max_samples)
    for i in range(n):
        s = ds[i]
        pred = _padded_flow(flow_fn, s, padding_factor)
        epe = _epe_map(pred, s["flow"])
        epe_list.append(epe.reshape(-1))
        if evaluate_matched_unmatched:
            noc = (s["noc_valid"] > 0.5) & compute_out_of_boundary_mask(
                s["flow"])
            if noc.any():
                matched.append(epe[noc])
            if (~noc).any():
                unmatched.append(epe[~noc])
        if with_speed_metric:
            _speed_buckets(epe, s["flow"], s0, s1, s2)
    key = f"sintel_{dstype}"
    results = _rates(key, np.concatenate(epe_list))
    if evaluate_matched_unmatched:
        results[f"{key}_matched"] = float(np.mean(np.concatenate(matched)))
        results[f"{key}_unmatched"] = float(np.mean(np.concatenate(
            unmatched)))
    return (_with_buckets(results, key, s0, s1, s2)
            if with_speed_metric else results)


def validate_kitti(flow_fn, root="datasets/KITTI", padding_factor=8,
                   with_speed_metric=False, max_samples=None):
    """KITTI-2015 training split: the mean of each pair's EPE over its
    valid pixels, and F1-all (EPE > 3 px and > 5 % of |gt|), in %."""
    ds = fdata.KITTI(split="training", root=root)
    epe_list, out_list, s0, s1, s2 = [], [], [], [], []
    n = len(ds) if max_samples is None else min(len(ds), max_samples)
    for i in range(n):
        s = ds[i]
        pred = _padded_flow(flow_fn, s, padding_factor, mode="kitti")
        gt, valid = s["flow"], s["valid"] >= 0.5
        epe = _epe_map(pred, gt)
        mag = np.sqrt(np.sum(gt ** 2, axis=-1))
        out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-9)) > 0.05)
        epe_list.append(epe[valid].mean())
        out_list.append(out[valid].reshape(-1))
        if with_speed_metric:
            _speed_buckets(np.where(valid, epe, np.nan), gt, s0, s1, s2)
    results = {"kitti_epe": float(np.mean(epe_list)),
               "kitti_f1": 100.0 * float(np.mean(np.concatenate(out_list)))}
    return (_with_buckets(results, "kitti", s0, s1, s2)
            if with_speed_metric else results)


def create_sintel_submission(flow_fn, root="datasets/Sintel",
                             output_path="sintel_submission", dstype="clean",
                             padding_factor=8):
    """.flo predictions for Sintel's test split,
    <output_path>/<dstype>/<scene>/frame%04d.flo."""
    ds = fdata.MpiSintel(split="test", root=root, dstype=dstype)
    for i in range(len(ds)):
        s = ds[i]
        scene, frame_id = s["extra_info"]
        flow = _padded_flow(flow_fn, s, padding_factor)
        out_dir = osp.join(output_path, dstype, scene)
        os.makedirs(out_dir, exist_ok=True)
        fdata.write_flo(osp.join(out_dir, "frame%04d.flo" % (frame_id + 1)),
                        flow)


def create_kitti_submission(flow_fn, root="datasets/KITTI",
                            output_path="kitti_submission",
                            padding_factor=8):
    """KITTI's 16-bit PNG predictions for its testing split."""
    ds = fdata.KITTI(split="testing", root=root)
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(ds)):
        s = ds[i]
        (frame_id,) = s["extra_info"]
        flow = _padded_flow(flow_fn, s, padding_factor, mode="kitti")
        fdata.write_flow_kitti(osp.join(output_path, frame_id), flow)


def inference_on_dir(flow_fn, inference_dir, output_path="output",
                     padding_factor=8, save_flo_flow=False):
    """Flow of each consecutive pair of the directory's .png / .ppm frames
    (sorted by name): <output_path>/%04d_flow.png, the Middlebury picture,
    and with save_flo_flow %04d_pred.flo. Returns the flows."""
    from comfyui_keep_torch.utils.flow import flow_to_image
    files = [osp.join(inference_dir, f)
             for f in sorted(os.listdir(inference_dir))
             if f.lower().endswith((".png", ".jpg", ".jpeg", ".ppm"))]
    os.makedirs(output_path, exist_ok=True)

    def rgb(path):
        img = fdata.read_image(path)
        img = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
        return img[..., :3].astype(np.float32)

    flows = []
    for i in range(len(files) - 1):
        s = {"img1": rgb(files[i]), "img2": rgb(files[i + 1])}
        flow = _padded_flow(flow_fn, s, padding_factor)
        flows.append(flow)
        with open(osp.join(output_path, "%04d_flow.png" % i), "wb") as f:
            f.write(png.encode(flow_to_image(flow)))
        if save_flo_flow:
            fdata.write_flo(osp.join(output_path, "%04d_pred.flo" % i), flow)
    return flows
