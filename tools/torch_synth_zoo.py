#!/usr/bin/env python3
"""Write the KEEP model zoo as random-weight .pth checkpoints from the
PyTorch port's modules, in the reference's file names, serialization and
state-dict layout (the counterpart of tools/synth_zoo.py, which builds the
same files from the reference's modules). It is the port's half of the
readiness drill for the real checkpoints: every loader path of the port
(api.load_models(keep_ckpt=...), facelib/factory.py with model_rootpath,
factory.load_reference for the upscalers) reads these files as it will
read the released ones.

Files (the layout of the reference zoo, modules/utils.py:41-97 and the
facelib loaders):

  keep_models/KEEP/KEEP-b76feb75.pth
      {"params_ema": KEEP's state dict with GMFlow under flownet.model.*}
  facedetection/detection_Resnet50_Final.pth
      RetinaFace-ResNet50 with the DataParallel `module.` prefix; its
      BatchNorm statistics drawn at random and its heads scaled so that it
      detects at the pipeline's operating point (conf 0.97, eye distance
      >= 5 px), checked on a synthetic 640^2 image
  facedetection/parsing_parsenet.pth
      ParseNet, legacy (non-zip) torch serialization
  upscale_models/RealESRGAN_x2_bg.pth, RealESRGAN_x2_face.pth
      RRDBNet x2 as {"params_ema", "params"}, as the Real-ESRGAN releases

  python tools/torch_synth_zoo.py --out-dir /tmp/keep_zoo [--seed 0] \
      [--variant KEEP] [--cfg-json '{"img_size": 64, ...}'] [--skip-keep] \
      [--rrdb-blocks 2]

Everything is built on the CPU.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DETECT_CONF, DETECT_EYE = 0.97, 5.0
ZOO = {
    "KEEP-b76feb75.pth": ("keep_models/KEEP", "keep"),
    "detection_Resnet50_Final.pth": ("facedetection", "retinaface"),
    "parsing_parsenet.pth": ("facedetection", "parsenet"),
    "RealESRGAN_x2_bg.pth": ("upscale_models", "rrdbnet"),
    "RealESRGAN_x2_face.pth": ("upscale_models", "rrdbnet"),
}


def synth_image(rng, h, w):
    """A deterministic structured image: smooth gradients and texture."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([
        0.5 + 0.4 * np.sin(xx / 37.0) * np.cos(yy / 29.0),
        0.5 + 0.4 * np.cos(xx / 23.0 + yy / 41.0),
        0.5 + 0.4 * np.sin((xx + yy) / 53.0),
    ], axis=-1)
    noise = rng.random((h, w, 3), dtype=np.float32) * 0.25
    return np.clip((base + noise) * 255.0 / 1.25, 0, 255).astype(np.uint8)


def randomize_bn_stats(net, seed=11):
    """Every BatchNorm's running statistics and affine drawn at random: at
    plain random init, eval-mode BatchNorms collapse the features to
    constants and every prior scores alike."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
                m.weight.normal_(1.0, 0.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return net


def calibrate_detectable_heads(net, cls_scale=8.0, face_bias=-1.2,
                               lm_scale=40.0, box_scale=4.0):
    """Scale RetinaFace's 1x1 heads so that random weights detect at the
    pipeline's operating point: the class head spreads the scores (plain
    random heads sit near 0.5) and its face bias places their upper tail
    across 0.97; the landmark and box heads spread the decoded points past
    the 5-px eye-distance filter. On the port's init (seed 0) the synthetic
    640^2 image gives 9 rows at 0.97, 8 of them past the eye filter."""
    import torch
    with torch.no_grad():
        for ch in net.ClassHead:
            ch.conv1x1.weight.mul_(cls_scale)
            ch.conv1x1.bias.mul_(cls_scale)
            ch.conv1x1.bias.view(-1, 2)[:, 1].add_(face_bias)
        for lh in net.LandmarkHead:
            lh.conv1x1.weight.mul_(lm_scale)
            lh.conv1x1.bias.mul_(lm_scale)
        for bh in net.BboxHead:
            bh.conv1x1.weight.mul_(box_scale)
            bh.conv1x1.bias.mul_(box_scale)
    return net


def synth_keep(path, variant="KEEP", cfg_overrides=None, seed=0):
    """KEEP (from `seed`) with GMFlow (from seed + 1) under flownet.model.*,
    as {"params_ema": ...}."""
    import torch
    from comfyui_keep_torch.models.gmflow import GMFlow
    from comfyui_keep_torch.models.keep import KEEP
    from comfyui_keep_torch.utils.convert import FLOWNET_PREFIX
    keep = KEEP(variant, device="cpu",
                generator=torch.Generator().manual_seed(seed),
                **(cfg_overrides or {}))
    gm = GMFlow(device="cpu", generator=torch.Generator().manual_seed(
        seed + 1))
    sd = dict(keep.state_dict())
    sd.update({FLOWNET_PREFIX + k: v for k, v in gm.state_dict().items()})
    torch.save({"params_ema": sd}, path)
    return path


def synth_retinaface(path, network="resnet50", seed=0, self_check=True):
    """RetinaFace with random BatchNorm statistics and calibrated heads,
    saved with the `module.` prefix the reference strips at load."""
    import torch
    from comfyui_keep_torch.models.retinaface import (RetinaFace,
                                                      make_detector_fn)
    net = RetinaFace(network, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    randomize_bn_stats(net, seed=seed + 11)
    calibrate_detectable_heads(net)
    if self_check:
        img = synth_image(np.random.default_rng(0), 640, 640)
        rows = make_detector_fn(net)(img, DETECT_CONF)
        eye = np.linalg.norm(rows[:, 5:7] - rows[:, 7:9], axis=1)
        n_ok = int((eye >= DETECT_EYE).sum())
        if not 1 <= n_ok <= 50:
            raise RuntimeError(
                f"synthetic detector degenerate: {len(rows)} rows at conf >= "
                f"{DETECT_CONF}, {n_ok} with eye distance >= {DETECT_EYE} "
                "(want 1..50)")
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()}, path)
    return path


def synth_parsenet(path, seed=0):
    """ParseNet (512 in and out, 19 classes) with random BatchNorm
    statistics, in torch's legacy serialization."""
    import torch
    from comfyui_keep_torch.models.parsenet import ParseNet
    net = ParseNet(device="cpu", generator=torch.Generator().manual_seed(seed))
    randomize_bn_stats(net, seed=seed + 11)
    torch.save(dict(net.state_dict()), path,
               _use_new_zipfile_serialization=False)
    return path


def synth_rrdbnet(path, seed=0, num_block=2, num_feat=32, scale=2):
    """RRDBNet x`scale` as {"params_ema", "params"}. num_block defaults
    small: the drill checks loaders and numerics, not ESRGAN's quality."""
    import torch
    from comfyui_keep_torch.models.sr_basic import RRDBNet
    net = RRDBNet(num_in_ch=3, num_out_ch=3, scale=scale, num_feat=num_feat,
                  num_block=num_block, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    sd = dict(net.state_dict())
    torch.save({"params_ema": sd, "params": sd}, path)
    return path


def synth_all(out_dir, seed=0, cfg_overrides=None, variant="KEEP",
              skip_keep=False, rrdb_blocks=2):
    """Write the zoo under out_dir; returns {file name: path}."""
    made = {}
    for fname, (sub, kind) in ZOO.items():
        if kind == "keep" and skip_keep:
            continue
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, fname)
        if kind == "keep":
            synth_keep(path, variant, cfg_overrides, seed)
        elif kind == "retinaface":
            synth_retinaface(path, "resnet50", seed)
        elif kind == "parsenet":
            synth_parsenet(path, seed)
        else:
            synth_rrdbnet(path, seed + (1 if "face" in fname else 0),
                          num_block=rrdb_blocks)
        made[fname] = path
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return made


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--variant", default="KEEP", choices=["KEEP", "Asian"])
    p.add_argument("--cfg-json", default=None,
                   help="JSON dict of KEEP config overrides (small sizes)")
    p.add_argument("--skip-keep", action="store_true",
                   help="the face toolkit's and the upscalers' files only")
    p.add_argument("--rrdb-blocks", type=int, default=2)
    args = p.parse_args(argv)
    cfg = json.loads(args.cfg_json) if args.cfg_json else None
    return synth_all(args.out_dir, args.seed, cfg, args.variant,
                     args.skip_keep, args.rrdb_blocks)


if __name__ == "__main__":
    main()
