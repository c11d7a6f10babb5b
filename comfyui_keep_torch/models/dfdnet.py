"""DFDNet (reference archs/dfdnet_arch.py, dfdnet_util.py), ported from
comfyui_keep_tpu/models/dfdnet.py: VGG19 features of a 512^2 face in
[-1, 1]; at four levels each facial part's feature is swapped for its
nearest atom of a component dictionary (after AdaIN to the part's colour
statistics), blended by an attention block; then a multi-scale dilation
block and four SFT upsampling blocks decode.

The dictionary swap slices part regions whose sizes come from the data,
at batch 1, as the reference does. The dictionary is data, not weights:
{str(feature size): {part: (N, C, h, w) atoms}}, kept as non-persistent
buffers (the reference loads it from its own file), so state dicts hold
the reference's keys only.
"""
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.discriminators import (SpectralNormConv2d,
                                                      build)
from comfyui_keep_torch.models.layers import adaptive_instance_normalization
from comfyui_keep_torch.models.vgg import VGGFeatureExtractor
from comfyui_keep_torch.ops import leaky_relu, resize_bilinear, resize_nearest
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

PARTS = ("left_eye", "right_eye", "nose", "mouth")
FEATURE_SIZES = (256, 128, 64, 32)
CHANNEL_SIZES = (128, 256, 512, 512)
VGG_LAYERS = ("relu2_2", "relu3_4", "relu4_4", "conv5_4")
_BLUR = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16


class Blur(nn.Module):
    """Depthwise 3x3 binomial blur, padding 1."""

    def forward(self, x):
        c = x.shape[1]
        k = _BLUR.to(x.device, x.dtype).expand(c, 1, 3, 3)
        return F.conv2d(x, k, padding=1, groups=c)


def _sn_pair(cin: int, cout: int, dilation: int = 1) -> nn.Sequential:
    """SN conv, leaky ReLU 0.2, SN conv (3x3, padding = dilation)."""
    return nn.Sequential(
        SpectralNormConv2d(cin, cout, 3, padding=dilation, dilation=dilation),
        nn.LeakyReLU(0.2),
        SpectralNormConv2d(cout, cout, 3, padding=dilation,
                           dilation=dilation))


def _run_pair(seq: nn.Sequential, x):
    return seq[2](leaky_relu(seq[0](x), 0.2))


class AttentionBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.mask = _sn_pair(c, c)

    def forward(self, x):
        return _run_pair(self.mask, x)


class MSDilationBlock(nn.Module):
    def __init__(self, c: int, dilation: Sequence[int] = (4, 3, 2, 1)):
        super().__init__()
        self.conv_blocks = nn.ModuleList([_sn_pair(c, c, d)
                                          for d in dilation])
        self.conv_fusion = SpectralNormConv2d(4 * c, c, 3, padding=1)

    def forward(self, x):
        out = torch.cat([_run_pair(b, x) for b in self.conv_blocks], 1)
        return self.conv_fusion(out) + x


class UpResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.2),
                                  nn.Conv2d(c, c, 3, 1, 1))

    def forward(self, x):
        return x + self.body[2](leaky_relu(self.body[0](x), 0.2))


class SFTUpBlock(nn.Module):
    """Blur, SN conv, leaky ReLU 0.04; scaled and shifted by maps from the
    updated VGG feature (spatial feature transform); x2 bilinear, SN conv,
    leaky ReLU 0.2."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(Blur(), SpectralNormConv2d(
            cin, cout, 3, padding=1), nn.LeakyReLU(0.04))
        self.convup = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear"),
            SpectralNormConv2d(cout, cout, 3, padding=1), nn.LeakyReLU(0.2))
        self.scale_block = _sn_pair(cin, cout)
        self.shift_block = nn.Sequential(*_sn_pair(cin, cout), nn.Sigmoid())

    def forward(self, x, updated_feat):
        out = leaky_relu(self.conv1[1](self.conv1[0](x)), 0.04)
        scale = _run_pair(self.scale_block, updated_feat)
        shift = torch.sigmoid(_run_pair(self.shift_block, updated_feat))
        out = out * scale + shift
        out = resize_bilinear(out, (out.shape[2] * 2, out.shape[3] * 2))
        return leaky_relu(self.convup[1](out), 0.2)


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):
    def __init__(self, num_feat: int = 64,
                 dictionary: Optional[Dict[str, Dict[str, torch.Tensor]]]
                 = None, device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vgg_extractor = VGGFeatureExtractor(
            VGG_LAYERS, "vgg19", use_input_norm=True, range_norm=True,
            device="cpu")
        self.attn_blocks = nn.ModuleDict({
            f"{name}_{fs}": AttentionBlock(c)
            for fs, c in zip(FEATURE_SIZES, CHANNEL_SIZES) for name in PARTS})
        self.multi_scale_dilation = MSDilationBlock(num_feat * 8)
        self.upsample0 = SFTUpBlock(num_feat * 8, num_feat * 8)
        self.upsample1 = SFTUpBlock(num_feat * 8, num_feat * 4)
        self.upsample2 = SFTUpBlock(num_feat * 4, num_feat * 2)
        self.upsample3 = SFTUpBlock(num_feat * 2, num_feat)
        self.upsample4 = nn.Sequential(
            SpectralNormConv2d(num_feat, num_feat, 3, padding=1),
            nn.LeakyReLU(0.2), UpResBlock(num_feat), UpResBlock(num_feat),
            nn.Conv2d(num_feat, 3, 3, 1, 1), nn.Tanh())
        for fs, parts in (dictionary or {}).items():
            for part, atoms in parts.items():
                self.register_buffer(f"dict_{fs}_{part}",
                                     torch.as_tensor(atoms), persistent=False)
        build(self, device, dtype, generator)

    def atoms(self, f_size: int, part: str):
        return getattr(self, f"dict_{f_size}_{part}")

    def swap_features(self, x, part_locations,
                      picks: Optional[Dict[Tuple[int, str], int]] = None):
        """The VGG features of x, each level's features with the parts
        swapped (dfdnet_arch.py swap_feat), and every part's similarity to
        each atom {(feature size, part): (N,)}. part_locations: four (1, 4)
        [x1, y1, x2, y2] boxes at 512 scale (left eye, right eye, nose,
        mouth). picks, where given, replaces the argmax's choice of atom
        for that (feature size, part)."""
        feats = self.vgg_extractor(x)
        updated, scores = [], {}
        for layer, fs in zip(VGG_LAYERS, FEATURE_SIZES):
            vgg_feat = feats[layer]
            upd = vgg_feat.clone()
            for pi, part in enumerate(PARTS):
                x1, y1, x2, y2 = [int(v) // (512 // fs) for v in
                                  torch.as_tensor(part_locations[pi])[0]]
                part_feat = vgg_feat[:, :, y1:y2, x1:x2]
                atoms = self.atoms(fs, part).to(x.dtype)
                part_resized = resize_bilinear(part_feat, atoms.shape[2:])
                d = adaptive_instance_normalization(atoms, part_resized)
                sim = torch.einsum("chw,nchw->n", part_resized[0], d)
                scores[(fs, part)] = sim
                if picks is not None and (fs, part) in picks:
                    idx = picks[(fs, part)]
                else:
                    idx = int(torch.argmax(torch.softmax(sim, 0)))
                swap = resize_nearest(d[idx:idx + 1], (y2 - y1, x2 - x1))
                attn = self.attn_blocks[f"{part}_{fs}"](swap - part_feat)
                upd[:, :, y1:y2, x1:x2] = attn * swap + part_feat
            updated.append(upd)
        return feats, updated, scores

    def forward(self, x, part_locations,
                picks: Optional[Dict[Tuple[int, str], int]] = None):
        """x: (1, 3, 512, 512) in [-1, 1] -> tanh (1, 3, 512, 512)."""
        feats, updated, _ = self.swap_features(x, part_locations, picks)
        h = self.multi_scale_dilation(feats["conv5_4"])
        for i, up in enumerate((self.upsample0, self.upsample1,
                                self.upsample2, self.upsample3)):
            h = up(h, updated[3 - i])
        u4 = self.upsample4
        h = leaky_relu(u4[0](h), 0.2)
        h = u4[4](u4[3](u4[2](h)))
        return torch.tanh(h)
