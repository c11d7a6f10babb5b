"""BiSeNet face parser (reference wm_facelib/parsing/bisenet.py and its
ResNet18, parsing/resnet.py), ported from comfyui_keep_tpu/models/
bisenet.py: the ResNet18 context path with the attention refinement
modules and the global-average context, the feature fusion module, and the
main, 1/16 and 1/32 heads, each upsampled to the input by bilinear
interpolation with align_corners=True. BatchNorm in its inference form;
the spatial path is the ResNet's 1/8 feature, as in the reference. NCHW.
Module names are the reference's (cp.resnet.layer1.0.conv1, cp.arm16.conv.
bn, ffm.convblk.conv, conv_out16.conv_out, ...), so parsing_bisenet.pth
loads as it is.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import (batch_norm, conv2d, max_pool, relu,
                                    resize_bilinear, resize_nearest)
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(cin, cout, ks, 1, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        x = conv2d(x, self.conv.weight, padding=self.padding)
        return relu(batch_norm(x, self.bn))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        r = relu(batch_norm(conv2d(x, self.conv1.weight, stride=self.stride,
                                   padding=1), self.bn1))
        r = batch_norm(conv2d(r, self.conv2.weight, padding=1), self.bn2)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = batch_norm(conv2d(x, conv.weight, stride=self.stride), bn)
        return relu(x + r)


LAYERS = (("layer1", 64, 64, 1), ("layer2", 64, 128, 2),
          ("layer3", 128, 256, 2), ("layer4", 256, 512, 2))


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        for name, cin, cout, stride in LAYERS:
            setattr(self, name, nn.Sequential(BasicBlock(cin, cout, stride),
                                              BasicBlock(cout, cout, 1)))

    def forward(self, x):
        """(B, 3, H, W) -> the 1/8, 1/16 and 1/32 features."""
        x = relu(batch_norm(conv2d(x, self.conv1.weight, stride=2,
                                   padding=3), self.bn1))
        x = self.layer1(max_pool(x, 3, 2, 1))
        feats = []
        for name, _, _, _ in LAYERS[1:]:
            x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


def global_mean(x):
    """F.avg_pool2d(x, x.size()[2:]): the mean over H and W, kept 1 x 1."""
    return x.mean(dim=(-2, -1), keepdim=True)


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = conv2d(global_mean(feat), self.conv_atten.weight)
        return feat * torch.sigmoid(batch_norm(atten, self.bn_atten))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(global_mean(feat32))
        avg_up = resize_nearest(avg, feat32.shape[-2:])
        feat32_sum = self.arm32(feat32) + avg_up
        feat32_up = self.conv_head32(resize_nearest(feat32_sum,
                                                    feat16.shape[-2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(resize_nearest(feat16_sum,
                                                    feat8.shape[-2:]))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1, padding=0)
        self.conv1 = nn.Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        atten = relu(conv2d(global_mean(feat), self.conv1.weight))
        atten = torch.sigmoid(conv2d(atten, self.conv2.weight))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, num_class: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = nn.Conv2d(mid, num_class, 1, bias=False)

    def forward(self, x):
        feat = self.conv(x)
        return conv2d(feat, self.conv_out.weight), feat


@ARCH_REGISTRY.register()
class BiSeNet(nn.Module):
    def __init__(self, num_class: int = 19, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, num_class)
        self.conv_out16 = BiSeNetOutput(128, 64, num_class)
        self.conv_out32 = BiSeNetOutput(128, 64, num_class)
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x, return_feat: bool = False):
        """x: (B, 3, H, W) -> (out, out16, out32)[, their features]: each
        head's per-pixel logits, bilinearly upsampled (align_corners=True)
        to H x W."""
        hw = x.shape[-2:]
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        feat_fuse = self.ffm(feat_res8, feat_cp8)
        out, feat = self.conv_out(feat_fuse)
        out16, feat16 = self.conv_out16(feat_cp8)
        out32, feat32 = self.conv_out32(feat_cp16)

        def up(t):
            return resize_bilinear(t, hw, align_corners=True)

        if return_feat:
            return (up(out), up(out16), up(out32), up(feat), up(feat16),
                    up(feat32))
        return up(out), up(out16), up(out32)


def make_parser_fn(model: BiSeNet):
    """parser(face_rgb_pm1 (1, 512, 512, 3), numpy or a tensor) -> (1, 512,
    512, 19) logits of the main head, a tensor on the model's device: the
    FaceRestoreHelper plug-in. The module is parser.model."""

    def parser(x):
        p = next(model.parameters())
        x = (x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))).to(p.device, p.dtype)
        with torch.no_grad():
            out = model(x.permute(0, 3, 1, 2))[0]
        return out.permute(0, 2, 3, 1)

    parser.model = model
    return parser
