"""Video SR archs (reference basicvsr_arch.py, edvr_arch.py,
basicvsrpp_arch.py), ported from comfyui_keep_tpu/models/video_sr.py:
BasicVSR and IconVSR (bidirectional recurrent propagation over SpyNet
flows; IconVSR refines keyframes with an EDVR feature extractor), EDVR
(pyramid, cascading and deformable alignment, PCD, then temporal and
spatial attention fusion, TSA) and BasicVSR++ (second-order flow-guided
deformable alignment).

Clips are (B, T, 3, H, W) in [0, 1]; flows (B, T - 1, 2, H, W). The
recurrences are Python loops over the frames, where the JAX package scans:
the first frame in each direction is not warped. The deformable
convolutions run on ops/native.py (plain PyTorch gathers). BasicVSR++
always builds its deformable alignment, as the JAX package does (the
reference builds it only when CUDA is present). Keys are the reference's.
"""
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish, zero_
from comfyui_keep_torch.models.sr_basic import (ResidualBlockNoBN,
                                                pixel_shuffle)
from comfyui_keep_torch.models.spynet import SpyNet
from comfyui_keep_torch.ops import (flow_warp, leaky_relu, max_pool,
                                    resize_bilinear)
from comfyui_keep_torch.ops.native import dcn_v2_pack, deform_conv2d
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY


def lrelu(x):
    return leaky_relu(x, 0.1)


def warp(x, flow):
    """x (N, C, H, W) warped by flow (N, 2, H, W), zero padding."""
    return flow_warp(x, flow.permute(0, 2, 3, 1))


def _build(module: nn.Module, device, dtype, generator):
    """Seeded init (deformable layers: their offset predictor's last conv
    zeroed, as the reference's init does), then device and dtype."""
    if generator is not None:
        default_init_(module, generator)
        for m in module.modules():
            if isinstance(m, (DCNv2Pack, SecondOrderDeformableAlignment)):
                off = m.conv_offset
                zero_(off[-1] if isinstance(off, nn.Sequential) else off)
    return finish(module, device, dtype)


class ConvResidualBlocks(nn.Module):
    """conv + leaky ReLU 0.1, then num_block ResidualBlockNoBN (`main` at
    Sequential indices 0 and 2)."""

    def __init__(self, cin: int, cout: int, num_block: int):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(cout)
                            for _ in range(num_block)]))

    def forward(self, x):
        return self.main[2](lrelu(self.main[0](x)))


class _Upsampler(nn.Module):
    """The x4 tail shared by BasicVSR, IconVSR, EDVR and BasicVSR++:
    upconv1 / upconv2 each with pixel_shuffle(2), conv_hr, conv_last, plus
    the bilinear x4 of the low-resolution frame."""

    def _make_upsampler(self, nf: int):
        self.upconv1 = nn.Conv2d(nf, nf * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(nf, 64 * 4, 3, 1, 1)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)

    def upsample(self, feat, lr):
        out = lrelu(pixel_shuffle(self.upconv1(feat), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        return out + resize_bilinear(lr, (lr.shape[2] * 4, lr.shape[3] * 4))


def spynet_flows(spynet: SpyNet, x):
    """(forward, backward) flows of a clip (B, T, 3, H, W): backward[:, i]
    from frame i to i + 1, forward[:, i] from frame i + 1 to i."""
    b, t, c, h, w = x.shape
    x1 = x[:, :-1].reshape(-1, c, h, w)
    x2 = x[:, 1:].reshape(-1, c, h, w)
    backward = spynet(x1, x2).reshape(b, t - 1, 2, h, w)
    forward = spynet(x2, x1).reshape(b, t - 1, 2, h, w)
    return forward, backward


# -- BasicVSR (basicvsr_arch.py) ------------------------------------------------

@ARCH_REGISTRY.register()
class BasicVSR(_Upsampler):
    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_feat = num_feat
        self.spynet = SpyNet(device="cpu")
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                num_block)
        self.fusion = nn.Conv2d(num_feat * 2, num_feat, 1, 1, 0)
        self._make_upsampler(num_feat)
        _build(self, device, dtype, generator)

    def forward(self, x):
        """x: (B, T, 3, H, W) -> (B, T, 3, 4H, 4W)."""
        b, t, _, h, w = x.shape
        flows_forward, flows_backward = spynet_flows(self.spynet, x)
        out_l: List[torch.Tensor] = [None] * t
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat_prop = warp(feat_prop, flows_backward[:, i])
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop],
                                                      1))
            out_l[i] = feat_prop
        feat_prop = torch.zeros_like(feat_prop)
        outs = []
        for i in range(t):
            if i > 0:
                feat_prop = warp(feat_prop, flows_forward[:, i - 1])
            feat_prop = self.forward_trunk(torch.cat([x[:, i], feat_prop], 1))
            out = lrelu(self.fusion(torch.cat([out_l[i], feat_prop], 1)))
            outs.append(self.upsample(out, x[:, i]))
        return torch.stack(outs, dim=1)


# -- EDVR (edvr_arch.py) --------------------------------------------------------

class DCNv2Pack(nn.Conv2d):
    """Modulated deformable 3x3 convolution whose offsets and mask come from
    a second map through `conv_offset` (arch_util.py DCNv2Pack): the
    convolution's own weight and bias, as ModulatedDeformConvPack keeps
    them."""

    def __init__(self, cin: int, cout: int, deformable_groups: int):
        super().__init__(cin, cout, 3, 1, 1)
        self.deformable_groups = deformable_groups
        self.conv_offset = nn.Conv2d(cin, deformable_groups * 27, 3, 1, 1)

    def forward(self, x, feat):
        return dcn_v2_pack(x, feat, self.weight, self.bias,
                           self.conv_offset.weight, self.conv_offset.bias,
                           deformable_groups=self.deformable_groups)


class PCDAlignment(nn.Module):
    """Pyramid, cascading and deformable alignment of a neighbour's three
    feature levels to the reference frame's."""

    def __init__(self, num_feat: int = 64, deformable_groups: int = 8):
        super().__init__()
        self.offset_conv1, self.offset_conv2 = nn.ModuleDict(), nn.ModuleDict()
        self.offset_conv3, self.dcn_pack = nn.ModuleDict(), nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in range(3, 0, -1):
            lv = f"l{i}"
            self.offset_conv1[lv] = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
            if i == 3:
                self.offset_conv2[lv] = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            else:
                self.offset_conv2[lv] = nn.Conv2d(num_feat * 2, num_feat, 3,
                                                  1, 1)
                self.offset_conv3[lv] = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.dcn_pack[lv] = DCNv2Pack(num_feat, num_feat,
                                          deformable_groups)
            if i < 3:
                self.feat_conv[lv] = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
        self.cas_offset_conv1 = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
        self.cas_offset_conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.cas_dcnpack = DCNv2Pack(num_feat, num_feat, deformable_groups)

    def forward(self, nbr_feat_l, ref_feat_l):
        def up(z):
            return resize_bilinear(z, (z.shape[2] * 2, z.shape[3] * 2))

        up_offset = up_feat = feat = None
        for i in range(3, 0, -1):
            lv = f"l{i}"
            offset = lrelu(self.offset_conv1[lv](torch.cat(
                [nbr_feat_l[i - 1], ref_feat_l[i - 1]], 1)))
            if i == 3:
                offset = lrelu(self.offset_conv2[lv](offset))
            else:
                offset = lrelu(self.offset_conv2[lv](torch.cat(
                    [offset, up_offset], 1)))
                offset = lrelu(self.offset_conv3[lv](offset))
            feat = self.dcn_pack[lv](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[lv](torch.cat([feat, up_feat], 1))
            if i > 1:
                feat = lrelu(feat)
                up_offset = up(offset) * 2
                up_feat = up(feat)
        offset = torch.cat([feat, ref_feat_l[0]], 1)
        offset = lrelu(self.cas_offset_conv2(lrelu(
            self.cas_offset_conv1(offset))))
        return lrelu(self.cas_dcnpack(feat, offset))


def _avg_pool3s2(x):
    """AvgPool2d(3, stride 2, padding 1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, 2, 1)


class TSAFusion(nn.Module):
    """Temporal attention (each frame's embedding against the reference
    frame's) and spatial attention over a two-level pyramid."""

    SPECS = {"temporal_attn1": (3, 1, 1), "temporal_attn2": (3, 1, 1),
             "feat_fusion": (1, "t", 1), "spatial_attn1": (1, "t", 1),
             "spatial_attn2": (1, 2, 1), "spatial_attn3": (3, 1, 1),
             "spatial_attn4": (1, 1, 1), "spatial_attn5": (3, 1, 1),
             "spatial_attn_l1": (1, 1, 1), "spatial_attn_l2": (3, 2, 1),
             "spatial_attn_l3": (3, 1, 1), "spatial_attn_add1": (1, 1, 1),
             "spatial_attn_add2": (1, 1, 1)}

    def __init__(self, num_feat: int = 64, num_frame: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        self.center_frame_idx = center_frame_idx
        for name, (k, cin_mult, cout_mult) in self.SPECS.items():
            cin = num_feat * (num_frame if cin_mult == "t" else cin_mult)
            setattr(self, name, nn.Conv2d(cin, num_feat * cout_mult, k, 1,
                                          k // 2))

    def _c(self, name, x):
        return getattr(self, name)(x)

    def _pyramid(self, name, x):
        return lrelu(self._c(name, torch.cat([max_pool(x, 3, 2, 1),
                                              _avg_pool3s2(x)], 1)))

    def forward(self, aligned):
        """aligned: (B, T, C, H, W) -> (B, C, H, W)."""
        b, t, c, h, w = aligned.shape
        emb_ref = self._c("temporal_attn1", aligned[:, self.center_frame_idx])
        emb = self._c("temporal_attn2", aligned.reshape(-1, c, h, w)
                      ).reshape(b, t, c, h, w)
        corr_prob = torch.sigmoid((emb * emb_ref[:, None]).sum(2))
        feat = (aligned * corr_prob[:, :, None]).reshape(b, t * c, h, w)
        fused = lrelu(self._c("feat_fusion", feat))
        attn = self._pyramid("spatial_attn2",
                             lrelu(self._c("spatial_attn1", feat)))
        level = self._pyramid("spatial_attn_l2",
                              lrelu(self._c("spatial_attn_l1", attn)))
        level = resize_bilinear(lrelu(self._c("spatial_attn_l3", level)),
                                attn.shape[2:])
        attn = lrelu(self._c("spatial_attn3", attn)) + level
        attn = resize_bilinear(lrelu(self._c("spatial_attn4", attn)), (h, w))
        attn = self._c("spatial_attn5", attn)
        attn_add = self._c("spatial_attn_add2",
                           lrelu(self._c("spatial_attn_add1", attn)))
        return fused * torch.sigmoid(attn) * 2 + attn_add


class EDVRFeatureExtractor(nn.Module):
    """EDVR's front half (basicvsr_arch.py EDVRFeatureExtractor): frame
    features at three levels, PCD alignment of every frame to the centre
    one and TSA fusion (or a 1x1 fusion conv without TSA)."""

    def __init__(self, num_input_frame: int = 5, num_feat: int = 64,
                 num_in_ch: int = 3, deformable_groups: int = 8,
                 num_extract_block: int = 5, with_tsa: bool = True,
                 center_frame_idx: Optional[int] = None):
        super().__init__()
        self.center_frame_idx = (num_input_frame // 2
                                 if center_frame_idx is None
                                 else center_frame_idx)
        self.with_tsa = with_tsa
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.feature_extraction = nn.Sequential(*[
            ResidualBlockNoBN(num_feat) for _ in range(num_extract_block)])
        self.conv_l2_1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.conv_l2_2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_l3_1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.conv_l3_2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.pcd_align = PCDAlignment(num_feat, deformable_groups)
        if with_tsa:
            self.fusion = TSAFusion(num_feat, num_input_frame,
                                    self.center_frame_idx)
        else:
            self.fusion = nn.Conv2d(num_input_frame * num_feat, num_feat, 1,
                                    1, 0)

    def forward(self, x):
        """x: (B, T, C, H, W), H and W multiples of 4 -> the fused centre
        feature (B, num_feat, H, W)."""
        b, t, c, h, w = x.shape
        f1 = self.feature_extraction(lrelu(
            self.conv_first(x.reshape(-1, c, h, w))))
        f2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(f1))))
        f3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(f2))))
        levels = [f.reshape(b, t, *f.shape[1:]) for f in (f1, f2, f3)]
        ref = [f[:, self.center_frame_idx] for f in levels]
        aligned = torch.stack([self.pcd_align([f[:, i] for f in levels], ref)
                               for i in range(t)], dim=1)
        if self.with_tsa:
            return self.fusion(aligned)
        return self.fusion(aligned.reshape(b, -1, h, w))


@ARCH_REGISTRY.register()
class EDVR(EDVRFeatureExtractor, _Upsampler):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_frame: int = 5,
                 deformable_groups: int = 8, num_extract_block: int = 5,
                 num_reconstruct_block: int = 10,
                 center_frame_idx: Optional[int] = None,
                 with_tsa: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        # num_out_ch: the reference's signature; its tail writes 3 channels
        super().__init__(num_frame, num_feat, num_in_ch, deformable_groups,
                         num_extract_block, with_tsa, center_frame_idx)
        self.reconstruction = nn.Sequential(*[
            ResidualBlockNoBN(num_feat) for _ in range(num_reconstruct_block)])
        self._make_upsampler(num_feat)
        _build(self, device, dtype, generator)

    def forward(self, x):
        """x: (B, T, 3, H, W) -> the centre frame x4 (B, 3, 4H, 4W)."""
        feat = self.reconstruction(super().forward(x))
        return self.upsample(feat, x[:, self.center_frame_idx])


# -- BasicVSR++ (basicvsrpp_arch.py) --------------------------------------------

class SecondOrderDeformableAlignment(nn.Conv2d):
    """Modulated deformable 3x3 convolution of the stacked (n-1, n-2)
    features whose offsets are residues (max_residue_magnitude * tanh) on
    top of the two flows, predicted by `conv_offset` from the warped
    features and the flows."""

    def __init__(self, cin: int, cout: int, deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0):
        super().__init__(cin, cout, 3, 1, 1)
        self.deformable_groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * cout + 4, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, 27 * deformable_groups, 3, 1, 1))

    def forward(self, x, extra_feat, flow_1, flow_2):
        feat = torch.cat([extra_feat, flow_1, flow_2], 1)
        for i in (0, 2, 4):
            feat = lrelu(self.conv_offset[i](feat))
        o1, o2, mask = torch.chunk(self.conv_offset[6](feat), 3,
                                   dim=1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2],
                                                                   1))
        off1, off2 = torch.chunk(offset, 2, dim=1)
        # the flows' (dx, dy) as the taps' (y, x) offsets
        off1 = off1 + flow_1.flip(1).repeat(1, off1.shape[1] // 2, 1, 1)
        off2 = off2 + flow_2.flip(1).repeat(1, off2.shape[1] // 2, 1, 1)
        return deform_conv2d(x, torch.cat([off1, off2], 1), self.weight,
                             self.bias, padding=1,
                             deformable_groups=self.deformable_groups,
                             mask=torch.sigmoid(mask))


@ARCH_REGISTRY.register()
class BasicVSRPlusPlus(_Upsampler):
    MODULES = ("backward_1", "forward_1", "backward_2", "forward_2")

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10.0,
                 deformable_groups: int = 16, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mid_channels = mid_channels
        self.spynet = SpyNet(device="cpu")
        self.feat_extract = ConvResidualBlocks(3, mid_channels, 5)
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, m in enumerate(self.MODULES):
            self.deform_align[m] = SecondOrderDeformableAlignment(
                2 * mid_channels, mid_channels, deformable_groups,
                max_residue_magnitude)
            self.backbone[m] = ConvResidualBlocks((2 + i) * mid_channels,
                                                  mid_channels, num_blocks)
        self.reconstruction = ConvResidualBlocks(5 * mid_channels,
                                                 mid_channels, 5)
        self._make_upsampler(mid_channels)
        _build(self, device, dtype, generator)

    def propagate(self, feats: Dict[str, List[torch.Tensor]], flows,
                  module: str):
        """One direction of one iteration: second-order propagation with
        deformable alignment, each frame's feature joined with the earlier
        branches' at that frame."""
        t = len(feats["spatial"])
        frame_idx = list(range(t))
        flow_idx = list(range(-1, t - 1))
        if module.startswith("backward"):
            frame_idx = flow_idx = frame_idx[::-1]
        out = feats[module] = []
        feat_prop = feats["spatial"][0].new_zeros(
            feats["spatial"][0].shape[0], self.mid_channels,
            *feats["spatial"][0].shape[2:])
        for i, idx in enumerate(frame_idx):
            feat_current = feats["spatial"][idx]
            if i > 0:
                flow_n1 = flows[:, flow_idx[i]]
                cond_n1 = warp(feat_prop, flow_n1)
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = out[-2]
                    flow_n2 = flows[:, flow_idx[i - 1]]
                    flow_n2 = flow_n1 + warp(flow_n2, flow_n1)
                    cond_n2 = warp(feat_n2, flow_n2)
                cond = torch.cat([cond_n1, feat_current, cond_n2], 1)
                feat_prop = self.deform_align[module](
                    torch.cat([feat_prop, feat_n2], 1), cond, flow_n1,
                    flow_n2)
            feat = torch.cat([feat_current]
                             + [feats[k][idx] for k in feats
                                if k not in ("spatial", module)]
                             + [feat_prop], 1)
            feat_prop = feat_prop + self.backbone[module](feat)
            out.append(feat_prop)
        if module.startswith("backward"):
            out.reverse()

    def forward(self, lqs):
        """lqs: (B, T, 3, H, W) -> (B, T, 3, 4H, 4W)."""
        b, t, c, h, w = lqs.shape
        sp = self.feat_extract(lqs.reshape(-1, c, h, w)).reshape(b, t, -1, h,
                                                                 w)
        feats = {"spatial": [sp[:, i] for i in range(t)]}
        flows_forward, flows_backward = spynet_flows(self.spynet, lqs)
        for m in self.MODULES:
            self.propagate(feats, flows_backward if m.startswith("backward")
                           else flows_forward, m)
        outs = []
        for i in range(t):
            hr = self.reconstruction(torch.cat([feats[k][i] for k in (
                "spatial",) + self.MODULES], 1))
            outs.append(self.upsample(hr, lqs[:, i]))
        return torch.stack(outs, dim=1)


# -- IconVSR (basicvsr_arch.py) -------------------------------------------------

@ARCH_REGISTRY.register()
class IconVSR(_Upsampler):
    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 keyframe_stride: int = 5, temporal_padding: int = 2,
                 device="cuda", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if temporal_padding not in (2, 3):
            raise ValueError("temporal_padding is 2 or 3")
        self.num_feat, self.keyframe_stride = num_feat, keyframe_stride
        self.temporal_padding = temporal_padding
        self.edvr = EDVRFeatureExtractor(temporal_padding * 2 + 1, num_feat)
        self.spynet = SpyNet(device="cpu")
        self.backward_fusion = nn.Conv2d(2 * num_feat, num_feat, 3, 1, 1)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_fusion = nn.Conv2d(2 * num_feat, num_feat, 3, 1, 1)
        self.forward_trunk = ConvResidualBlocks(2 * num_feat + 3, num_feat,
                                                num_block)
        self._make_upsampler(num_feat)
        _build(self, device, dtype, generator)

    def keyframe_features(self, x, keyframe_idx):
        """The EDVR feature of each keyframe over its 2 * temporal_padding
        + 1 neighbours, the clip mirrored at both ends."""
        tp = self.temporal_padding
        head, tail = ([4, 3], [-4, -5]) if tp == 2 else ([6, 5, 4],
                                                         [-5, -6, -7])
        xp = torch.cat([x[:, head], x, x[:, tail]], dim=1)
        return {i: self.edvr(xp[:, i:i + 2 * tp + 1]) for i in keyframe_idx}

    def forward(self, x):
        """x: (B, T, 3, H, W), T >= 2 * temporal_padding + 1 -> (B, T, 3,
        4H, 4W). H and W are reflect-padded to multiples of 4 and the
        output cropped back."""
        b, n, c, h_in, w_in = x.shape
        pad_h, pad_w = (4 - h_in % 4) % 4, (4 - w_in % 4) % 4
        if pad_h or pad_w:
            x = F.pad(x.reshape(-1, c, h_in, w_in), (0, pad_w, 0, pad_h),
                      mode="reflect").reshape(b, n, c, h_in + pad_h,
                                              w_in + pad_w)
        h, w = x.shape[3], x.shape[4]
        keyframe_idx = list(range(0, n, self.keyframe_stride))
        if keyframe_idx[-1] != n - 1:
            keyframe_idx.append(n - 1)
        flows_forward, flows_backward = spynet_flows(self.spynet, x)
        feats_key = self.keyframe_features(x, keyframe_idx)

        out_l: List[torch.Tensor] = [None] * n
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = warp(feat_prop, flows_backward[:, i])
            if i in feats_key:
                feat_prop = self.backward_fusion(torch.cat(
                    [feat_prop, feats_key[i]], 1))
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop],
                                                      1))
            out_l[i] = feat_prop
        feat_prop = torch.zeros_like(feat_prop)
        outs = []
        for i in range(n):
            if i > 0:
                feat_prop = warp(feat_prop, flows_forward[:, i - 1])
            if i in feats_key:
                feat_prop = self.forward_fusion(torch.cat(
                    [feat_prop, feats_key[i]], 1))
            feat_prop = self.forward_trunk(torch.cat(
                [x[:, i], out_l[i], feat_prop], 1))
            outs.append(self.upsample(feat_prop, x[:, i]))
        return torch.stack(outs, dim=1)[..., :4 * h_in, :4 * w_in]
