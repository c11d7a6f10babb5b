"""VGG feature extractor for perceptual losses and DFDNet (reference
archs/vgg_arch.py), ported from comfyui_keep_tpu/models/vgg.py.

torchvision's VGG19 / VGG16 topology with named layers ('conv1_1' ...
'pool5'); the forward returns the activations of the requested layers and
stops after the deepest. Keys are the reference's: `vgg_net.conv1_1.weight`
and the input normalisation's `mean` / `std` buffers. Every convolution is
built whatever the layers asked for (as in the JAX package); weights load
from torchvision's `features.N.*` state dicts with `from_torchvision`.
"""
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from comfyui_keep_torch.models.init import default_init_, finish
from comfyui_keep_torch.ops import max_pool, relu
from comfyui_keep_torch.utils.registry import ARCH_REGISTRY

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
CFGS = {"vgg19": VGG19_CFG, "vgg16": VGG16_CFG}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def layer_names(cfg) -> List[str]:
    """conv / relu / pool names in order: a name's index is its layer's
    index in torchvision's `features`."""
    names, block, conv_i = [], 1, 0
    for v in cfg:
        if v == "M":
            names.append(f"pool{block}")
            block += 1
            conv_i = 0
        else:
            conv_i += 1
            names += [f"conv{block}_{conv_i}", f"relu{block}_{conv_i}"]
    return names


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    JAX_ABSENT = ("mean", "std")

    def __init__(self, layer_name_list: Sequence[str] = ("relu5_4",),
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = CFGS[vgg_type]
        self.names = layer_names(self.cfg)
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm, self.range_norm = use_input_norm, range_norm
        layers, cin = OrderedDict(), 3
        convs = [n for n in self.names if n.startswith("conv")]
        for name, cout in zip(convs, [v for v in self.cfg if v != "M"]):
            layers[name] = nn.Conv2d(cin, cout, 3, 1, 1)
            cin = cout
        self.vgg_net = nn.Sequential(layers)
        if use_input_norm:
            self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
                1, 3, 1, 1))
            self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
                1, 3, 1, 1))
        if generator is not None:
            default_init_(self, generator)
        finish(self, device, dtype)

    def forward(self, x, layer_name_list: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
        """x: (B, 3, H, W) in [0, 1] ([-1, 1] with range_norm) -> {name:
        activation} for the layers of layer_name_list (the module's own
        unless given: PerceptualLoss and LPIPSLoss name theirs)."""
        wanted = set(layer_name_list or self.layer_name_list)
        deepest = max(self.names.index(n) for n in wanted)
        if self.range_norm:
            x = (x + 1) / 2
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        out = {}
        for name in self.names[:deepest + 1]:
            if name.startswith("conv"):
                x = getattr(self.vgg_net, name)(x)
            elif name.startswith("relu"):
                x = relu(x)
            else:
                x = max_pool(x, 2, 2)
            if name in wanted:
                out[name] = x
        return out

    def from_torchvision(self, sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """torchvision `features.N.weight` / `.bias` -> this module's state
        dict (the input normalisation's buffers as they are)."""
        out = {k: v for k, v in self.state_dict().items()
               if not k.startswith("vgg_net.")}
        for k, v in sd.items():
            part, idx, leaf = k.split(".")
            if part == "features":
                out[f"vgg_net.{self.names[int(idx)]}.{leaf}"] = v
        return out
