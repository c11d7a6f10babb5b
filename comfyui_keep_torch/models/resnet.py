"""torchvision's ResNet50 feature body (bottleneck v1.5), the RetinaFace-
ResNet50 backbone, ported from comfyui_keep_tpu/models/resnet.py.

The reference builds torchvision's resnet50 and taps layer2/3/4 through
IntermediateLayerGetter, so the module names (conv1, bn1, layer1.0.conv1,
layer1.0.downsample.0, ...) are torchvision's and detection_Resnet50_Final.pth
loads as it is. BatchNorm runs in its inference form; NCHW.
"""
from typing import Tuple

from torch import nn

from comfyui_keep_torch.ops import batch_norm, conv2d, max_pool, relu

EXPANSION = 4
LAYERS_50 = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        cout = width * EXPANSION
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        h = relu(batch_norm(conv2d(x, self.conv1.weight), self.bn1))
        h = relu(batch_norm(conv2d(h, self.conv2.weight, stride=self.stride,
                                   padding=1), self.bn2))
        h = batch_norm(conv2d(h, self.conv3.weight), self.bn3)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = batch_norm(conv2d(x, conv.weight, stride=self.stride), bn)
        return relu(x + h)


class ResNet50Body(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (blocks, width, stride) in enumerate(
                zip(LAYERS_50, (64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, width, stride if bi == 0 else 1))
                cin = width * EXPANSION
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x) -> Tuple:
        """(B, 3, H, W) -> (layer2, layer3, layer4) features: 512, 1024 and
        2048 channels at strides 8, 16 and 32."""
        h = relu(batch_norm(conv2d(x, self.conv1.weight, stride=2, padding=3),
                            self.bn1))
        h = max_pool(h, 3, 2, 1)
        outs = []
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
            if li >= 2:
                outs.append(h)
        return tuple(outs)
