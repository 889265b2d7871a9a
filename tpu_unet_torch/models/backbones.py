"""Encoder feature pyramids (counterparts of ``tpu_unet/models/backbones.py``).

``VGG16``: cfg 'D', no batch norm, five features at strides 1/2/4/8/16 with
64/128/256/512/512 channels.  ``features`` is the reference
``nn.Sequential`` (convs at indices 0, 2, 5, …, 28, ReLUs and pools
between), so the state dict carries the reference key names
``features.{i}.weight``.  The forward does not run the Sequential: stage 1
goes to the stem kernel wrapper and stages 2-5 to the encoder-block wrapper,
NHWC throughout.  In training (``train=True``) the route decides
(``train/step.py::StepConfig.train_route``): ``"paired"``, as JAX's paired
training region (``fused_stem_train``, models/backbones.py:79-145), trains
each stage the kernels tile through its training kernels
(``kernels/encoder_train.py``: kernel forward keeping the intermediates,
one backward kernel); ``"fused"`` and any untileable stage run the plain
composition under autograd (cuDNN convs), as JAX's step does without the
paired region.

``ResNet50``: five features at strides 2/4/8/16/32 with 64/256/512/1024/2048
channels, module names of the reference (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1,2,3}``, ``.bn{1,2,3}``, ``.downsample.{0,1}``).
The JAX package runs it outside any Pallas kernel, so it is plain PyTorch
here: ``F.conv2d`` on channels-last views of the NHWC tensors, batch norm
through ``nn/blocks.py::bn`` (eval: the running statistics; ``train=True``:
flax's train mode, the batch statistics in float32 updating the running
ones in place), and the ceil-mode max-pool; in training autograd takes
their backward (cuDNN's convs, the pool's first-max routing), on both
training routes.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.kernels.encoder import vgg_block, vgg_block_plain
from tpu_unet_torch.kernels.encoder_train import (vgg_block_train, vgg_block_train_ok,
                                                  vgg_stem_train)
from tpu_unet_torch.kernels.stem import vgg_stem, vgg_stem_plain, vgg_stem_shape_ok
from tpu_unet_torch.nn.blocks import BN_EPS, bn, max_pool_ceil

# cfg 'D' (reference: nets/vgg.py:59)
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512, "M"]
# torch Sequential indices of each stage's convs
_STAGES = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
# bottlenecks in ResNet50's layer1..4
RESNET50_BLOCKS = (3, 4, 6, 3)


def _make_features() -> nn.Sequential:
    layers, cin = [], 3
    for v in _CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, v, kernel_size=3, padding=1),
                       nn.ReLU(inplace=True)]
            cin = v
    return nn.Sequential(*layers)


class VGG16(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = _make_features()

    def _wb(self, idx):
        convs = [self.features[i] for i in idx]
        return [c.weight for c in convs], [c.bias for c in convs]

    def forward(self, x: torch.Tensor, train: bool = False, route: str = "paired"):
        """(B, H, W, 3) uint8 or float image → [feat1 … feat5], NHWC."""
        kernels = train and route == "paired"
        (w0, w2), (b0, b2) = self._wb(_STAGES[0])
        stem = vgg_stem_plain if train else vgg_stem
        if kernels and vgg_stem_shape_ok(x.shape[1], x.shape[2], w0.shape[0]):
            stem = vgg_stem_train
        feat1, x = stem(x, w0, b0, w2, b2)
        feats = [feat1]
        for si, idx in enumerate(_STAGES[1:], start=1):
            ws, bs = self._wb(idx)
            block = vgg_block_plain if train else vgg_block
            chans = [x.shape[-1]] + [w.shape[0] for w in ws]
            if kernels and vgg_block_train_ok(x.shape[1], x.shape[2], chans):
                block = vgg_block_train
            skip, pooled = block(x, ws, bs, pool=si < len(_STAGES) - 1)
            feats.append(skip)
            x = pooled
        return feats


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
    return (nn.Conv2d(cin, cout, k, stride, padding, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS))


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (stride) → 1×1 expand ×4, residual
    (reference: nets/resnet.py:55-97).  NCHW channels-last in and out."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 1)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride, 1)
        self.conv3, self.bn3 = _conv_bn(planes, planes * 4, 1)
        self.downsample = nn.Sequential(
            *_conv_bn(inplanes, planes * 4, 1, stride)) if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(bn(self.conv1(x), self.bn1, train))
        y = torch.relu(bn(self.conv2(y), self.bn2, train))
        y = bn(self.conv3(y), self.bn3, train)
        identity = x if self.downsample is None else \
            bn(self.downsample[0](x), self.downsample[1], train)
        return torch.relu(y + identity)


class ResNet50(nn.Module):
    """5-stage ResNet50 feature pyramid (reference: nets/resnet.py:100-185)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(3, 64, 7, 2, 3)
        inplanes = 64
        for li, (blocks, planes) in enumerate(zip(RESNET50_BLOCKS, (64, 128, 256, 512))):
            stride = 1 if li == 0 else 2
            mods = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                ds = bi == 0 and (s != 1 or inplanes != planes * 4)
                mods.append(Bottleneck(inplanes, planes, s, ds))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor, train: bool = False):
        """(B, H, W, 3) float image → [feat1 … feat5], NHWC contiguous;
        ``train`` as flax's ``ResNet50.__call__(x, train)``
        (models/backbones.py:229-246)."""
        y = x.permute(0, 3, 1, 2)  # channels-last view, no copy
        feat1 = torch.relu(bn(self.conv1(y), self.bn1, train)).permute(0, 2, 3, 1)
        y = max_pool_ceil(feat1, 3, 2).permute(0, 3, 1, 2)
        feats = [feat1.contiguous()]
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                y = block(y, train)
            feats.append(y.permute(0, 2, 3, 1).contiguous())
        return feats
