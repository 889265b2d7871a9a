"""ImprovedUltraLightweightUnet (counterpart of ``tpu_unet/models/improved.py``;
reference: nets/ImprovedUltraLightweightUnet.py:67-141): the ladder skeleton
whose stages are LightConvBlock (mid floor 8) + SE at ``se_light``, whose
decoder merges the resized deep map and the skip through a FeatureFusion
(concat → 1×1 → SE) before each stage, with 1×1 aux heads on dec4 / dec3 /
dec2.  Every head is resized to the input with align corners.  With
``train=True`` it returns ``(final, aux4, aux3, aux2)``, else ``final``; the
aux heads always exist.  Plain PyTorch, as the JAX package runs it outside
any Pallas kernel.  Modules are registered in flax's creation order (each
``fusion{i}`` before its ``dec{i}``, the aux heads after ``final``), so
``model.modules()`` lists convs and batch norms as flax's tree does.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.nn.blocks import SE, FeatureFusion, LightConvBlock, conv1x1, se_light
from tpu_unet_torch.nn.resize import resize_bilinear

_WIDTHS = (32, 64, 128, 256, 512)


class SELightBlock(LightConvBlock):
    """LightConvBlock (mid floor 8) then SE at ``se_light`` (reference:
    nets/ImprovedUltraLightweightUnet.py:35-52); keys ``conv.*``, ``se.*``."""

    def __init__(self, in_size: int, features: int):
        super().__init__(in_size, features, 8)
        self.se = SE(features, se_light(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.se(super().forward(x, train))


class ImprovedUltraLightweightUnet(nn.Module):
    def __init__(self, num_classes: int = 21):
        super().__init__()
        self.num_classes = num_classes
        c1, c2, c3, c4, cb = _WIDTHS
        cin = 3
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"enc{i}", SELightBlock(cin, c))
            cin = c
        self.bridge = SELightBlock(c4, cb)
        prev = cb
        for i, c in zip((4, 3, 2, 1), (c4, c3, c2, c1)):
            setattr(self, f"fusion{i}", FeatureFusion(prev + c, c))
            setattr(self, f"dec{i}", SELightBlock(c, c))
            prev = c
        self.final = nn.Conv2d(c1, num_classes, 1)
        for i, c in ((4, c4), (3, c3), (2, c2)):
            setattr(self, f"aux_out{i}", nn.Conv2d(c, num_classes, 1))

    @staticmethod
    def _head(conv: nn.Conv2d, h: torch.Tensor, size) -> torch.Tensor:
        return resize_bilinear(conv1x1(conv, h), size, align_corners=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        """(B, H, W, 3) float image → logits (B, H, W, C); with ``train``
        also the three aux heads' (this model has no dropout:
        ``generator`` is not read)."""
        encs, h = [], x
        for i in range(1, 5):
            if i > 1:
                h = max_pool2x2(h)
            h = getattr(self, f"enc{i}")(h, train)
            encs.append(h)
        h = self.bridge(max_pool2x2(h), train)
        decs = {}
        for i in (4, 3, 2, 1):
            skip = encs[i - 1]
            up = resize_bilinear(h, skip.shape[1:3], align_corners=True)
            h = getattr(self, f"dec{i}")(getattr(self, f"fusion{i}")(up, skip), train)
            decs[i] = h
        size = x.shape[1:3]
        final = self._head(self.final, decs[1], size)
        if not train:
            return final
        return (final, *(self._head(getattr(self, f"aux_out{i}"), decs[i], size)
                         for i in (4, 3, 2)))


def improved_ultralight(num_classes: int = 21) -> ImprovedUltraLightweightUnet:
    return ImprovedUltraLightweightUnet(num_classes)
