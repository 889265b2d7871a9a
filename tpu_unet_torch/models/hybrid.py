"""HybridEfficientSeg (counterpart of ``tpu_unet/models/hybrid.py``;
reference: nets/HybridEfficientSeg.py:93-150): STDC blocks down (2×2 max-pool
between stages), an STDC bridge with Dropout2d 0.2 (``train=True`` only,
drawn from ``generator``), DW-separable decoder blocks up (align-corners
resize to the skip's size, concat [up, skip]), a DWSeparableBNReLU and a
1×1 classifier, resized to the input with align corners.  Plain PyTorch, as
the JAX package runs it outside any Pallas kernel.  NHWC in and out; keys
``enc{i}``, ``bridge``, ``dec{i}``, ``final_conv.{0,1}``.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.nn.blocks import (DecoderBlock, DWSeparableBNReLU, STDCBlock, conv1x1,
                                      dropout2d)
from tpu_unet_torch.nn.resize import resize_bilinear

_WIDTHS = (32, 64, 128, 256, 512)


class HybridEfficientSeg(nn.Module):
    def __init__(self, num_classes: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = 0.2  # Dropout2d on the bridge, in train mode
        c1, c2, c3, c4, cb = _WIDTHS
        cin = 3
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"enc{i}", STDCBlock(cin, c))
            cin = c
        self.bridge = STDCBlock(c4, cb)
        prev = cb
        for i, c in zip((4, 3, 2, 1), (c4, c3, c2, c1)):
            setattr(self, f"dec{i}", DecoderBlock(prev + c, c))
            prev = c
        self.final_conv = nn.Sequential(DWSeparableBNReLU(c1, c1), nn.Conv2d(c1, num_classes, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        encs, h = [], x
        for i in range(1, 5):
            if i > 1:
                h = max_pool2x2(h)
            h = getattr(self, f"enc{i}")(h, train)
            encs.append(h)
        h = self.bridge(max_pool2x2(h), train)
        h = dropout2d(h, self.dropout, generator, train)
        for i in (4, 3, 2, 1):
            skip = encs[i - 1]
            up = resize_bilinear(h, skip.shape[1:3], align_corners=True)
            h = getattr(self, f"dec{i}")(up, skip, train)
        logits = conv1x1(self.final_conv[1], self.final_conv[0](h, train))
        return resize_bilinear(logits, x.shape[1:3], align_corners=True)


def hybrid_efficientseg(num_classes: int = 3) -> HybridEfficientSeg:
    return HybridEfficientSeg(num_classes)
