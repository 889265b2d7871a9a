"""The OptimizedBalancedSeg family (counterpart of
``tpu_unet/models/balancedseg.py``; reference: nets/SegNets.py): a
multi-scale encoder (OptimizedMultiScaleBlock stages ``enc1``..``enc4`` with
2×2 max-pools between, a multi-scale ``bridge`` with Dropout2d 0.1 drawn from
``generator`` in train mode) and an efficient-attention decoder, in four
flavours:

- ``balancedseg`` (nets/SegNets.py:607-670): SE after each encoder stage,
  the decoder resizes with torch's default *nearest* rule (the reference's
  quirk, ``nn/resize.py::resize_nearest``), dec4 concatenates enc4, a
  spatial attention after each decoder stage, an aux head on enc3; with
  ``train=True`` it returns ``(final, aux)``.  The reference also builds
  CBAM and edge-enhancement modules it never applies: as in the JAX
  package, the port builds neither (``infer/convert.py::load_state_dict``
  skips their keys in a reference checkpoint);
- ``balancedseg_fpn`` (:533-604): 1×1 laterals added into each decoder
  output, dec4 takes no skip, an edge-enhancement residual before the
  final conv, align-corners resizes;
- ``balancedseg_fpn_sup`` (:438-526): the FPN with deep supervision, 1×1
  aux heads on dec3 / dec2 / dec1; with ``train=True`` it returns
  ``(final, aux1, aux2, aux3)``;
- ``balancedseg_crfs`` (:864-925): a CRFS attention after each decoder
  stage, the edge-enhancement residual.

Plain PyTorch, as the JAX package runs these models outside any Pallas
kernel.  NHWC in and out.  Modules are registered in flax's creation order
(the FPN's aux heads 3, 2, 1), so ``model.modules()`` lists convs and batch
norms as flax's tree does.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.nn.blocks import (SE, CRFSAttention, DWConvBNReLU,
                                      EdgeEnhancementBlock, EfficientDecoderBlock,
                                      LightweightSpatialAttention, OptimizedMultiScaleBlock,
                                      conv1x1, dropout2d, se_lightweight)
from tpu_unet_torch.nn.resize import resize_bilinear, resize_nearest

_WIDTHS = (32, 64, 128, 256, 512)
# the reference checkpoint's modules that no forward applies (not built)
UNUSED_REFERENCE_KEYS = ("enc1_cbam.", "enc2_cbam.", "enc3_cbam.", "enc4_cbam.",
                         "edge_enhancement.")


class _BalancedBase(nn.Module):
    """The shared encoder: ``enc1``..``enc4``, ``bridge.0`` (Dropout2d 0.1 at
    ``bridge.1``, as the reference's ``nn.Sequential``)."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = 0.1  # Dropout2d on the bridge, in train mode
        cin = 3
        for i, c in enumerate(_WIDTHS[:4], start=1):
            setattr(self, f"enc{i}", OptimizedMultiScaleBlock(cin, c))
            cin = c
        self.bridge = nn.Sequential(OptimizedMultiScaleBlock(_WIDTHS[3], _WIDTHS[4]),
                                    nn.Dropout2d(self.dropout))

    def _encode(self, x, train, generator, se: bool = False):
        encs, h = [], x
        for i in range(1, 5):
            if i > 1:
                h = max_pool2x2(h)
            h = getattr(self, f"enc{i}")(h, train)
            if se:
                h = getattr(self, f"enc{i}_se")(h)
            encs.append(h)
        h = self.bridge[0](max_pool2x2(h), train)
        return encs, dropout2d(h, self.dropout, generator, train)


class OptimizedBalancedSeg(_BalancedBase):
    def __init__(self, num_classes: int = 3):
        super().__init__(num_classes)
        c1, c2, c3, c4, cb = _WIDTHS
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"enc{i}_se", SE(c, se_lightweight(c)))
        prev = cb
        for i, c in zip((4, 3, 2, 1), (c4, c3, c2, c1)):
            setattr(self, f"dec{i}", EfficientDecoderBlock(prev + c, c))
            setattr(self, f"dec{i}_spa", LightweightSpatialAttention())
            prev = c
        self.final_conv = nn.Sequential(DWConvBNReLU(c1, c1), nn.Conv2d(c1, num_classes, 1))
        self.aux_head = nn.Conv2d(c3, num_classes, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        encs, h = self._encode(x, train, generator, se=True)
        for i in (4, 3, 2, 1):
            skip = encs[i - 1]
            up = resize_nearest(h, skip.shape[1:3])
            h = getattr(self, f"dec{i}_spa")(getattr(self, f"dec{i}")(up, skip, train))
        final = conv1x1(self.final_conv[1], self.final_conv[0](h, train))
        final = resize_nearest(final, x.shape[1:3])
        if not train:
            return final
        return final, resize_nearest(conv1x1(self.aux_head, encs[2]), x.shape[1:3])


class _FPNBase(_BalancedBase):
    """The shared FPN decoder (nets/SegNets.py:533-604)."""

    def __init__(self, num_classes: int, supervision: bool):
        super().__init__(num_classes)
        c1, c2, c3, c4, cb = _WIDTHS
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"lateral{i}", nn.Conv2d(c, c, 1))
        prev = cb
        for i, c in zip((4, 3, 2, 1), (c4, c3, c2, c1)):
            # dec4 takes no concat skip (nets/SegNets.py:587)
            setattr(self, f"dec{i}", EfficientDecoderBlock(prev + (c if i < 4 else 0), c))
            prev = c
        self.edge_enhancement = EdgeEnhancementBlock(c1, c1)
        self.final_conv = nn.Sequential(DWConvBNReLU(c1, c1), nn.Conv2d(c1, num_classes, 1))
        self.supervision = supervision
        if supervision:
            for i, c in ((3, c3), (2, c2), (1, c1)):
                setattr(self, f"aux_output{i}", nn.Conv2d(c, num_classes, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        encs, h = self._encode(x, train, generator)
        lats = [conv1x1(getattr(self, f"lateral{i}"), encs[i - 1]) for i in range(1, 5)]
        decs = {}
        for i in (4, 3, 2, 1):
            skip = encs[i - 1]
            up = resize_bilinear(h, skip.shape[1:3], align_corners=True)
            h = getattr(self, f"dec{i}")(up, skip if i < 4 else None, train)
            h = resize_bilinear(lats[i - 1], h.shape[1:3], align_corners=True) + h
            decs[i] = h
        h = h + self.edge_enhancement(h, train)
        final = conv1x1(self.final_conv[1], self.final_conv[0](h, train))
        size = x.shape[1:3]
        final = resize_bilinear(final, size, align_corners=True)
        if not (self.supervision and train):
            return final
        return (final, *(resize_bilinear(conv1x1(getattr(self, f"aux_output{i}"), decs[i]), size,
                                         align_corners=True) for i in (1, 2, 3)))


class OptimizedBalancedSegWithFPN(_FPNBase):
    def __init__(self, num_classes: int = 3):
        super().__init__(num_classes, supervision=False)


class OptimizedBalancedSegWithFPNSupervision(_FPNBase):
    def __init__(self, num_classes: int = 3):
        super().__init__(num_classes, supervision=True)


class OptimizedBalancedSegWithCRFS(_BalancedBase):
    def __init__(self, num_classes: int = 3):
        super().__init__(num_classes)
        c1, c2, c3, c4, cb = _WIDTHS
        prev = cb
        for i, c in zip((4, 3, 2, 1), (c4, c3, c2, c1)):
            setattr(self, f"dec{i}", EfficientDecoderBlock(prev + c, c))
            setattr(self, f"crfs_att{i}", CRFSAttention(c))
            prev = c
        self.edge_enhancement = EdgeEnhancementBlock(c1, c1)
        self.final_conv = nn.Sequential(DWConvBNReLU(c1, c1), nn.Conv2d(c1, num_classes, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        encs, h = self._encode(x, train, generator)
        for i in (4, 3, 2, 1):
            skip = encs[i - 1]
            up = resize_bilinear(h, skip.shape[1:3], align_corners=True)
            h = getattr(self, f"crfs_att{i}")(getattr(self, f"dec{i}")(up, skip, train))
        h = h + self.edge_enhancement(h, train)
        final = conv1x1(self.final_conv[1], self.final_conv[0](h, train))
        return resize_bilinear(final, x.shape[1:3], align_corners=True)


def balancedseg(num_classes: int = 3) -> OptimizedBalancedSeg:
    return OptimizedBalancedSeg(num_classes)


def balancedseg_fpn(num_classes: int = 3) -> OptimizedBalancedSegWithFPN:
    return OptimizedBalancedSegWithFPN(num_classes)


def balancedseg_fpn_sup(num_classes: int = 3) -> OptimizedBalancedSegWithFPNSupervision:
    return OptimizedBalancedSegWithFPNSupervision(num_classes)


def balancedseg_crfs(num_classes: int = 3) -> OptimizedBalancedSegWithCRFS:
    return OptimizedBalancedSegWithCRFS(num_classes)
