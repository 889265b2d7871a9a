"""LadderUNet — the encoder / bridge / decoder skeleton of the
UltraLightweight family (counterpart of ``tpu_unet/models/ladder.py``):

    enc1..enc4 (each optionally followed by SE), 2×2 max-pool between stages
    bridge, then Dropout2d at the model's rate (``train=True`` only)
    dec4..dec1: align-corners resize to the skip's size, concat [up, skip],
                block
    1×1 final conv → align-corners resize to the input size

Six configurations: ``ultralight``, ``ultralight_large``,
``ultralight_large_optimized`` (the DataB submission model, 926,347
parameters at 4 classes), ``ultralight44``, ``sk_ultralight`` (the
``"sk"`` kind, LightSKBlock) and ``repvgg_segnet`` (the ``"repvgg"`` kind,
RepVGGStem, with its ``deploy`` form; ``"fusedmb"`` with
``use_repvgg=False``).  NHWC in and out; module names follow
the reference torch models (``enc{i}``, ``se{i}``, ``bridge``, ``dec{i}``,
``final``).  Plain PyTorch: the JAX package runs these models outside any
Pallas kernel; the serving step's class mask is the ``argmax_mask`` kernel,
the training loss the logit-level loss kernels (``kernels/loss.py``, #25 /
#26).  ``train=True`` is the training forward (JAX's ``__call__(x,
train)``): batch norm on the batch statistics, the bridge's Dropout2d drawn
from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.nn.blocks import (SE, LightConvBlock, LightSKBlock, RepVGGStem, conv1x1,
                                      dropout2d, se_light, se_light_large, se_lightweight)
from tpu_unet_torch.nn.resize import resize_bilinear

_SE_RULES = {"light": se_light, "light_large": se_light_large,
             "lightweight": se_lightweight}


def _make_block(kind: str, in_size: int, features: int, deploy: bool) -> nn.Module:
    """The stage block of ``kind`` (JAX ``models/ladder.py::_make_block``)."""
    if kind == "light8":
        return LightConvBlock(in_size, features, 8)
    if kind == "light16":
        return LightConvBlock(in_size, features, 16)
    if kind == "sk":
        return LightSKBlock(in_size, features)
    if kind == "repvgg":
        return RepVGGStem(in_size, features, use_repvgg=True, deploy=deploy)
    if kind == "fusedmb":
        return RepVGGStem(in_size, features, use_repvgg=False)
    raise ValueError(f"unknown block kind {kind!r}")


class LadderUNet(nn.Module):
    def __init__(self, num_classes: int, channels: Tuple[int, int, int, int, int],
                 block: str = "light8", se: Optional[str] = None,
                 dropout: float = 0.0, deploy: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = dropout  # Dropout2d on the bridge, in train mode
        c1, c2, c3, c4, cb = channels
        cin = 3
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"enc{i}", _make_block(block, cin, c, deploy))
            cin = c
        self.se = se
        if se is not None:
            for i, c in enumerate((c1, c2, c3, c4), start=1):
                setattr(self, f"se{i}", SE(c, _SE_RULES[se](c)))
        self.bridge = _make_block(block, c4, cb, deploy)
        prev = cb
        for i, c in zip((4, 3, 2, 1), (c4, c3, c2, c1)):
            setattr(self, f"dec{i}", _make_block(block, prev + c, c, deploy))
            prev = c
        self.final = nn.Conv2d(c1, num_classes, 1)

    def forward(self, x: torch.Tensor, features_out: bool = False, train: bool = False,
                generator: torch.Generator | None = None):
        """(B, H, W, 3) float image → logits (B, H, W, C); with
        ``features_out`` the (B, H, W, c1) features before ``final``."""
        encs = []
        h = x
        for i in range(1, 5):
            if i > 1:
                h = max_pool2x2(h)
            h = getattr(self, f"enc{i}")(h, train)
            if self.se is not None:
                h = getattr(self, f"se{i}")(h)
            encs.append(h)
        h = self.bridge(max_pool2x2(h), train)
        h = dropout2d(h, self.dropout, generator, train)
        for i in (4, 3, 2, 1):
            skip = encs[i - 1]
            up = resize_bilinear(h, skip.shape[1:3], align_corners=True)
            h = getattr(self, f"dec{i}")(torch.cat([up, skip], dim=-1), train)
        if features_out:
            return h
        return resize_bilinear(conv1x1(self.final, h), x.shape[1:3], align_corners=True)


def ultralight(num_classes: int = 21) -> LadderUNet:
    """UltraLightweightUnet (reference: nets/UltraLightweightUnet.py:57-107;
    its Dropout2d(0.1) is defined but never applied)."""
    return LadderUNet(num_classes, (32, 64, 128, 256, 512), block="light8")


def ultralight_large(num_classes: int = 21) -> LadderUNet:
    """UltraLightweightUnet_large (reference:
    nets/UltraLightweightUnet_large.py:55-111)."""
    return LadderUNet(num_classes, (64, 128, 256, 512, 1024), block="light16",
                      se="light_large", dropout=0.2)


def ultralight_large_optimized(num_classes: int = 21) -> LadderUNet:
    """UltraLightweightUnet_large_optimized, the DataB submission model
    (reference: nets/UltraLightweightUnet_large_optimized.py:51-103)."""
    return LadderUNet(num_classes, (44, 88, 176, 352, 704), block="light16",
                      se="light_large", dropout=0.15)


def ultralight44(num_classes: int = 21) -> LadderUNet:
    """The 44-wide clone in nets/SegNets.py:673-729 (LightweightSEBlock SE
    rule, mid floor 16)."""
    return LadderUNet(num_classes, (44, 88, 176, 352, 704), block="light16",
                      se="lightweight", dropout=0.15)


def sk_ultralight(num_classes: int = 21) -> LadderUNet:
    """SK_UltraLightweightUnet (reference: nets/SK_UltraLightweightUnet.py:85-141)."""
    return LadderUNet(num_classes, (44, 88, 176, 352, 704), block="sk",
                      se="light_large", dropout=0.15)


def repvgg_segnet(num_classes: int = 21, use_repvgg: bool = True,
                  deploy: bool = False) -> LadderUNet:
    """ImprovedSegNet, the RepVGG-block UNet (reference: nets/RepVGG_Unet.py:150-207);
    ``deploy=True`` is the folded form (``models/repvgg.py::fold_repvgg``),
    ``use_repvgg=False`` the FusedMBConv variant."""
    return LadderUNet(num_classes, (44, 88, 176, 352, 704),
                      block="repvgg" if use_repvgg else "fusedmb",
                      se="light_large", dropout=0.15, deploy=deploy)
