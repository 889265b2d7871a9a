"""LightweightUnet — SE-residual VGG-style encoder and residual decoder
(counterpart of ``tpu_unet/models/lightweight.py``; reference:
nets/LightWeightUnet.py:132-185).  Each encoder stage is ConvBlock →
ResidualBlock → 2×2 max-pool, so the first feature is already at stride 2
and the raw logits come out at half the input resolution, as in the
reference; the serving step and the single-image forward resize them, and
training takes the plain losses, which resize them too (as JAX, whose fused
loss needs logits at the target's size).  ``train=True`` is the training
forward: batch norm on the batch statistics and Dropout2d(0.1) after each
encoder stage (JAX's ``bdrop1-5``), each decoder stage and ``final_conv``'s
ConvBlock, drawn from ``generator``.  NHWC in and out; module names follow
the reference torch model (``backbone.stage{i}.{0,1}``,
``up_concat{i}.conv.{0,1}``, ``final_conv.{0,2,3}``).  Plain PyTorch.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.nn.blocks import ConvBNReLU, ResidualBlock, dropout2d
from tpu_unet_torch.nn.resize import upsample2x

_WIDTHS = (24, 48, 96, 192, 384)
_DROP = 0.1  # every Dropout2d of the model (reference: nets/LightWeightUnet.py)


class LightweightUnet(nn.Module):
    def __init__(self, num_classes: int = 21):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = nn.Module()
        cin = 3
        for i, c in enumerate(_WIDTHS, start=1):
            setattr(self.backbone, f"stage{i}", nn.Sequential(
                ConvBNReLU(cin, c), ResidualBlock(c), nn.MaxPool2d(2)))
            cin = c
        for i in (4, 3, 2, 1):
            c = _WIDTHS[i - 1]
            up = nn.Module()
            up.conv = nn.Sequential(ConvBNReLU(c + _WIDTHS[i], c), ResidualBlock(c),
                                    nn.Dropout2d(0.1))
            setattr(self, f"up_concat{i}", up)
        c = _WIDTHS[0]
        self.final_conv = nn.Sequential(ConvBNReLU(c, c), nn.Dropout2d(0.1),
                                        ResidualBlock(c), nn.Conv2d(c, num_classes, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, H, W, 3) float image → logits (B, H/2, W/2, C)."""
        feats = []
        h = x
        for i in range(1, 6):
            stage = getattr(self.backbone, f"stage{i}")
            h = max_pool2x2(stage[1](stage[0](h, train), train))
            feats.append(dropout2d(h, _DROP, generator, train))
        h = feats[4]
        for i in (4, 3, 2, 1):
            conv = getattr(self, f"up_concat{i}").conv
            h = torch.cat([feats[i - 1], upsample2x(h)], dim=-1)
            h = dropout2d(conv[1](conv[0](h, train), train), _DROP, generator, train)
        fc = self.final_conv
        h = fc[2](dropout2d(fc[0](h, train), _DROP, generator, train), train)
        final = fc[3]
        w = final.weight.reshape(self.num_classes, -1)
        return h @ w.t().to(h.dtype) + final.bias.to(h.dtype)


def lightweight(num_classes: int = 21) -> LightweightUnet:
    return LightweightUnet(num_classes=num_classes)
