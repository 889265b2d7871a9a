"""TraditionalUnet — the plain 4-level UNet of DoubleConv blocks (counterpart
of ``tpu_unet/models/traditional.py``): base 32 (``traditional``, the DataB
competition baseline) and its 22-wide clone (``traditional22``).  NHWC in and
out; module names follow the reference torch model (``inc``,
``down1..3``, ``up1..3``, ``outc``).  Plain PyTorch throughout: its serving
tail is the one kernel (``kernels/postprocess.py``), applied by the wrapper
to the features this model emits with ``features_out``.  ``train=True`` is
the training forward (batch norm on the batch statistics, JAX's
``__call__(x, train)``); the model has no dropout.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.nn.blocks import DoubleConv, Down, Up


class TraditionalUnet(nn.Module):
    def __init__(self, num_classes: int = 21, base: int = 32):
        super().__init__()
        c = base
        self.num_classes = num_classes
        self.inc = DoubleConv(3, c)
        self.down1 = Down(c, 2 * c)
        self.down2 = Down(2 * c, 4 * c)
        self.down3 = Down(4 * c, 8 * c)
        self.up1 = Up(12 * c, 4 * c)
        self.up2 = Up(6 * c, 2 * c)
        self.up3 = Up(3 * c, c)
        self.outc = nn.Conv2d(c, num_classes, 1)

    def forward(self, x: torch.Tensor, features_out: bool = False, train: bool = False,
                generator: torch.Generator | None = None):
        """(B, H, W, 3) float image → logits (B, H, W, C); with
        ``features_out`` the (B, H, W, base) features before ``outc``, for
        the fused tail that applies ``outc`` itself.  ``generator`` is
        unused (no dropout)."""
        x1 = self.inc(x, train)
        x2 = self.down1(x1, train)
        x3 = self.down2(x2, train)
        x4 = self.down3(x3, train)
        h = self.up1(x4, x3, train)
        h = self.up2(h, x2, train)
        h = self.up3(h, x1, train)
        if features_out:
            return h
        w = self.outc.weight.reshape(self.num_classes, -1)
        return h @ w.t().to(h.dtype) + self.outc.bias.to(h.dtype)


def traditional(num_classes: int = 21) -> TraditionalUnet:
    return TraditionalUnet(num_classes=num_classes, base=32)


def traditional22(num_classes: int = 21) -> TraditionalUnet:
    """The 22-channel clone (reference: nets/SegNets.py:732-801)."""
    return TraditionalUnet(num_classes=num_classes, base=22)
