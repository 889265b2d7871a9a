"""Shared blocks of the canonical UNet (counterpart of ``tpu_unet/nn/blocks.py``):
the decoder block ``UnetUp`` (×2 align-corners upsample of the deep feature,
concat [skip, up], two 3×3 conv + ReLU, no batch norm; parameter names follow
the reference torch module, ``conv1``, ``conv2``), the ceil-mode max-pool of
the ResNet50 stem, and the batch-norm constants.  NHWC activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_unet_torch.kernels.decoder_fuse import unetup

# torch BN defaults, as the JAX package uses them (momentum 0.1 in torch's
# convention; only eval mode is ported)
BN_EPS = 1e-5


def max_pool_ceil(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max-pool of NHWC ``x`` with ``ceil_mode=True`` and no padding
    (reference: nets/resnet.py:113).  The JAX package pads the right and
    bottom edges with -inf up to the ceil size; torch's ceil mode takes the
    maximum over the valid part of the last window, which is the same."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


class UnetUp(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_size, out_size, kernel_size=3, padding=1)
        self.conv2 = nn.Conv2d(out_size, out_size, kernel_size=3, padding=1)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return unetup(skip, x, self.conv1.weight, self.conv1.bias,
                      self.conv2.weight, self.conv2.bias)
