"""Plain PyTorch building blocks shared by the kernels' plain versions.

Activations are NHWC; convolution weights are torch OIHW.  The NHWC tensor
is handed to ``F.conv2d`` as a channels-last NCHW view, so no copy is made
on either side of the call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor, False for a CUDA tensor; raise otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights: OIHW (F, C, 3, 3) → (C, F, 3, 3), flipped in ky/kx."""
    return w.flip(2, 3).transpose(0, 1)


def conv3x3_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(3×3 SAME conv + bias) of NHWC ``x``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype), padding=1)
    return torch.relu(y).permute(0, 2, 3, 1).contiguous()


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max-pool of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
