"""Precision policy of the port (counterpart of ``tpu_unet/core/precision.py``).

On the card the serving path follows ``tpu_unet/infer/wrapper.py``'s
accelerator branch: parameters are cast to bfloat16 once, activations are
bfloat16, and every kernel accumulates in float32.  Batch norm follows the
JAX step too (``wrapper.py:350-356``): its scale and bias are parameters and
are rounded to bfloat16, its running statistics are ``batch_stats`` and
stay float32.  On the CPU everything is float32, as JAX on the CPU is.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


DEFAULT_PRECISION = Precision()
BF16_PRECISION = Precision(param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)


def for_device(device: torch.device | str) -> Precision:
    """bf16 compute with f32 accumulation on the card, f32 on the CPU."""
    return BF16_PRECISION if torch.device(device).type == "cuda" \
        else DEFAULT_PRECISION


@torch.no_grad()
def cast_params(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``net``'s parameters to ``dtype`` in place, except batch norm's:
    its weight and bias are rounded to ``dtype`` but stored in float32, and
    its running statistics stay float32 (``F.batch_norm`` then computes in
    float32 on bfloat16 activations, as flax's BatchNorm does)."""
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            for p in (m.weight, m.bias):
                p.copy_(p.to(dtype).float())
        else:
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return net


def normalize_u8(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 → ``dtype(dtype(u8) / dtype(255))``: the division runs in the
    compute dtype, as ``wrapper.py``'s serving step does."""
    return images.to(dtype) / torch.tensor(255.0, dtype=dtype,
                                           device=images.device)
