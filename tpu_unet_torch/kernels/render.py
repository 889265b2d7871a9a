"""Palette lookup and alpha blend of a class mask over its RGB image
(counterpart of ``tpu_unet/kernels/postprocess.py::fused_mask_palette``).

CUDA kernel: ``csrc/palette.cu`` — replaces ``fused_mask_palette`` (the
Pallas call at ``postprocess.py:300``): ``uint8(round(img·(1−α) +
palette[mask]·α))`` in float32, half to even, a class outside ``[0, C)``
black.  Bit-exact against the plain version and against the host render of
``tools/predict.py``.  The batched video path calls it when the frame size
equals the model size.  Bound on the H100: memory, see the source note.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu

_MASK_DTYPES = (torch.uint8, torch.int32)
_MAX_PALETTE = 256


def _alphas(alpha: float):
    """(α, 1 − α) as float32, the subtraction in float32 as the TPU kernel
    does it on its float32 α."""
    a = np.float32(alpha)
    return a, np.float32(1.0) - a


def palette_tensor(colors, device) -> torch.Tensor:
    """A ``(C, 3)`` list of RGB colours → uint8 tensor on ``device``."""
    return torch.as_tensor(np.asarray(colors, np.uint8).reshape(-1, 3), device=device)


def mask_palette_plain(mask: torch.Tensor, image: torch.Tensor,
                       palette: torch.Tensor, alpha: float = 0.7) -> torch.Tensor:
    """(N, H, W) int mask + (N, H, W, 3) uint8 image + (C, 3) uint8 palette
    → (N, H, W, 3) uint8 blend: one float32 rounding after each product and
    after the sum, then half-to-even rounding."""
    a, b = _alphas(alpha)
    c = palette.shape[0]
    m = mask.long()
    inside = ((m >= 0) & (m < c))[..., None]
    seg = torch.where(inside, palette[m.clamp(0, c - 1)].float(), 0.0)
    out = image.float() * torch.tensor(b) + seg * torch.tensor(a)
    return torch.round(out).to(torch.uint8)


def _mask_palette_cuda(mask, image, palette, alpha):
    _build.no_grad_inputs("mask_palette", mask, image, palette)
    n, h, w = mask.shape
    if mask.dtype not in _MASK_DTYPES or not 1 <= palette.shape[0] <= _MAX_PALETTE:
        raise ValueError(f"mask_palette kernel: mask in {_MASK_DTYPES} and 1 to "
                         f"{_MAX_PALETTE} palette colours, got {mask.dtype} and "
                         f"{palette.shape[0]}")
    _build.check(mask, "mask", mask.dtype)
    _build.check(image, "image", torch.uint8, (n, h, w, 3), mask.device)
    _build.check(palette, "palette", torch.uint8, (None, 3), mask.device)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=mask.device)
    if mask.numel() == 0:
        return out
    a, b = _alphas(alpha)
    _build.call("tu_mask_palette", mask.data_ptr(), int(mask.dtype == torch.int32),
                image.data_ptr(), palette.data_ptr(), palette.shape[0], float(a),
                float(b), out.data_ptr(), mask.numel())
    _build.launch_counts["mask_palette"] += 1
    return out


def mask_palette(mask: torch.Tensor, image: torch.Tensor, palette: torch.Tensor,
                 alpha: float = 0.7) -> torch.Tensor:
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    (contiguous uint8 or int32 mask, uint8 image and ≤ 256-colour palette on
    the same card) for tensors on the card."""
    if on_cpu(mask):
        return mask_palette_plain(mask, image, palette, alpha)
    return _mask_palette_cuda(mask, image, palette, alpha)
