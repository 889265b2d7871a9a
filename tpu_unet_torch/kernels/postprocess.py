"""The serving tail: final 1×1 conv + argmax + uint8 mask + per-image
class histogram (counterpart of ``tpu_unet/kernels/postprocess.py``).

CUDA kernel: ``csrc/postprocess.cu`` — replaces
``postprocess.py::fused_final_argmax_hist_paired``.  It reads natural NHWC
features (the port has no column-paired layout), keeps the logits out of
device memory, and counts the histogram in int32 (the JAX kernel counts in
float32 and the serving step casts; both are exact at these sizes).
Bound on the H100: memory (reading the features), see the source note.
"""
from __future__ import annotations

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu


def _weights(weight: torch.Tensor, bias: torch.Tensor, num_classes: int):
    c = weight.shape[0]
    if c != num_classes or bias.shape != (c,):
        raise ValueError(f"final conv has {c} classes, expected {num_classes}")
    return weight.reshape(c, -1), bias


def masks_and_hist(cls: torch.Tensor, num_classes: int):
    """Class indices (N, H, W) → (uint8 masks, int32 per-image histogram
    (N, num_classes)), one ``bincount`` over image-offset classes."""
    n = cls.shape[0]
    offs = torch.arange(n, device=cls.device).reshape(n, 1, 1) * num_classes
    hist = torch.bincount((cls + offs).reshape(-1), minlength=n * num_classes)
    return cls.to(torch.uint8), hist.reshape(n, num_classes).to(torch.int32)


def final_argmax_hist_plain(feats: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, num_classes: int):
    """(N, H, W, F) features + torch final conv (C, F, 1, 1), (C,) →
    (uint8 masks (N, H, W), int32 hist (N, C)).  Logits in float32; the
    argmax keeps the first maximum."""
    w, b = _weights(weight, bias, num_classes)
    n, h, wd, f = feats.shape
    logits = feats.reshape(-1, f).float() @ w.float().t() + b.float()
    return masks_and_hist(torch.argmax(logits, dim=-1).reshape(n, h, wd),
                          num_classes)


def _final_argmax_hist_cuda(feats, weight, bias, num_classes):
    w, b = _weights(weight, bias, num_classes)
    n, h, wd, f = feats.shape
    _build.check(feats, "feats", torch.bfloat16, (n, h, wd, 64))
    if (h * wd) % 256 or not 1 <= num_classes <= 32:
        raise ValueError(f"final_argmax_hist: H*W={h * wd} must be a multiple "
                         f"of 256 and classes={num_classes} in [1, 32]")
    wt = w.t().float().contiguous().to(feats.device)    # (F, C)
    bf = b.float().contiguous().to(feats.device)
    masks = torch.empty((n, h, wd), dtype=torch.uint8, device=feats.device)
    hist = torch.zeros((n, num_classes), dtype=torch.int32, device=feats.device)
    _build.call("tu_final_argmax_hist", feats.data_ptr(), wt.data_ptr(),
                bf.data_ptr(), masks.data_ptr(), hist.data_ptr(),
                n * h * wd, h * wd, f, num_classes)
    _build.launch_counts["final_argmax_hist"] += 1
    return masks, hist


def final_argmax_hist(feats: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, num_classes: int):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    (bf16 features, F = 64, H·W a multiple of 256) for tensors on the card."""
    if on_cpu(feats):
        return final_argmax_hist_plain(feats, weight, bias, num_classes)
    return _final_argmax_hist_cuda(feats, weight, bias, num_classes)
