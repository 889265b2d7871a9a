"""The serving tails: final 1×1 conv + argmax + uint8 mask, with or without
the per-image class histogram (counterpart of
``tpu_unet/kernels/postprocess.py``).

CUDA kernels: ``csrc/postprocess.cu``, one template on the feature width
F ∈ {22, 32, 64}:

- ``final_argmax_hist`` replaces ``fused_final_argmax_hist_paired`` (the
  tail of ``unet_vgg`` and ``unet_resnet50``, F = 64) and
  ``fused_final_argmax_hist`` (the natural-layout tail of ``traditional``,
  F = 32, and ``traditional22``, F = 22).  The port has no column-paired
  layout, so both read natural NHWC features.  It counts the histogram in
  int32 (the JAX kernels count in float32 and the serving step casts; both
  are exact at these sizes).
- ``final_argmax`` replaces ``fused_final_argmax``: the mask alone, for
  any pixel count; the serving step then counts the histogram with
  :func:`masks_and_hist`, as ``postprocess.py:148-152`` does.

Both keep the logits out of device memory.  Bound on the H100: memory
(reading the features), see the source note.

CUDA kernel ``csrc/argmax.cu``: ``argmax_mask`` replaces
``fused_argmax_mask`` (``postprocess.py:38-67``), the class mask of logits
that were stored: the generic serving step's ``argmax(logits, -1)``
(``infer/wrapper.py:439``), which ``self_net``, the ladder models and
``lightweight`` take.  Compared in float32, the first maximum wins, a NaN
counts as the maximum; int32 as JAX returns it, or uint8 as the serving
step writes it.  Bound on the H100: memory (reading the logits).
"""
from __future__ import annotations

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu

# feature widths the CUDA tail is instantiated for; most classes it takes
_WIDTHS = (22, 32, 64)
_MAX_CLASSES = 32
_LOGIT_DTYPES = (torch.float32, torch.bfloat16)
_MASK_DTYPES = (torch.int32, torch.uint8)
HIST_BLOCK = 256  # pixels a CUDA block; a histogram block never spans two images


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


def final_argmax_plain(feats: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, H, W, F) features + torch final conv (C, F, 1, 1), (C,) → uint8
    class mask (N, H, W).  Logits in float32; the argmax keeps the first
    maximum."""
    w, b = _weights(weight, bias, num_classes)
    n, h, wd, f = feats.shape
    logits = feats.reshape(-1, f).float() @ w.float().t() + b.float()
    return torch.argmax(logits, dim=-1).reshape(n, h, wd).to(torch.uint8)


def final_argmax_hist_plain(feats: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, num_classes: int):
    """(N, H, W, F) features + torch final conv (C, F, 1, 1), (C,) →
    (uint8 masks (N, H, W), int32 hist (N, C))."""
    return masks_and_hist(final_argmax_plain(feats, weight, bias, num_classes),
                          num_classes)


def _tail_args(feats, weight, bias, num_classes, name):
    """Shape rule (checked before the device), then the CUDA operands:
    (F, C) float32 weights and the float32 bias."""
    w, b = _weights(weight, bias, num_classes)
    n, h, wd, f = feats.shape
    if f not in _WIDTHS or not 1 <= num_classes <= _MAX_CLASSES:
        raise ValueError(f"{name} kernel: F={f} must be one of {_WIDTHS} "
                         f"and classes={num_classes} in [1, {_MAX_CLASSES}]")
    _build.check(feats, "feats", torch.bfloat16, (n, h, wd, f))
    if feats.data_ptr() % 16:
        raise ValueError(f"{name} kernel: features must be 16-byte aligned")
    return w.t().float().contiguous().to(feats.device), \
        b.float().contiguous().to(feats.device)


def _final_argmax_hist_cuda(feats, weight, bias, num_classes):
    _build.no_grad_inputs("final_argmax_hist", feats, weight, bias)
    n, h, wd, f = feats.shape
    if (h * wd) % HIST_BLOCK:
        raise ValueError(f"final_argmax_hist kernel: H*W={h * wd} must be a "
                         f"multiple of {HIST_BLOCK}")
    wt, bf = _tail_args(feats, weight, bias, num_classes, "final_argmax_hist")
    masks = torch.empty((n, h, wd), dtype=torch.uint8, device=feats.device)
    hist = torch.zeros((n, num_classes), dtype=torch.int32, device=feats.device)
    _build.call("tu_final_argmax_hist", feats.data_ptr(), wt.data_ptr(),
                bf.data_ptr(), masks.data_ptr(), hist.data_ptr(),
                n * h * wd, h * wd, f, num_classes)
    _build.launch_counts["final_argmax_hist"] += 1
    return masks, hist


def _final_argmax_cuda(feats, weight, bias, num_classes):
    _build.no_grad_inputs("final_argmax", feats, weight, bias)
    n, h, wd, f = feats.shape
    wt, bf = _tail_args(feats, weight, bias, num_classes, "final_argmax")
    masks = torch.empty((n, h, wd), dtype=torch.uint8, device=feats.device)
    _build.call("tu_final_argmax", feats.data_ptr(), wt.data_ptr(),
                bf.data_ptr(), masks.data_ptr(), n * h * wd, f, num_classes)
    _build.launch_counts["final_argmax"] += 1
    return masks


def final_argmax_hist(feats: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, num_classes: int):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    (bf16 features, F ∈ {22, 32, 64}, C ≤ 32, H·W a multiple of 256) for
    tensors on the card."""
    if on_cpu(feats):
        return final_argmax_hist_plain(feats, weight, bias, num_classes)
    return _final_argmax_hist_cuda(feats, weight, bias, num_classes)


def final_argmax(feats: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    (bf16 features, F ∈ {22, 32, 64}, C ≤ 32, any pixel count) for tensors
    on the card."""
    if on_cpu(feats):
        return final_argmax_plain(feats, weight, bias, num_classes)
    return _final_argmax_cuda(feats, weight, bias, num_classes)


def argmax_mask_plain(logits: torch.Tensor,
                      out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(N, H, W, C) logits → (N, H, W) index of the first maximum over C,
    compared in float32 (a NaN counts as the maximum), as ``out_dtype``."""
    return torch.argmax(logits.float(), dim=-1).to(out_dtype)


def _argmax_mask_cuda(logits, out_dtype):
    _build.no_grad_inputs("argmax_mask", logits)
    if logits.ndim != 4 or logits.dtype not in _LOGIT_DTYPES \
            or out_dtype not in _MASK_DTYPES \
            or not 1 <= logits.shape[-1] <= _MAX_CLASSES:
        raise ValueError(f"argmax_mask kernel: (N, H, W, C ≤ {_MAX_CLASSES}) "
                         f"logits in {_LOGIT_DTYPES} to {_MASK_DTYPES}, got "
                         f"{tuple(logits.shape)} {logits.dtype} to {out_dtype}")
    _build.check(logits, "logits", logits.dtype)
    out = torch.empty(logits.shape[:-1], dtype=out_dtype, device=logits.device)
    if out.numel() == 0:
        return out
    _build.call("tu_argmax_mask", logits.data_ptr(), out.data_ptr(), out.numel(),
                logits.shape[-1], int(logits.dtype == torch.bfloat16),
                int(out_dtype == torch.uint8))
    _build.launch_counts["argmax_mask"] += 1
    return out


def argmax_mask(logits: torch.Tensor,
                out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    (contiguous float32 or bfloat16 logits, C ≤ 32, int32 or uint8 out) for
    tensors on the card."""
    if on_cpu(logits):
        return argmax_mask_plain(logits, out_dtype)
    return _argmax_mask_cuda(logits, out_dtype)
