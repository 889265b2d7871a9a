"""The serving tails: final 1×1 conv + argmax + uint8 mask, with or without
the per-image class histogram (counterpart of
``tpu_unet/kernels/postprocess.py``).

One CUDA kernel at every feature width F ∈ {22, 32, 64},
``csrc/tail_sm90.cu`` behind the C entries of ``csrc/postprocess.cu``:
the products on ``wgmma``, the argmax, mask and histogram in its
epilogue; a ring of TMA loads at F = 64, of 1-D bulk copies at F = 22 and
32 (A then from registers, the features in the K order
:func:`tail_k_order` gives); planned as :func:`tail_plan` says.

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
(reading the features), see the source's note.  The weights are rounded
to bf16 for the tensor cores, as the TPU kernels cast them to the feature
dtype (the serving models' weights are bf16 already).

CUDA kernel ``csrc/argmax.cu``: ``argmax_mask`` replaces
``fused_argmax_mask`` (``postprocess.py:38-67``), the class mask of logits
that were stored: the generic serving step's ``argmax(logits, -1)``
(``infer/wrapper.py:439``), which ``self_net``, the ladder models and
``lightweight`` take.  Compared in float32, the first maximum wins, a NaN
counts as the maximum; int32 as JAX returns it, or uint8 as the serving
step writes it.  Bound on the H100: memory (reading the logits).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu

# feature widths the CUDA tail is instantiated for; most classes it takes
_WIDTHS = (22, 32, 64)
_MAX_CLASSES = 32
_LOGIT_DTYPES = (torch.float32, torch.bfloat16)
_MASK_DTYPES = (torch.int32, torch.uint8)
HIST_BLOCK = 256  # a histogram image's pixels are a multiple of this
TAIL_SMS = 132    # the H100's SMs
TAIL_KN = 32      # K columns at F = 22 and 32: two k16 steps


def tail_tile(f: int) -> int:
    """Pixels a tile of the tail at feature width ``f``: 64 a consumer
    warpgroup, two warpgroups at F = 64, four at F = 22 and 32."""
    return 128 if f == 64 else 256


def tail_ctas(f: int) -> int:
    """The tail's most blocks at feature width ``f``: one an SM at F = 64,
    two at F = 22 and 32 (two rings fit an SM's shared memory)."""
    return TAIL_SMS * (1 if f == 64 else 2)


class TailPlan(NamedTuple):
    """The tail's launch (the mirror of ``csrc/tail_sm90.cu``): ``np``
    classes padded to the ``wgmma`` width (a multiple of 8), ``tiles`` of
    ``tile`` pixels, ``grid`` persistent blocks, block g taking the tiles
    ``[tiles·g / grid, tiles·(g + 1) / grid)``; ``copy`` the bytes a full
    tile's load brings (a TMA box at F = 64, one bulk copy else),
    ``last_copy`` the last tile's and ``rest`` the bytes of the last tile
    that its consumers read in device memory (a bulk copy moves a multiple
    of 16 bytes; TMA boxes fill the rows past n with zeros); with the
    histogram, ``flushes[i]`` is how many blocks add counts of image i (one
    global ``atomicAdd`` a class each)."""
    np: int
    tile: int
    tiles: int
    grid: int
    copy: int
    last_copy: int
    rest: int
    flushes: tuple


def tail_plan(n_pix: int, num_classes: int, per_img: int | None = None, *,
              f: int) -> TailPlan:
    """The tail's plan for ``n_pix`` pixels of ``f`` features (``per_img``
    a multiple of the tile with the histogram, None for the mask alone)."""
    tile = tail_tile(f)
    tiles = -(-n_pix // tile)
    grid = min(tiles, tail_ctas(f))
    copy = tile * f * 2
    last = (n_pix - (tiles - 1) * tile) * f * 2
    last_copy = copy if f == 64 else last & ~15
    flushes = ()
    if per_img is not None:
        counts = [0] * (n_pix // per_img)
        for g in range(grid):
            t0, t1 = tiles * g // grid, tiles * (g + 1) // grid
            for img in range(t0 * tile // per_img, (t1 - 1) * tile // per_img + 1):
                counts[img] += 1
        flushes = tuple(counts)
    return TailPlan(-(-num_classes // 8) * 8, tile, tiles, grid, copy, last_copy,
                    0 if f == 64 else last - last_copy, flushes)


def tail_word(f: int, q: int, m: int) -> int:
    """At F = 22 and 32: the word of a pixel's row (features 2·word and
    2·word + 1) that quad lane ``q`` puts in A slot ``m`` (k16 step m // 2;
    fragment registers 0 / 1 at m even, 2 / 3 at m odd), or -1 for a zero:
    the 16-byte run 4q .. 4q + 3 at F = 32, 3q .. 3q + 2 below 11 at F =
    22."""
    if f == 32:
        return 4 * q + m
    return 3 * q + m if m < 3 and 3 * q + m < f // 2 else -1


def tail_k_order(f: int) -> tuple:
    """The feature behind each K column of the tail's products (-1 where A
    and W hold zeros): at F = 64 the features in order; at F = 22 and 32
    the order the threads' word loads give (``tail_word``)."""
    if f == 64:
        return tuple(range(64))
    out = []
    for k in range(TAIL_KN):
        s, c = divmod(k, 16)
        q, e, h = (c % 8) // 2, c % 2, c // 8
        word = tail_word(f, q, 2 * s + h)
        out.append(-1 if word < 0 else 2 * word + e)
    return tuple(out)


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
