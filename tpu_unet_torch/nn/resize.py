"""Align-corners bilinear resizing for NHWC tensors.

Counterpart of ``tpu_unet/nn/resize.py``: the same float64 coefficient
formula (source position ``i * (in - 1) / (out - 1)`` for align-corners,
``(i + 0.5) * in / out - 0.5`` otherwise), applied as a separable lerp,
H pass first, then W pass.

Rounding follows the JAX package: each pass rounds to the input dtype, and
the lerp weights are the resize matrix's entries cast to that dtype
(``_apply_matrix`` casts the matrix to ``x.dtype``).  A pass computes in
float32, or in float64 for a float64 input (as JAX's matrix product in
that dtype).  In float32 this is
``torch.nn.functional.interpolate(..., align_corners=True)`` up to the
last bit; in bfloat16 it reproduces the JAX rounding points.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _lerp_coeffs(in_size: int, out_size: int, align_corners: bool):
    """Host-precomputed (i0, i1, w) for 1-D linear interpolation."""
    if out_size == in_size:
        i = np.arange(out_size)
        return i, i, np.zeros(out_size, np.float32)
    if align_corners:
        if out_size == 1:
            pos = np.zeros(1, np.float64)
        else:
            pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        pos = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        pos = np.clip(pos, 0.0, in_size - 1)
    i0 = np.floor(pos).astype(np.int32)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (pos - i0).astype(np.float32)
    return i0, i1, w


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool):
    """(out, in) row-stochastic interpolation matrix — 2 nonzeros per row."""
    i0, i1, w = _lerp_coeffs(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - w)
    np.add.at(m, (rows, i1), w)
    return m


def lerp_tables(in_size: int, out_size: int, align_corners: bool,
                dtype: torch.dtype):
    """(idx int32 (2, out), wts float32 (2, out)) for one axis: output
    position u reads ``wts[0, u] * x[idx[0, u]] + wts[1, u] * x[idx[1, u]]``.

    The weights are the resize matrix's entries rounded to ``dtype`` (the
    JAX package casts the matrix to the activation dtype), so the CUDA
    decoder kernel and the plain version use the same numbers."""
    i0, i1, w = _lerp_coeffs(in_size, out_size, align_corners)
    w0 = (1.0 - w).astype(np.float32)
    w1 = w.astype(np.float32)
    wts = torch.from_numpy(np.stack([w0, w1])).to(dtype).float()
    idx = torch.from_numpy(np.stack([i0, i1]).astype(np.int32))
    return idx, wts


def _interp_axis(x: torch.Tensor, out_size: int, axis: int,
                 align_corners: bool) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx, wts = lerp_tables(in_size, out_size, align_corners, x.dtype)
    shape = [1] * x.ndim
    shape[axis] = out_size
    # rows split on the host, then moved (no indexing of a device tensor)
    i0, i1 = (i.to(device=x.device, dtype=torch.long) for i in idx)
    w0, w1 = (w.to(x.device).reshape(shape) for w in wts)
    ct = torch.promote_types(x.dtype, torch.float32)
    a = x.index_select(axis, i0).to(ct)
    b = x.index_select(axis, i1).to(ct)
    return (a * w0 + b * w1).to(x.dtype)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True):
    """Bilinear-resize NHWC (or HWC) ``x`` to spatial ``size=(H, W)``."""
    oh, ow = int(size[0]), int(size[1])
    orig_dtype = x.dtype
    y = x if x.is_floating_point() else x.float()
    y = _interp_axis(y, oh, x.ndim - 3, align_corners)
    y = _interp_axis(y, ow, x.ndim - 2, align_corners)
    return y if y.dtype == orig_dtype else y.to(orig_dtype)


@functools.lru_cache(maxsize=None)
def _nearest_idx(in_size: int, out_size: int) -> torch.Tensor:
    # torch F.interpolate(mode='nearest'): src = floor(dst * in / out)
    idx = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return torch.from_numpy(np.clip(idx.astype(np.int64), 0, in_size - 1))


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) ``x`` to ``size=(H, W)``
    with torch's default ``F.interpolate(mode='nearest')`` index rule
    (``tpu_unet/nn/resize.py:118-138``; the OptimizedBalancedSeg decoder
    and heads, reference: nets/SegNets.py:658-670): a row and column
    selection, exact in every dtype."""
    oh, ow = int(size[0]), int(size[1])
    y = x
    for axis, out in ((x.ndim - 3, oh), (x.ndim - 2, ow)):
        if y.shape[axis] != out:
            y = y.index_select(axis, _nearest_idx(y.shape[axis], out).to(x.device))
    return y


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """×2 bilinear upsample of NHWC ``x`` (decoder hot path)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, (2 * h, 2 * w), align_corners=align_corners)


def adjoint_tables(in_size: int, dtype: torch.dtype):
    """Gather form of the ×2 align-corners lerp's adjoint on one axis:
    (idx int32 (in, n), wts float32 (in, n)), row i listing every
    (output position u, weight) pair of :func:`lerp_tables` that reads
    input i, in increasing u (i0's entry before i1's), padded at the end
    with index -1 and weight 0.  n is the longest list (5 for ×2 from 2
    inputs up)."""
    idx, wts = lerp_tables(in_size, 2 * in_size, True, dtype)
    lists = [[] for _ in range(in_size)]
    for u in range(2 * in_size):
        for k in (0, 1):
            lists[int(idx[k, u])].append((u, float(wts[k, u])))
    n = max(len(entries) for entries in lists)
    t_idx = torch.full((in_size, n), -1, dtype=torch.int32)
    t_w = torch.zeros((in_size, n), dtype=torch.float32)
    for i, entries in enumerate(lists):
        for a, (u, wt) in enumerate(entries):
            t_idx[i, a], t_w[i, a] = u, wt
    return t_idx, t_w


def upsample2x_adjoint_plain(dup: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The exact adjoint of :func:`upsample2x` at ``dup``'s dtype: NHWC
    ``dup`` (B, 2h, 2w, C) → (B, h, w, C).  The lerp weights are those the
    forward uses at that dtype (rounded to it); the sums run in float32 (W
    pass first, as autograd of the forward takes them; float64 for a
    float64 ``dup``) and round once."""
    ridx, rw = lerp_tables(h, 2 * h, True, dup.dtype)
    cidx, cw = lerp_tables(w, 2 * w, True, dup.dtype)
    dev = dup.device
    ct = torch.promote_types(dup.dtype, torch.float32)
    d = dup.to(ct)
    dh = torch.zeros(d.shape[:2] + (w, d.shape[-1]), dtype=ct, device=dev)
    for k in (0, 1):
        dh.index_add_(2, cidx[k].to(dev, torch.long), d * cw[k].to(dev)[:, None])
    dx = torch.zeros((d.shape[0], h, w, d.shape[-1]), dtype=ct, device=dev)
    for k in (0, 1):
        dx.index_add_(1, ridx[k].to(dev, torch.long), dh * rw[k].to(dev)[:, None, None])
    return dx.to(dup.dtype)
