"""VGG16 encoder blocks 2-5: 2 or 3 stacked 3×3 conv + ReLU and an optional
trailing 2×2 max-pool (counterpart of ``tpu_unet/kernels/encoder.py``).

CUDA kernel: ``csrc/encoder.cu`` — replaces ``encoder.py::fused_vgg_block_impl``.
One launch per conv; the pool rides the last conv's epilogue.  Every conv,
of two (block 2) or three (blocks 3-5), runs on the Hopper core
``csrc/conv3x3_sm90.cuh`` (wgmma, TMA), its launches planned by
:func:`tpu_unet_torch.kernels.sm90.block_fwd_launches`.  Bound and design
in the source notes.
"""
from __future__ import annotations

import functools

import torch

from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import conv3x3_relu, max_pool2x2, on_cpu


def vgg_block_plain(x, ws, bs, pool: bool = True):
    """(B, H, W, C) → (skip (B, H, W, F), pooled (B, H/2, W/2, F) or None);
    mirrors ``reference_vgg_block`` (encoder.py:305)."""
    y = x
    for w, b in zip(ws, bs):
        y = conv3x3_relu(y, w, b)
    return y, (max_pool2x2(y) if pool else None)


def vgg_block_shape_ok(H: int, W: int, chans) -> bool:
    """The block kernels' shape rule (forward and backward): H % 8, W % 16,
    input widths % 32 and output widths % 64 all 0."""
    return not (H % 8 or W % 16 or any(c % 32 for c in chans[:-1])
                or any(c % 64 for c in chans[1:]))


@functools.lru_cache(maxsize=64)
def block_plan(B: int, H: int, W: int, chans: tuple, pool: bool,
               f32: bool = False) -> torch.Tensor:
    """The launch records of a block's forward on the Hopper core, one a
    conv (the last pooling when ``pool``), in bf16 or (``f32``) float32."""
    return sm90.encode(sm90.block_fwd_launches(B, H, W, chans, pool, f32))


def _vgg_block_cuda(x, ws, bs, pool, key="vgg_block"):
    """The kernel; returns (skip, pooled or None, [the intermediate ReLU
    outputs]), counted under ``key`` (the training forward's keys name the
    JAX kernel it stands for; float32 under its ``_f32`` key)."""
    _build.no_grad_inputs(key, x, ws, bs)
    n = len(ws)
    B, H, W, C = x.shape
    chans = [C] + [int(w.shape[0]) for w in ws]
    dt = _build.conv_dtype(x, key)
    _build.check(x, "x", dt)
    if n not in (2, 3) or len(bs) != n:
        raise ValueError(f"vgg_block kernel takes 2 or 3 convs, got {n}")
    for i, w in enumerate(ws):
        _build.check(w, f"ws[{i}]", dt, (chans[i + 1], chans[i], 3, 3), x.device)
    if not vgg_block_shape_ok(H, W, chans):
        raise ValueError(f"vgg_block kernel: H={H} % 8, W={W} % 16, input "
                         f"widths % 32 and output widths % 64 must be 0 "
                         f"(chans {chans})")
    f32 = dt == torch.float32
    wts = _build.pack_weights(ws, dt)
    bfs = [b.float().contiguous() for b in bs]
    mids = [torch.empty((B, H, W, c), dtype=dt, device=x.device) for c in chans[1:-1]]
    skip = torch.empty((B, H, W, chans[-1]), dtype=dt, device=x.device)
    pooled = (torch.empty((B, H // 2, W // 2, chans[-1]), dtype=dt, device=x.device)
              if pool else None)
    pad = [None] * (3 - n)
    plan = block_plan(B, H, W, tuple(chans), pool, f32)
    _build.call("tu_vgg_block", x.data_ptr(), n,
                *[t.data_ptr() for t in wts], *pad,
                *[t.data_ptr() for t in bfs], *pad,
                *[t.data_ptr() for t in mids], *([None] * (2 - len(mids))),
                skip.data_ptr(), _build.ptr(pooled), B, H, W,
                *chans, *([0] * (4 - len(chans))), int(f32), plan.data_ptr())
    _build.launch_counts[_build.count_key(key, dt)] += 1
    return skip, pooled, mids


def vgg_block(x, ws, bs, pool: bool = True):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    for tensors on the card (bf16, or float32 on TF32 products; H % 8, W %
    16, input widths % 32 and output widths % 64 all 0)."""
    if on_cpu(x):
        return vgg_block_plain(x, ws, bs, pool)
    return _vgg_block_cuda(x, ws, bs, pool)[:2]
