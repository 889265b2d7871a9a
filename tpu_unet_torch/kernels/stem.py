"""VGG16 stem: conv1_1 (3→F) + ReLU, conv1_2 (F→F) + ReLU, 2×2 max-pool
(counterpart of ``tpu_unet/kernels/stem.py``).

CUDA kernel: ``csrc/stem.cu`` — replaces ``stem.py::fused_vgg_stem_impl``
(#2).  Two launches on the Hopper kernels, planned by
:func:`tpu_unet_torch.kernels.sm90.stem_fwd_launches`: conv1_1 on a
``wgmma`` GEMM of its own whose producer warpgroup gathers the 27 im2col
columns of the raw uint8 image (normalised there as bf16(bf16(u8) /
bf16(255))) or of a bf16 image, writing a1; then conv1_2 over a1 on the
conv core ``csrc/conv3x3_sm90.cuh`` with the 2×2 max-pool in its epilogue,
writing the natural-layout skip and the pooled tensor.  With float32
weights the same two launches run the float32 instantiations (TF32
products, float32 storage; a uint8 image normalised as f32(u8) / 255, a
float32 image taken as it is).  Traced by ``torch.export``, the
launch runs as the operator ``tpu_unet_torch::vgg_stem``
(:func:`vgg_stem_op`, with a fake that gives its outputs' shapes), so the
graph keeps the kernel; an eager call launches it directly.  Bound and
design in the source note.
"""
from __future__ import annotations

import functools

import torch

from tpu_unet_torch.core.precision import normalize_u8
from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import conv3x3_relu, max_pool2x2, on_cpu


def vgg_stem_plain(x, w11, b11, w12, b12):
    """(B, H, W, 3) image (uint8, or already normalised) → (skip (B, H, W, F),
    pooled (B, H/2, W/2, F)); mirrors ``reference_vgg_stem`` (stem.py:235)
    in natural layout.  uint8 input is normalised in the weights' dtype."""
    dt = w11.dtype
    x = normalize_u8(x, dt) if x.dtype == torch.uint8 else x.to(dt)
    y = conv3x3_relu(conv3x3_relu(x, w11, b11), w12, b12)
    return y, max_pool2x2(y)


def vgg_stem_shape_ok(H: int, W: int, f: int) -> bool:
    """The stem kernels' shape rule (forward and backward): H % 8, W % 16
    and F % 64 all 0."""
    return not (H % 8 or W % 16 or f % 64)


@functools.lru_cache(maxsize=32)
def stem_plan(B: int, H: int, W: int, f: int, f32: bool = False) -> torch.Tensor:
    """The launch records of the stem's forward on the Hopper kernels
    (``sm90.stem_fwd_launches``), in bf16 or (``f32``) float32."""
    return sm90.encode(sm90.stem_fwd_launches(B, H, W, f, f32))


def _vgg_stem_check(x, w11, b11, w12, b12):
    """The stem kernel's checks, which read shapes, dtypes and devices only
    (so they run on fake tensors too): (B, H, W, F, dtype) or a raise."""
    B, H, W = x.shape[:3]
    f = w11.shape[0]
    dt = _build.conv_dtype(w11, "vgg_stem")
    if x.dtype not in (torch.uint8, dt):
        raise ValueError(f"vgg_stem kernel takes uint8 images or images of the weights' "
                         f"dtype {dt}, got {x.dtype}")
    _build.check(x, "x", x.dtype, (B, H, W, 3))
    _build.check(w11, "w11", dt, (f, 3, 3, 3), x.device)
    _build.check(w12, "w12", dt, (f, f, 3, 3), x.device)
    if not vgg_stem_shape_ok(H, W, f):
        raise ValueError(f"vgg_stem kernel: H={H} % 8, W={W} % 16, F={f} % 64 "
                         "must all be 0")
    return B, H, W, f, dt


def _vgg_stem_cuda(x, w11, b11, w12, b12):
    """The kernel; returns (skip, pooled, a1), a1 conv1_1's ReLU output, in
    the weights' dtype (bf16, or float32 on TF32 products)."""
    _build.no_grad_inputs("vgg_stem", x, w11, b11, w12, b12)
    B, H, W, f, dt = _vgg_stem_check(x, w11, b11, w12, b12)
    f32 = dt == torch.float32
    wt11, wt12 = _build.pack_weights([w11, w12], dt, k_pads=[sm90.slice_c(f32), None])
    b11f, b12f = b11.float().contiguous(), b12.float().contiguous()
    a1 = torch.empty((B, H, W, f), dtype=dt, device=x.device)
    skip = torch.empty_like(a1)
    pooled = torch.empty((B, H // 2, W // 2, f), dtype=dt, device=x.device)
    _build.call("tu_vgg_stem", x.data_ptr(), int(x.dtype == torch.uint8),
                wt11.data_ptr(), b11f.data_ptr(), wt12.data_ptr(),
                b12f.data_ptr(), a1.data_ptr(), skip.data_ptr(),
                pooled.data_ptr(), B, H, W, f, int(f32),
                stem_plan(B, H, W, f, f32).data_ptr())
    _build.launch_counts[_build.count_key("vgg_stem", dt)] += 1
    return skip, pooled, a1


@torch.library.custom_op("tpu_unet_torch::vgg_stem", mutates_args=(),
                         schema="(Tensor x, Tensor w11, Tensor b11, Tensor w12, Tensor b12)"
                                " -> (Tensor, Tensor)")
def vgg_stem_op(x, w11, b11, w12, b12):
    """The stem kernel's launch as an operator, (skip, pooled): what a
    traced forward on the card calls and ``torch.export`` keeps in its
    graph (``tools/export.py``); the launch's checks refuse tensors off
    the card."""
    return _vgg_stem_cuda(x, w11, b11, w12, b12)[:2]


@vgg_stem_op.register_fake
def _vgg_stem_fake(x, w11, b11, w12, b12):
    B, H, W, f, dt = _vgg_stem_check(x, w11, b11, w12, b12)
    return x.new_empty((B, H, W, f), dtype=dt), x.new_empty((B, H // 2, W // 2, f), dtype=dt)


def vgg_stem(x, w11, b11, w12, b12):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    for tensors on the card, through :func:`vgg_stem_op` while traced
    (bf16 or float32 weights, a uint8 image or one of their dtype, H % 8
    == 0, W % 16 == 0)."""
    if on_cpu(x):
        return vgg_stem_plain(x, w11, b11, w12, b12)
    if _build.traced(x):
        _build.no_grad_inputs("vgg_stem", x, w11, b11, w12, b12)
        return vgg_stem_op(x, w11, b11, w12, b12)
    return _vgg_stem_cuda(x, w11, b11, w12, b12)[:2]
