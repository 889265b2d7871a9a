"""VGG16 stem: conv1_1 (3→F) + ReLU, conv1_2 (F→F) + ReLU, 2×2 max-pool
(counterpart of ``tpu_unet/kernels/stem.py``).

CUDA kernel: ``csrc/stem.cu`` — replaces ``stem.py::fused_vgg_stem_impl``
(#2).  Two launches on the Hopper kernels, planned by
:func:`tpu_unet_torch.kernels.sm90.stem_fwd_launches`: conv1_1 on a
``wgmma`` GEMM of its own whose producer warpgroup gathers the 27 im2col
columns of the raw uint8 image (normalised there as bf16(bf16(u8) /
bf16(255))) or of a bf16 image, writing a1; then conv1_2 over a1 on the
conv core ``csrc/conv3x3_sm90.cuh`` with the 2×2 max-pool in its epilogue,
writing the natural-layout skip and the pooled tensor.  Bound and design
in the source note.
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
def stem_plan(B: int, H: int, W: int, f: int) -> torch.Tensor:
    """The launch records of the stem's forward on the Hopper kernels
    (``sm90.stem_fwd_launches``)."""
    return sm90.encode(sm90.stem_fwd_launches(B, H, W, f))


def _vgg_stem_cuda(x, w11, b11, w12, b12):
    """The kernel; returns (skip, pooled, a1), a1 conv1_1's ReLU output."""
    _build.no_grad_inputs("vgg_stem", x, w11, b11, w12, b12)
    B, H, W = x.shape[:3]
    f = w11.shape[0]
    if x.dtype not in (torch.uint8, torch.bfloat16):
        raise ValueError(f"vgg_stem kernel takes uint8 or bf16 images, got {x.dtype}")
    _build.check(x, "x", x.dtype, (B, H, W, 3))
    _build.check(w11, "w11", torch.bfloat16, (f, 3, 3, 3), x.device)
    _build.check(w12, "w12", torch.bfloat16, (f, f, 3, 3), x.device)
    if not vgg_stem_shape_ok(H, W, f):
        raise ValueError(f"vgg_stem kernel: H={H} % 8, W={W} % 16, F={f} % 64 "
                         "must all be 0")
    wt11 = _build.pack_conv3x3(w11, sm90.SLICE_C)
    wt12 = _build.pack_conv3x3(w12)
    b11f, b12f = b11.float().contiguous(), b12.float().contiguous()
    a1 = torch.empty((B, H, W, f), dtype=torch.bfloat16, device=x.device)
    skip = torch.empty_like(a1)
    pooled = torch.empty((B, H // 2, W // 2, f), dtype=torch.bfloat16,
                         device=x.device)
    _build.call("tu_vgg_stem", x.data_ptr(), int(x.dtype == torch.uint8),
                wt11.data_ptr(), b11f.data_ptr(), wt12.data_ptr(),
                b12f.data_ptr(), a1.data_ptr(), skip.data_ptr(),
                pooled.data_ptr(), B, H, W, f, stem_plan(B, H, W, f).data_ptr())
    _build.launch_counts["vgg_stem"] += 1
    return skip, pooled, a1


def vgg_stem(x, w11, b11, w12, b12):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    for tensors on the card (bf16 weights, H % 8 == 0, W % 16 == 0)."""
    if on_cpu(x):
        return vgg_stem_plain(x, w11, b11, w12, b12)
    return _vgg_stem_cuda(x, w11, b11, w12, b12)[:2]
