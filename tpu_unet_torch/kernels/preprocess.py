"""uint8 → normalised images in the compute dtype (counterpart of
``tpu_unet/kernels/preprocess.py``).

CUDA kernel: ``csrc/preprocess.cu`` — replaces
``preprocess.py::normalize_images``: ``dtype(float32(u8) * float32(1/255))``
for ``dtype`` float32 or bfloat16, bit-exact against the plain version.
This is the single-image forward's first step (``wrapper.py:136-139``).  It
is not ``core/precision.py::normalize_u8``, which divides in the compute
dtype as the batched serving step does; the two differ in bf16.  Bound on
the H100: memory, see the source note.
"""
from __future__ import annotations

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu

_DTYPES = (torch.float32, torch.bfloat16)
# float32(1.0 / 255.0): the constant of the TPU kernel (preprocess.py:23)
_INV255 = 1.0 / 255.0


def normalize_images_plain(images: torch.Tensor,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, H, W, 3) ``dtype`` in [0, 1]: the product
    in float32, then one rounding to ``dtype``."""
    inv = torch.tensor(_INV255, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) * inv).to(dtype)


def _normalize_images_cuda(images, dtype):
    _build.no_grad_inputs("normalize_images", images)
    if images.dtype != torch.uint8 or dtype not in _DTYPES:
        raise ValueError(f"normalize_images kernel: uint8 images to one of "
                         f"{_DTYPES}, got {images.dtype} to {dtype}")
    _build.check(images, "images", torch.uint8)
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    if images.numel() == 0:
        return out
    _build.call("tu_normalize_images", images.data_ptr(), out.data_ptr(),
                images.numel(), int(dtype == torch.bfloat16))
    _build.launch_counts["normalize_images"] += 1
    return out


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    (contiguous uint8 to float32 or bfloat16) for tensors on the card."""
    if on_cpu(images):
        return normalize_images_plain(images, dtype)
    return _normalize_images_cuda(images, dtype)
