"""tpu_unet_torch/kernels/preprocess.py (CPU path) against the JAX normalize
kernel in interpret mode — bit-exact, to float32 and to bfloat16 — and the
rule of its CUDA side."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_unet.kernels.preprocess import normalize_images as jax_normalize_images
from tpu_unet_torch.core.precision import normalize_u8
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.kernels.preprocess import (_normalize_images_cuda,
                                               normalize_images,
                                               normalize_images_plain)

# the DataB single image, and N·H that the JAX kernel's 256-row block does
# not divide (it pads); odd widths
SHAPES = [(1, 256, 256, 3), (1, 64, 64, 3), (2, 40, 50, 3), (3, 17, 9, 3)]
BITS = {"float32": (torch.int32, np.int32), "bfloat16": (torch.int16, np.int16)}


def _images(shape):
    imgs = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    imgs.reshape(-1)[:256] = np.arange(256)  # every uint8 value
    return imgs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_normalize_bit_exact_vs_jax_kernel(shape, dtype):
    imgs = _images(shape)
    ref = np.asarray(jax_normalize_images(jnp.asarray(imgs), getattr(jnp, dtype),
                                          interpret=True))
    n = launch_counts["normalize_images"]
    out = normalize_images(torch.from_numpy(imgs), getattr(torch, dtype))
    assert launch_counts["normalize_images"] == n  # the CPU path launches nothing
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == shape
    t_bits, np_bits = BITS[dtype]
    np.testing.assert_array_equal(out.view(t_bits).numpy(), ref.view(np_bits))


def test_normalize_is_not_the_serving_division():
    """The kernel multiplies by float32(1/255); the serving step's
    ``normalize_u8`` divides by 255 in the compute dtype.  In float32 they
    differ by at most one ulp, on about half of the 256 values; in bfloat16
    the division rounds the float32 quotient once, and they agree."""
    x = torch.arange(256, dtype=torch.uint8)
    mul = normalize_images_plain(x, torch.float32)
    div = normalize_u8(x, torch.float32)
    differ = (mul != div).sum().item()
    assert 64 < differ < 192
    assert torch.equal(normalize_images_plain(x, torch.bfloat16),
                       normalize_u8(x, torch.bfloat16))
    ulps = (mul.view(torch.int32) - div.view(torch.int32)).abs().max().item()
    assert ulps == 1
    np.testing.assert_array_equal(div.numpy(), x.numpy().astype(np.float32) / np.float32(255))


@pytest.mark.parametrize("images,dtype", [
    (torch.zeros(1, 8, 8, 3), torch.float32),                    # not uint8
    (torch.zeros(1, 8, 8, 3, dtype=torch.uint8), torch.float16),  # no fp16 kernel
])
def test_kernel_refuses_other_dtypes(images, dtype):
    """The dtype rule is checked before the device: it raises on any
    device, and never falls back."""
    with pytest.raises(ValueError, match="normalize_images kernel"):
        _normalize_images_cuda(images, dtype)


@pytest.mark.parametrize("images,dtype,exc,match", [
    # a float input that autograd records: refused as having no backward
    (torch.zeros(1, 8, 8, 3, requires_grad=True), torch.float32, RuntimeError, "no backward"),
    (torch.zeros(1, 8, 8, 3, dtype=torch.uint8), torch.float32, ValueError, "CUDA tensor"),
    (torch.zeros(1, 8, 8, 6, dtype=torch.uint8)[..., ::2], torch.bfloat16, ValueError,
     "CUDA tensor"),
    (torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device="meta"), torch.bfloat16, ValueError,
     "CUDA tensor"),
])
def test_kernel_refusals_after_the_one_test(images, dtype, exc, match):
    """The wrapper takes an input after one combined test; every input that
    fails it still raises what the separate checks raised, and launches
    nothing."""
    n = launch_counts["normalize_images"]
    with pytest.raises(exc, match=match):
        _normalize_images_cuda(images, dtype)
    assert launch_counts["normalize_images"] == n
