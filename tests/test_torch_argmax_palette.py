"""The plain versions of the port's #6 (``argmax_mask``) and #8
(``mask_palette``) kernels against ``tpu_unet``'s Pallas kernels
``fused_argmax_mask`` and ``fused_mask_palette`` in interpret mode, exactly:
float32 and bfloat16 logits with forced ties and NaNs, masks with classes
outside the palette, several blend factors."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.postprocess import fused_argmax_mask, fused_mask_palette
from tpu_unet_torch.infer.wrapper import VOC_COLORS
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.kernels.postprocess import argmax_mask, argmax_mask_plain
from tpu_unet_torch.kernels.render import mask_palette, mask_palette_plain, palette_tensor
from tpu_unet_torch.tools.predict import render

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tied_logits(seed, shape, nan=False):
    """Small integers, so most pixels have tied maxima; a NaN in a few rows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, shape).astype(np.float32)
    if nan:
        x.reshape(-1, shape[-1])[::37, rng.integers(0, shape[-1])] = np.nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,nan", [((2, 8, 16, 4), False), ((1, 24, 40, 21), True),
                                       ((3, 5, 7, 32), True)])
def test_argmax_mask_equals_pallas(dtype, shape, nan):
    jdt, tdt = _DTYPES[dtype]
    x = jnp.asarray(_tied_logits(sum(shape), shape, nan), jdt)
    ref = np.asarray(fused_argmax_mask(x, interpret=True))
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    counts = dict(launch_counts)
    for out_dtype in (torch.int32, torch.uint8):
        out = argmax_mask(t, out_dtype)
        assert out.dtype == out_dtype and tuple(out.shape) == shape[:-1]
        np.testing.assert_array_equal(out.numpy().astype(np.int32), ref)
    assert launch_counts == counts  # the CPU path launches nothing
    np.testing.assert_array_equal(argmax_mask_plain(t).numpy(), np.asarray(jnp.argmax(x, -1)))


def test_argmax_mask_ties_and_nan_rules():
    x = torch.tensor([[[[1.0, 3.0, 3.0, 0.0], [float("nan"), 5.0, float("nan"), 1.0],
                        [-1.0, -1.0, -1.0, -1.0], [0.0, 1.0, 2.0, float("nan")]]]])
    np.testing.assert_array_equal(argmax_mask(x).numpy(), [[[1, 0, 0, 3]]])


@pytest.mark.parametrize("alpha", [0.7, 1.0, 0.5, 0.123])
@pytest.mark.parametrize("mask_dtype", [np.int32, np.uint8])
def test_mask_palette_equals_pallas(alpha, mask_dtype):
    """Bit-exact against the Pallas blend, a class ≥ C (black) included."""
    rng = np.random.default_rng(int(alpha * 1000))
    mask = rng.integers(0, len(VOC_COLORS) + 4, (2, 12, 20)).astype(mask_dtype)
    img = rng.integers(0, 256, (2, 12, 20, 3)).astype(np.uint8)
    ref = np.asarray(fused_mask_palette(jnp.asarray(mask.astype(np.int32)), jnp.asarray(img),
                                        VOC_COLORS, alpha, interpret=True))
    pal = palette_tensor(VOC_COLORS, "cpu")
    out = mask_palette(torch.from_numpy(mask), torch.from_numpy(img), pal, alpha)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, 12, 20, 3)
    np.testing.assert_array_equal(out.numpy(), ref)
    outside = mask >= len(VOC_COLORS)
    assert outside.any()
    np.testing.assert_array_equal(
        out.numpy()[outside], np.round(img[outside] * (np.float32(1) - np.float32(alpha))))


def test_mask_palette_equals_host_render():
    """In-range masks at frame size: the plain blend and ``render`` give the
    same bytes (the host path of the batched video path)."""
    rng = np.random.default_rng(3)
    mask = rng.integers(0, 4, (3, 16, 24)).astype(np.uint8)
    img = rng.integers(0, 256, (3, 16, 24, 3)).astype(np.uint8)
    colors = np.asarray(VOC_COLORS, np.uint8)
    out = mask_palette_plain(torch.from_numpy(mask), torch.from_numpy(img),
                             torch.from_numpy(colors), 0.7).numpy()
    for i in range(3):
        np.testing.assert_array_equal(out[i], render(img[i], mask[i], colors, 0.7,
                                                     (0, 0, 24, 16), (24, 16)))
