"""The port's align-corners resize (tpu_unet_torch/nn/resize.py) against the
JAX package's (tpu_unet/nn/resize.py) and torch's own interpolate."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
import torch.nn.functional as F

from tpu_unet.nn import resize as jresize
from tpu_unet_torch.nn import resize as tresize


@pytest.mark.parametrize("n_in,n_out,ac", [(4, 8, True), (7, 14, True),
                                           (16, 32, True), (5, 3, False),
                                           (9, 20, False)])
def test_lerp_coeffs_match_jax(n_in, n_out, ac):
    for a, b in zip(tresize._lerp_coeffs(n_in, n_out, ac),
                    jresize._lerp_coeffs(n_in, n_out, ac)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tresize._interp_matrix(n_in, n_out, ac),
                                  jresize._interp_matrix(n_in, n_out, ac))


@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (1, 8, 8, 16), (1, 5, 3, 2)])
def test_upsample2x_matches_jax_f32(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jresize.upsample2x(jnp.asarray(x)))
    out = tresize.upsample2x(torch.from_numpy(x)).numpy()
    # f32: the same two-term lerps, summed in another order (1-2 ulps)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_upsample2x_matches_interpolate():
    x = np.random.default_rng(1).standard_normal((2, 6, 10, 4)).astype(np.float32)
    t = torch.from_numpy(x)
    ref = F.interpolate(t.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                        align_corners=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(tresize.upsample2x(t).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_upsample2x_bf16_follows_jax_rounding():
    """bf16: both round after the H pass and after the W pass, with the
    weights cast to bf16 — equal up to one bf16 ulp (JAX's einsum may fuse
    the two products)."""
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 8)).astype(np.float32)
    ref = np.asarray(jresize.upsample2x(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    out = tresize.upsample2x(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(out - ref) <= ulp)


def test_resize_bilinear_half_pixel():
    x = np.random.default_rng(3).standard_normal((1, 7, 5, 2)).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), (11, 9),
                                             align_corners=False))
    out = tresize.resize_bilinear(torch.from_numpy(x), (11, 9),
                                  align_corners=False).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
