"""tpu_unet_torch/kernels/stem.py (CPU path) against the JAX stem kernel in
interpret mode and against its XLA reference, in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.stem import fused_vgg_stem_impl, reference_vgg_stem
from tpu_unet_torch.kernels.stem import vgg_stem


def _case(B, H, W, F, seed, u8=False):
    rng = np.random.default_rng(seed)
    if u8:
        x = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    else:
        x = rng.random((B, H, W, 3)).astype(np.float32)
    k11 = (rng.standard_normal((3, 3, 3, F)) * 0.2).astype(np.float32)
    b11 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    k12 = (rng.standard_normal((3, 3, F, F)) * 0.2).astype(np.float32)
    b12 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    return x, k11, b11, k12, b12


def _port(x, k11, b11, k12, b12):
    oihw = lambda k: torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # noqa: E731
    skip, pooled = vgg_stem(torch.from_numpy(x), oihw(k11),
                            torch.from_numpy(b11), oihw(k12),
                            torch.from_numpy(b12))
    return skip.numpy(), pooled.numpy()


@pytest.mark.parametrize("shape,u8", [((1, 32, 32, 8), False),
                                      ((2, 16, 20, 16), False),
                                      ((2, 16, 16, 8), True)])
def test_stem_matches_jax_kernel(shape, u8):
    x, k11, b11, k12, b12 = _case(*shape, seed=sum(shape), u8=u8)
    args = [jnp.asarray(a) for a in (x, k11, b11, k12, b12)]
    out = fused_vgg_stem_impl(*args, prepad_pool=False, prepad_skip=False,
                              input_scale=1 / 255.0 if u8 else None)
    assert out is not None, "JAX stem kernel fell back"
    jskip, jpool = (np.asarray(o) for o in out)
    B, H, W, F = shape
    skip, pooled = _port(x, k11, b11, k12, b12)
    # f32 on both sides, sums in another order (and for uint8 the JAX
    # kernel folds 1/255 into the weights): ~1e-6 relative
    np.testing.assert_allclose(skip, jskip.reshape(B, H, W, F), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pooled, jpool, rtol=1e-5, atol=1e-5)


def test_stem_matches_jax_reference():
    x, k11, b11, k12, b12 = _case(2, 16, 16, 16, seed=5)
    jskip, jpool = (np.asarray(o) for o in reference_vgg_stem(
        *[jnp.asarray(a) for a in (x, k11, b11, k12, b12)]))
    skip, pooled = _port(x, k11, b11, k12, b12)
    np.testing.assert_allclose(skip, jskip.reshape(skip.shape), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pooled, jpool, rtol=1e-5, atol=1e-5)
