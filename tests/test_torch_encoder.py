"""tpu_unet_torch/kernels/encoder.py (CPU path) against the JAX encoder-block
kernel in interpret mode and against its XLA reference, in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.encoder import fused_vgg_block_impl, reference_vgg_block
from tpu_unet_torch.kernels.encoder import vgg_block


def _case(B, H, W, chans, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, chans[0])).astype(np.float32)
    ks = [(0.1 * rng.standard_normal((3, 3, ci, co))).astype(np.float32)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32) for co in chans[1:]]
    return x, ks, bs


def _port(x, ks, bs, pool):
    skip, pooled = vgg_block(
        torch.from_numpy(x),
        [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in ks],
        [torch.from_numpy(b) for b in bs], pool)
    return skip.numpy(), None if pooled is None else pooled.numpy()


# chained f32 convs: sums in another order than the JAX kernel's per-ky/kx
# matmuls, compounding over 2-3 convs (the JAX tests allow 2e-3 absolute)
TOL = dict(rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("shape,pool", [
    ((1, 8, 16, [64, 128, 128]), True),         # block 2 (im2col first conv)
    ((1, 8, 16, [128, 128, 128, 128]), True),   # 3-conv block with pool
    ((1, 8, 8, [128, 128, 128, 128]), False),   # block 5: no pool
])
def test_block_matches_jax_kernel(shape, pool):
    B, H, W, chans = shape
    x, ks, bs = _case(B, H, W, chans, seed=len(chans) + H)
    out = fused_vgg_block_impl(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                               [jnp.asarray(b) for b in bs], pool=pool,
                               block_rows=8)
    assert out is not None, "JAX encoder kernel fell back"
    skip, pooled = _port(x, ks, bs, pool)
    np.testing.assert_allclose(skip, np.asarray(out[0]), **TOL)
    if pool:
        np.testing.assert_allclose(pooled, np.asarray(out[1]), **TOL)
    else:
        assert pooled is None and out[1] is None


def test_block_matches_jax_reference():
    x, ks, bs = _case(2, 8, 8, [32, 64, 64], seed=11)
    jskip, jpool = reference_vgg_block(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                                       [jnp.asarray(b) for b in bs], pool=True)
    skip, pooled = _port(x, ks, bs, True)
    np.testing.assert_allclose(skip, np.asarray(jskip), **TOL)
    np.testing.assert_allclose(pooled, np.asarray(jpool), **TOL)
