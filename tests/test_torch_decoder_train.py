"""The plain version of #13 (``kernels/decoder_train.py::unetup_bwd``)
against ``tpu_unet``'s ``fused_unetup_bwd_impl`` (Pallas in interpret mode,
``block_rows=8``) on all four outputs, and ``unetup_train``'s gradients
against ``jax.grad`` of ``fused_unetup_train`` and of ``reference_unetup``
at the shapes of ``tests/test_decoder_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.decoder_fuse import fused_unetup_train, reference_unetup
from tpu_unet.kernels.decoder_train import fused_unetup_bwd_impl
from tpu_unet_torch.kernels.decoder_fuse import unetup_train
from tpu_unet_torch.kernels.decoder_train import unetup_bwd_plain

SHAPES = [(1, 8, 8, 8, 16, 8), (2, 8, 16, 4, 8, 16)]


def _case(seed, B, H, W, Cs, Cx, F):
    rng = np.random.RandomState(seed)
    skip = rng.randn(B, 2 * H, 2 * W, Cs).astype(np.float32)
    x = rng.randn(B, H, W, Cx).astype(np.float32)
    k1 = (rng.randn(3, 3, Cs + Cx, F) * 0.1).astype(np.float32)
    b1 = (rng.randn(F) * 0.1).astype(np.float32)
    k2 = (rng.randn(3, 3, F, F) * 0.1).astype(np.float32)
    b2 = (rng.randn(F) * 0.1).astype(np.float32)
    return skip, x, k1, b1, k2, b2


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_pallas(shape):
    B, H, W, Cs, Cx, F = shape
    skip, x, k1, b1, k2, b2 = _case(1, *shape)
    rng = np.random.RandomState(2)
    g = rng.randn(B, 2 * H, 2 * W, F).astype(np.float32)
    out = rng.randn(B, 2 * H, 2 * W, F).astype(np.float32)
    y1 = rng.randn(B, 2 * H, 2 * W, F).astype(np.float32)
    ref = fused_unetup_bwd_impl(jnp.asarray(g), jnp.asarray(out), jnp.asarray(y1),
                                jnp.asarray(k1), jnp.asarray(k2), Cs, block_rows=8)
    assert ref is not None
    res = unetup_bwd_plain(torch.from_numpy(g), torch.from_numpy(out),
                           torch.from_numpy(y1), _oihw(k1), _oihw(k2), Cs)
    for name, a, b in zip(("dskip", "dups", "g2", "dz1"), res, ref):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    np.testing.assert_array_equal(res[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("shape", SHAPES)
def test_unetup_train_grads_match_jax(shape):
    skip, x, k1, b1, k2, b2 = _case(3, *shape)
    jargs = [jnp.asarray(a) for a in (skip, x, k1, b1, k2, b2)]

    def loss_f(fn):
        return lambda *a: jnp.sum(fn(*a) ** 2)

    g_fus = jax.grad(loss_f(fused_unetup_train), argnums=tuple(range(6)))(*jargs)
    g_ref = jax.grad(loss_f(reference_unetup), argnums=tuple(range(6)))(*jargs)
    targs = [torch.from_numpy(skip), torch.from_numpy(x), _oihw(k1),
             torch.from_numpy(b1), _oihw(k2), torch.from_numpy(b2)]
    targs = [t.clone().requires_grad_() for t in targs]
    (unetup_train(*targs) ** 2).sum().backward()
    for i, (t, a, b) in enumerate(zip(targs, g_fus, g_ref)):
        got = t.grad.numpy()
        if got.ndim == 4 and i in (2, 4):
            got = got.transpose(2, 3, 1, 0)  # OIHW → HWIO
        assert _rel(got, a) <= 2e-4, (i, _rel(got, a))
        assert _rel(got, b) <= 2e-4, (i, _rel(got, b))
