"""tpu_unet_torch/kernels/decoder_fuse.py (CPU path) against the JAX UnetUp
kernel in interpret mode and its XLA reference (float32), plus the host
tables the CUDA kernel's operand loader reads."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.decoder_fuse import _fused_unetup_fwd_impl, reference_unetup
from tpu_unet_torch.kernels.decoder_fuse import unetup
from tpu_unet_torch.nn.resize import lerp_tables, upsample2x


def _case(B, H, W, Cs, Cx, F, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    skip = rng.standard_normal((B, 2 * H, 2 * W, Cs)).astype(np.float32)
    x = rng.standard_normal((B, H, W, Cx)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, Cs + Cx, F)) * scale).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, F, F)) * scale).astype(np.float32)
    b2 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    return skip, x, k1, b1, k2, b2


def _port(skip, x, k1, b1, k2, b2):
    oihw = lambda k: torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # noqa: E731
    return unetup(torch.from_numpy(skip), torch.from_numpy(x), oihw(k1),
                  torch.from_numpy(b1), oihw(k2), torch.from_numpy(b2)).numpy()


@pytest.mark.parametrize("shape,tol", [
    # paired kernel body (F < 128); f32 with another summation order
    ((2, 16, 16, 8, 16, 8), 1e-5),
    # wide plane-paired kernel body (F >= 128); the JAX tests allow 2e-4
    ((1, 8, 8, 128, 128, 128), 2e-4),
])
def test_unetup_matches_jax_kernel(shape, tol):
    args = _case(*shape, seed=shape[-1], scale=0.1 if shape[-1] < 128 else 0.05)
    out = _fused_unetup_fwd_impl(*[jnp.asarray(a) for a in args])
    assert out is not None, "JAX decoder kernel fell back"
    np.testing.assert_allclose(_port(*args), np.asarray(out), rtol=tol, atol=tol)


def test_unetup_matches_jax_reference():
    args = _case(1, 8, 8, 16, 24, 32, seed=3)
    ref = reference_unetup(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(_port(*args), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_loader_tables_reproduce_upsample_bf16():
    """The CUDA loader's arithmetic on the (idx, wts) tables — H pass
    rounded to bf16, then W pass — gives exactly the plain version's bf16
    upsample (the kernel keeps the products unfused for this)."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 6, 10, 8)).astype(np.float32)).to(torch.bfloat16)
    ridx, rw = lerp_tables(6, 12, True, torch.bfloat16)
    cidx, cw = lerp_tables(10, 20, True, torch.bfloat16)
    xf = x.float()[0]
    out = torch.empty(12, 20, 8)
    for uy in range(12):
        for ux in range(20):
            r0, r1, q0, q1 = ridx[0, uy], ridx[1, uy], cidx[0, ux], cidx[1, ux]
            h0 = (xf[r0, q0] * rw[0, uy] + xf[r1, q0] * rw[1, uy]).to(torch.bfloat16).float()
            h1 = (xf[r0, q1] * rw[0, uy] + xf[r1, q1] * rw[1, uy]).to(torch.bfloat16).float()
            out[uy, ux] = (h0 * cw[0, ux] + h1 * cw[1, ux]).to(torch.bfloat16).float()
    assert torch.equal(out, upsample2x(x)[0].float())
