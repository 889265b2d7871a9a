"""tpu_unet_torch/kernels/upconv.py (CPU path) against the JAX up_conv head
kernel in interpret mode and its XLA reference (float32), plus the shape
rule of the CUDA side."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.upconv import fused_upconv_impl, reference_upconv
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.kernels.upconv import _upconv_cuda, upconv, upconv_plain

# the JAX package's own upconv test shapes (B, H, W, Cx, F)
SHAPES = [(1, 8, 8, 16, 8), (2, 8, 16, 8, 16)]


def _case(B, H, W, Cx, F, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Cx)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, Cx, F)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, F, F)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    return x, k1, b1, k2, b2


def _port(x, k1, b1, k2, b2):
    oihw = lambda k: torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # noqa: E731
    return upconv(torch.from_numpy(x), oihw(k1), torch.from_numpy(b1),
                  oihw(k2), torch.from_numpy(b2)).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_upconv_matches_jax_kernel(shape):
    args = _case(*shape)
    out = fused_upconv_impl(*[jnp.asarray(a) for a in args])
    assert out is not None, "JAX up_conv kernel fell back"
    B, H2, W, F2 = out.shape
    # unpair the column-paired (B, 2H, W, 2F) output to (B, 2H, 2W, F)
    ref = np.asarray(out).reshape(B, H2, 2 * W, F2 // 2)
    n = launch_counts["upconv"]
    port = _port(*args)
    assert launch_counts["upconv"] == n  # the CPU path launches nothing
    assert port.shape == ref.shape
    # the JAX upconv tests' tolerance
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_upconv_matches_jax_reference(shape):
    args = _case(*shape, seed=6)
    ref = np.asarray(reference_upconv(*[jnp.asarray(a) for a in args]))
    # f32 both sides, two convs summed in another order
    np.testing.assert_allclose(_port(*args), ref, rtol=1e-5, atol=1e-5)


def test_upconv_plain_keeps_bf16():
    x, k1, b1, k2, b2 = (torch.from_numpy(a).to(torch.bfloat16)
                         for a in _case(1, 4, 8, 16, 8))
    oihw = lambda k: k.permute(3, 2, 0, 1)  # noqa: E731
    out = upconv_plain(x, oihw(k1), b1, oihw(k2), b2)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 8, 16, 8)
    assert out.is_contiguous()


@pytest.mark.parametrize("h,w,cx,f", [(3, 8, 64, 64),    # 2H % 8
                                      (4, 4, 64, 64),    # 2W % 16
                                      (4, 8, 48, 64),    # Cx % 32 (K % 32)
                                      (4, 8, 64, 32)])   # F % 64
def test_upconv_kernel_refuses_untileable_shapes(h, w, cx, f):
    """The shape rule is checked before the device: a shape the kernel
    cannot take raises, on any device, and never falls back."""
    bf = torch.bfloat16
    x = torch.zeros(1, h, w, cx, dtype=bf)
    w1, w2 = torch.zeros(f, cx, 3, 3, dtype=bf), torch.zeros(f, f, 3, 3, dtype=bf)
    b = torch.zeros(f, dtype=bf)
    with pytest.raises(ValueError, match="upconv kernel"):
        _upconv_cuda(x, w1, b, w2, b)
