"""tpu_unet_torch/kernels/postprocess.py (CPU path) against the JAX serving
tails in interpret mode — the paired tail of the canonical UNets, the
natural-layout tail of the TraditionalUnet family and its mask-only
kernel — the shape rule of the CUDA side, plus the conv weight packing the
CUDA conv core reads."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
import torch.nn.functional as F

from tpu_unet.kernels.postprocess import (fused_final_argmax,
                                          fused_final_argmax_hist,
                                          fused_final_argmax_hist_paired)
from tpu_unet_torch.kernels import _build, launch_counts
from tpu_unet_torch.kernels.postprocess import (_final_argmax_cuda,
                                                _final_argmax_hist_cuda,
                                                final_argmax, final_argmax_hist,
                                                masks_and_hist)


@pytest.mark.parametrize("n,h,w,f,c", [(2, 64, 64, 8, 5), (1, 32, 128, 16, 21)])
def test_tail_matches_jax_kernel(n, h, w, f, c):
    rng = np.random.default_rng(f + c)
    feats = rng.standard_normal((n, h, w, f)).astype(np.float32)
    kern = rng.standard_normal((1, 1, f, c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jm, jh = fused_final_argmax_hist_paired(
        jnp.asarray(feats.reshape(n, h, w // 2, 2 * f)), jnp.asarray(kern),
        jnp.asarray(bias), c, interpret=True)
    jm, jh = np.asarray(jm), np.asarray(jh)
    masks, hist = final_argmax_hist(
        torch.from_numpy(feats),
        torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias), c)
    masks, hist = masks.numpy(), hist.numpy()
    assert masks.dtype == np.uint8 and hist.dtype == np.int32
    # masks identical wherever the top-1/top-2 logit gap exceeds 1e-5 of
    # the logit scale (f32 dot products summed in another order)
    logits = feats.reshape(-1, f) @ kern[0, 0] + bias
    top2 = np.sort(logits, axis=-1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]).reshape(masks.shape)
    differ = masks != jm
    assert not np.any(differ & (gap > 1e-5 * np.abs(logits).max()))
    for i in range(n):
        np.testing.assert_array_equal(hist[i], np.bincount(masks[i].ravel(), minlength=c))
    if not differ.any():
        np.testing.assert_array_equal(hist, jh.astype(np.int32))


def _natural_case(n, h, w, f, c):
    rng = np.random.default_rng(7 * f + h)
    feats = rng.standard_normal((n, h, w, f)).astype(np.float32)
    kern = rng.standard_normal((1, 1, f, c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    torch_args = (torch.from_numpy(feats),
                  torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                  torch.from_numpy(bias), c)
    return (jnp.asarray(feats), jnp.asarray(kern), jnp.asarray(bias)), torch_args


# traditional (F = 32) and traditional22 (F = 22), DataB's 4 classes; H·W a
# multiple of the JAX tail's 1024-row block, so its histogram kernel runs
@pytest.mark.parametrize("n,h,w,f,c", [(2, 32, 32, 32, 4), (2, 32, 64, 22, 4),
                                       (1, 64, 32, 22, 21)])
def test_natural_tail_matches_jax_kernel(n, h, w, f, c):
    jargs, targs = _natural_case(n, h, w, f, c)
    jm, jh = (np.asarray(a) for a in fused_final_argmax_hist(*jargs, c, interpret=True))
    runs = launch_counts["final_argmax_hist"]
    masks, hist = final_argmax_hist(*targs)
    assert launch_counts["final_argmax_hist"] == runs  # the CPU path launches nothing
    assert masks.dtype == torch.uint8 and hist.dtype == torch.int32
    # f32 on both sides; no near-tie at these seeds
    np.testing.assert_array_equal(masks.numpy(), jm)
    np.testing.assert_array_equal(hist.numpy(), jh.astype(np.int32))


# pixel counts that the 2048-row block of fused_final_argmax does not divide
@pytest.mark.parametrize("n,h,w,f,c", [(2, 20, 30, 32, 4), (3, 25, 25, 22, 4),
                                       (1, 40, 40, 64, 21)])
def test_mask_only_tail_matches_jax_kernel(n, h, w, f, c):
    jargs, targs = _natural_case(n, h, w, f, c)
    jm = np.asarray(fused_final_argmax(*jargs, interpret=True))
    runs = launch_counts["final_argmax"]
    masks = final_argmax(*targs)
    assert launch_counts["final_argmax"] == runs
    assert masks.dtype == torch.uint8 and masks.shape == (n, h, w)
    np.testing.assert_array_equal(masks.numpy(), jm)
    # the JAX histogram tail falls back to the same kernel at these sizes
    jm2, jh = (np.asarray(a) for a in fused_final_argmax_hist(*jargs, c, interpret=True))
    m2, hist = masks_and_hist(masks, c)
    np.testing.assert_array_equal(m2.numpy(), jm2)
    np.testing.assert_array_equal(hist.numpy(), jh.astype(np.int32))


@pytest.mark.parametrize("fn,shape,c,rule", [
    (_final_argmax_hist_cuda, (1, 16, 16, 48), 4, "F=48"),        # F not instantiated
    (_final_argmax_hist_cuda, (1, 16, 16, 32), 33, "classes=33"),  # C > 32
    (_final_argmax_hist_cuda, (1, 10, 10, 32), 4, "H\\*W=100"),   # block spans images
    (_final_argmax_cuda, (1, 10, 10, 16), 4, "F=16"),
    (_final_argmax_cuda, (1, 10, 10, 22), 40, "classes=40"),
])
def test_tail_kernels_refuse_untileable_shapes(fn, shape, c, rule):
    """The shape rule is checked before the device: it raises on any
    device, and never falls back."""
    feats = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=rule):
        fn(feats, torch.zeros(c, shape[-1], 1, 1), torch.zeros(c), c)


def test_pack_conv3x3_is_the_kernel_gemm():
    """The conv core computes sum_k A[p, k] * Wt[n, k] with
    k = (ky * 3 + kx) * C + c; the packed weights under that im2col order
    must reproduce F.conv2d."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 5, 7, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8, 3, 3)).astype(np.float32))
    wt = _build.pack_conv3x3(w, 80).float()
    assert wt.shape == (16, 80) and not wt[:, 72:].any()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ky:ky + 5, kx:kx + 7, :] for ky in range(3)
                      for kx in range(3)], dim=-1)            # (1, 5, 7, 72)
    out = cols @ wt[:, :72].t()
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.to(torch.bfloat16).float(),
                   padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
