"""``nn/blocks.py::bn`` in train mode against flax's ``nn.BatchNorm`` (the
JAX package's ``batch_norm``) on the CPU: the output and the updated
running statistics in float64 (flax under ``jax.enable_x64``)
and in float32, on seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from jax import enable_x64

from tpu_unet.nn.blocks import batch_norm
from tpu_unet_torch.nn.blocks import bn


def _case(dtype, seed=0, n=4, c=6, h=5, w=7):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((n, c, h, w)) + 1.5).astype(dtype)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(dtype), rng.standard_normal(c).astype(dtype)
    mean, var = rng.standard_normal(c).astype(dtype), rng.uniform(0.5, 2.0, c).astype(dtype)
    return x, scale, bias, mean, var


def _flax(x, scale, bias, mean, var):
    """flax's train-mode batch norm of NCHW ``x`` (flax takes NHWC)."""
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    y, mut = batch_norm(True, "bn").apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                          mutable=["batch_stats"])
    stats = mut["batch_stats"]
    return (np.asarray(y).transpose(0, 3, 1, 2), np.asarray(stats["mean"]),
            np.asarray(stats["var"]))


def _port(x, scale, bias, mean, var, dtype):
    m = torch.nn.BatchNorm2d(x.shape[1]).to(dtype)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean))
        m.running_var.copy_(torch.from_numpy(var))
        y = bn(torch.from_numpy(x), m, train=True)
    return y.numpy(), m.running_mean.numpy(), m.running_var.numpy()


def test_bn_float64_matches_flax():
    """A float64 input: statistics and normalisation in float64 on both
    sides, output and running statistics within 1e-12 (relative to each
    one's largest magnitude)."""
    case = _case(np.float64)
    with enable_x64(True):
        ref = _flax(*case)
    assert all(r.dtype == np.float64 for r in ref)
    got = _port(*case, torch.float64)
    for name, g, r in zip(("y", "running_mean", "running_var"), got, ref):
        assert g.dtype == np.float64, name
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= 1e-12, (name, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_bn_float32_matches_flax(seed):
    """A float32 input stays in float32 (as before the float64 repair):
    within 1e-5 of flax, whose sums run in another order."""
    case = _case(np.float32, seed)
    ref = _flax(*case)
    got = _port(*case, torch.float32)
    for name, g, r in zip(("y", "running_mean", "running_var"), got, ref):
        assert g.dtype == np.float32, name
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= 1e-5, (name, err)
