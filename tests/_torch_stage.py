"""Shared by the training-kernel tests (``test_torch_unetup_paired_bwd.py``,
``test_torch_unetup_wide_bwd.py``, ``test_torch_upsample_wgrad.py``,
``test_torch_encoder_train.py``): one UnetUp stage's numpy inputs, the
comparison of a port training stage with a JAX one, and the error relative
to the reference's largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

NAMES = ("dskip", "dx", "dk1", "db1", "dk2", "db2")


def stage_case(seed, B, H, W, Cs, Cx, F, scale=0.1):
    """numpy inputs of one stage (HWIO kernels) and a cotangent of its
    natural output."""
    rng = np.random.RandomState(seed)
    skip = rng.randn(B, 2 * H, 2 * W, Cs).astype(np.float32)
    x = rng.randn(B, H, W, Cx).astype(np.float32)
    k1 = (rng.randn(3, 3, Cs + Cx, F) * scale).astype(np.float32)
    b1 = (rng.randn(F) * scale).astype(np.float32)
    k2 = (rng.randn(3, 3, F, F) * scale).astype(np.float32)
    b2 = (rng.randn(F) * scale).astype(np.float32)
    g = rng.randn(B, 2 * H, 2 * W, F).astype(np.float32)
    return (skip, x, k1, b1, k2, b2), g


def compare_with_jax(jax_fn, port_fn, args, g, tol):
    """Forward and the six gradients of ``port_fn`` (torch, OIHW weights)
    against ``jax_fn`` (HWIO) for cotangent ``g``, each within ``tol`` of
    max |JAX|."""
    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(g).reshape(jout.shape))
    targs = [torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 and i in (2, 4)
                              else a).requires_grad_() for i, a in enumerate(args)]
    out = port_fn(*targs)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(g))
    errs = {"out": rel_err(out.detach().numpy().reshape(jout.shape), jout)}
    for i, (name, t, j) in enumerate(zip(NAMES, grads, jgrads)):
        t = t.numpy()
        if i in (2, 4):
            t = t.transpose(2, 3, 1, 0)  # OIHW → HWIO
        assert t.shape == j.shape, name
        errs[name] = rel_err(t, j)
    assert all(e <= tol for e in errs.values()), errs


def rel_err(a, b):
    """max |a - b| / max |b| in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
