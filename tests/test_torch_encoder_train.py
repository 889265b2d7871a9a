"""The port of the training encoder (``kernels/encoder_train.py``: the stem
#2 / #20, block 2 #21 / #22, blocks 3-5 #23 / #24) on its plain versions,
against ``jax.vjp`` of the references JAX's training VJPs are held to
(``reference_vgg_stem``, ``reference_vgg_block``, ``encoder3_train._ref``;
their untileable-shape fallback is that same VJP): the forward and every
gradient for one numpy cotangent of each output, float32 on the CPU.  The
2×2 max-pool's gradient goes to the first maximum of its window, as XLA's
select-and-scatter routes it; a case with tied maxima holds the port's
routing to ``jax.vjp`` of ``tpu_unet.nn.blocks.max_pool2``.

Tolerance: 1e-5 of max |JAX| — float32 convolutions summed in another
order (about 1e-7 relative each) through at most three dgrads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from _torch_stage import rel_err

from tpu_unet.kernels.encoder import reference_vgg_block
from tpu_unet.kernels.encoder3_train import _ref as block3_ref
from tpu_unet.kernels.stem import reference_vgg_stem
from tpu_unet.nn.blocks import max_pool2
from tpu_unet_torch.kernels.encoder_train import (pool_relu_grad_plain, vgg_block_train,
                                                  vgg_stem_train)

TOL = 1e-5


def _case(seed, B, H, W, chans, scale=0.2):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, chans[0]).astype(np.float32)
    ks = [(rng.randn(3, 3, c, f) * scale / np.sqrt(c)).astype(np.float32)
          for c, f in zip(chans[:-1], chans[1:])]
    bs = [(rng.randn(f) * 0.1).astype(np.float32) for f in chans[1:]]
    return x, ks, bs, rng


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def _oihw(k):
    return _torch(k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("chans,pool", [([8, 16, 16], True), ([16, 32, 32, 32], True),
                                        ([16, 32, 32, 32], False)])
def test_block_matches_jax_vjp(chans, pool):
    """Block 2 (two convs, pool: #21 / #22) against ``reference_vgg_block``,
    blocks 3-5 (three convs, pool or not — block 5 has none: #23 / #24)
    against ``encoder3_train._ref``; dx and every dk / db."""
    x, ks, bs, rng = _case(len(chans) + pool, 2, 8, 16, chans)
    n = len(ks)

    def jfn(x, *kb):
        if n == 2:
            return reference_vgg_block(x, list(kb[:2]), list(kb[2:]), pool=pool)
        return block3_ref(x, kb[0], kb[3], kb[1], kb[4], kb[2], kb[5], pool)

    jout, vjp = jax.vjp(jfn, jnp.asarray(x), *map(jnp.asarray, ks), *map(jnp.asarray, bs))
    gskip = rng.randn(*jout[0].shape).astype(np.float32)
    gpool = rng.randn(*jout[1].shape).astype(np.float32) if pool else None
    jg = vjp((jnp.asarray(gskip), None if gpool is None else jnp.asarray(gpool)))
    tx, tks, tbs = _torch(x), [_oihw(k) for k in ks], [_torch(b) for b in bs]
    skip, pooled = vgg_block_train(tx, tks, tbs, pool)
    assert (pooled is None) == (not pool)
    assert rel_err(skip.detach(), jout[0]) <= TOL
    outs, cots = [skip], [torch.from_numpy(gskip)]
    if pool:
        assert rel_err(pooled.detach(), jout[1]) <= TOL
        outs.append(pooled)
        cots.append(torch.from_numpy(gpool))
    grads = torch.autograd.grad(outs, [tx, *tks, *tbs], cots)
    assert rel_err(grads[0], jg[0]) <= TOL
    for i in range(n):
        assert rel_err(grads[1 + i].numpy().transpose(2, 3, 1, 0), jg[1 + i]) <= TOL, f"dk{i}"
        assert rel_err(grads[1 + n + i], jg[1 + n + i]) <= TOL, f"db{i}"


def test_stem_matches_jax_vjp():
    """The stem (#2 / #20) against ``reference_vgg_stem``, whose skip is
    column-paired (the free reshape of the port's natural one): every dk /
    db; the image gets no gradient (JAX's training VJP returns zeros)."""
    x, ks, bs, rng = _case(7, 2, 8, 16, [3, 16, 16])
    jout, vjp = jax.vjp(reference_vgg_stem, jnp.asarray(x), jnp.asarray(ks[0]),
                        jnp.asarray(bs[0]), jnp.asarray(ks[1]), jnp.asarray(bs[1]))
    gskip = rng.randn(2, 8, 16, 16).astype(np.float32)
    gpool = rng.randn(*jout[1].shape).astype(np.float32)
    jg = vjp((jnp.asarray(gskip).reshape(jout[0].shape), jnp.asarray(gpool)))
    tx = torch.from_numpy(x)
    tks, tbs = [_oihw(k) for k in ks], [_torch(b) for b in bs]
    skip, pooled = vgg_stem_train(tx, tks[0], tbs[0], tks[1], tbs[1])
    assert rel_err(skip.detach().reshape(jout[0].shape), jout[0]) <= TOL
    assert rel_err(pooled.detach(), jout[1]) <= TOL
    grads = torch.autograd.grad([skip, pooled], [tks[0], tbs[0], tks[1], tbs[1]],
                                [torch.from_numpy(gskip), torch.from_numpy(gpool)])
    for i, (t, j) in enumerate(zip(grads, jg[1:])):
        t = t.numpy()
        assert rel_err(t.transpose(2, 3, 1, 0) if t.ndim == 4 else t, j) <= TOL, i


def test_pool_routes_to_first_max_as_jax():
    """Tied maxima (values on a coarse grid): the pooled gradient goes to the
    first maximum of each 2×2 window in row-major order, as ``jax.vjp`` of
    ``max_pool2`` (select-and-scatter) routes it; then the ReLU mask."""
    rng = np.random.RandomState(3)
    out = np.maximum(rng.randint(-2, 3, (2, 8, 8, 16)), 0).astype(np.float32)
    dskip = rng.randn(*out.shape).astype(np.float32)
    dpool = rng.randn(2, 4, 4, 16).astype(np.float32)
    _, vjp = jax.vjp(max_pool2, jnp.asarray(out))
    routed, = vjp(jnp.asarray(dpool))
    ref = np.where(out > 0, dskip + np.asarray(routed), 0.0)
    got = pool_relu_grad_plain(torch.from_numpy(dskip), torch.from_numpy(dpool),
                               torch.from_numpy(out))
    assert np.array_equal(got.numpy(), ref)
