"""The plain versions of the two kernels the port of #14-#19 adds, against
JAX, and CPU emulations of the kernels' own index schemes against the plain
versions:

- ``upsample2x_adjoint_plain`` against ``jax.vjp`` of
  ``tpu_unet.nn.resize.upsample2x``; the gather tables of
  ``adjoint_tables`` (what ``csrc/upsample_adjoint.cu`` reads), summed as
  the kernel sums them, against the plain version;
- ``unetup_wgrad_plain`` against ``jax.vjp`` of ``reference_unetup`` (the
  weight and bias cotangents); the pixel-major GEMM of
  ``csrc/unetup_wgrad.cu`` (im2col of the forward loader's packed K
  ``(ky * 3 + kx) * C + c``, split-K over 32-pixel chunks, the partials
  added in split order, written as (F, C, 3, 3)) against the plain version.

All float32 and cheap (no interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stage import rel_err, stage_case

from tpu_unet.kernels.decoder_fuse import reference_unetup
from tpu_unet.nn.resize import upsample2x as jax_upsample2x
from tpu_unet_torch.kernels import decoder_train
from tpu_unet_torch.kernels.decoder_fuse import _unetup_plain_y1
from tpu_unet_torch.kernels.decoder_train import unetup_bwd_plain, unetup_wgrad_plain
from tpu_unet_torch.nn.resize import (adjoint_tables, lerp_tables, upsample2x,
                                      upsample2x_adjoint_plain)


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 8, 8, 16), (1, 1, 3, 8)])
def test_adjoint_plain_matches_jax_vjp(shape):
    """float32: the same two-tap sums in another order, 1e-6 of max |JAX|."""
    b, h, w, c = shape
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    dup = rng.randn(b, 2 * h, 2 * w, c).astype(np.float32)
    _, vjp = jax.vjp(jax_upsample2x, jnp.asarray(x))
    ref, = vjp(jnp.asarray(dup))
    got = upsample2x_adjoint_plain(torch.from_numpy(dup), h, w)
    assert got.shape == (b, h, w, c)
    assert rel_err(got, ref) <= 1e-6


def _gather_adjoint(dup, h, w, dtype):
    """The kernel's sum: for each low-res (i, j), over its row list (outer)
    and column list (inner) of (index, weight), in table order, float32."""
    ridx, rw = (t.numpy() for t in adjoint_tables(h, dtype))
    cidx, cw = (t.numpy() for t in adjoint_tables(w, dtype))
    d = dup.float().numpy()
    out = np.zeros((d.shape[0], h, w, d.shape[-1]), np.float32)
    for i in range(h):
        for j in range(w):
            acc = np.zeros((d.shape[0], d.shape[-1]), np.float32)
            for u, wr in zip(ridx[i], rw[i]):
                if u < 0:
                    break
                row = np.zeros_like(acc)
                for v, wc in zip(cidx[j], cw[j]):
                    if v < 0:
                        break
                    row = row + np.float32(wc) * d[:, u, v]
                acc = acc + np.float32(wr) * row
            out[:, i, j] = acc
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_tables_cover_the_lerp(dtype):
    """Every (output position, tap) pair of ``lerp_tables`` appears once in
    the tables, with its weight; the gather sum equals the plain adjoint
    (float32 within 1e-6 of max; bf16 within one ulp of the element)."""
    h, w = 6, 9
    for n in (h, w):
        idx, wts = lerp_tables(n, 2 * n, True, dtype)
        t_idx, t_w = adjoint_tables(n, dtype)
        pairs = sorted((int(idx[k, u]), u, float(wts[k, u])) for u in range(2 * n)
                       for k in (0, 1))
        got = sorted((i, int(u), float(wt)) for i in range(n)
                     for u, wt in zip(t_idx[i], t_w[i]) if u >= 0)
        assert got == pairs
    dup = torch.from_numpy(np.random.RandomState(1).randn(2, 2 * h, 2 * w, 8)
                           .astype(np.float32)).to(dtype)
    ref = upsample2x_adjoint_plain(dup, h, w)
    got = _gather_adjoint(dup, h, w, dtype)
    if dtype == torch.float32:
        assert rel_err(got, ref) <= 1e-6
    else:
        ulp = 2.0 ** -7 * ref.float().abs()
        assert bool(((got.float() - ref.float()).abs() <= ulp + 1e-30).all())


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _port_chain(skip, x, k1, b1, k2, b2, g):
    """The port's forward keeping y1, then #13's plain chain: the wgrad
    inputs (skip, x, dz1, y1, g2) as torch tensors."""
    ts, tx = torch.from_numpy(skip), torch.from_numpy(x)
    w1, w2 = _oihw(k1), _oihw(k2)
    out, y1 = _unetup_plain_y1(ts, tx, w1, torch.from_numpy(b1), w2, torch.from_numpy(b2))
    _, _, g2, dz1 = unetup_bwd_plain(torch.from_numpy(g), out, y1, w1, w2, skip.shape[-1])
    return ts, tx, dz1, y1, g2


@pytest.mark.parametrize("shape", [(1, 4, 4, 8, 16, 8), (2, 4, 8, 16, 16, 16)])
def test_wgrad_plain_matches_jax_vjp(shape):
    """dk1, db1, dk2, db2 against ``jax.vjp(reference_unetup)``'s weight and
    bias cotangents: float32 sums in another order, 1e-5 of max |JAX|."""
    (skip, x, k1, b1, k2, b2), g = stage_case(4, *shape)
    _, vjp = jax.vjp(reference_unetup, *(jnp.asarray(a) for a in (skip, x, k1, b1, k2, b2)))
    ref = vjp(jnp.asarray(g))
    got = unetup_wgrad_plain(*_port_chain(skip, x, k1, b1, k2, b2, g))
    for name, a, b in zip(("dk1", "db1", "dk2", "db2"), got, (ref[2], ref[3], ref[4], ref[5])):
        a = a.numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW → HWIO
        assert a.dtype == np.float32
        assert rel_err(a, b) <= 1e-5, (name, rel_err(a, b))


def _im2col(v):
    """(P, 9C) operand of the forward conv, K index (ky * 3 + kx) * C + c,
    zero outside the image (the loaders' SAME padding)."""
    B, H, W, C = v.shape
    p = np.pad(v, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = [p[:, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, axis=-1).reshape(B * H * W, 9 * C)


def _gemm_like_kernel(v, gout, nsplit):
    """csrc/unetup_wgrad.cu's arithmetic on the CPU: per split, the partial
    G^T A over its 32-pixel chunks; the partials and the column sums added
    in split order; (F, 9C) → (F, C, 3, 3)."""
    a, gm = _im2col(v), gout.reshape(-1, gout.shape[-1])
    nch = a.shape[0] // decoder_train.WGRAD_CHUNK
    f, k = gm.shape[1], a.shape[1]
    dk, db = np.zeros((f, k), np.float32), np.zeros(f, np.float32)
    for s in range(nsplit):
        lo = s * nch // nsplit * decoder_train.WGRAD_CHUNK
        hi = (s + 1) * nch // nsplit * decoder_train.WGRAD_CHUNK
        dk += gm[lo:hi].T @ a[lo:hi]
        db += gm[lo:hi].sum(0)
    c = v.shape[-1]
    return dk.reshape(f, 3, 3, c).transpose(0, 3, 1, 2), db


@pytest.mark.parametrize("nsplit", [1, 3])
def test_kernel_gemm_layout_matches_plain(nsplit):
    """The kernel's pixel-major GEMM and its output layout give the plain
    version's dk1 / dk2 and bias sums (1e-5 of max)."""
    (skip, x, k1, b1, k2, b2), g = stage_case(5, 2, 4, 8, 8, 16, 8)
    ts, tx, dz1, y1, g2 = _port_chain(skip, x, k1, b1, k2, b2, g)
    ref = unetup_wgrad_plain(ts, tx, dz1, y1, g2)
    cc = torch.cat([ts, upsample2x(tx)], -1)
    dk1, db1 = _gemm_like_kernel(cc.numpy(), dz1.numpy(), nsplit)
    dk2, db2 = _gemm_like_kernel(y1.numpy(), g2.numpy(), nsplit)
    for name, a, b in zip(("dk1", "db1", "dk2", "db2"), (dk1, db1, dk2, db2), ref):
        assert rel_err(a, b.numpy()) <= 1e-5, name


@pytest.mark.parametrize("h,cs,cx,f", [(256, 64, 128, 64), (128, 128, 256, 128),
                                       (64, 256, 512, 256), (32, 512, 512, 512)])
def test_wgrad_split_fills_the_card(h, cs, cx, f):
    """At unet_vgg's stages (512², batch 8) the split-K gives each GEMM at
    least two blocks per streaming multiprocessor (132 on an H100) and keeps
    the partials under 32 MB (one partial per pixel tile would take up to
    19 MB a tile at up4)."""
    n_pix = 8 * (2 * h) ** 2
    for c in (cs + cx, f):
        tiles = (f // 64) * (9 * c // 64)
        ns = decoder_train._wgrad_splits(tiles, n_pix)
        assert tiles * ns >= 2 * 132
        assert ns * f * 9 * c * 4 <= 32 * 2**20
