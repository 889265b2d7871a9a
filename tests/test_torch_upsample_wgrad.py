"""The plain versions of the two kernels the port of #14-#19 adds, against
JAX, and CPU emulations of the kernels' own index schemes against the plain
versions:

- ``upsample2x_adjoint_plain`` against ``jax.vjp`` of
  ``tpu_unet.nn.resize.upsample2x``; the gather tables of
  ``adjoint_tables`` (what ``csrc/upsample_adjoint.cu`` reads), summed as
  the kernel sums them, against the plain version;
- ``unetup_wgrad_plain`` against ``jax.vjp`` of ``reference_unetup`` (the
  weight and bias cotangents); the GEMMs of ``csrc/unetup_wgrad.cu`` on
  ``csrc/wgrad_sm90.cuh`` (im2col with each tap padded to 64-column boxes,
  split-K over 8 × 16 pixel patches, the partials added in split order,
  dk1's skip and up launches written into their channel ranges of one
  (F, Cs + Cx, 3, 3)) against the plain version.

All float32 and cheap (no interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from _torch_stage import rel_err, stage_case

from tpu_unet.kernels.decoder_fuse import reference_unetup
from tpu_unet.nn.resize import upsample2x as jax_upsample2x
from tpu_unet_torch.kernels import decoder_train, sm90
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


def _im2col(v, cp):
    """(P, 9 cp) operand of the forward conv, column tap * cp + c for
    c < C, each tap's C channels padded to cp with zeros (TMA's fill past
    the input's width), zero outside the image (the SAME halo)."""
    B, H, W, C = v.shape
    p = np.pad(v, ((0, 0), (1, 1), (1, 1), (0, cp - C)))
    cols = [p[:, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)]
    return np.concatenate(cols, axis=-1).reshape(B * H * W, 9 * cp)


def _patch_pixels(B, H, W):
    """Pixel rows (b, y, x order) of each 8 × 16 patch, patches in the
    GEMM's (b, patch row, patch column) order."""
    idx = np.arange(B * H * W).reshape(B, H // 8, 8, W // 16, 16)
    return idx.transpose(0, 1, 3, 2, 4).reshape(-1, 128)


def _gemm_like_kernel(v, gout, nsplit, ctot=None, coff=0, dk=None):
    """csrc/wgrad_sm90.cuh's arithmetic on the CPU: per split, the partial
    G^T A over its contiguous range of 8 × 16 pixel patches
    (``sm90.split_ranges``), with each tap of A padded to tap_width(C)
    columns; the partials and the column sums added in split order; the
    reduce pass dropping the padding and writing channels [coff, coff + C)
    of an (F, ctot, 3, 3) gradient."""
    B, H, W, c = v.shape
    cp = sm90.tap_width(c)
    a, gm = _im2col(v, cp), gout.reshape(-1, gout.shape[-1])
    pix = _patch_pixels(B, H, W)
    f = gm.shape[1]
    part, db = np.zeros((f, 9 * cp), np.float32), np.zeros(f, np.float32)
    for lo, hi in sm90.split_ranges(len(pix), nsplit):
        rows = pix[lo:hi].reshape(-1)
        part += gm[rows].T @ a[rows]
        db += gm[rows].sum(0)
    ctot = c if ctot is None else ctot
    dk = np.zeros((f, ctot, 3, 3), np.float32) if dk is None else dk
    dk[:, coff:coff + c] = part.reshape(f, 3, 3, cp)[..., :c].transpose(0, 3, 1, 2)
    return dk, db


@pytest.mark.parametrize("nsplit", [1, 3])
def test_kernel_gemm_layout_matches_plain(nsplit):
    """The Hopper GEMM's scheme (``unetup_wgrad``: dk1 as two launches over
    skip and over up2x(x), each writing its channel range of one dk1, db1
    from the first; dk2 over y1) gives the plain version's dk1 / dk2 and
    bias sums (1e-5 of max); Cs = 8 pads each tap to 64 columns."""
    (skip, x, k1, b1, k2, b2), g = stage_case(5, 2, 8, 16, 8, 16, 8)
    ts, tx, dz1, y1, g2 = _port_chain(skip, x, k1, b1, k2, b2, g)
    ref = unetup_wgrad_plain(ts, tx, dz1, y1, g2)
    cs, cx = ts.shape[-1], tx.shape[-1]
    dk1, db1 = _gemm_like_kernel(ts.numpy(), dz1.numpy(), nsplit, cs + cx, 0)
    dk1, _ = _gemm_like_kernel(upsample2x(tx).numpy(), dz1.numpy(), nsplit, cs + cx, cs, dk1)
    dk2, db2 = _gemm_like_kernel(y1.numpy(), g2.numpy(), nsplit)
    for name, a, b in zip(("dk1", "db1", "dk2", "db2"), (dk1, db1, dk2, db2), ref):
        assert rel_err(a, b.numpy()) <= 1e-5, name


@pytest.mark.parametrize("h,cs,cx,f", [(256, 64, 128, 64), (128, 128, 256, 128),
                                       (64, 256, 512, 256), (32, 512, 512, 512)])
def test_wgrad_split_fills_the_card(h, cs, cx, f):
    """At unet_vgg's stages (512², batch 8) the split-K of each of the
    stage's three Hopper GEMMs fills the 132 SMs of an H100 (at least 4
    waves of blocks or a last wave at least 85% full), keeps at least 8
    patches a split, and keeps the partials within the 50 MB L2 that the
    reduce pass reads them from."""
    launches = sm90.unetup_wgrad_launches(8, 2 * h, 2 * h, cs, cx, f)
    assert decoder_train.wgrad_plan(8, 2 * h, 2 * h, cs, cx, f)[1] == \
        tuple(ln["nsplit"] for ln in launches)
    for ln in launches:
        blocks = ln["grid"][0] * ln["grid"][1] * ln["nsplit"]
        waves = blocks / 132
        assert waves >= 4 or waves / -(-waves // 1) >= 0.85
        assert ln["npatch"] // ln["nsplit"] >= 8
        assert ln["nsplit"] * f * ln["k"] * 4 <= 50 * 2**20
