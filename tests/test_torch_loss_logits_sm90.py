"""The Hopper logit-level loss's host plan and numerics on the CPU
(``csrc/loss_logits.cu``, #25 / #26; the kernels themselves run in
``tests/test_torch_gpu.py`` on the card).  No JAX here: the plain
versions these emulations are held to are held against JAX in
``tests/test_torch_loss_logits.py``.

- ``logit_loss_plan`` for the class counts the kernels take, bf16 and
  float32, forward and backward: G threads a pixel and K (4, 6 or 8)
  classes a thread, the fewest that hold C; a tile of a power of two
  pixels whose logits and target bytes are whole multiples of 16 bytes
  and whose pixel slots make whole steps of every consumer thread; a ring
  that fits the 227 KB a block may take and keeps at least 32 KB in
  flight, room in the idle ring for the end-of-block reductions;
  ``logit_loss_grid``: one block a tile, at most 132, so a partial sum's
  pixels depend on n only.
- The forward's sums emulated in float32 in the kernel's order (each
  thread's pixel slots in turn, shuffles within a pixel's group, the lanes
  of the same classes, warps in order, blocks in row order), then
  ``_finish``, against
  ``_sums`` / ``_finish`` in float64, at pixel counts no tile divides:
  rows past n count nowhere.
- The backward's device prologue (A, B, A + B, inv) in the C code's
  float32 operations equals ``dice_coefs`` / ``_inv``, CE and focal, dice
  on and off, with zero-weight classes; its per-pixel dlogits from those
  coefficients match ``_dlogits`` in float64.
"""
import math

import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet_torch.kernels import loss as L

CLASSES = [1, 4, 16, 21, 126]
SMEM_MAX = 232448  # a block's dynamic shared memory on an H100, 227 KB
NC = L.LOGIT_THREADS  # consumer threads a block
NO_CLASS = 1024
f32 = np.float32


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("f32_logits", [False, True])
@pytest.mark.parametrize("c", CLASSES)
def test_plan_rule(c, f32_logits, backward):
    p = L.logit_loss_plan(c, f32_logits, backward)
    size = 4 if f32_logits else 2
    # G threads a pixel: the fewest powers of two of 8 classes; K of 4, 6, 8
    assert p.g in (1, 2, 4, 8, 16) and 8 * p.g >= c and (p.g == 1 or 4 * p.g < c)
    assert p.k * p.g >= c and p.k == (4 if c <= 4 else 6 if 6 * p.g >= c else 8)
    # a power of two pixels, the largest up to 2048 whose logits fit 16 KB,
    # unless the slots would not fill a step of every thread
    tile, step = p.tile, L.LOGIT_SLOTS * NC
    assert tile & (tile - 1) == 0 and tile <= 2048 and tile * p.g >= step
    assert tile * c * size <= 16384 or tile * p.g == step
    assert tile == 2048 or 2 * tile * c * size > 16384
    # bulk copies move whole multiples of 16 bytes; whole steps
    assert (tile * c * size) % 16 == 0 and tile % 16 == 0
    assert (tile * p.g) % step == 0
    # the ring: as many stages as fit, up to 8; at least 32 KB in flight
    per_stage = tile * c * size + tile + 16
    assert 2 <= p.stages <= 8 and p.smem <= SMEM_MAX
    assert p.stages == 8 or p.smem + per_stage > SMEM_MAX
    target_sums = 0 if backward else 12 * p.k * NC  # tp, tsum, tp@0.5 a class slot
    assert p.smem == 4096 + target_sums + p.stages * per_stage
    assert p.stages * (tile * c * size + tile) >= 32 * 1024
    # the idle ring holds the end-of-block sums (per warp 5 x K·G, then 2
    # a warp) and the last block's (the 2 + 5C sums, 256 scratch)
    warps = NC // 32
    assert p.stages * tile * c * size >= 4 * max(warps * (5 * p.k * p.g + 2), 1024 + 256)
    assert p.row == (0 if backward else 2 + 5 * c)


@pytest.mark.parametrize("c", [4, 21])
@pytest.mark.parametrize("n", [1, 207, 2048, 2049, 132 * 2048 + 1, 32 * 256 * 256,
                               8 * 512 * 512])
def test_grid_rule(n, c):
    tile = L.logit_loss_plan(c, False, False).tile
    tiles = math.ceil(n / tile)
    g = L.logit_loss_grid(n, tile)
    assert g == min(132, tiles)
    # block i takes tiles i, i + g, ...: every tile once, each block's set
    # fixed by n alone
    owner = [i % g for i in range(tiles)]
    assert sorted(set(owner)) == list(range(g))
    assert all(len(range(b, tiles, g)) in (tiles // g, tiles // g + 1) for b in range(g))


def _inputs(seed, n, c):
    """bf16-valued float32 logits (n, C), uint8 targets with ~3% the ignore
    class C and ~2% raw 255, class weights (the DataB (1, 15, 0, 0) at C =
    4: zero-weight classes)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((2 * rng.randn(n, c)).astype(f32)).to(torch.bfloat16).float().numpy()
    t = rng.randint(0, c, n)
    r = rng.rand(n)
    t[r < 0.03] = c
    t[r > 0.98] = 255
    cw = (1.0, 15.0, 0.0, 0.0) if c == 4 else tuple(1.0 + 0.1 * i for i in range(c))
    return x, t.astype(np.uint8), np.asarray(cw, f32)


def _lanes(v, offsets, op=np.add):
    """Shuffle-xor steps over the block's NC lanes (rows of ``v``)."""
    lane = np.arange(NC)
    for o in offsets:
        v = op(v, v[lane ^ o])
    return v


def _emulate_fwd(x, t8, cw, c, focal, alpha=0.5, gamma=2.0):
    """The forward's 2 + 5C sums in float32, in the kernel's order: per
    block its tiles, per tile each of the NC threads' pixel slots in turn
    (tid, tid + NC, ...; slot q: pixel q / G, classes q % G + G·k; a
    thread takes two at once, accumulated in that order), the max and the
    sums by shuffles within a pixel's G lanes, each thread's running sums;
    then shuffles over the lanes of the same classes, the warps in order,
    the blocks' rows in row order.  Rows past n are masked by their index.
    Exponentials by numpy in float32 (the card's ex2 rounds otherwise)."""
    n = x.shape[0]
    plan = L.logit_loss_plan(c, False, False)
    k_, g_, tile = plan.k, plan.g, plan.tile
    grid, ntiles = L.logit_loss_grid(n, tile), math.ceil(n / tile)
    lane = np.arange(NC)
    cls = (lane % g_)[:, None] + g_ * np.arange(k_)[None, :]
    in_group = [1 << i for i in range(int(math.log2(g_)))]
    rows = []
    for b in range(grid):
        ps, tp = np.zeros((NC, k_), f32), np.zeros((NC, k_), f32)
        pos, ts, tpt = (np.zeros((NC, k_), np.int64) for _ in range(3))
        s0, s1 = np.zeros(NC, f32), np.zeros(NC, f32)
        for tl in range(b, ntiles, grid):
            p0 = tl * tile
            nrows = min(tile, n - p0)
            for q0 in range(0, tile * g_, NC):
                i = (q0 + lane) // g_
                valid = i < nrows
                pix = np.where(valid, p0 + i, 0)
                xv = np.where(cls < c, x[pix[:, None], np.minimum(cls, c - 1)], -np.inf).astype(f32)
                xv[~valid] = 0
                raw = t8[pix].astype(np.int64)
                t = np.where(valid & (raw < c), raw, NO_CLASS)
                m = _lanes(xv.max(1), in_group, np.maximum)
                e = np.exp(xv - m[:, None]).astype(f32)
                s = np.zeros(NC, f32)
                for k in range(k_):
                    s = s + e[:, k]
                s = _lanes(s, in_group)
                hit = cls == t[:, None]
                xt = _lanes(np.where(hit, xv, f32(0)).sum(1).astype(f32), in_group)
                r = np.where(valid, f32(1) / s, f32(0)).astype(f32)
                p = e * r[:, None]
                hi = p > f32(0.5)
                ps += p
                pos += hi
                tp += np.where(hit, p, f32(0))
                ts += hit
                tpt += hit & hi
                own = (t != NO_CLASS) & ((t % g_) == lane % g_)
                w = cw[np.minimum(t, c - 1)]
                with np.errstate(divide="ignore", invalid="ignore"):
                    u = w * (np.log(s) + m - xt)
                    term = f32(alpha) * (f32(1) - np.exp(-u)) ** f32(gamma) * u if focal else u
                s0 += np.where(own, term, f32(0)).astype(f32)
                s1 += np.where(own, w, f32(0))
        same = [o for o in (1, 2, 4, 8, 16) if o >= g_]
        tp, ps = _lanes(tp, same), _lanes(ps, same)
        ts, tpt, pos = _lanes(ts, same), _lanes(tpt, same), _lanes(pos, same)
        s0, s1 = _lanes(s0, (1, 2, 4, 8, 16)), _lanes(s1, (1, 2, 4, 8, 16))
        row = np.zeros(2 + 5 * c, f32)
        heads = np.arange(0, NC, 32)  # lane 0 of each warp, in order
        for w8 in heads:
            row[0] += s0[w8]
            row[1] += s1[w8]
        for q, (v, count) in enumerate(((tp, False), (ps, False), (ts, True), (tpt, True),
                                        (pos, True))):
            for cc in range(c):
                ln, kk = cc % g_, cc // g_
                vals = [v[w8 + ln, kk] for w8 in heads]
                row[2 + q * c + cc] = f32(sum(vals)) if count else sum(vals, f32(0))
        rows.append(row)
    sums = np.zeros(2 + 5 * c, f32)
    for row in rows:  # the last block: rows in row order
        sums = sums + row
    return sums


@pytest.mark.parametrize("c,n", [(4, 207), (4, 300), (4, 2049), (21, 207), (21, 300),
                                 (21, 257)])
def test_forward_sums_in_kernel_order(c, n):
    """At pixel counts no tile divides (n = one tile + 1 among them), the
    float32 sums in the kernel's order lie within float32 rounding of the
    float64 ``_sums``, the counts exact; rows past n count nowhere (psum
    sums to the pixel count, tsum to the pixels not ignored); the loss and
    f_score of ``_finish`` follow.  Focal at C = 4 (the DataB presets), CE
    at C = 21."""
    focal = c == 4
    x, t8, cw = _inputs(c + n, n, c)
    got = _emulate_fwd(x, t8, cw, c, focal)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t8)
    fl = (0.5, 2.0) if focal else None
    ref = L._sums(xt.double(), L._clamped(tt, c), torch.from_numpy(cw).double(), c, fl).numpy()
    counts = slice(2 + 2 * c, 2 + 5 * c)
    assert np.array_equal(got[counts], ref[counts])
    floats = np.r_[0:2 + 2 * c]
    assert np.abs(got[floats] - ref[floats]).max() <= 2e-6 * np.abs(ref[floats]).max()
    assert abs(got[2 + c:2 + 2 * c].sum() - n) <= 1e-4 * n
    assert got[2 + 2 * c:2 + 3 * c].sum() == (t8 < c).sum()
    loss, fs, _ = L._finish(torch.from_numpy(got), c, True, n if focal else None)
    ploss, pfs, _ = L._finish(torch.from_numpy(ref), c, True, n if focal else None)
    assert abs(loss.item() - ploss.item()) <= 1e-5 * abs(ploss.item())
    assert abs(fs.item() - pfs.item()) <= 1e-6


@pytest.mark.parametrize("with_dice", [True, False])
@pytest.mark.parametrize("focal", [False, True])
def test_backward_prologue(focal, with_dice):
    """A, B, A + B and inv as the kernel's prologue computes them (the C
    code's float32 operations, written out in numpy) are exactly
    ``dice_coefs`` / ``_inv``; dlogits from them in the kernel's
    expression, (p − onehot)·(k·w·inv) + p·((A·onehot + B) − Σ (A·onehot +
    B)·p), lie within float32 rounding of ``_dlogits`` in float64, with the
    DataB weights' zero-weight classes (u = 0: 1 − pt clamped at 1e-12)."""
    c, n = 4, 300
    x, t8, cw = _inputs(7, n, c)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t8)
    _, _, (s_w, denom, score) = L.ce_dice_fwd_plain(xt, tt, tuple(cw.tolist()), c, with_dice,
                                                    focal)
    gl = torch.tensor(0.75)
    a, b = L.dice_coefs(score, denom, c, gl, with_dice)
    inv = L._inv(gl, s_w, n if focal else None)
    # the prologue, float32 by float32
    g, d, sc = f32(gl.item()), denom.numpy().astype(f32), score.numpy().astype(f32)
    if with_dice:
        num = sc * d
        ka = (-(f32(2) / d) / f32(c)) * g
        kb = (-(-num / (d * d)) / f32(c)) * g
    else:
        ka = kb = np.zeros(c, f32)
    kinv = g / f32(n) if focal else g / max(f32(s_w.item()), f32(1e-12))
    assert np.array_equal(ka, a.numpy()) and np.array_equal(kb, b.numpy())
    assert np.float32(kinv) == np.float32(inv.item())
    # the per-pixel expression from those coefficients
    tcl = L._clamped(tt, c).numpy()
    p = torch.softmax(xt.double(), -1).numpy()
    hit = np.arange(c)[None, :] == tcl[:, None]
    w = np.where(tcl < c, cw.astype(np.float64)[np.minimum(tcl, c - 1)], 0.0)
    kw = w
    if focal:
        u = w * -np.log(np.where(tcl < c, p[np.arange(n), np.minimum(tcl, c - 1)], 1.0))
        pt = np.exp(-u)
        base = np.maximum(1 - pt, 1e-12)
        kw = 0.5 * (base ** 2 + 2 * u * pt * base) * w
    ab, bb = (ka + kb).astype(np.float64), kb.astype(np.float64)
    dl = np.where(hit, ab, bb)
    inner = (dl * p).sum(1, keepdims=True)
    got = np.where(hit, p - 1, p) * (kw * float(kinv))[:, None] + p * (dl - inner)
    ref = L._dlogits(xt.double(), torch.from_numpy(tcl), torch.from_numpy(cw).double(), c,
                     a.double(), b.double(), inv.double(), (0.5, 2.0) if focal else None)
    assert np.abs(got - ref.numpy()).max() <= 1e-6 * np.abs(ref.numpy()).max()
