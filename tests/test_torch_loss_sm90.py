"""The Hopper fused loss's host plan and numerics on the CPU
(``csrc/loss.cu``, #27 / #29; the kernels themselves run in
``tests/test_torch_gpu.py`` on the card).

- ``final_loss_plan`` for every class count the kernels take: the classes
  padded to a ``wgmma`` width, a ring of TMA stages that fits the 227 KB a
  block may take (at 128 padded classes too) and keeps at least 32 KB in
  flight, the partial row's layout; ``final_loss_grid``: one block a
  128-pixel tile, at most 132, a constant, so a partial sum's pixels depend
  on n only.
- The backward's split products, emulated in float64 in the kernel's tile
  order with float32 accumulators: dlog fed to the bf16 tensor cores as
  hi = bf16(dlog) and lo = bf16(dlog − hi) (and float32 features and
  weights split the same way) gives dfeat and dW within 2⁻¹⁴ of the
  float32-dlog products of ``final_ce_dice_bwd_plain`` evaluated in
  float64; a single bf16 dlog lies further off.
- The forward's sums in the kernel's order (blocks, warpgroups, the
  columns a thread holds) at a pixel count no tile divides: rows past n,
  which TMA fills with zero features and target 0, counted nowhere.
"""
import math

import numpy as np
import pytest
import torch

from tpu_unet_torch.kernels import loss as L

CLASSES = [1, 4, 16, 21, 126]
SMEM_MAX = 232448  # a block's dynamic shared memory on an H100, 227 KB


def _case(seed, shape, c, dtype):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(np.maximum(rng.randn(*shape, 64), 0).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(c, 64, 1, 1) / 8).astype(np.float32)).to(dtype).float()
    b = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)).to(dtype).float()
    t = rng.randint(0, c + 1, shape).astype(np.int64)
    t[..., 0, :3] = 255
    return feats, w, b, torch.from_numpy(t), tuple((1.0 + 0.1 * np.arange(c)).tolist())


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("c", CLASSES)
def test_plan_rule(c, f32, backward):
    plan = L.final_loss_plan(c, f32, backward)
    np_ = plan.np
    assert np_ % 16 == 0 and np_ >= c and np_ in (16, 32, 64, 128)
    assert np_ == 16 or np_ // 2 < c  # the narrowest width that holds C
    tile = 128 * 64 * (4 if f32 else 2)
    per_stage = tile + 128 + 16  # features, target bytes, two barriers
    assert 2 <= plan.stages <= 6 and plan.smem <= SMEM_MAX
    # as many stages as fit, up to 6; at least 32 KB of features in flight
    assert plan.stages == 6 or plan.smem + per_stage > SMEM_MAX
    assert plan.stages * tile >= 32 * 1024
    # the end-of-block reductions reuse the ring: dW of a warpgroup, db and
    # the per-warp sums by class
    assert plan.stages * tile >= 4 * (64 * np_ + 40 * np_ + 64)
    assert plan.row == (65 * c if backward else 2 + 5 * c)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 207, 132 * 128, 132 * 128 + 1,
                               8 * 512 * 512, 32 * 256 * 256])
def test_grid_rule(n):
    tiles = math.ceil(n / 128)
    g = L.final_loss_grid(n)
    assert g == min(132, tiles)
    # block i takes tiles i, i + g, ...: every tile once, each block's set
    # fixed by n alone
    owner = [i % g for i in range(tiles)]
    assert sorted(set(owner)) == list(range(g))


def _split(x):
    """float32 → (hi, lo) bf16 pieces as float64: hi = bf16(x), lo =
    bf16(x − hi), the kernel's __float2bfloat16_rn twice."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi.double(), lo.double()


def _acc(acc, prod):
    """One wgmma step: float64 products added to a float32 accumulator."""
    return (acc.double() + prod).float()


def _emulate_bwd(f2, wt, dlog, f32, pieces):
    """dfeat (before its rounding to the feature dtype) and dW (C, 64) as
    the kernel sums them: 128-pixel tiles to blocks i, i + grid, ...; a
    warpgroup's 64 pixels; dfeat over 16-class steps, dW over 16-pixel
    steps into one float32 accumulator per warpgroup across its tiles, the
    warpgroups then the blocks added in order.  ``pieces``: dlog's pieces
    (hi, lo), or (hi,) for a single bf16 dlog."""
    n, c = dlog.shape
    np_ = L.final_loss_plan(c, f32, True).np
    pad = np_ - c
    d = torch.nn.functional.pad(dlog, (0, pad))
    dh, dl = _split(d)
    dps = [dh, dl][:pieces]
    w = torch.nn.functional.pad(wt, (0, 0, 0, pad))
    if f32:
        fh, fl = _split(f2)
        wh, wl = _split(w)
    else:
        fh, fl, wh, wl = f2.double(), None, w.double(), None
    dfeat = torch.zeros(n, 64)
    for k in range(0, np_, 16):
        for dp in dps:
            dfeat = _acc(dfeat, dp[:, k:k + 16] @ wh[k:k + 16])
    if f32:
        for k in range(0, np_, 16):
            dfeat = _acc(dfeat, dh[:, k:k + 16] @ wl[k:k + 16])
    tiles = math.ceil(n / 128)
    g = L.final_loss_grid(n)
    total = torch.zeros(64, np_)
    for blk in range(g):
        accs = [torch.zeros(64, np_), torch.zeros(64, np_)]
        for tile in range(blk, tiles, g):
            for wg in range(2):
                for k in range(0, 64, 16):
                    r0 = tile * 128 + wg * 64 + k
                    rows = slice(min(r0, n), min(r0 + 16, n))
                    for dp in dps:
                        accs[wg] = _acc(accs[wg], fh[rows].t() @ dp[rows])
                    if f32:
                        accs[wg] = _acc(accs[wg], fl[rows].t() @ dh[rows])
        total = (total + (accs[0] + accs[1])).float()
    return dfeat, total[:, :c].t()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_products_float64(dtype):
    """The split's dfeat and dW within 2⁻¹⁴ of the float32-dlog products
    (``final_ce_dice_bwd_plain``'s, evaluated in float64), a single bf16
    dlog further off; readings printed (``-s``)."""
    c = 21
    feats, w, b, t, cw = _case(0, (2, 8, 16), c, dtype)
    f32 = dtype == torch.float32
    _, _, res = L.final_ce_dice_fwd_plain(feats, w, b, t, cw, c, True)
    gl = torch.tensor(1.0)
    f2 = feats.reshape(-1, 64)
    wt = w.reshape(c, 64).to(dtype).float()
    a, bb = L.dice_coefs(res[2], res[1], c, gl, True)
    dlog = L._dlogits(L._logits(f2, w, b, c), L._clamped(t, c),
                      torch.tensor(cw), c, a, bb, L._inv(gl, res[0]))
    # the plain version's products, evaluated in float64
    ref_df = dlog.double() @ wt.double()
    ref_dw = (f2.double().t() @ dlog.double()).t()
    split_df, split_dw = _emulate_bwd(f2.float(), wt, dlog, f32, 2)
    one_df, one_dw = _emulate_bwd(f2.float(), wt, dlog, f32, 1)
    readings = {"dtype": str(dtype), "split_dfeat": _rel(split_df, ref_df),
                "split_dW": _rel(split_dw, ref_dw), "single_bf16_dfeat": _rel(one_df, ref_df),
                "single_bf16_dW": _rel(one_dw, ref_dw)}
    print(readings)
    bound = 2.0 ** -14
    assert readings["split_dfeat"] <= bound and readings["split_dW"] <= bound
    assert readings["single_bf16_dfeat"] > bound and readings["single_bf16_dW"] > bound
    # the plain version itself (float32 products) sits at float32's rounding
    pdf, pdw, _ = L.final_ce_dice_bwd_plain(feats, w, b, t, cw, c, True, res, gl)
    if f32:
        assert _rel(pdf.reshape(-1, 64), ref_df) <= 1e-6
        assert _rel(pdw.reshape(c, 64), ref_dw) <= 1e-6


def _emulate_fwd_sums(f2, w, b, t8, cw, c, n, mask):
    """The forward's sums as the kernel takes them: the tiles padded past n
    as TMA fills them (zero features, target byte 0), rows past n dropped
    by their index when ``mask``; per block the float sums by class over
    its tiles, then the blocks in order."""
    tiles = math.ceil(n / 128)
    pad = tiles * 128 - n
    fp = torch.cat([f2, torch.zeros(pad, 64, dtype=f2.dtype)])
    tp = torch.cat([t8.long(), torch.zeros(pad, dtype=torch.long)])
    x = L._logits(fp, w, b, c)
    valid = torch.arange(tiles * 128) < n if mask else torch.ones(tiles * 128, dtype=torch.bool)
    g = L.final_loss_grid(n)
    total = torch.zeros(2 + 5 * c)
    for blk in range(g):
        rows = torch.cat([torch.arange(i * 128, i * 128 + 128) for i in range(blk, tiles, g)])
        rows = rows[valid[rows]]
        total = total + L._sums(x[rows], torch.clamp_max(tp[rows], c), torch.tensor(cw), c)
    return total


@pytest.mark.parametrize("n", [207, 300])
def test_ragged_tail_counted_nowhere(n):
    """At a pixel count no 128-pixel tile divides, the forward's sums in the
    kernel's block order equal the plain version's with the rows past n
    masked by their index; unmasked, TMA's zero fill would count as target
    0 (tsum[0], psum)."""
    c = 21
    feats, w, b, t, cw = _case(1, (1, 1, n), c, torch.bfloat16)
    f2, t8 = feats.reshape(-1, 64), L.pack_targets(t.reshape(-1), c)
    ref = L._sums(L._logits(f2, w, b, c), L._clamped(t8, c), torch.tensor(cw), c)
    masked = _emulate_fwd_sums(f2, w, b, t8, cw, c, n, True)
    assert _rel(masked, ref) <= 1e-6
    unmasked = _emulate_fwd_sums(f2, w, b, t8, cw, c, n, False)
    pad = math.ceil(n / 128) * 128 - n
    assert unmasked[2 + 2 * c].item() == ref[2 + 2 * c].item() + pad  # tsum[0]
    loss, fs, _ = L._finish(masked, c, True)
    ploss, pfs, _ = L.final_ce_dice_fwd_plain(feats, w, b, t, cw, c, True)
    assert abs(loss.item() - ploss.item()) <= 1e-5 * ploss.item()
    assert abs(fs.item() - pfs.item()) <= 1e-6
