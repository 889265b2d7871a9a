"""Host-side checks of a Hopper kernel's plan and order, on the CPU: the
×2 upsample's adjoint (``csrc/upsample_adjoint.cuh``, planned by
``kernels/decoder_train.py::adjoint_plan``): its blocks (strip of columns
× channel chunk × band of rows × image) cover dx once, each block's TMA
boxes hold every dup position that ``adjoint_tables`` lists for it, the
per-row slots it gathers from the row table fit, and its streamed order
(a W pass per arriving high-resolution row, the H pass by increasing row
into two open accumulators), emulated, lies within 1e-12 of
``upsample2x_adjoint_plain`` in float64 and equals the gather order (the
old kernel's) element for element in float32.  The serving tail's plan is
checked in ``tests/test_torch_tail_sm90.py``.
"""
import numpy as np
import pytest
import torch

from tpu_unet_torch.kernels.decoder_train import (ADJ_MAX_CONSUMERS, ADJ_RPS, ADJ_STAGES,
                                                  adjoint_plan)
from tpu_unet_torch.nn.resize import adjoint_tables, upsample2x_adjoint_plain

SMEM_MAX = 232448  # a block's dynamic shared memory on the H100
L2_BYTES = 50 * 2**20
# dx (B, h, w, C) of the adjoint's launches: unet_vgg's four stages,
# unet_resnet50's four, the unet_resnet50 and self_net heads (all 512²,
# batch 8), the train_py recipe's four stages (256², batch 32), small and
# odd sizes
MAIN_SHAPES = [(8, 256, 256, 128), (8, 128, 128, 256), (8, 64, 64, 512), (8, 32, 32, 512),
               (8, 128, 128, 128), (8, 64, 64, 256), (8, 32, 32, 512), (8, 16, 16, 2048),
               (8, 256, 256, 64), (8, 512, 512, 64)]
RECIPE_SHAPES = [(32, 128, 128, 128), (32, 64, 64, 256), (32, 32, 32, 512), (32, 16, 16, 512)]
ODD_SHAPES = [(1, 1, 5, 8), (2, 3, 5, 16), (2, 4, 8, 8), (1, 3, 8, 24), (1, 5, 33, 8),
              (1, 70, 9, 8), (2, 17, 40, 2048), (1, 200, 3, 64)]


def _decode(p, bid):
    """The kernel's block index → (strip, chunk, band, image)."""
    strip, bid = bid % p.strips, bid // p.strips
    chunk, bid = bid % p.chunks, bid // p.chunks
    return strip, chunk, bid % p.bands, bid // p.bands


def _slots(ridx, rw, ib0, rows, u0, nu):
    """The kernel's slots of a band: for each high-resolution row l = u -
    u0, the (row i, weight) entries of the band's rows that list u, in
    (i, a) order, at most two."""
    nr = ridx.shape[1]
    slots = [[None, None] for _ in range(nu)]
    for i in range(ib0, ib0 + rows):
        for a in range(nr):
            u = int(ridx[i, a])
            if u < 0:
                continue
            s = int((ridx[i, :a] == u).sum())
            if i > ib0:
                s += int((ridx[i - 1] == u).sum())
            assert 0 <= u - u0 < nu and s <= 1, (i, a, u)
            assert slots[u - u0][s] is None
            slots[u - u0][s] = (i, float(rw[i, a]))
    for sl in slots:
        assert sl[1] is None or sl[0] is not None  # slot 1 only after slot 0
    return [[e for e in sl if e is not None] for sl in slots]


@pytest.mark.parametrize("shape", MAIN_SHAPES + RECIPE_SHAPES + ODD_SHAPES)
def test_adjoint_plan_covers_dx_once(shape):
    B, h, w, c = shape
    p = adjoint_plan(B, h, w, c)
    # the launch fits the card and TMA's rules
    assert p.tw in (8, 16, 32) and c % p.cc == 0 and p.cc * 2 % 16 == 0 and p.cc <= 256
    assert 2 * p.tw + 4 <= 256 and p.stage_bytes % 128 == 0
    assert p.tw * p.cc // 8 <= p.consumers <= ADJ_MAX_CONSUMERS and p.consumers % 32 == 0
    assert p.smem <= SMEM_MAX and 2 * p.th + 4 <= 2 * 64 + 4
    assert p.stage_bytes == ADJ_RPS * (2 * p.tw + 4) * p.cc * 2
    assert p.smem >= ADJ_STAGES * p.stage_bytes
    # strips, chunks and bands partition their axes; the blocks the product
    for n, t, k in ((w, p.tw, p.strips), (c, p.cc, p.chunks), (h, p.th, p.bands)):
        cover = np.zeros(t * k, int)
        for i in range(k):
            cover[i * t:(i + 1) * t] += 1
        assert (cover[:n] == 1).all() and t * (k - 1) < n
    blocks = {_decode(p, bid) for bid in range(p.grid)}
    assert len(blocks) == p.grid == B * p.strips * p.chunks * p.bands
    assert all(s < p.strips and k < p.chunks and d < p.bands and b < B
               for s, k, d, b in blocks)
    if shape in MAIN_SHAPES:
        assert p.grid >= 132  # a block on every SM


@pytest.mark.parametrize("shape", MAIN_SHAPES + ODD_SHAPES)
def test_adjoint_boxes_hold_the_tables(shape):
    """Each strip's columns [2 j0 - 2, 2 j0 + 2 TW + 2) hold every v its
    columns list, each band's rows [2 i0 - 2, 2 i0 + 2 rows + 2) every u
    its rows list; the slots fit; the bytes read against dup's."""
    B, h, w, c = shape
    p = adjoint_plan(B, h, w, c)
    ridx, rw = (t.numpy() for t in adjoint_tables(h, torch.bfloat16))
    cidx, _ = (t.numpy() for t in adjoint_tables(w, torch.bfloat16))
    assert ridx.shape[1] <= 5 and cidx.shape[1] <= 5
    for strip in range(p.strips):
        j0 = strip * p.tw
        v = cidx[j0:min(j0 + p.tw, w)]
        v = v[v >= 0]
        assert v.min() >= 2 * j0 - 2 and v.max() < 2 * j0 - 2 + 2 * p.tw + 4
    loaded_rows = 0
    for band in range(p.bands):
        ib0 = band * p.th
        rows = min(p.th, h - ib0)
        nu, u0 = 2 * rows + 4, 2 * ib0 - 2
        loaded_rows += nu
        u = ridx[ib0:ib0 + rows]
        u = u[u >= 0]
        assert u.min() >= u0 and u.max() < u0 + nu
        slots = _slots(ridx, rw, ib0, rows, u0, nu)
        # every entry of the band's rows is in exactly one slot
        assert sum(len(s) for s in slots) == int((ridx[ib0:ib0 + rows] >= 0).sum())
    amp = loaded_rows / (2 * h) * (2 * p.tw + 4) * p.strips / (2 * w)
    if shape in MAIN_SHAPES and B * 4 * h * w * c * 2 > L2_BYTES:
        assert amp <= 1.2, amp  # beyond the L2: the halos cost device memory


def _fma(a, b, c, dt):
    """a * b + c rounded once to dt (float32: the product is exact in
    float64, then one rounding of the sum there and one to float32)."""
    return (a.astype(np.float64) * b + c).astype(dt)


def _tables(h, w, dt):
    """Row and column tables, the weights at the working precision: float64
    for a float64 emulation (as the plain version in float64), bf16 for the
    kernel's (a bf16 dup)."""
    tdt = torch.float64 if dt == np.float64 else torch.bfloat16
    return [t.numpy() for t in (*adjoint_tables(h, tdt), *adjoint_tables(w, tdt))]


def _streamed_adjoint(dup, h, w, dt):
    """The adjoint kernel's order, block by block: each band's rows stream
    in increasing u; for u a W pass over each column's table list, then
    u's slots fold into the accumulators of rows r0 and r0 + 1, row r0
    stored (once) when a slot reaches r0 + 2.  Every dx element's writes
    are counted."""
    B, c = dup.shape[0], dup.shape[-1]
    p = adjoint_plan(B, h, w, c)
    ridx, rw, cidx, cw = _tables(h, w, dt)
    dx = np.zeros((B, h, w, c), dt)
    writes = np.zeros((h, w), int)
    for band in range(p.bands):
        ib0 = band * p.th
        rows = min(p.th, h - ib0)
        nu, u0 = 2 * rows + 4, 2 * ib0 - 2
        slots = _slots(ridx, rw, ib0, rows, u0, nu)
        for strip in range(p.strips):
            j0 = strip * p.tw
            js = np.arange(j0, min(j0 + p.tw, w))
            v0, ncol = 2 * j0 - 2, 2 * p.tw + 4
            # the TMA box: rows u0 .., columns v0 .., zero out of bounds
            box = np.zeros((B, nu, ncol, c), dt)
            ul, uh, vl, vh = max(u0, 0), min(u0 + nu, 2 * h), max(v0, 0), min(v0 + ncol, 2 * w)
            box[:, ul - u0:uh - u0, vl - v0:vh - v0] = dup[:, ul:uh, vl:vh]
            acc = [np.zeros((B, len(js), c), dt), np.zeros((B, len(js), c), dt)]
            r0 = ib0

            def store(r, a):
                dx[:, r, js] = a
                writes[r, js] += 1

            for l in range(nu):
                if not slots[l]:
                    continue
                row = np.zeros((B, len(js), c), dt)
                for q in range(cidx.shape[1]):
                    v, wc = cidx[js, q], cw[js, q]
                    live = v >= 0  # a list's -1 padding ends it
                    val = box[:, l, np.where(live, v - v0, 0)]
                    row = np.where(live[None, :, None],
                                   _fma(wc.astype(dt)[None, :, None], val, row, dt), row)
                for i, wr in slots[l]:
                    while i > r0 + 1:
                        store(r0, acc[0])
                        acc, r0 = [acc[1], np.zeros_like(acc[1])], r0 + 1
                    k = i - r0
                    acc[k] = _fma(np.asarray(wr, dt), row, acc[k], dt)
            for k in (0, 1):
                if r0 + k < ib0 + rows:
                    store(r0 + k, acc[k])
    assert (writes == 1).all()
    return dx


def _gather_adjoint(dup, h, w, dt):
    """The gather order (one dx element at a time: W pass inside over the
    column list, H pass outside over the row list), with the same fma."""
    ridx, rw, cidx, cw = _tables(h, w, dt)
    B, c = dup.shape[0], dup.shape[-1]
    dx = np.zeros((B, h, w, c), dt)
    for i in range(h):
        for j in range(w):
            acc = np.zeros((B, c), dt)
            for u, wr in zip(ridx[i], rw[i]):
                if u < 0:
                    break
                row = np.zeros((B, c), dt)
                for v, wc in zip(cidx[j], cw[j]):
                    if v < 0:
                        break
                    row = _fma(np.asarray(wc, dt), dup[:, u, v], row, dt)
                acc = _fma(np.asarray(wr, dt), row, acc, dt)
            dx[:, i, j] = acc
    return dx


ORDER_SHAPES = [(2, 1, 5, 8), (1, 3, 8, 16), (2, 4, 5, 8), (1, 5, 33, 8), (1, 70, 9, 8),
                (1, 17, 40, 16)]


@pytest.mark.parametrize("shape", ORDER_SHAPES)
def test_streamed_order_float64(shape):
    B, h, w, c = shape
    dup = np.random.default_rng(sum(shape)).standard_normal((B, 2 * h, 2 * w, c))
    got = _streamed_adjoint(dup, h, w, np.float64)
    ref = upsample2x_adjoint_plain(torch.from_numpy(dup), h, w).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("shape", ORDER_SHAPES[:4])
def test_streamed_order_is_the_gather_order(shape):
    """float32, the same fma: the streamed order gives the gather order's
    result bit for bit (so the kernel's dx is the old kernel's)."""
    B, h, w, c = shape
    dup = np.random.default_rng(sum(shape)).standard_normal((B, 2 * h, 2 * w, c))
    dup = torch.from_numpy(dup).to(torch.bfloat16).float().numpy()
    assert np.array_equal(_streamed_adjoint(dup, h, w, np.float32),
                          _gather_adjoint(dup, h, w, np.float32))
