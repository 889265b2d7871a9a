"""The host plan of a UnetUp decoder stage on the Hopper conv core and
weight-gradient GEMM (``tpu_unet_torch/kernels/sm90.py::unetup_launches``,
``unetup_bwd_launches`` and ``unetup_wgrad_launches``: #1's two convs,
#13's two dgrads, ``unetup_wgrad``'s three GEMMs), on the CPU, at the
eight stages of unet_vgg / self_net and
unet_resnet50 (512², batch 8) and at small sizes: shared memory within the
card's 227 KB, TMA boxes within the 128-byte swizzle span, 16-byte strides,
conv tiles that cover every output pixel and channel once, conv1's K walk
over every (tap, skip slice) and (tap, up slice) once at the weight
channels of (F, 9, Cs + Cx), dk1's two GEMMs writing disjoint channel
ranges that cover (F, Cs + Cx, 3, 3) once with db1 summed once, splits
that cover every pixel patch once in order, conv1's dgrad sending every
channel of [0, Cs + Cx) to exactly one of dskip and dups, the records,
and the stage kernels' shape rules, which the new core leaves as they
were.  Then conv1 and conv2 emulated in float64 slice by slice in the
plan's K order against ``unetup_plain`` and, through it, JAX's
``reference_unetup``, and #13's two dgrads the same way against
``unetup_bwd_plain``."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from tpu_unet.kernels.decoder_fuse import reference_unetup
from tpu_unet_torch.kernels import sm90
from tpu_unet_torch.kernels.decoder_fuse import (_unetup_plain_y1, stage_plan, unetup_plain,
                                                 unetup_shape_ok)
from tpu_unet_torch.kernels.decoder_train import (dgrad_plan, flip_t, stage_shape_ok,
                                                  unetup_bwd_plain, wgrad_plan)
from tpu_unet_torch.nn.resize import upsample2x

SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory (227 KB)
SWIZZLE_BYTES = 128   # the span of CU_TENSOR_MAP_SWIZZLE_128B

# (B, 2H, 2W, Cs, Cx, F): unet_vgg's (and self_net's) up1-up4 and
# unet_resnet50's at a 512² input, batch 8; then the test sizes (batch
# 1-2, 8-32 pixels, widths cut; Cs % 64 != 0 where the rules allow it;
# 2H = 8 or 24 for the 128-pixel tile at F ≤ 128; Cs = 8, a split inside
# conv1's dgrad tile, at the GPU test's size)
FULL = [(8, 512, 512, 64, 128, 64), (8, 256, 256, 128, 256, 128),
        (8, 128, 128, 256, 512, 256), (8, 64, 64, 512, 512, 512),
        (8, 256, 256, 64, 128, 64), (8, 128, 128, 256, 256, 128),
        (8, 64, 64, 512, 512, 256), (8, 32, 32, 1024, 2048, 512)]
SMALL = [(2, 16, 32, 64, 128, 64), (1, 16, 16, 128, 256, 128), (2, 16, 32, 256, 512, 256),
         (1, 8, 16, 512, 512, 512), (1, 8, 16, 1024, 2048, 512), (2, 8, 16, 32, 96, 64),
         (1, 16, 32, 8, 56, 64), (2, 24, 32, 96, 160, 128), (1, 24, 32, 64, 128, 64),
         (2, 8, 16, 8, 120, 64)]
CASES = FULL + SMALL


def _convs(B, H2, W2, Cs, Cx, F, train=True):
    """(name, launch, C, C2, F) of the stage plan's conv launches: #1's two
    convs and, with ``train``, #13's two dgrads (C the output gradient's
    width, F the dgrad's output width)."""
    c1, c2 = sm90.unetup_launches(B, H2, W2, Cs, Cx, F)
    out = [("conv1", c1, Cs, Cx, F), ("conv2", c2, F, 0, F)]
    if train:
        d2, d1 = sm90.unetup_bwd_launches(B, H2, W2, Cs, Cx, F)
        out += [("dgrad2", d2, F, 0, F), ("dgrad1", d1, F, 0, Cs + Cx)]
    return out


def _conv_tiles(launch, B, H, W, F):
    """The (b, y0, x0, n0) tile of every block, decoded as
    ``conv3x3_sm90.cuh`` decodes ``blockIdx.x`` (PH = tile_m / 16 rows)."""
    tm, tn = launch["tile"]
    ph = tm // sm90.PATCH_W
    ntn = F // tn
    tiles_w, tiles_hw = W // sm90.PATCH_W, (H // ph) * (W // sm90.PATCH_W)
    for bid in range(launch["grid"][0]):
        n0, m = (bid % ntn) * tn, bid // ntn
        b, thw = divmod(m, tiles_hw)
        yield b, (thw // tiles_w) * ph, (thw % tiles_w) * sm90.PATCH_W, n0


def _check_map(m):
    assert m["box"][0] * 2 <= SWIZZLE_BYTES
    assert all(1 <= b <= 256 for b in m["box"])
    assert all(s % 16 == 0 for s in m["strides"]), m
    dense = [2 * m["dims"][0]]
    for d in m["dims"][1:-1]:
        dense.append(dense[-1] * d)
    assert list(m["strides"]) == dense


@pytest.mark.parametrize("case", CASES)
def test_plan_fits_the_card(case):
    """Shared memory within 227 KB; each map's box within the 128-byte
    swizzle span on its innermost dim, at most 256 on every dim; byte
    strides multiples of 16 (TMA's rule) and those of the dense tensor; the
    ring holds at least two stages and, for a conv, the epilogue's tile:
    beside the ring where that leaves 4 stages (a block then walks many
    tiles), else inside it."""
    B, H2, W2, Cs, Cx, F = case
    for name, ln, c, c2, f in _convs(*case):
        tm, tn = ln["tile"]
        stage, out = (tm + tn) * 64 * 2, tm * (tn + 8) * 2  # bf16 epilogue tile
        assert ln["smem"] <= SMEM_LIMIT and ln["stages"] >= 2, name
        assert ln["stages"] * stage <= sm90.RING_BYTES
        if sm90.conv_own_staging(tn, tm):
            assert ln["stages"] >= 4 and ln["smem"] >= ln["stages"] * stage + out
        else:
            assert (tn, tm) in ((256, 128), (128, 256)) and out <= ln["stages"] * stage
        for m in ln["maps"]:
            _check_map(m)
    for ln in sm90.unetup_wgrad_launches(*case):
        assert ln["smem"] <= SMEM_LIMIT and ln["stages"] >= 2
        assert ln["stages"] * sm90.wgrad_stage_boxes(*ln["tile"]) * sm90.BOX_BYTES \
            <= sm90.RING_BYTES
        for m in ln["maps"]:
            _check_map(m)


def _split_routes(rec, tile_n, f):
    """conv3x3_sm90.cuh's OP_DGRAD_SPLIT store on the CPU, from the encoded
    record's split word: how often each channel of the first output
    (split) and of the second (f - split) is written, over the 16-byte
    chunks of every N tile of one pixel patch."""
    split = int(rec[7])
    hits = [np.zeros(split, int), np.zeros(f - split, int)]
    for n0 in range(0, f, tile_n):
        for n in range(n0, n0 + tile_n, 8):
            side, at = (0, n) if n < split else (1, n - split)
            assert at + 8 <= len(hits[side])  # a chunk never straddles the split
            hits[side][at:at + 8] += 1
    return split, hits


@pytest.mark.parametrize("case", CASES)
def test_conv_tiles_cover_output_once(case):
    """The four convs' tiles (#1's two, #13's two dgrads), at the plan's
    tile, cover every (pixel patch, output channel block) exactly once
    (decoded block by block at the test sizes, counted at 512²); conv1's
    maps are skip's and up's NHWC (the same box) and the packed w1 seen as
    (F, 9, Cs + Cx), conv2's y1's and w2's, the dgrads' g2's and dz1's with
    flipT(w2) and flipT(w1) packed (F, 9, F) and (Cs + Cx, 9, F), with no
    second input map; conv1's dgrad, from its record, sends every channel
    of [0, Cs + Cx) to exactly one of dskip (Cs) and dups (Cx), once."""
    B, H2, W2, Cs, Cx, F = case
    split, hits = _split_routes(dgrad_plan(*case)[1], _convs(*case)[3][1]["tile"][1], Cs + Cx)
    assert split == Cs and [len(h) for h in hits] == [Cs, Cx]
    assert all((h == 1).all() for h in hits)
    for name, ln, c, c2, f in _convs(*case):
        tm, tn = ln["tile"]
        ph = tm // 16
        n_tiles = B * (H2 // ph) * (W2 // 16) * (f // tn)
        assert f % tn == 0 and H2 % ph == 0 and ln["grid"] == (n_tiles, 1, 1), name
        if B * H2 * W2 <= 4096:
            tiles = list(_conv_tiles(ln, B, H2, W2, f))
            assert len(set(tiles)) == len(tiles) == n_tiles
            assert {(b, y, x) for b, y, x, _ in tiles} == {
                (b, y, x) for b in range(B) for y in range(0, H2, ph) for x in range(0, W2, 16)}
            assert {n for *_, n in tiles} == set(range(0, f, tn))
        maps = ln["maps"]
        assert maps[0]["dims"] == (c, W2, H2, B) and maps[0]["box"] == (64, 16, ph, 1)
        assert maps[1]["dims"] == (c + c2, 9, f) and maps[1]["box"] == (64, 1, tn)
        if c2:
            assert len(maps) == 3 and maps[2]["dims"] == (c2, W2, H2, B)
            assert maps[2]["box"] == maps[0]["box"]
        else:
            assert len(maps) == 2


def test_tile_rule():
    """The plan's conv tile, the forward's and the dgrads' alike: 256
    pixels where the N tile is at most 128 wide (the F = 64 and F = 128
    stages, up1 and up2 of both models at 512²), 128 at N tiles of 192
    (conv1's dgrad at Cs + Cx = 192 and 384: where 192 divides N and 256
    does not) and 256 and where 2H % 16 != 0; the kernel builds the
    256-pixel tile at 64 and 128 channels only.  The test sizes reach both
    tiles at both of those widths, the 192-wide tile, and a split of
    conv1's dgrad inside an N tile (Cs = 8)."""
    got = {case: sm90.unetup_launches(*case)[0]["tile"] for case in FULL}
    assert got == {case: ((256, case[-1]) if case[-1] <= 128 else (128, 256)) for case in FULL}
    for case in FULL:
        d2, d1 = (ln["tile"] for ln in sm90.unetup_bwd_launches(*case))
        assert d2 == got[case]
        n = sm90.conv_tile_n(case[3] + case[4])
        assert d1 == ((256 if n <= 128 else 128), n)
    assert [sm90.unetup_bwd_launches(*c)[1]["tile"] for c in FULL[:2] + FULL[4:6]] == \
        [(128, 192), (128, 192), (128, 192), (128, 256)]
    reached = {ln["tile"] for case in SMALL for ln in sm90.unetup_launches(*case)
               + sm90.unetup_bwd_launches(*case)}
    assert {(128, 64), (256, 64), (128, 128), (256, 128), (128, 192)} <= reached
    assert any(case[3] % sm90.unetup_bwd_launches(*case)[1]["tile"][1] for case in SMALL)
    assert [sm90.conv_tile_n(n) for n in (64, 128, 192, 256, 320, 384, 576, 768)] == \
        [64, 128, 192, 256, 64, 192, 192, 256]
    assert sm90.conv_tile_m(24, 64) == 128 and sm90.conv_tile_m(32, 128) == 256
    assert sm90.conv_tile_m(32, 192) == 128 and sm90.conv_tile_m(32, 320) == 256


@pytest.mark.parametrize("case", CASES)
def test_k_walk_visits_every_slice_once(case):
    """conv1's K walk takes, per tap, every 64-channel slice of skip and
    then of up exactly once; each slice's weight box starts at its channel
    of (F, 9, Cs + Cx) (skip's at c0, up's at Cs + c0), so the real
    channels of the slices (those inside their map) meet every weight
    channel of every tap exactly once; the slices past a map's width arrive
    as TMA's zero fill.  conv2's walk is y1's slices alone."""
    B, H2, W2, Cs, Cx, F = case
    walk = sm90.k_walk(Cs, Cx)
    conv1, conv2 = sm90.unetup_launches(B, H2, W2, Cs, Cx, F)
    assert len(walk) == conv1["k_slices"] == 9 * (-(-Cs // 64) + -(-Cx // 64))
    assert len(set(walk)) == len(walk)
    assert [w[0] for w in walk] == sorted(w[0] for w in walk)  # tap-major
    width = {0: Cs, 2: Cx}
    for tap in range(9):
        mine = [w for w in walk if w[0] == tap]
        assert [m for _, m, _, _ in mine] == sorted(m for _, m, _, _ in mine)  # skip first
        assert {(m, c0) for _, m, c0, _ in mine} == \
            {(0, c) for c in range(0, Cs, 64)} | {(2, c) for c in range(0, Cx, 64)}
        hit = np.zeros(Cs + Cx, int)
        for _, m, c0, wc in mine:
            assert wc == (c0 if m == 0 else Cs + c0)
            real = min(64, width[m] - c0)
            hit[wc:wc + real] += 1
        assert (hit == 1).all()
    assert sm90.k_walk(F) == [(t, 0, c, c) for t in range(9) for c in range(0, F, 64)]
    assert conv2["k_slices"] == 9 * -(-F // 64)


def _written(ln):
    """The reduce pass of ``wgrad_sm90.cuh`` on the CPU: the (F, Ctot, 3, 3)
    indices a weight-gradient launch writes, from its record's numbers."""
    F, C = ln["maps"][0]["dims"][0], ln["maps"][1]["dims"][0]
    ctot, coff, _ = ln["out"]
    cp = sm90.tap_width(C)
    idx = np.arange(F * 9 * cp)
    f, k = idx // (9 * cp), idx % (9 * cp)
    tap, c = k // cp, k % cp
    keep = c < C
    return ((f * ctot + coff + c) * 9 + tap)[keep], F * ctot * 9


@pytest.mark.parametrize("case", CASES)
def test_wgrad_writes_dk_once(case):
    """``unetup_wgrad``'s GEMMs: dk1's skip and up launches write disjoint
    channel ranges [0, Cs) and [Cs, Cs + Cx) that together cover every
    (f, c, tap) of (F, Cs + Cx, 3, 3) once; dk2's covers (F, F, 3, 3) once;
    the bias gradients are summed by dk1's skip launch and dk2's, once
    each; the records carry these numbers."""
    B, H2, W2, Cs, Cx, F = case
    lns = sm90.unetup_wgrad_launches(*case)
    assert [ln["maps"][1]["dims"][0] for ln in lns] == [Cs, Cx, F]
    assert [ln["out"] for ln in lns] == [(Cs + Cx, 0, 1), (Cs + Cx, Cs, 0), (F, 0, 1)]
    for group in (lns[:2], lns[2:]):
        hits, size = None, None
        for ln in group:
            w, size = _written(ln)
            counts = np.bincount(w, minlength=size)
            hits = counts if hits is None else hits + counts
        assert hits.shape == (size,) and (hits == 1).all()
        assert sum(ln["out"][2] for ln in group) == 1
    rec = sm90.encode(lns)
    assert rec[:, 7:10].tolist() == [list(ln["out"]) for ln in lns]


@pytest.mark.parametrize("case", CASES)
def test_wgrad_tiles_and_splits(case):
    """Each GEMM's tiles cover its K = 9 · tap_width(C) columns and F rows
    once (128 f × 128 or 64 columns; at F = 64, 64 f × 128 columns, the
    last tile holding 64 where 9 · tap_width(C) is an odd multiple of 64),
    each 64-column piece inside one tap; its splits cover every pixel patch
    once, in order, none empty; its maps are G's (dz1 or g2) and the
    input's (skip, up or y1) NHWC."""
    B, H2, W2, Cs, Cx, F = case
    npatch = B * (H2 // 8) * (W2 // 16)
    for ln, c in zip(sm90.unetup_wgrad_launches(*case), (Cs, Cx, F)):
        tf, tn = ln["tile"]
        gx, gy, ns = ln["grid"]
        cp = sm90.tap_width(c)
        assert tf == (64 if F == 64 else 128)
        assert ln["k"] == 9 * cp and gx * tn >= 9 * cp > (gx - 1) * tn and cp % 64 == 0
        assert tf == 64 or gx * tn == 9 * cp
        assert gy * tf >= F > (gy - 1) * tf and ns == ln["nsplit"]
        assert all((k // cp) == ((k + 63) // cp) for k in range(0, 9 * cp, 64))
        assert ln["npatch"] == npatch
        ranges = sm90.split_ranges(npatch, ns)
        assert ranges[0][0] == 0 and ranges[-1][1] == npatch
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(lo < hi for lo, hi in ranges)
        assert ln["maps"][0]["dims"] == (F, W2, H2, B) and ln["maps"][1]["dims"] == (c, W2, H2, B)


def test_full_size_splits_fill_the_card():
    """At 512², batch 8 each GEMM's splits give at least 4 waves of blocks
    on the 132 SMs or a last wave at least 85% full, and its partials fit
    in the H100's 50 MB L2, from which the reduce pass reads them."""
    for case in FULL:
        for ln in sm90.unetup_wgrad_launches(*case):
            waves = ln["grid"][0] * ln["grid"][1] * ln["nsplit"] / sm90.SMS
            assert waves >= 4 or waves / -(-waves // 1) >= 0.85, (case, waves)
            assert ln["nsplit"] * case[-1] * ln["k"] * 4 <= 50 * 2**20, case


def test_records_match_plans():
    """The cached int64 records (``csrc/sm90.cuh::Launch``) carry each
    launch's numbers: the two convs OP_FWD, conv1 with the up map third;
    the three GEMMs OP_WGRAD with their split counts and work area; #13's
    dgrads OP_DGRAD_MASK and OP_DGRAD_SPLIT with the split at Cs."""
    B, H2, W2, Cs, Cx, F = 2, 16, 32, 64, 128, 64
    rec = stage_plan(B, H2, W2, Cs, Cx, F)
    assert tuple(rec.shape) == (2, sm90.PLAN_WORDS)
    lns = sm90.unetup_launches(B, H2, W2, Cs, Cx, F)
    for i, ln in enumerate(lns):
        assert rec[i, :7].tolist() == [sm90.OP_FWD, ln["tile"][1], *ln["grid"], 1, ln["tile"][0]]
        for j in range(3):
            words = rec[i, sm90.HEAD_WORDS + j * sm90.MAP_WORDS:
                        sm90.HEAD_WORDS + (j + 1) * sm90.MAP_WORDS].tolist()
            if j < len(ln["maps"]):
                m = ln["maps"][j]
                r = len(m["dims"])
                assert words == [r, *m["dims"], *[0] * (4 - r), *m["strides"],
                                 *[0] * (3 - len(m["strides"])), *m["box"], *[0] * (4 - r)]
            else:
                assert words == [0] * sm90.MAP_WORDS
    wrec, ns, work = wgrad_plan(B, H2, W2, Cs, Cx, F)
    wl = sm90.unetup_wgrad_launches(B, H2, W2, Cs, Cx, F)
    assert wrec[:, 0].tolist() == [sm90.OP_WGRAD] * 3 and wrec[:, 5].tolist() == list(ns)
    assert work == max(ln["nsplit"] * F * (ln["k"] + 1) for ln in wl)
    drec = dgrad_plan(B, H2, W2, Cs, Cx, F)
    dl = sm90.unetup_bwd_launches(B, H2, W2, Cs, Cx, F)
    assert drec[:, 0].tolist() == [sm90.OP_DGRAD_MASK, sm90.OP_DGRAD_SPLIT]
    assert drec[:, 7:10].tolist() == [[0, 0, 0], [Cs, 0, 0]]  # conv1's split at Cs
    for rec, ln in zip(drec, dl):
        assert rec[1:7].tolist() == [ln["tile"][1], *ln["grid"], 1, ln["tile"][0]]
        assert rec[sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS:].abs().sum() == 0  # one input map


def _old_fwd_rule(H2, W2, cs, cx, f):
    return not (H2 % 8 or W2 % 16 or cs % 8 or cx % 8 or (cs + cx) % 32 or f % 64)


def _old_stage_rule(H2, W2, f, cp, cs):
    return not (H2 % 8 or W2 % 16 or f % 64 or cp % 64 or cs % 8 or cp <= cs)


GRID = list(itertools.product((8, 12, 16, 24), (8, 16, 24, 32), (8, 32, 64, 96, 100),
                              (32, 56, 64, 128, 160), (64, 96, 128, 192)))


@pytest.mark.parametrize("train", [False, True])
def test_shape_rules_unchanged_and_tileable(train):
    """#1's rule (2H % 8, 2W % 16, Cs % 8, Cx % 8, (Cs + Cx) % 32, F % 64)
    and the stage backward's (``stage_shape_ok``: F % 64, (Cs + Cx) % 64,
    Cs % 8) accept exactly what they accepted before the Hopper core, over
    a grid of sizes and widths; every shape they accept gets plans that
    tile it (output widths whole multiples of the tile, rows of the tile's
    height, K pieces inside one tap, TMA strides multiples of 16)."""
    for H2, W2, cs, cx, f in GRID:
        if train:
            ok = stage_shape_ok(H2, W2, f, cs + cx, cs)
            assert ok == _old_stage_rule(H2, W2, f, cs + cx, cs)
        else:
            ok = unetup_shape_ok(H2, W2, cs, cx, f)
            assert ok == _old_fwd_rule(H2, W2, cs, cx, f)
        if not ok:
            continue
        if train:
            for ln in sm90.unetup_wgrad_launches(1, H2, W2, cs, cx, f):
                assert ln["grid"][0] == -(-ln["k"] // ln["tile"][1]) and ln["k"] % 64 == 0
                assert all(s % 16 == 0 for m in ln["maps"] for s in m["strides"])
        for _, ln, c, c2, fo in _convs(1, H2, W2, cs, cx, f, train):
            assert fo % ln["tile"][1] == 0 and H2 % (ln["tile"][0] // 16) == 0
            assert all(s % 16 == 0 for m in ln["maps"] for s in m["strides"])


def _emulate_conv(ins, wt, ln, C, C2, bias=None, mask=None):
    """The conv core's arithmetic in float64 on the CPU, block by block and
    slice by slice in the plan's K order: each slice's input box gathered
    from its map (zero outside the image and past the map's width, TMA's
    fill) and contracted with the weight box at its channel offset of the
    packed (F, 9, C + C2) weights; the epilogue bias + ReLU (the forward),
    · [mask > 0] (``OP_DGRAD_MASK``) or the plain store (a dgrad)."""
    B, H, W, _ = ins[0].shape
    F = wt.shape[0]
    tm, tn = ln["tile"]
    ph = tm // 16
    padded = {m: torch.nn.functional.pad(t, (0, 64, 1, 1, 1, 1)) for m, t in ins.items()}
    wp = torch.nn.functional.pad(wt, (0, 64))
    out = torch.zeros((B, H, W, F), dtype=torch.float64)
    for b, y0, x0, n0 in _conv_tiles(ln, B, H, W, F):
        acc = torch.zeros((tm, tn), dtype=torch.float64)
        for tap, m, c0, wc in sm90.k_walk(C, C2):
            ky, kx = divmod(tap, 3)
            a = padded[m][b, y0 + ky:y0 + ky + ph, x0 + kx:x0 + kx + 16, c0:c0 + 64]
            acc += a.reshape(tm, 64) @ wp[n0:n0 + tn, tap, wc:wc + 64].T
        v = acc.reshape(ph, 16, tn)
        if bias is not None:
            v = torch.relu(v + bias[n0:n0 + tn])
        if mask is not None:
            v = v * (mask[b, y0:y0 + ph, x0:x0 + 16, n0:n0 + tn] > 0)
        out[b, y0:y0 + ph, x0:x0 + 16, n0:n0 + tn] = v
    return out


def _pack(w):
    """OIHW (O, I, 3, 3) → (O, 9, I), ``_build.pack_conv3x3``'s layout."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], 9, -1)


@pytest.mark.parametrize("case,tile_m", [((1, 24, 32, 96, 96, 64), 128),
                                         ((1, 16, 32, 96, 96, 64), 256),
                                         ((2, 8, 16, 64, 128, 128), 128)])
def test_conv1_k_order_float64(case, tile_m):
    """conv1 over [skip | upsample2x(x)] emulated in float64 in the plan's K
    order (skip's 64-channel slices then up's, per tap, with Cs and Cx %
    64 != 0 exercising the zero fill) and conv2 over its y1: within 1e-12 of
    ``unetup_plain`` (and its y1), which is within 1e-12 of JAX's
    ``reference_unetup`` (decoder_fuse.py:1181) in float64.  Then #13 on
    that forward's out and y1: the mask pass, conv2's dgrad masked by y1 >
    0 and conv1's split at the record's Cs (inside a 64-wide N tile at Cs =
    96), emulated the same way at the plan's tiles, within 1e-12 of
    ``unetup_bwd_plain`` (dskip, dups, g2, dz1)."""
    B, H2, W2, Cs, Cx, F = case
    rng = np.random.default_rng(sum(case) + tile_m)
    skip = rng.standard_normal((B, H2, W2, Cs))
    x = rng.standard_normal((B, H2 // 2, W2 // 2, Cx))
    k1 = rng.standard_normal((3, 3, Cs + Cx, F)) / np.sqrt(9 * (Cs + Cx))
    b1 = 0.1 * rng.standard_normal(F)
    k2 = rng.standard_normal((3, 3, F, F)) / np.sqrt(9 * F)
    b2 = 0.1 * rng.standard_normal(F)
    t = [torch.from_numpy(a) for a in (skip, x, k1, b1, k2, b2)]
    oihw = [t[2].permute(3, 2, 0, 1), t[4].permute(3, 2, 0, 1)]
    out, y1 = _unetup_plain_y1(t[0], t[1], oihw[0], t[3], oihw[1], t[5])
    conv1, conv2 = sm90.unetup_launches(B, H2, W2, Cs, Cx, F)
    assert conv1["tile"][0] == conv2["tile"][0] == tile_m  # the plan's rule picks it
    packed = [_pack(w) for w in oihw]
    ey1 = _emulate_conv({0: t[0], 2: upsample2x(t[1])}, packed[0], conv1, Cs, Cx, bias=t[3])
    eout = _emulate_conv({0: ey1}, packed[1], conv2, F, 0, bias=t[5])
    assert (ey1 - y1).abs().max() <= 1e-12 * y1.abs().max()
    assert (eout - out).abs().max() <= 1e-12 * out.abs().max()
    with enable_x64(True):
        ref = np.asarray(reference_unetup(*[jnp.asarray(a) for a in (skip, x, k1, b1, k2, b2)]))
    assert ref.dtype == np.float64
    plain = unetup_plain(*t[:2], oihw[0], t[3], oihw[1], t[5]).numpy()
    assert np.abs(plain - ref).max() <= 1e-12 * np.abs(ref).max()
    g = torch.from_numpy(rng.standard_normal((B, H2, W2, F)))
    d2, d1 = sm90.unetup_bwd_launches(B, H2, W2, Cs, Cx, F)
    split = int(dgrad_plan(B, H2, W2, Cs, Cx, F)[1, 7])
    g2 = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype))
    dz1 = _emulate_conv({0: g2}, _pack(flip_t(oihw[1])), d2, F, 0, mask=y1)
    d = _emulate_conv({0: dz1}, _pack(flip_t(oihw[0])), d1, F, 0)
    refs = unetup_bwd_plain(g, out, y1, oihw[0], oihw[1], Cs)
    for e, r in zip((d[..., :split], d[..., split:], g2, dz1), refs):
        assert e.shape == r.shape and (e - r).abs().max() <= 1e-12 * r.abs().max()
