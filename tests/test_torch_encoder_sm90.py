"""The host plan of the Hopper conv core and weight-gradient GEMM
(``tpu_unet_torch/kernels/sm90.py``), on the CPU: what the kernels are
told at every blocks 3-5 shape of unet_vgg and self_net (512², batch 8)
and at the test sizes — shared memory within the card's 227 KB, TMA boxes
within the 128-byte swizzle span, 16-byte strides, tiles that cover every
output pixel and channel once, splits that cover every pixel patch once
in order — and the block kernels' shape rule, which the new core leaves as
it was."""
import itertools

import pytest

from tpu_unet_torch.kernels import sm90
from tpu_unet_torch.kernels.encoder import block_plan, vgg_block_shape_ok
from tpu_unet_torch.kernels.encoder_train import bwd_plan, vgg_block_train_ok

SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory (227 KB)
SWIZZLE_BYTES = 128   # the span of CU_TENSOR_MAP_SWIZZLE_128B

# blocks 3-5 of VGG16 at a 512² input (unet_vgg and self_net share the
# encoder), batch 8: (H, widths); and the GPU tests' sizes
FULL = [(8, 128, 128, [128, 256, 256, 256]), (8, 64, 64, [256, 512, 512, 512]),
        (8, 32, 32, [512, 512, 512, 512])]
SMALL = [(2, 16, 32, [128, 256, 256, 256]), (2, 16, 32, [256, 512, 512, 512]),
         (2, 16, 32, [512, 512, 512, 512]), (1, 8, 16, [64, 64, 64, 64]),
         (2, 24, 32, [96, 128, 192, 64]), (2, 8, 16, [32, 64, 128, 128])]


def _convs(B, H, W, chans, train=True):
    """Every launch of a block: (what, launch, C, F) with C the input's
    width and F the output's of that product."""
    out = []
    for cin, cout in zip(chans[:-1], chans[1:]):
        out.append(("fwd", sm90.conv_launch(sm90.OP_FWD, B, H, W, cin, cout), cin, cout))
        if train:
            out.append(("dgrad", sm90.conv_launch(sm90.OP_DGRAD_MASK, B, H, W, cout, cin),
                        cout, cin))
            out.append(("wgrad", sm90.wgrad_launch(B, H, W, cin, cout), cin, cout))
    return out


def _conv_tiles(launch, B, H, W, F):
    """The (b, y0, x0, n0) tile of every block, decoded as
    ``conv3x3_sm90.cuh`` decodes ``blockIdx.x``."""
    tn = launch["tile"][1]
    ntn = F // tn
    tiles_w, tiles_hw = W // sm90.PATCH_W, (H // sm90.PATCH_H) * (W // sm90.PATCH_W)
    for bid in range(launch["grid"][0]):
        n0, m = (bid % ntn) * tn, bid // ntn
        b, thw = divmod(m, tiles_hw)
        yield b, (thw // tiles_w) * sm90.PATCH_H, (thw % tiles_w) * sm90.PATCH_W, n0


def _train_case(B, H, W, chans):
    return vgg_block_train_ok(H, W, chans)


TRAIN = [case for case in FULL + SMALL if _train_case(*case)]


@pytest.mark.parametrize("B,H,W,chans", FULL + SMALL)
def test_plan_fits_the_card(B, H, W, chans):
    """Shared memory within 227 KB; each map's box within the 128-byte
    swizzle span on its innermost dim, at most 256 on every dim; byte
    strides multiples of 16 (TMA's rule) and those of the dense tensor."""
    for what, ln, c, f in _convs(B, H, W, chans, _train_case(B, H, W, chans)):
        assert ln["smem"] <= SMEM_LIMIT, (what, ln["smem"])
        for m in ln["maps"]:
            assert m["box"][0] * 2 <= SWIZZLE_BYTES
            assert all(1 <= b <= 256 for b in m["box"])
            assert all(s % 16 == 0 for s in m["strides"]), (what, m)
            dense = [2 * m["dims"][0]]
            for d in m["dims"][1:-1]:
                dense.append(dense[-1] * d)
            assert list(m["strides"]) == dense
        tn = ln["tile"][1]
        stage = sm90.wgrad_stage_boxes(*ln["tile"]) * sm90.BOX_BYTES if what == "wgrad" else \
            sm90.BOX_BYTES + tn * 64 * 2
        assert ln["stages"] >= 2 and ln["stages"] * stage <= sm90.RING_BYTES
        if what != "wgrad":  # the epilogue's bf16 tile is staged in the ring
            assert sm90.PATCH * (tn + 8) * 2 <= ln["stages"] * stage


@pytest.mark.parametrize("B,H,W,chans", FULL + SMALL)
def test_conv_tiles_cover_output_once(B, H, W, chans):
    """The forward's and the dgrad's tiles cover every (pixel patch, output
    channel block) exactly once (decoded block by block at the test sizes,
    counted at 512²); the maps are the input's NHWC and the packed weights'
    (F, 9, C); the K slices cover every tap and channel."""
    for what, ln, c, f in _convs(B, H, W, chans, _train_case(B, H, W, chans)):
        if what == "wgrad":
            continue
        tn = ln["tile"][1]
        assert f % tn == 0 and ln["tile"][0] == sm90.PATCH
        n_tiles = B * (H // 8) * (W // 16) * (f // tn)
        assert ln["grid"] == (n_tiles, 1, 1)
        if B * H * W <= 4096:
            tiles = list(_conv_tiles(ln, B, H, W, f))
            assert len(set(tiles)) == len(tiles) == n_tiles
            assert {(b, y, x) for b, y, x, _ in tiles} == {
                (b, y, x) for b in range(B) for y in range(0, H, 8) for x in range(0, W, 16)}
            assert {n for *_, n in tiles} == set(range(0, f, tn))
        assert ln["maps"][0]["dims"] == (c, W, H, B)
        assert ln["maps"][1]["dims"] == (c, 9, f) and ln["maps"][1]["box"] == (64, 1, tn)
        assert ln["k_slices"] * 64 >= 9 * c > (ln["k_slices"] - 9) * 64


@pytest.mark.parametrize("B,H,W,chans", TRAIN)
def test_wgrad_tiles_and_splits(B, H, W, chans):
    """The weight-gradient GEMM's tiles cover its (F, 9C) output once, each
    64-column half inside one tap; its splits cover every pixel patch once,
    in order, none empty; its maps are G's and the input's NHWC."""
    for what, ln, c, f in _convs(B, H, W, chans):
        if what != "wgrad":
            continue
        tf, tn = ln["tile"]
        gx, gy, ns = ln["grid"]
        # 128 f x tn columns; at F = 64, 64 f x 128 (the last tile may hold 64)
        assert gx * tn >= 9 * c > (gx - 1) * tn and (tf == 64 or gx * tn == 9 * c)
        assert gy * tf >= f > (gy - 1) * tf and ns == ln["nsplit"]
        halves = [(k // c, k % c) for k in range(0, 9 * c, 64)]
        assert all(cc + 64 <= c for _, cc in halves)
        npatch = B * (H // 8) * (W // 16)
        assert ln["npatch"] == npatch and ln["maps"][0]["box"] == (64, 16, 8, 1)
        ranges = sm90.split_ranges(npatch, ns)
        assert ranges[0][0] == 0 and ranges[-1][1] == npatch
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(lo < hi for lo, hi in ranges)
        assert ln["maps"][0]["dims"] == (f, W, H, B) and ln["maps"][1]["dims"] == (c, W, H, B)


def test_full_size_splits():
    """At 512², batch 8 the splits fill the SMs: at least 4 waves of blocks
    or a last wave at least 85% full."""
    for B, H, W, chans in FULL:
        for what, ln, c, f in _convs(B, H, W, chans):
            if what == "wgrad":
                waves = ln["grid"][0] * ln["grid"][1] * ln["nsplit"] / sm90.SMS
                assert waves >= 4 or waves / -(-waves // 1) >= 0.85, (chans, waves)


def test_records_match_plans():
    """The int64 records (``csrc/sm90.cuh::Launch``) carry each launch's
    numbers: forward records pool on the last conv only; the backward's
    conv 0 dgrad record is the unmasked epilogue, empty without dx."""
    B, H, W, chans = 2, 16, 32, (128, 256, 256, 256)
    rec = block_plan(B, H, W, chans, True)
    assert tuple(rec.shape) == (3, sm90.PLAN_WORDS)
    assert rec[:, 0].tolist() == [sm90.OP_FWD, sm90.OP_FWD, sm90.OP_FWD_POOL]
    for i in range(3):
        ln = sm90.conv_launch(sm90.OP_FWD, B, H, W, chans[i], chans[i + 1])
        assert rec[i, 1:6].tolist() == [ln["tile"][1], *ln["grid"], 1]
        m0 = rec[i, sm90.HEAD_WORDS:sm90.HEAD_WORDS + sm90.MAP_WORDS].tolist()
        assert m0 == [4, *ln["maps"][0]["dims"], *ln["maps"][0]["strides"], *ln["maps"][0]["box"]]
        m1 = rec[i, sm90.HEAD_WORDS + sm90.MAP_WORDS:sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS].tolist()
        assert m1 == [3, *ln["maps"][1]["dims"], 0, *ln["maps"][1]["strides"], 0,
                      *ln["maps"][1]["box"], 0]
        assert rec[i, sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS:].abs().sum() == 0  # one input map
    assert block_plan(B, H, W, chans, False)[:, 0].tolist() == [sm90.OP_FWD] * 3
    for want_dx in (True, False):
        rec, ns = bwd_plan(B, H, W, chans, want_dx)
        assert rec[0::2, 0].tolist() == [sm90.OP_WGRAD] * 3
        assert rec[0::2, 5].tolist() == list(ns)
        assert rec[1::2, 0].tolist() == [sm90.OP_DGRAD if want_dx else 0,
                                         sm90.OP_DGRAD_MASK, sm90.OP_DGRAD_MASK]
        assert (rec[1].abs().sum() > 0) == want_dx


def _old_shape_ok(H, W, chans):
    return not (H % 8 or W % 16 or any(c % 32 for c in chans[:-1])
                or any(c % 64 for c in chans[1:]))


GRID = list(itertools.product((8, 12, 16, 24, 32), (8, 16, 24, 32, 48),
                              itertools.product((32, 48, 64, 96, 128), (64, 96, 128),
                                                (64, 128), (64, 192, 512))))


@pytest.mark.parametrize("train", [False, True])
def test_shape_rule_unchanged_and_tileable(train):
    """The three-conv block's shape rule accepts exactly what it accepted
    before the Hopper core (forward: H % 8, W % 16, input widths % 32,
    output widths % 64; training: the input % 64 as well), over a grid of
    H, W and widths; every shape it accepts gets plans that tile it (output
    widths whole multiples of the tile, TMA strides multiples of 16)."""
    rule = vgg_block_train_ok if train else vgg_block_shape_ok
    for H, W, chans in GRID:
        chans = list(chans)
        old = _old_shape_ok(H, W, chans) and (not train or chans[0] % 64 == 0)
        assert rule(H, W, chans) == old, (H, W, chans)
        if not old:
            continue
        for what, ln, c, f in _convs(1, H, W, chans, train):
            tn = ln["tile"][1]
            if what == "wgrad":
                assert c % 64 == 0 and ln["grid"][0] == -(-9 * c // tn)
            else:
                assert f % tn == 0
            assert all(s % 16 == 0 for m in ln["maps"] for s in m["strides"])
