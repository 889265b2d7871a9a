"""The host plan of the Hopper conv core and weight-gradient GEMM
(``tpu_unet_torch/kernels/sm90.py``), on the CPU: what the kernels are
told at every blocks 2-5 shape of unet_vgg and self_net (512², batch 8;
forward and backward, two convs or three) and at the test sizes — shared
memory within the card's 227 KB, TMA boxes within the 128-byte swizzle
span, 16-byte strides, tiles that cover every output pixel and channel
once, splits that cover every pixel patch once in order — and the block
kernels' shape rule, which the new core leaves as it was."""
import itertools

import pytest

from tpu_unet_torch.kernels import sm90
from tpu_unet_torch.kernels.encoder import block_plan, vgg_block_shape_ok
from tpu_unet_torch.kernels.encoder_train import bwd_plan, vgg_block_train_ok

SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory (227 KB)
SWIZZLE_BYTES = 128   # the span of CU_TENSOR_MAP_SWIZZLE_128B

# blocks 2-5 of VGG16 at a 512² input (unet_vgg and self_net share the
# encoder), batch 8: (H, widths); and the GPU tests' sizes (block 2's at
# H = 16, the 256-pixel dgrad tile, and at H = 8, the 128-pixel one)
FULL = [(8, 256, 256, [64, 128, 128]), (8, 128, 128, [128, 256, 256, 256]),
        (8, 64, 64, [256, 512, 512, 512]), (8, 32, 32, [512, 512, 512, 512])]
SMALL = [(2, 16, 32, [128, 256, 256, 256]), (2, 16, 32, [256, 512, 512, 512]),
         (2, 16, 32, [512, 512, 512, 512]), (1, 8, 16, [64, 64, 64, 64]),
         (2, 24, 32, [96, 128, 192, 64]), (2, 8, 16, [32, 64, 128, 128]),
         (2, 16, 32, [64, 128, 128]), (1, 8, 16, [64, 128, 128]), (2, 24, 32, [64, 128, 128]),
         (2, 8, 16, [32, 64, 64])]


def _convs(B, H, W, chans, train=True):
    """Every launch of a block: (what, launch, C, F) with C the input's
    width and F the output's of that product; the forward's (pooling) as
    ``sm90.block_fwd_launches`` plans them, and with ``train`` the
    backward's as ``sm90.block_bwd_launches`` does (conv 0's dgrad to
    dx)."""
    fwd = sm90.block_fwd_launches(B, H, W, chans, True)
    out = [("fwd", ln, cin, cout) for ln, cin, cout in zip(fwd, chans[:-1], chans[1:])]
    if train:
        bwd = sm90.block_bwd_launches(B, H, W, chans, True)
        for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
            out += [("wgrad", bwd[2 * i], cin, cout), ("dgrad", bwd[2 * i + 1], cout, cin)]
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


def _train_case(B, H, W, chans):
    return vgg_block_train_ok(H, W, chans)


TRAIN = [case for case in FULL + SMALL if _train_case(*case)]


@pytest.mark.parametrize("B,H,W,chans", FULL + SMALL)
def test_plan_fits_the_card(B, H, W, chans):
    """Shared memory within 227 KB; each map's box within the 128-byte
    swizzle span on its innermost dim, at most 256 on every dim; byte
    strides multiples of 16 (TMA's rule) and those of the dense tensor; a
    conv's epilogue tile beside a ring of at least 4 stages, or in it."""
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
        tm, tn = ln["tile"]
        stage = sm90.wgrad_stage_boxes(*ln["tile"]) * sm90.BOX_BYTES if what == "wgrad" else \
            (tm + tn) * 64 * 2
        assert ln["stages"] >= 2 and ln["stages"] * stage <= sm90.RING_BYTES
        if what != "wgrad":  # the epilogue's bf16 tile: beside the ring, or in it
            out = tm * (tn + 8) * 2
            if sm90.conv_own_staging(tn, tm):
                assert ln["stages"] >= 4 and ln["smem"] >= ln["stages"] * stage + out
            else:
                assert out <= ln["stages"] * stage


@pytest.mark.parametrize("B,H,W,chans", FULL + SMALL)
def test_conv_tiles_cover_output_once(B, H, W, chans):
    """The forward's and the dgrad's tiles cover every (pixel patch, output
    channel block) exactly once (decoded block by block at the test sizes,
    counted at 512²), both at the plan's rule (256 pixels where the N tile
    is at most 128 wide and H % 16 == 0: block 2's convs at 512²); the
    maps are the input's NHWC and the packed weights' (F, 9, C); the K
    slices cover every tap and channel."""
    for what, ln, c, f in _convs(B, H, W, chans, _train_case(B, H, W, chans)):
        if what == "wgrad":
            continue
        tm, tn = ln["tile"]
        assert tm == sm90.conv_tile_m(H, f)
        if (H, chans) == (256, [64, 128, 128]):
            assert tm == 2 * sm90.PATCH
        ph = tm // 16
        assert f % tn == 0 and H % ph == 0
        n_tiles = B * (H // ph) * (W // 16) * (f // tn)
        assert ln["grid"] == (n_tiles, 1, 1)
        if B * H * W <= 4096:
            tiles = list(_conv_tiles(ln, B, H, W, f))
            assert len(set(tiles)) == len(tiles) == n_tiles
            assert {(b, y, x) for b, y, x, _ in tiles} == {
                (b, y, x) for b in range(B) for y in range(0, H, ph) for x in range(0, W, 16)}
            assert {n for *_, n in tiles} == set(range(0, f, tn))
        assert ln["maps"][0]["dims"] == (c, W, H, B) and ln["maps"][0]["box"] == (64, 16, ph, 1)
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


@pytest.mark.parametrize("B,H,W,chans", [(2, 16, 32, (128, 256, 256, 256)),
                                         (8, 256, 256, (64, 128, 128)),
                                         (2, 24, 32, (64, 128, 128))])
def test_forward_records_match_plans(B, H, W, chans):
    """A block's forward records (``csrc/sm90.cuh::Launch``), two convs or
    three: ``OP_FWD`` and the pool on the last conv only, each conv's tile,
    grid, split count and pixels, its input and weight maps and no second
    input map, within the card's shared memory."""
    n = len(chans) - 1
    rec = block_plan(B, H, W, chans, True)
    assert tuple(rec.shape) == (n, sm90.PLAN_WORDS)
    assert rec[:, 0].tolist() == [sm90.OP_FWD] * (n - 1) + [sm90.OP_FWD_POOL]
    for i, ln in enumerate(sm90.block_fwd_launches(B, H, W, chans, True)):
        tm, tn = ln["tile"]
        assert ln["op"] == rec[i, 0] and ln["smem"] <= SMEM_LIMIT
        assert tn == sm90.conv_tile_n(chans[i + 1]) and tm == sm90.conv_tile_m(H, chans[i + 1])
        assert tm == (2 * sm90.PATCH if chans[0] == 64 and H % 16 == 0 else sm90.PATCH)
        assert rec[i, 1:7].tolist() == [tn, *ln["grid"], 1, tm]
        assert ln["grid"] == (B * (H // (tm // 16)) * (W // 16) * (chans[i + 1] // tn), 1, 1)
        m0 = rec[i, sm90.HEAD_WORDS:sm90.HEAD_WORDS + sm90.MAP_WORDS].tolist()
        assert m0 == [4, chans[i], W, H, B, *ln["maps"][0]["strides"], 64, 16, tm // 16, 1]
        m1 = rec[i, sm90.HEAD_WORDS + sm90.MAP_WORDS:sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS].tolist()
        assert m1 == [3, chans[i], 9, chans[i + 1], 0, *ln["maps"][1]["strides"], 0,
                      64, 1, tn, 0]
        assert rec[i, sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS:].abs().sum() == 0  # one input map
    assert block_plan(B, H, W, chans, False)[:, 0].tolist() == [sm90.OP_FWD] * n


def test_records_match_plans():
    """The backward's records (three convs and block 2's two): conv 0's
    dgrad record is the unmasked epilogue with every channel to dx, empty
    without dx, the dgrads at the tile rule's pixels."""
    B, H, W, chans = 2, 16, 32, (128, 256, 256, 256)
    for bwd_chans in (chans, (64, 128, 128)):  # block 3's widths, block 2's
        n = len(bwd_chans) - 1
        for want_dx in (True, False):
            rec, ns = bwd_plan(B, H, W, bwd_chans, want_dx)
            assert tuple(rec.shape) == (2 * n, sm90.PLAN_WORDS)
            assert rec[0::2, 0].tolist() == [sm90.OP_WGRAD] * n
            assert rec[0::2, 5].tolist() == list(ns)
            assert rec[1::2, 0].tolist() == [sm90.OP_DGRAD_SPLIT if want_dx else 0] + \
                [sm90.OP_DGRAD_MASK] * (n - 1)
            assert (rec[1].abs().sum() > 0) == want_dx
            # conv 0's dgrad sends every channel to dx: its split is Cin
            assert rec[1, 7] == (bwd_chans[0] if want_dx else 0)
            assert rec[1::2, 6].tolist() == [sm90.conv_tile_m(H, c) if want_dx or i else 0
                                             for i, c in enumerate(bwd_chans[:-1])]


def _old_shape_ok(H, W, chans):
    return not (H % 8 or W % 16 or any(c % 32 for c in chans[:-1])
                or any(c % 64 for c in chans[1:]))


HW = list(itertools.product((8, 12, 16, 24, 32), (8, 16, 24, 32, 48)))
WIDTHS = {3: list(itertools.product((32, 48, 64, 96, 128), (64, 96, 128), (64, 128),
                                    (64, 192, 512))),
          2: list(itertools.product((32, 48, 64, 96, 128), (64, 96, 128, 192),
                                    (64, 128, 192, 256)))}


@pytest.mark.parametrize("n_convs", [2, 3])
@pytest.mark.parametrize("train", [False, True])
def test_shape_rule_unchanged_and_tileable(train, n_convs):
    """The block's shape rule, two convs or three, accepts exactly what it
    accepted before the Hopper core (forward: H % 8, W % 16, input widths %
    32, output widths % 64; training: the input % 64 as well), over a grid
    of H, W and widths; every shape it accepts gets plans that tile it
    (output widths whole multiples of the tile, TMA strides multiples of
    16) within the card's shared memory."""
    rule = vgg_block_train_ok if train else vgg_block_shape_ok
    for (H, W), chans in itertools.product(HW, WIDTHS[n_convs]):
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
                assert f % tn == 0 and H % (ln["tile"][0] // 16) == 0
            assert ln["smem"] <= SMEM_LIMIT
            assert all(s % 16 == 0 for m in ln["maps"] for s in m["strides"])
