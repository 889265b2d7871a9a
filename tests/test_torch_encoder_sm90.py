"""The host plan of the Hopper conv core and weight-gradient GEMM
(``tpu_unet_torch/kernels/sm90.py``), on the CPU: what the kernels are
told at every blocks 2-5 shape of unet_vgg and self_net (512², batch 8;
forward and backward, two convs or three) and at the test sizes — shared
memory within the card's 227 KB, TMA boxes within the 128-byte swizzle
span, 16-byte strides, tiles that cover every output pixel and channel
once, splits that cover every pixel patch once in order — the stem's
backward (#20: conv1_2's weight gradient and masked dgrad) the same way,
the stem's forward (#2: conv1_1's gathering image GEMM, conv1_2 with the
pool) the same way, with conv1_1 emulated in float64 in the plan's order,
and the block kernels' shape rule, which the new core leaves as it
was."""
import itertools

import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet_torch.core.precision import normalize_u8
from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import conv3x3_relu, max_pool2x2
from tpu_unet_torch.kernels.encoder import block_plan, vgg_block_shape_ok
from tpu_unet_torch.kernels.encoder_train import bwd_plan, vgg_block_train_ok
from tpu_unet_torch.kernels.stem import stem_plan, vgg_stem_plain

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


@pytest.mark.parametrize("B,H,W", [(8, 512, 512), (2, 24, 32)])
def test_stem_bwd_plan(B, H, W):
    """The stem's backward laid out as a block's (conv i's records at 2i
    and 2i + 1): conv1_1's weight gradient over the image
    (``OP_WGRAD_IMAGE``: 64 f × 64 columns, the G box its one map, two
    blocks an SM at 512², splits covering every pixel patch once in order, at
    least 8 patches each) and no dgrad; conv1_2's weight gradient over a1
    (``OP_WGRAD``, 64 f × 128 columns: 5 column tiles of K = 576) and its
    dgrad masked by a1 > 0 (``OP_DGRAD_MASK``, 64 wide at the tile rule's
    pixels: 256 and persistent at 512²), maps of g and a1, within the
    card's shared memory."""
    rec, ns = bwd_plan(B, H, W, (3, 64, 64), False)
    lns = sm90.stem_bwd_launches(B, H, W, 64)
    assert tuple(rec.shape) == (4, sm90.PLAN_WORDS) and lns[1] is None
    assert rec[1].abs().sum() == 0
    assert rec[0::2, 0].tolist() == [sm90.OP_WGRAD_IMAGE, sm90.OP_WGRAD]
    assert rec[3, 0] == sm90.OP_DGRAD_MASK
    wi, wg, dg = lns[0], lns[2], lns[3]
    npatch = B * (H // 8) * (W // 16)
    assert rec[0, 1:10].tolist() == [64, 1, 1, ns[0], ns[0], 64, 3, 0, 1]
    assert ns[0] == min(2 * sm90.SMS, npatch // 8) and wi["npatch"] == npatch
    assert wi["maps"][0]["dims"] == (64, W, H, B) and wi["maps"][0]["box"] == (64, 16, 8, 1)
    assert rec[0, sm90.HEAD_WORDS + sm90.MAP_WORDS:].abs().sum() == 0  # one map: G's
    assert wg["tile"] == (64, 128) and wg["k"] == 576 and wg["npatch"] == npatch
    assert rec[2, 1:10].tolist() == [128, 5, 1, ns[1], ns[1], 64, 64, 0, 1]
    for n in ns:
        ranges = sm90.split_ranges(npatch, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == npatch
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(hi - lo >= min(8, npatch) for lo, hi in ranges)
    assert wg["maps"][0]["dims"] == wg["maps"][1]["dims"] == (64, W, H, B)
    tm = sm90.conv_tile_m(H, 64)
    assert dg["tile"] == (tm, 64) and dg["k_slices"] == 9
    assert rec[3, 1:7].tolist() == [64, B * (H // (tm // 16)) * (W // 16), 1, 1, 1, tm]
    assert dg["maps"][0]["dims"] == (64, W, H, B) and dg["maps"][1]["dims"] == (64, 9, 64)
    assert rec[3, sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS:].abs().sum() == 0  # one input map
    for ln in (wi, wg, dg):
        assert ln["smem"] <= SMEM_LIMIT
        assert all(s % 16 == 0 for m in ln["maps"] for s in m["strides"])
    assert 2 * wi["smem"] <= SMEM_LIMIT and wi["stages"] >= 3  # two blocks an SM
    if H == 512:
        assert ns[0] == 2 * sm90.SMS and tm == 256 and sm90.conv_own_staging(64, tm)
        waves = wg["grid"][0] * ns[1] / sm90.SMS
        assert waves >= 4 or waves / -(-waves // 1) >= 0.85


@pytest.mark.parametrize("B,H,W", [(2, 16, 32), (1, 24, 16)])
def test_image_wgrad_float64(B, H, W):
    """The image GEMM's arithmetic in float64 on the CPU, as
    ``wgrad_image_kernel`` and its reduce pass do it: per split, over its
    8 × 16 patches in order, G^T times the 128 × 64 im2col box (column k =
    tap · 3 + c of each pixel's 3 × 3 neighbourhood, zero outside the image
    and past 27), then the splits added in order and column k sent to dk[f,
    k % 3, tap = k // 3], the bias from G's sums: within 1e-12 of the plain
    version's weight and bias gradients (``conv_wgrad``'s
    ``convolution_backward``, here in float64)."""
    rng = np.random.default_rng(B * H * W)
    img = torch.from_numpy(rng.random((B, H, W, 3)))
    g = torch.from_numpy(rng.standard_normal((B, H, W, 64)))
    ln = sm90.wgrad_image_launch(B, H, W, 64)
    pad = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    cols = torch.zeros((B, H, W, 64), dtype=torch.float64)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        cols[..., 3 * tap:3 * tap + 3] = pad[:, ky:ky + H, kx:kx + W]
    tiles_w, tiles_hw = W // 16, (H // 8) * (W // 16)
    part = torch.zeros((ln["nsplit"], 64, 64), dtype=torch.float64)
    bpart = torch.zeros((ln["nsplit"], 64), dtype=torch.float64)
    for s, (lo, hi) in enumerate(sm90.split_ranges(ln["npatch"], ln["nsplit"])):
        for q in range(lo, hi):
            b, thw = divmod(q, tiles_hw)
            y0, x0 = (thw // tiles_w) * 8, (thw % tiles_w) * 16
            gb = g[b, y0:y0 + 8, x0:x0 + 16].reshape(128, 64)
            part[s] += gb.T @ cols[b, y0:y0 + 8, x0:x0 + 16].reshape(128, 64)
            bpart[s] += gb.sum(0)
    total = part.sum(0)
    assert total[:, 27:].abs().max() == 0  # the padding columns
    dk = torch.zeros((64, 3, 3, 3), dtype=torch.float64)
    for k in range(27):
        dk[:, k % 3, (k // 3) // 3, (k // 3) % 3] = total[:, k]
    ref = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), img.permute(0, 3, 1, 2), dk, None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [False, True, False])[1]
    assert ref.shape == dk.shape and (dk - ref).abs().max() <= 1e-12 * ref.abs().max()
    db = bpart.sum(0)
    assert (db - g.sum((0, 1, 2))).abs().max() <= 1e-12 * db.abs().max()


@pytest.mark.parametrize("B,H,W", [(8, 512, 512), (1, 512, 512), (2, 24, 32)])
def test_stem_fwd_plan(B, H, W):
    """The stem's forward: conv1_1 on the image GEMM (``OP_FWD_IMAGE``: 128
    pixels × 64 channels, no tensor map, grid x blocks walking the 8 × 16
    patches, two an SM, grid y the F / 64 channel tiles; two blocks' shared
    memory within the SM's) and conv1_2 over a1 with the pool
    (``OP_FWD_POOL``, the maps of a1 and the packed w12) at the tile rule's
    pixels: 256 × 64 and persistent where H % 16 == 0, 128 × 64 where not;
    the blocks' patch walks cover every patch once; the cached records
    carry it all."""
    F = 64
    img, conv = sm90.stem_fwd_launches(B, H, W, F)
    rec = stem_plan(B, H, W, F)
    npatch = B * (H // 8) * (W // 16)
    assert tuple(rec.shape) == (2, sm90.PLAN_WORDS)
    assert img["op"] == sm90.OP_FWD_IMAGE and img["tile"] == (128, 64) and img["maps"] == []
    assert img["grid"] == (min(npatch, 2 * sm90.SMS), 1, 1) and img["npatch"] == npatch
    assert rec[0, :7].tolist() == [sm90.OP_FWD_IMAGE, 64, *img["grid"], 1, 128]
    assert rec[0, 7:].abs().sum() == 0
    assert 2 * (img["smem"] + 1024) <= SMEM_LIMIT + 1024  # two blocks an SM (228 KB)
    assert img["smem"] == (img["stages"] * (16384 + 16) + 8192 + 128 * 72 * 2 + 512
                           + 1024)
    walks = [q for i in range(img["grid"][0]) for q in range(i, npatch, img["grid"][0])]
    assert sorted(walks) == list(range(npatch))
    tm = 128 if H % 16 else 256
    assert conv["op"] == sm90.OP_FWD_POOL and conv["tile"] == (tm, 64)
    assert sm90.conv_own_staging(64, tm) and conv["smem"] <= SMEM_LIMIT
    assert conv["grid"] == (B * (H // (tm // 16)) * (W // 16), 1, 1) and conv["k_slices"] == 9
    assert conv["maps"][0]["dims"] == (F, W, H, B) and conv["maps"][1]["dims"] == (F, 9, F)
    assert rec[1, :7].tolist() == [sm90.OP_FWD_POOL, 64, *conv["grid"], 1, tm]
    assert rec[1, sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS:].abs().sum() == 0  # one input map
    for m in conv["maps"]:
        assert all(s % 16 == 0 for s in m["strides"]) and m["box"][0] * 2 <= SWIZZLE_BYTES


def _pack_image(w):
    """OIHW (F, 3, 3, 3) → (F, 64), column k = tap · 3 + c, zero past 27:
    ``_build.pack_conv3x3(w, 64)``'s layout in ``w``'s dtype."""
    p = w.permute(0, 2, 3, 1).reshape(w.shape[0], 27)
    return torch.nn.functional.pad(p, (0, 64 - 27))


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("B,H,W", [(2, 16, 32), (1, 24, 16)])
def test_image_fwd_float64(B, H, W, u8):
    """conv1_1's image GEMM in float64 on the CPU, as ``conv_image_kernel``
    does it: block i of the plan walks patches i, i + blocks, ..., gathering
    each pixel's 64 im2col columns (k = tap · 3 + c, zero outside the image
    and past 27; a uint8 image normalised in the weights' dtype, a bf16
    image's values as they are), multiplying the 128 × 64 tile by the packed
    weights (the layout of ``_build.pack_conv3x3(w11, 64)``) and adding bias
    + ReLU: within 1e-12 of ``vgg_stem_plain``'s conv1_1 in float64; that
    a1 through conv1_2 and the pool within 1e-12 of ``vgg_stem_plain``'s
    skip and pooled."""
    rng = np.random.default_rng(B * H * W + u8)
    if u8:
        img = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8))
    else:
        img = torch.from_numpy(rng.random((B, H, W, 3))).to(torch.bfloat16)
    w11 = torch.from_numpy(rng.standard_normal((64, 3, 3, 3)) / np.sqrt(27))
    w12 = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)) / 24)
    b11, b12 = (torch.from_numpy(0.1 * rng.standard_normal(64)) for _ in range(2))
    wt = _pack_image(w11)
    assert torch.equal(_build.pack_conv3x3(w11, 64), wt.to(torch.bfloat16))
    x = normalize_u8(img, torch.float64) if u8 else img.to(torch.float64)
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.zeros((B, H, W, 64), dtype=torch.float64)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        cols[..., 3 * tap:3 * tap + 3] = pad[:, ky:ky + H, kx:kx + W]
    ln = sm90.image_fwd_launch(B, H, W, 64)
    tiles_w, tiles_hw = W // 16, (H // 8) * (W // 16)
    a1 = torch.full((B, H, W, 64), float("nan"), dtype=torch.float64)
    for i in range(ln["grid"][0]):
        for q in range(i, ln["npatch"], ln["grid"][0]):
            b, thw = divmod(q, tiles_hw)
            y0, x0 = (thw // tiles_w) * 8, (thw % tiles_w) * 16
            acc = cols[b, y0:y0 + 8, x0:x0 + 16].reshape(128, 64) @ wt.T
            a1[b, y0:y0 + 8, x0:x0 + 16] = torch.relu(acc + b11).reshape(8, 16, 64)
    ref = conv3x3_relu(x, w11, b11)
    assert ref.dtype == torch.float64 and (a1 - ref).abs().max() <= 1e-12 * ref.abs().max()
    skip = conv3x3_relu(a1, w12, b12)
    for e, r in zip((skip, max_pool2x2(skip)), vgg_stem_plain(img, w11, b11, w12, b12)):
        assert r.dtype == torch.float64 and (e - r).abs().max() <= 1e-12 * r.abs().max()


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
