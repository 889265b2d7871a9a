"""Host plan of the Hopper conv core (``csrc/conv3x3_sm90.cuh``), the
weight-gradient GEMM (``csrc/wgrad_sm90.cuh``) and the stem's image GEMMs
(``csrc/stem.cu``, ``csrc/encoder_train.cu``).

Everything such a kernel is told comes from here: its tile, its grid, its
split count and the TMA tensor maps (dims, byte strides, boxes) of its
operands (a conv's input, or the two input maps of a channel concat, and
its weights; a GEMM's output gradient and input).  :func:`encode` lays
launches out as the int64 records that ``csrc/sm90.cuh::Launch`` reads;
the C side binds the tensors' addresses, picks the instantiation of the
record's tile and encodes the maps.
The ring's stages and shared memory follow from the tile: the C side
derives them (``ConvSmem``, ``WgradSmem``) and a plan states them for the
CPU tests, which reach every number.
"""
from __future__ import annotations

import math

import torch

PATCH_H, PATCH_W = 8, 16           # a tile's pixels: 8 rows x 16 columns
PATCH = PATCH_H * PATCH_W
SLICE_C = 64                       # channels of a box (128 bytes, the swizzle span)
BOX_BYTES = PATCH * SLICE_C * 2
CONSUMERS = 256                    # two consumer warpgroups (and one producer)
RING_BYTES = 192 * 1024            # the TMA ring (the conv kernel's where it stages in it)
SMEM_MAX = 232448                  # a block's dynamic shared memory on an H100, 227 KB
SMS = 132                          # an H100 SXM's streaming multiprocessors
OP_FWD, OP_FWD_POOL, OP_DGRAD_MASK, OP_DGRAD_SPLIT, OP_WGRAD, OP_WGRAD_IMAGE, OP_FWD_IMAGE = \
    range(7)
HEAD_WORDS, MAP_WORDS = 10, 12
PLAN_WORDS = HEAD_WORDS + 3 * MAP_WORDS


def conv_stage_bytes(tile_n: int, tile_m: int = PATCH) -> int:
    """One stage of the conv kernel's ring: an input box of ``tile_m``
    pixels and a weight box, 64 channels each."""
    return (tile_m + tile_n) * SLICE_C * 2


def conv_out_bytes(tile_n: int, tile_m: int = PATCH) -> int:
    """The conv kernel's epilogue tile: bf16 rows of tile_n + 8 channels."""
    return tile_m * (tile_n + 8) * 2


def conv_own_staging(tile_n: int, tile_m: int = PATCH) -> bool:
    """Whether the epilogue tile has shared memory of its own (and a block
    walks many tiles, the producer filling the ring during the epilogue):
    where that leaves the ring at least 4 stages."""
    fit = (SMEM_MAX - 2048 - conv_out_bytes(tile_n, tile_m)) // conv_stage_bytes(tile_n, tile_m)
    return fit >= 4


def conv_stages(tile_n: int, tile_m: int = PATCH) -> int:
    """Ring stages of the conv kernel: beside its own epilogue tile, as many
    as fit (at most 8); else as many as 192 KB hold, the epilogue tile
    staged in the ring."""
    stage = conv_stage_bytes(tile_n, tile_m)
    if conv_own_staging(tile_n, tile_m):
        return min(8, (SMEM_MAX - 2048 - conv_out_bytes(tile_n, tile_m)) // stage)
    return RING_BYTES // stage


def conv_smem(tile_n: int, tile_m: int = PATCH) -> int:
    """Dynamic shared memory of the conv kernel: the ring, the epilogue
    tile where it has its own, the barriers and 1024 bytes to align the
    ring."""
    n = conv_stages(tile_n, tile_m)
    out = conv_out_bytes(tile_n, tile_m) if conv_own_staging(tile_n, tile_m) else 0
    return n * conv_stage_bytes(tile_n, tile_m) + out + 2 * n * 8 + 1024


def tap_width(c: int) -> int:
    """A tap's columns in the weight-gradient GEMM's K: C padded to a
    multiple of 64 (one TMA box never straddles two taps)."""
    return -(-c // SLICE_C) * SLICE_C


def wgrad_stage_boxes(tile_f: int, tile_n: int) -> int:
    """TMA boxes a stage of the weight-gradient kernel holds: at 128 f, two
    gradient boxes and tile_n / 64 input boxes; at 64 f (the warpgroups
    splitting the 128 columns), one gradient box and two input boxes."""
    return 2 + tile_n // 64 if tile_f == 128 else 3


def wgrad_stages(tile_n: int, tile_f: int = 128) -> int:
    """Ring stages of the weight-gradient kernel: as many as 192 KB hold."""
    return RING_BYTES // (wgrad_stage_boxes(tile_f, tile_n) * BOX_BYTES)


def wgrad_smem(tile_n: int, tile_f: int = 128) -> int:
    """Dynamic shared memory of the weight-gradient kernel: the ring, the
    bias partials (8 floats a consumer thread), the barriers and the
    alignment."""
    n = wgrad_stages(tile_n, tile_f)
    return (n * wgrad_stage_boxes(tile_f, tile_n) * BOX_BYTES + CONSUMERS * 8 * 4 + 2 * n * 8
            + 1024)


def widest_tile(n: int) -> int:
    """The widest N tile (256, 128 or 64) that divides ``n``."""
    return next(t for t in (256, 128, 64) if n % t == 0)


def conv_tile_n(n: int) -> int:
    """The conv core's N tile for an output of ``n`` channels: 192 where 192
    divides n and 256 does not (conv1's dgrad at a decoder's up1 and up2,
    Cs + Cx = 192 and 384), else the widest of 256 / 128 / 64 that divides
    it.  On an H100 one 128 × 192 tile ran that dgrad 19% faster than
    three 256 × 64 tiles at up1 (77 FLOP a byte of L2 against 52) and two
    ran it 13% faster than three 256 × 128 tiles at up2, whose 48 KB stages
    leave no room for a staging tile of their own (PERF.md, Findings)."""
    return 192 if n % 192 == 0 and n % 256 else widest_tile(n)


def tensor_map(dims, box) -> dict:
    """A bf16 tensor map: ``dims`` and ``box`` innermost first, the byte
    strides of dims 1.. of the dense tensor."""
    strides, s = [], 2
    for d in dims[:-1]:
        s *= d
        strides.append(s)
    return {"dims": tuple(dims), "strides": tuple(strides), "box": tuple(box)}


def nhwc_map(B: int, H: int, W: int, C: int, patch_h: int = PATCH_H) -> dict:
    """(B, H, W, C) activations; the box is a tile's ``patch_h`` x 16
    pixels by 64 channels."""
    return tensor_map((C, W, H, B), (SLICE_C, PATCH_W, patch_h, 1))


def weight_map(C: int, F: int, tile_n: int) -> dict:
    """Packed weights (F, 9C) seen as (F, 9, C); the box is one tap's 64
    channels of tile_n output channels."""
    return tensor_map((C, 9, F), (SLICE_C, 1, tile_n))


def conv_launch(op: int, B: int, H: int, W: int, C: int, F: int, C2: int = 0,
                tile_m: int = PATCH, split: int | None = None) -> dict:
    """One 3×3 SAME conv (B, H, W, C [+ C2]) → (B, H, W, F) on the conv
    core: the forward (``OP_FWD`` / ``OP_FWD_POOL``) or a dgrad (C is then
    the output gradient's width and F the input's): ``OP_DGRAD_MASK``, or
    ``OP_DGRAD_SPLIT`` unmasked, channels [0, ``split``) to one output and
    [split, F) to another (``split`` defaults to F; the record carries
    it).  With ``C2`` the input is the channel concat of two maps, [in (C)
    | in2 (C2)], never stored: the weights are (F, 9, C + C2) and the K walk
    (:func:`k_walk`) takes each tap's slices of in, then of in2 (a UnetUp
    stage's conv1).  Tile: ``tile_m`` pixels (128: 8 × 16; 256: 16 × 16,
    :func:`conv_tile_m`'s rule) × :func:`conv_tile_n`'s channels: the
    widest reads the fewest L2 bytes a FLOP, and at
    VGG16's block 5 (8 × 32², 512 channels) its 128 blocks make one wave
    on the 132 SMs.  The grid's x is the tile count, the F / tile_n tiles of
    one patch adjacent (the kernel launches one block an SM that walks them
    where its epilogue tile has memory of its own,
    :func:`conv_own_staging`)."""
    tile_n = conv_tile_n(F)
    patch_h = tile_m // PATCH_W
    tiles_m = B * (H // patch_h) * (W // PATCH_W)
    maps = [nhwc_map(B, H, W, C, patch_h), weight_map(C + C2, F, tile_n)]
    if C2:
        maps.append(nhwc_map(B, H, W, C2, patch_h))
    ln = {"op": op, "tile": (tile_m, tile_n), "grid": ((F // tile_n) * tiles_m, 1, 1),
          "smem": conv_smem(tile_n, tile_m), "stages": conv_stages(tile_n, tile_m),
          "nsplit": 1, "k_slices": 9 * (-(-C // SLICE_C) + -(-C2 // SLICE_C)),
          "maps": maps}
    if op == OP_DGRAD_SPLIT:
        ln["out"] = (F if split is None else split, 0, 0)
    return ln


def k_walk(C: int, C2: int = 0):
    """The conv core's K slices in the producer's order: per tap, in's
    ceil(C / 64) slices, then in2's ceil(C2 / 64); each as (tap, map, c0,
    wc) — map 0 (in) or 2 (in2), the slice's first channel in that map and
    in the weights (F, 9, C + C2)."""
    out = []
    for tap in range(9):
        out += [(tap, 0, c0, c0) for c0 in range(0, C, SLICE_C)]
        out += [(tap, 2, c0, C + c0) for c0 in range(0, C2, SLICE_C)]
    return out


# the most 8 × 16 patches a weight-gradient split sums in one float32
# accumulator: its error grows with that run (self_net's head at 8.4M
# pixels, 23 splits of 2849 patches, read dk2 3.8e-4 of max |dk2| from a
# float64 evaluation on an H100); every other GEMM of the port at 512²,
# batch 8 runs at most 1260 and keeps its splits
MAX_SPLIT_PATCHES = 1280


def wgrad_splits(tiles: int, npatch: int) -> int:
    """The split count of a weight-gradient GEMM with ``tiles`` output tiles
    over ``npatch`` pixel patches: the smallest that fills the last wave of
    blocks on the SMs to 85% or gives at least 4 waves, each split keeping
    at least 8 patches and at most ``MAX_SPLIT_PATCHES`` (else the best
    fill found)."""
    least = -(-npatch // MAX_SPLIT_PATCHES)
    best, best_fill = least, 0.0
    for ns in range(least, max(least, npatch // 8) + 1):
        waves = tiles * ns / SMS
        fill = waves / math.ceil(waves)
        if fill >= 0.85 or waves >= 4:
            return ns
        if fill > best_fill:
            best, best_fill = ns, fill
    return best


def split_ranges(npatch: int, nsplit: int):
    """The contiguous patch range of each split, in order (as the kernel
    computes it)."""
    return [(s * npatch // nsplit, (s + 1) * npatch // nsplit) for s in range(nsplit)]


def wgrad_launch(B: int, H: int, W: int, C: int, F: int, out_channels: int | None = None,
                 out_offset: int = 0, bias: bool = True) -> dict:
    """The weight gradient (F, 9C) of a conv with input (B, H, W, C) and
    output gradient (B, H, W, F) over K = 9 ``tap_width(C)`` columns, split
    over the 8 × 16 pixel patches.  Tiles of 128 f × 128 K-columns (64
    where the padded tap width is no multiple of 128), a warpgroup's 64 f
    each; at F = 64, 64 f × 128 K-columns, a warpgroup's 64 columns each,
    so that neither idles (the last tile may hold 64 columns).  Its reduce
    pass writes channels [out_offset, out_offset + C) of an (F,
    out_channels, 3, 3) gradient (default: the whole (F, C, 3, 3)) and,
    with ``bias``, the bias gradient."""
    cp = tap_width(C)
    tile_f = 64 if F == 64 else 128
    tile_n = 128 if tile_f == 64 else min(128, widest_tile(cp))
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    grid_xy = (-(-(9 * cp) // tile_n), -(-F // tile_f))
    ns = wgrad_splits(grid_xy[0] * grid_xy[1], npatch)
    return {"op": OP_WGRAD, "tile": (tile_f, tile_n), "grid": (*grid_xy, ns),
            "smem": wgrad_smem(tile_n, tile_f), "stages": wgrad_stages(tile_n, tile_f),
            "nsplit": ns,
            "npatch": npatch, "k": 9 * cp,
            "out": (C if out_channels is None else out_channels, out_offset, int(bias)),
            "maps": [nhwc_map(B, H, W, F), nhwc_map(B, H, W, C)]}


def wgrad_image_stages() -> int:
    """Ring stages of the image GEMM: a G box and a gathered im2col box a
    stage, as many as half of 192 KB hold (two blocks an SM)."""
    return RING_BYTES // 2 // (2 * BOX_BYTES)


def wgrad_image_launch(B: int, H: int, W: int, F: int) -> dict:
    """The stem's conv1_1 weight gradient (F, 3, 3, 3) over the 3-channel
    image (``csrc/encoder_train.cu::wgrad_image_kernel``, ``OP_WGRAD_IMAGE``):
    G^T from TMA boxes of the output gradient as :func:`wgrad_launch` takes
    them, the 27 im2col columns (k = tap · 3 + c, padded to 64) gathered by
    the producer warpgroup (an image pixel is 6 bytes: no TMA box).  Tile 64
    f × 64 columns, one consumer warpgroup; split over the 8 × 16 pixel
    patches so that F / 64 × splits blocks take two an SM (each split
    keeping at least 8 patches): the GEMM is bound by reading G once.  Its
    reduce pass writes the whole (F, 3, 3, 3) and the bias gradient."""
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    ns = max(1, min(2 * SMS // (F // 64), npatch // 8))
    stages = wgrad_image_stages()
    return {"op": OP_WGRAD_IMAGE, "tile": (64, 64), "grid": (1, F // 64, ns),
            "smem": stages * 2 * BOX_BYTES + 128 * 8 * 4 + 2 * stages * 8 + 1024,
            "stages": stages, "nsplit": ns, "npatch": npatch, "k": 64, "out": (3, 0, 1),
            "maps": [nhwc_map(B, H, W, F)]}


IMAGE_FWD_STAGES = 4  # csrc/stem.cu::ImageFwdSmem


def image_fwd_smem() -> int:
    """Dynamic shared memory of conv1_1's forward GEMM: a ring of gathered
    128-pixel tiles, the block's 64 f × 64 columns of the weights, the
    epilogue's bf16 tile (rows of 72), the uint8 normalisation table (256
    bf16), the barriers and the alignment."""
    return (IMAGE_FWD_STAGES * BOX_BYTES + 64 * SLICE_C * 2 + PATCH * (64 + 8) * 2 + 256 * 2
            + 2 * IMAGE_FWD_STAGES * 8 + 1024)


def image_fwd_launch(B: int, H: int, W: int, F: int) -> dict:
    """The stem's conv1_1 forward (``csrc/stem.cu::conv_image_kernel``,
    ``OP_FWD_IMAGE``): a1 = relu(im2col(image) · W11ᵀ + b11) with the 27
    im2col columns (k = tap · 3 + c) padded to 64 and gathered by the
    producer warpgroup (no TMA box takes the image: no tensor map).  Tile
    128 pixels (an 8 × 16 patch) × 64 output channels; grid y the F / 64
    channel tiles, grid x blocks that walk the patches, two an SM: the GEMM
    is bound by writing a1."""
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    blocks = max(1, min(npatch, 2 * SMS // (F // 64)))
    return {"op": OP_FWD_IMAGE, "tile": (PATCH, 64), "grid": (blocks, F // 64, 1),
            "smem": image_fwd_smem(), "stages": IMAGE_FWD_STAGES, "nsplit": 1,
            "npatch": npatch, "maps": []}


def wgrad_work(launches, F: int) -> int:
    """float32 words of the work area that the weight-gradient launches
    share in turn (one stream orders them): the largest one's split
    partials (nsplit, F, K) and bias partials (nsplit, F)."""
    return max(ln["nsplit"] * F * (ln["k"] + 1) for ln in launches)


def conv_tile_m(H: int, F: int) -> int:
    """The conv tile's pixels for an output of F channels, H rows high: 256
    (16 × 16) where the N tile is at most 128 channels wide (a decoder's
    up1 and up2, VGG16 block 2's convs and dgrads) and H % 16 == 0, else
    128 (8 × 16).  The wider patch reads 52 rather than 43 FLOP a byte of
    L2 at 64 channels, 85 rather than 64 at 128; on an H100 it ran the
    decoder's conv1 and conv2 10-12% faster at both models' up1 and 19-22%
    at up2, and block 2's conv 1 (9 K slices) 14% faster than the
    persistent 128-pixel tile (PERF.md, Findings).  At 256 channels the
    128 × 256 tile already reads 85."""
    return 2 * PATCH if conv_tile_n(F) <= 128 and H % 16 == 0 else PATCH


def unetup_launches(B: int, H2: int, W2: int, Cs: int, Cx: int, F: int):
    """A UnetUp stage's forward on the conv core: conv1 over the two maps
    [skip (Cs) | up (Cx)] into y1, conv2 over y1, both with bias + ReLU, at
    the tile of :func:`conv_tile_m`.  At Cs = 0 (the ``up_conv`` head,
    #10 / #11) conv1 reads the one map up."""
    tm = conv_tile_m(H2, F)
    conv1 = conv_launch(OP_FWD, B, H2, W2, Cs, F, Cx, tm) if Cs else \
        conv_launch(OP_FWD, B, H2, W2, Cx, F, 0, tm)
    return [conv1, conv_launch(OP_FWD, B, H2, W2, F, F, 0, tm)]


def unetup_bwd_launches(B: int, H2: int, W2: int, Cs: int, Cx: int, F: int):
    """#13's two dgrads, each at the tile of :func:`conv_tile_m` for its
    output: conv2's over g2 (F → F), masked by y1 > 0 into dz1
    (``OP_DGRAD_MASK``); conv1's over dz1 (F → Cs + Cx), split at Cs into
    dskip and dups (``OP_DGRAD_SPLIT``)."""
    return [conv_launch(OP_DGRAD_MASK, B, H2, W2, F, F, 0, conv_tile_m(H2, F)),
            conv_launch(OP_DGRAD_SPLIT, B, H2, W2, F, Cs + Cx, 0, conv_tile_m(H2, Cs + Cx),
                        split=Cs)]


def block_fwd_launches(B: int, H: int, W: int, chans, pool: bool):
    """A VGG16 block's forward (two or three convs), each conv bias + ReLU:
    ``OP_FWD``, the last conv ``OP_FWD_POOL`` when ``pool``, each at the
    tile of :func:`conv_tile_m` for its output (256 pixels at block 2)."""
    n = len(chans) - 1
    return [conv_launch(OP_FWD_POOL if pool and i == n - 1 else OP_FWD, B, H, W, chans[i],
                        chans[i + 1], 0, conv_tile_m(H, chans[i + 1])) for i in range(n)]


def block_bwd_launches(B: int, H: int, W: int, chans, want_dx: bool):
    """A VGG16 block's backward (two or three convs): per conv i, its weight
    gradient at 2i and its dgrad at 2i + 1 — masked by the ReLU of its input
    for i > 0, for conv 0 the plain store to dx (``OP_DGRAD_SPLIT`` with
    every channel to dx), None without dx — the dgrads at the tile of
    :func:`conv_tile_m`."""
    launches = []
    for i in range(len(chans) - 1):
        cin, cout = chans[i], chans[i + 1]
        op = OP_DGRAD_MASK if i > 0 else OP_DGRAD_SPLIT
        dgrad = conv_launch(op, B, H, W, cout, cin, 0, conv_tile_m(H, cin)) \
            if i > 0 or want_dx else None
        launches += [wgrad_launch(B, H, W, cin, cout), dgrad]
    return launches


def stem_bwd_launches(B: int, H: int, W: int, F: int):
    """The stem's backward (#20) laid out as a block's
    (:func:`block_bwd_launches`: conv i's weight gradient at 2i, its dgrad
    at 2i + 1): conv1_1's weight gradient over the image
    (:func:`wgrad_image_launch`) and no dgrad (the stem computes no image
    gradient); conv1_2's weight gradient over a1 (F → F; at F = 64 the 64
    f × 128-column tile) and its dgrad masked by a1 > 0 at the tile of
    :func:`conv_tile_m`."""
    return [wgrad_image_launch(B, H, W, F), None,
            *block_bwd_launches(B, H, W, [F, F, F], False)[2:]]


def stem_fwd_launches(B: int, H: int, W: int, F: int):
    """The stem's forward (#2): conv1_1 over the image into a1
    (:func:`image_fwd_launch`), then conv1_2 over a1 with bias + ReLU and
    the 2 × 2 max-pool in its epilogue (``OP_FWD_POOL``) at the tile of
    :func:`conv_tile_m`, as block 2's second conv runs."""
    return [image_fwd_launch(B, H, W, F),
            conv_launch(OP_FWD_POOL, B, H, W, F, F, 0, conv_tile_m(H, F))]


def upconv_bwd_launches(B: int, H2: int, W2: int, Cx: int, F: int):
    """The ``up_conv`` head's backward (#12), the stage backward at Cs = 0:
    conv2's dgrad masked by y1 > 0 into dz1 (:func:`unetup_bwd_launches`'s
    first); conv1's dgrad over dz1 (F → Cx) with every channel to dups
    (``OP_DGRAD_SPLIT`` at split = Cx, as a block's conv 0 writes dx: the
    core takes 0 < split ≤ F); the weight gradients dk2 / db2 over (g2, y1)
    and dk1 / db1 over (dz1, up) (:func:`wgrad_launch`)."""
    return [unetup_bwd_launches(B, H2, W2, 0, Cx, F)[0],
            conv_launch(OP_DGRAD_SPLIT, B, H2, W2, F, Cx, 0, conv_tile_m(H2, Cx)),
            wgrad_launch(B, H2, W2, F, F), wgrad_launch(B, H2, W2, Cx, F)]


def unetup_wgrad_launches(B: int, H2: int, W2: int, Cs: int, Cx: int, F: int):
    """A UnetUp stage's weight gradients: dk1's skip channels from (dz1,
    skip) with db1, dk1's up channels from (dz1, up), dk2 from (g2, y1)
    with db2; each reduce pass writes its channel range of its gradient."""
    return [wgrad_launch(B, H2, W2, Cs, F, Cs + Cx, 0, True),
            wgrad_launch(B, H2, W2, Cx, F, Cs + Cx, Cs, False),
            wgrad_launch(B, H2, W2, F, F)]


def encode(launches) -> torch.Tensor:
    """(n, PLAN_WORDS) int64 records on the CPU: op, tile_n, grid x / y / z,
    split count, tile_m, a weight gradient's output channels, first channel
    and bias flag, then per map (three) its rank, dims (4), byte strides (3)
    and box (4); unused words and absent maps 0."""
    out = torch.zeros((len(launches), PLAN_WORDS), dtype=torch.int64)
    for i, ln in enumerate(launches):
        if ln is None:
            continue
        words = [ln["op"], ln["tile"][1], *ln["grid"], ln["nsplit"], ln["tile"][0],
                 *ln.get("out", (0, 0, 0))]
        for m in ln["maps"]:
            rank = len(m["dims"])
            words += [rank, *m["dims"], *([0] * (4 - rank)), *m["strides"],
                      *([0] * (3 - len(m["strides"]))), *m["box"], *([0] * (4 - rank))]
        out[i, :len(words)] = torch.tensor(words, dtype=torch.int64)
    return out
