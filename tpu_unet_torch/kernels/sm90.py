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

Every plan is in an element type: bf16, or float32 with ``f32=True`` (the
float32 training path; its products are TF32).  A record names it (its
word 10), and the C entries refuse a record of the other type.  In float32
a box's 128 bytes hold 32 channels, not 64: the conv core's K slices
follow, the stage bytes stay, and the epilogue's float32 tile takes twice
the bytes, so it is staged in chunks of columns (:func:`conv_chunk`) that
keep every float32 tile persistent (:func:`conv_own_staging`).
The weight-gradient GEMM in float32 is a kernel of its own
(``wgrad_tf32_kernel``: TF32 ``wgmma``, whose .tf32 form reads no MN-major
operand from shared memory, so the input goes in as register fragments and
G is restaged K-major): 64 f × 576 columns, all nine taps of a 64-channel
slice, from one halo box a 32-channel slice and a 2 × 16-pixel stage
(:func:`wgrad_launch`, :func:`halo_map`).  The up_conv head's four float32
convs, a UnetUp stage's two float32 convs at F ≤ 256 (conv1 over its two
maps) and the stem backward's float32 masked dgrad run on a mainloop of
their own (``csrc/conv3x3_halo_sm90.cuh``,
:func:`halo_conv_launch`): a K slice is one halo box of 32 channels that
serves all nine taps, each tap a shift of the rows its register fragments
read.  A conv's record names its mainloop (its word 9:
:data:`MAINLOOP_TAP`, :data:`MAINLOOP_HALO`), and each refuses the
other's.
"""
from __future__ import annotations

import math

import torch

PATCH_H, PATCH_W = 8, 16           # a tile's pixels: 8 rows x 16 columns
PATCH = PATCH_H * PATCH_W
BOX_BYTES = PATCH * 128            # a box: a tile's pixels by 128 bytes (the swizzle span)
CONSUMERS = 256                    # two consumer warpgroups (and one producer)
RING_BYTES = 192 * 1024            # the TMA ring (the conv kernel's where it stages in it)
SMEM_MAX = 232448                  # a block's dynamic shared memory on an H100, 227 KB
SMS = 132                          # an H100 SXM's streaming multiprocessors
OP_FWD, OP_FWD_POOL, OP_DGRAD_MASK, OP_DGRAD_SPLIT, OP_WGRAD, OP_WGRAD_IMAGE, OP_FWD_IMAGE = \
    range(7)
HEAD_WORDS, MAP_WORDS = 11, 12
PLAN_WORDS = HEAD_WORDS + 3 * MAP_WORDS
MAINLOOP_TAP, MAINLOOP_HALO = 0, 1  # a conv record's word 9


def itemsize(f32: bool = False) -> int:
    """Bytes of an element: 2 (bf16) or 4 (float32)."""
    return 4 if f32 else 2


def slice_c(f32: bool = False) -> int:
    """Channels of a box's 128 bytes: 64 bf16, 32 float32."""
    return 128 // itemsize(f32)


def conv_stage_bytes(tile_n: int, tile_m: int = PATCH) -> int:
    """One stage of the conv kernel's ring: an input box of ``tile_m``
    pixels and a weight box, 128 bytes of channels each (in either
    type)."""
    return (tile_m + tile_n) * 128


def conv_ring_fit(tile_n: int, tile_m: int, cols: int, f32: bool = False) -> int:
    """Ring stages that fit beside an epilogue buffer of ``cols`` columns
    (and 16 bytes a row) in the element type: of the 227 KB, less the
    barriers and 1024 spare bytes."""
    es = itemsize(f32)
    return (SMEM_MAX - 2048 - tile_m * (cols + 16 // es) * es) // conv_stage_bytes(tile_n, tile_m)


CONV_F32_CHUNKS = (64, 32, 16)  # the float32 epilogue's chunk widths, widest first


def conv_chunk(tile_n: int, tile_m: int = PATCH, f32: bool = False) -> int:
    """Columns the conv kernel's epilogue stages at a time: in bf16 the
    whole tile; in float32, whose tile takes twice the bytes, the widest of
    64, 32 or 16 whose buffer leaves the ring 4 stages (128 × 256: 32, 128
    × 192: 64, 256 × 128: 16, 256 × 64: 32, 128 × 128 and 128 × 64: 64),
    the accumulators staying in registers until their chunk's turn."""
    if not f32:
        return tile_n
    return next(w for w in CONV_F32_CHUNKS
                if w <= tile_n and conv_ring_fit(tile_n, tile_m, w, True) >= 4)


def conv_out_bytes(tile_n: int, tile_m: int = PATCH, f32: bool = False) -> int:
    """The conv kernel's epilogue buffer: rows of :func:`conv_chunk`'s
    columns and 16 bytes of padding, in the element type."""
    es = itemsize(f32)
    return tile_m * (conv_chunk(tile_n, tile_m, f32) + 16 // es) * es


def conv_own_staging(tile_n: int, tile_m: int = PATCH, f32: bool = False) -> bool:
    """Whether the epilogue buffer has shared memory of its own (and a block
    walks many tiles, the producer filling the ring during the epilogue):
    where that leaves the ring at least 4 stages — every float32 tile,
    through its chunks; in bf16 all but 128 × 256 and 256 × 128, whose
    whole tile is staged in the ring."""
    return conv_ring_fit(tile_n, tile_m, conv_chunk(tile_n, tile_m, f32), f32) >= 4


def conv_stages(tile_n: int, tile_m: int = PATCH, f32: bool = False) -> int:
    """Ring stages of the conv kernel: beside its own epilogue buffer, as
    many as fit (at most 8); else as many as 192 KB hold, the epilogue tile
    staged in the ring."""
    if conv_own_staging(tile_n, tile_m, f32):
        return min(8, conv_ring_fit(tile_n, tile_m, conv_chunk(tile_n, tile_m, f32), f32))
    return RING_BYTES // conv_stage_bytes(tile_n, tile_m)


def conv_smem(tile_n: int, tile_m: int = PATCH, f32: bool = False) -> int:
    """Dynamic shared memory of the conv kernel: the ring, the epilogue
    buffer where it has its own, the barriers and 1024 spare bytes (the
    ring is aligned by its declaration)."""
    n = conv_stages(tile_n, tile_m, f32)
    out = conv_out_bytes(tile_n, tile_m, f32) if conv_own_staging(tile_n, tile_m, f32) else 0
    return n * conv_stage_bytes(tile_n, tile_m) + out + 2 * n * 8 + 1024


PACK_TILE = 32  # csrc/pack_weights.cu: a block's f and c (all nine taps)


def pack_vector(dims, flip: bool, f32: bool) -> int:
    """Outputs a pack-kernel thread writes at once in a launch over weights
    of ``dims`` ((F, C, kp) each): 16 bytes (4 float32, 8 bf16) where every
    output row (kp columns) and every run (starting at a multiple of C, or
    F with ``flip``) keeps them aligned, else 1 (``csrc/pack_weights.cu``
    decides the same)."""
    v = 4 if f32 else 8
    return v if all(kp % v == 0 and (F if flip else C) % v == 0 for F, C, kp in dims) else 1


def pack_tiles(F: int, C: int):
    """The pack kernel's tiles over one weight (F, C, 3, 3), in block order
    (the c tiles of one f tile adjacent): (f0, c0), each PACK_TILE f × PACK_TILE
    c, the last of each axis ragged where F or C is no multiple of it."""
    tc = -(-C // PACK_TILE)
    return [((t // tc) * PACK_TILE, (t % tc) * PACK_TILE)
            for t in range(-(-F // PACK_TILE) * tc)]


def tap_width(c: int) -> int:
    """A tap's columns in the weight-gradient GEMM's K: C padded to 64
    channels (a bf16 box's; the float32 GEMM's column tile, two 32-channel
    halo boxes), so one tile never straddles two taps."""
    return -(-c // 64) * 64


# the float32 GEMM's stage (csrc/wgrad_sm90.cuh::WgradTf32Smem): a 2 × 16
# pixel sub-patch of an 8 × 16 patch; two G boxes (32 f, 16 x, 2 y), two
# halo boxes (32 c, 18 x, 4 y) of the input and the restaged G (64 f rows
# of 32 pixels), six of them in the ring
WGRAD_F32_SUB_H = 2
WGRAD_F32_G_BOX = WGRAD_F32_SUB_H * PATCH_W * 128
WGRAD_F32_HALO_BOX = (PATCH_W + 2) * (WGRAD_F32_SUB_H + 2) * 128
WGRAD_F32_STAGE = 2 * WGRAD_F32_G_BOX + 2 * WGRAD_F32_HALO_BOX + 64 * 128
WGRAD_F32_STAGES = 6


def wgrad_f32_row_channel(v: int, g: int) -> int:
    """The float32 GEMM's register-A fragment: the channel of a column
    tile's 64 that row 16 v + g of an m64 block stands for (warp v of the
    warpgroup, g = lane / 4; row 16 v + g + 8 stands for the next channel),
    so that each thread's two rows are one 8-byte load and a half-warp's
    loads fall on 16 distinct 8-byte places of the swizzled halo rows
    (``csrc/wgrad_sm90.cuh::wgrad_tf32_kernel`` computes the same)."""
    chunk = 2 * (v & 1) + (g >> 2) + 4 * ((g & 3) >> 1)
    return 32 * (v >> 1) + 4 * chunk + 2 * (g & 1)


def wgrad_f32_restage_block(lane: int, r: int):
    """The 4 × 4 block that thread ``lane`` of warp ``r`` (0-3) of the
    float32 GEMM's restager warpgroup moves a stage: (bx, j, pq) for f 32
    bx + 4 j + 0..3 by pixels 4 pq + 0..3 (``wgrad_tf32_kernel`` computes
    the same)."""
    j = lane & 7
    return r >> 1, j, j ^ (4 * (r & 1) + (lane >> 3))


def wgrad_stage_boxes(tile_f: int, tile_n: int) -> int:
    """TMA boxes a stage of the bf16 weight-gradient kernel holds: at 128
    f, two gradient boxes and tile_n / 64 input boxes; at 64 f (the
    warpgroups splitting the 128 columns), one gradient box and two input
    boxes."""
    return 2 + tile_n // 64 if tile_f == 128 else 3


def wgrad_stage_bytes(tile_f: int, tile_n: int, f32: bool = False) -> int:
    """Bytes of a stage of the weight-gradient kernel's ring (float32: the
    two G boxes, the two halo boxes and the restaged G, 34 KB)."""
    return WGRAD_F32_STAGE if f32 else wgrad_stage_boxes(tile_f, tile_n) * BOX_BYTES


def wgrad_stages(tile_n: int, tile_f: int = 128, f32: bool = False) -> int:
    """Ring stages of the weight-gradient kernel: as many as 192 KB hold
    (bf16); six of 34 KB (float32)."""
    if f32:
        return WGRAD_F32_STAGES
    return RING_BYTES // wgrad_stage_bytes(tile_f, tile_n)


def wgrad_smem(tile_n: int, tile_f: int = 128, f32: bool = False) -> int:
    """Dynamic shared memory of the weight-gradient kernel: the ring, the
    bias partials (8 floats a consumer thread in bf16, 4 a restaging thread
    in float32), the barriers (two a stage; float32 three) and 1024 spare
    bytes."""
    n = wgrad_stages(tile_n, tile_f, f32)
    if f32:
        return n * WGRAD_F32_STAGE + 128 * 4 * 4 + 3 * n * 8 + 1024
    return n * wgrad_stage_bytes(tile_f, tile_n) + CONSUMERS * 8 * 4 + 2 * n * 8 + 1024


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


def tensor_map(dims, box, f32: bool = False) -> dict:
    """A tensor map of bf16 (or float32) elements: ``dims`` and ``box``
    innermost first, the byte strides of dims 1.. of the dense tensor."""
    strides, s = [], itemsize(f32)
    for d in dims[:-1]:
        s *= d
        strides.append(s)
    return {"dims": tuple(dims), "strides": tuple(strides), "box": tuple(box)}


def nhwc_map(B: int, H: int, W: int, C: int, patch_h: int = PATCH_H, f32: bool = False) -> dict:
    """(B, H, W, C) activations; the box is a tile's ``patch_h`` x 16
    pixels by 128 bytes of channels (64 bf16, 32 float32)."""
    return tensor_map((C, W, H, B), (slice_c(f32), PATCH_W, patch_h, 1), f32)


def halo_map(B: int, H: int, W: int, C: int, rows: int = WGRAD_F32_SUB_H) -> dict:
    """(B, H, W, C) float32 activations seen through a halo box: ``rows`` ×
    16 pixels with their one-pixel halo, (rows + 2) × 18, by 32 channels
    (the float32 weight-gradient GEMM's 2 × 16 stage; the halo mainloop's
    tile, 16 or 8 rows); loaded at (c, x0 - 1, y0 - 1) its zero fill is the
    SAME padding, and it serves all nine taps."""
    return tensor_map((C, W, H, B), (slice_c(True), PATCH_W + 2, rows + 2, 1), True)


def weight_map(C: int, F: int, tile_n: int, f32: bool = False) -> dict:
    """Packed weights (F, 9C) seen as (F, 9, C); the box is one tap's 128
    bytes of channels of tile_n output channels."""
    return tensor_map((C, 9, F), (slice_c(f32), 1, tile_n), f32)


def conv_launch(op: int, B: int, H: int, W: int, C: int, F: int, C2: int = 0,
                tile_m: int = PATCH, split: int | None = None, f32: bool = False) -> dict:
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
    where its epilogue buffer has memory of its own,
    :func:`conv_own_staging`).  With ``f32`` the launch is float32's: the
    same tiles (the wider tile still reads the fewest L2 bytes a FLOP), K
    slices of 32 channels, the epilogue in chunks (:func:`conv_chunk`),
    persistent, and its own stages."""
    tile_n = conv_tile_n(F)
    patch_h = tile_m // PATCH_W
    tiles_m = B * (H // patch_h) * (W // PATCH_W)
    sl = slice_c(f32)
    maps = [nhwc_map(B, H, W, C, patch_h, f32), weight_map(C + C2, F, tile_n, f32)]
    if C2:
        maps.append(nhwc_map(B, H, W, C2, patch_h, f32))
    ln = {"op": op, "tile": (tile_m, tile_n), "grid": ((F // tile_n) * tiles_m, 1, 1),
          "smem": conv_smem(tile_n, tile_m, f32), "stages": conv_stages(tile_n, tile_m, f32),
          "nsplit": 1, "k_slices": 9 * (-(-C // sl) + -(-C2 // sl)),
          "maps": maps, "f32": f32}
    if op == OP_DGRAD_SPLIT:
        ln["out"] = (F if split is None else split, 0, 0)
    return ln


# the halo mainloop (csrc/conv3x3_halo_sm90.cuh::HaloSmem): 64 output
# channels a tile (a forward at F % 128 == 0: 128); a ring of 2 halo boxes
# and one of weight boxes (32 c, 1 tap, 64 n: 9, a slice's nine taps; 128
# n: 4); the epilogue's buffer beside them
HALO_TN = 64
HALO_STAGES = 2


def halo_tile_n(F: int, op: int = OP_FWD) -> int:
    """The halo mainloop's N tile: 128 channels for a forward where F %
    128 == 0 (one halo box serves both 64-channel halves), else 64."""
    return 2 * HALO_TN if op == OP_FWD and F % (2 * HALO_TN) == 0 else HALO_TN


def halo_w_stages(tile_n: int = HALO_TN) -> int:
    """The halo mainloop's weight ring: a slice's nine tap boxes at 64
    channels (8 KB each); the four that fit beside the halo stages and the
    epilogue's buffer at 128 (16 KB)."""
    return 9 if tile_n == HALO_TN else 4


def halo_box_bytes(tile_m: int) -> int:
    """Bytes of the halo mainloop's box: the tile's (tile_m / 16) × 16
    pixels with their halo, by 128 bytes (41,472 at 256 pixels)."""
    return (PATCH_W + 2) * (tile_m // PATCH_W + 2) * 128


def halo_slot(tile_m: int) -> int:
    """A halo box's stage: its bytes rounded up to 1024 (the 128-byte
    swizzle's repeat, on which TMA and the fragments' addressing agree)."""
    return -(-halo_box_bytes(tile_m) // 1024) * 1024


def halo_chunk(op: int) -> int:
    """Columns the halo mainloop's epilogue stages at a time: the tile's 64,
    or 32 for a masked dgrad (its second chunk's mask loads fly during the
    first chunk's stores)."""
    return 32 if op == OP_DGRAD_MASK else HALO_TN


def halo_smem(tile_m: int, op: int = OP_FWD, tile_n: int = HALO_TN) -> int:
    """Dynamic shared memory of the halo mainloop: 2 halo stages, the
    weight ring (:func:`halo_w_stages` boxes of tile_n × 128 bytes), the
    epilogue's buffer (rows of :func:`halo_chunk`'s columns and 16 bytes),
    3 barriers a halo stage and 2 a weight stage, 1024 spare bytes."""
    ws = halo_w_stages(tile_n)
    return (HALO_STAGES * halo_slot(tile_m) + ws * tile_n * 128
            + tile_m * (halo_chunk(op) + 4) * 4 + 8 * (3 * HALO_STAGES + 2 * ws) + 1024)


def halo_tile_m(H: int) -> int:
    """The halo mainloop's tile: 256 pixels (16 × 16) where H % 16 == 0,
    else 128 (8 × 16)."""
    return 2 * PATCH if H % 16 == 0 else PATCH


def halo_conv_launch(op: int, B: int, H: int, W: int, C: int, F: int, C2: int = 0,
                     split: int | None = None) -> dict:
    """One float32 3×3 SAME conv (B, H, W, C [+ C2]) → (B, H, W, F) on the
    halo mainloop (``OP_FWD``, ``OP_DGRAD_MASK`` or ``OP_DGRAD_SPLIT`` as
    :func:`conv_launch` takes them): tiles of :func:`halo_tile_m`'s pixels
    × :func:`halo_tile_n`'s channels, the F / tile_n channel tiles of a
    patch adjacent, persistent; its K walk slice-major (:func:`halo_walk`):
    per 32-channel slice one halo box (:func:`halo_map` at the tile's rows)
    and the nine taps' weight boxes (:func:`weight_map` at the tile's
    channels).  With ``C2`` (``OP_FWD`` only: a UnetUp stage's conv1) the
    input is the channel concat [in (C) | in2 (C2)], never stored: map 2 is
    in2's halo map, the weights (F, 9, C + C2), and the walk takes in's
    slices, then in2's.  At 256 pixels × 64 channels a slice is 41.5 KB of
    input and 72 KB of weights for 9.44 MFLOP, 82 FLOP a byte of L2 (× 128
    channels: 100) against 25.6 of the conv core's 256 × 64 float32
    tile."""
    if C2 and op != OP_FWD:
        raise ValueError("the halo mainloop takes a second input map only in a forward")
    tile_m, tile_n = halo_tile_m(H), halo_tile_n(F, op)
    patch_h = tile_m // PATCH_W
    tiles_m = B * (H // patch_h) * (W // PATCH_W)
    sl = slice_c(True)
    maps = [halo_map(B, H, W, C, patch_h), weight_map(C + C2, F, tile_n, True)]
    if C2:
        maps.append(halo_map(B, H, W, C2, patch_h))
    ln = {"op": op, "tile": (tile_m, tile_n), "grid": ((F // tile_n) * tiles_m, 1, 1),
          "smem": halo_smem(tile_m, op, tile_n), "stages": HALO_STAGES,
          "w_stages": halo_w_stages(tile_n),
          "nsplit": 1, "k_slices": -(-C // sl) + -(-C2 // sl), "maps": maps,
          "f32": True, "mainloop": MAINLOOP_HALO}
    if op == OP_DGRAD_SPLIT:
        ln["out"] = (F if split is None else split, 0, 0)
    return ln


def flop_per_l2_byte(ln: dict) -> float:
    """A conv launch's operations per byte of its K slice's boxes (what its
    tiles read from L2): the conv core's slice is one tap's box of the
    input and of the weights; the halo mainloop's a halo box and the nine
    taps' weight boxes."""
    tm, tn = ln["tile"]
    sl = slice_c(ln["f32"])
    if ln.get("mainloop") == MAINLOOP_HALO:
        return 2 * tm * tn * 9 * sl / (halo_box_bytes(tm) + 9 * tn * 128)
    return 2 * tm * tn * sl / conv_stage_bytes(tn, tm)


def halo_walk(C: int, C2: int = 0):
    """The halo mainloop's K walk, slice-major: per 32-channel slice of in
    (C channels), then of in2 (C2), the nine taps; each as (tap, map, c0,
    wc) — map 0 (in) or 2 (in2), the slice's first channel in that map and
    in the weights (F, 9, C + C2), as :func:`k_walk` has them."""
    s = slice_c(True)
    slices = [(0, c0, c0) for c0 in range(0, C, s)] + [(2, c0, C + c0) for c0 in range(0, C2, s)]
    return [(tap, m, c0, wc) for m, c0, wc in slices for tap in range(9)]


def halo_fragment_row(lane: int):
    """The halo mainloop's ldmatrix.x4 address of ``lane`` of a consumer
    warp, which gives row lane % 8 of matrix lane / 8: (x, unit) — the
    pixel column of the row it points at (matrices 1 and 3: 8 on) and the
    16-byte unit of the k8 step (matrices 2 and 3: the second)
    (``csrc/conv3x3_halo_sm90.cuh`` computes the same)."""
    return (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4


def k_walk(C: int, C2: int = 0, f32: bool = False):
    """The conv core's K slices in the producer's order: per tap, in's
    ceil(C / s) slices, then in2's ceil(C2 / s) (s = 64 bf16, 32 float32
    channels); each as (tap, map, c0, wc) — map 0 (in) or 2 (in2), the
    slice's first channel in that map and in the weights (F, 9, C + C2)."""
    s = slice_c(f32)
    out = []
    for tap in range(9):
        out += [(tap, 0, c0, c0) for c0 in range(0, C, s)]
        out += [(tap, 2, c0, C + c0) for c0 in range(0, C2, s)]
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
                 out_offset: int = 0, bias: bool = True, f32: bool = False) -> dict:
    """The weight gradient (F, 9C) of a conv with input (B, H, W, C) and
    output gradient (B, H, W, F) over K = 9 ``tap_width(C)`` columns, split
    over the 8 × 16 pixel patches.  Tiles of 128 f × 128 K-columns (64
    where the padded tap width is no multiple of 128), a warpgroup's 64 f
    each; at F = 64, 64 f × 128 K-columns, a warpgroup's 64 columns each,
    so that neither idles (the last tile may hold 64 columns).  Its reduce
    pass writes channels [out_offset, out_offset + C) of an (F,
    out_channels, 3, 3) gradient (default: the whole (F, C, 3, 3)) and,
    with ``bias``, the bias gradient.  With ``f32`` the float32 GEMM (TF32
    ``wgmma``): tiles of 64 f × 576 columns, a 64-channel slice's nine taps
    (grid x the slices, y the 64-f tiles), its stages 2 × 16 pixels of a
    split's patches (:data:`WGRAD_F32_STAGE`, six), the output gradient's
    boxes 2 × 16 pixels by 32 f and the input's the halo boxes of
    :func:`halo_map`."""
    cp = tap_width(C)
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    if f32:
        tile_f, tile_n = 64, 9 * 64
        grid_xy = (cp // 64, F // 64)
        maps = [nhwc_map(B, H, W, F, WGRAD_F32_SUB_H, True), halo_map(B, H, W, C)]
    else:
        tile_f = 64 if F == 64 else 128
        tile_n = 128 if tile_f == 64 else min(128, widest_tile(cp))
        grid_xy = (-(-(9 * cp) // tile_n), -(-F // tile_f))
        maps = [nhwc_map(B, H, W, F), nhwc_map(B, H, W, C)]
    ns = wgrad_splits(grid_xy[0] * grid_xy[1], npatch)
    return {"op": OP_WGRAD, "tile": (tile_f, tile_n), "grid": (*grid_xy, ns),
            "smem": wgrad_smem(tile_n, tile_f, f32), "stages": wgrad_stages(tile_n, tile_f, f32),
            "nsplit": ns, "npatch": npatch, "k": 9 * cp,
            "out": (C if out_channels is None else out_channels, out_offset, int(bias)),
            "maps": maps, "f32": f32}


def wgrad_image_stages(f32: bool = False) -> int:
    """Ring stages of the image GEMM: a G box (float32: two) and a gathered
    im2col box a stage, as many as half of 192 KB hold (two blocks an
    SM)."""
    return RING_BYTES // 2 // ((3 if f32 else 2) * BOX_BYTES)


def wgrad_image_launch(B: int, H: int, W: int, F: int, f32: bool = False) -> dict:
    """The stem's conv1_1 weight gradient (F, 3, 3, 3) over the 3-channel
    image (``csrc/encoder_train.cu::wgrad_image_kernel``, ``OP_WGRAD_IMAGE``):
    G^T from TMA boxes of the output gradient as :func:`wgrad_launch` takes
    them, the 27 im2col columns (k = tap · 3 + c, padded to 64) gathered by
    the producer warpgroup (an image pixel is 6 bytes: no TMA box).  Tile 64
    f × 64 columns, one consumer warpgroup; split over the 8 × 16 pixel
    patches so that F / 64 × splits blocks take two an SM (each split
    keeping at least 8 patches): the GEMM is bound by reading G once.  Its
    reduce pass writes the whole (F, 3, 3, 3) and the bias gradient.  With
    ``f32``: 32 columns (27 used), two G boxes of 32 f a stage, the
    product on ``mma.sync`` TF32 (two warps) and the bias sums (two
    others)."""
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    ns = max(1, min(2 * SMS // (F // 64), npatch // 8))
    stages = wgrad_image_stages(f32)
    kp = slice_c(f32)
    smem = (stages * 3 * BOX_BYTES + 64 * 4 * 4 if f32 else
            stages * 2 * BOX_BYTES + 128 * 8 * 4) + 2 * stages * 8 + 1024
    return {"op": OP_WGRAD_IMAGE, "tile": (64, kp), "grid": (1, F // 64, ns),
            "smem": smem, "stages": stages, "nsplit": ns, "npatch": npatch, "k": kp,
            "out": (3, 0, 1), "maps": [nhwc_map(B, H, W, F, f32=f32)], "f32": f32}


IMAGE_FWD_STAGES = 4  # csrc/stem.cu::ImageFwdSmem


def image_fwd_smem(f32: bool = False) -> int:
    """Dynamic shared memory of conv1_1's forward GEMM: a ring of gathered
    128-pixel tiles, the block's 64 f × 128 bytes of the weights, the
    epilogue's tile (rows of 64 channels and 16 bytes), the uint8
    normalisation table (256 elements), the barriers and 1024 spare bytes;
    in the element type."""
    es = itemsize(f32)
    return (IMAGE_FWD_STAGES * BOX_BYTES + 64 * 128 + PATCH * (64 + 16 // es) * es + 256 * es
            + 2 * IMAGE_FWD_STAGES * 8 + 1024)


def image_fwd_launch(B: int, H: int, W: int, F: int, f32: bool = False) -> dict:
    """The stem's conv1_1 forward (``csrc/stem.cu::conv_image_kernel``,
    ``OP_FWD_IMAGE``): a1 = relu(im2col(image) · W11ᵀ + b11) with the 27
    im2col columns (k = tap · 3 + c) padded to 64 and gathered by the
    producer warpgroup (no TMA box takes the image: no tensor map).  Tile
    128 pixels (an 8 × 16 patch) × 64 output channels; grid y the F / 64
    channel tiles, grid x blocks that walk the patches, two an SM: the GEMM
    is bound by writing a1.  With ``f32`` the columns are 32 float32
    (rounded to TF32 as they are gathered) and the product TF32."""
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    blocks = max(1, min(npatch, 2 * SMS // (F // 64)))
    return {"op": OP_FWD_IMAGE, "tile": (PATCH, 64), "grid": (blocks, F // 64, 1),
            "smem": image_fwd_smem(f32), "stages": IMAGE_FWD_STAGES, "nsplit": 1,
            "npatch": npatch, "maps": [], "f32": f32}


def wgrad_work(launches, F: int) -> int:
    """float32 words of the work area that the weight-gradient launches
    share in turn (one stream orders them): the largest one's split
    partials (nsplit, F, K) and bias partials (nsplit, F)."""
    return max(ln["nsplit"] * F * (ln["k"] + 1) for ln in launches)


def conv_tile_m(H: int, F: int, op: int = OP_FWD, f32: bool = False) -> int:
    """The conv tile's pixels for an output of F channels, H rows high: 256
    (16 × 16) where the N tile is at most 128 channels wide (a decoder's
    up1 and up2, VGG16 block 2's convs and dgrads) and H % 16 == 0, else
    128 (8 × 16).  The wider patch reads 52 rather than 43 FLOP a byte of
    L2 at 64 channels, 85 rather than 64 at 128; on an H100 it ran the
    decoder's conv1 and conv2 10-12% faster at both models' up1 and 19-22%
    at up2, and block 2's conv 1 (9 K slices) 14% faster than the
    persistent 128-pixel tile (PERF.md, Findings).  At 256 channels the
    128 × 256 tile already reads 85.  A float32 masked dgrad
    (``OP_DGRAD_MASK``) of a 128-wide tile takes 128 pixels: at 256 its
    eight 16-column chunks (:func:`conv_chunk`) each wait on their mask
    loads — on an H100 the 8 × 256² one read 0.66 ms, 0.51 with the loads
    taken out, no less with them two chunks ahead or prefetched into L2 —
    and at 128 its two 64-column chunks read 0.61-0.62 (PERF.md, Findings)."""
    if f32 and op == OP_DGRAD_MASK and conv_tile_n(F) == 128:
        return PATCH
    return 2 * PATCH if conv_tile_n(F) <= 128 and H % 16 == 0 else PATCH


def unetup_launches(B: int, H2: int, W2: int, Cs: int, Cx: int, F: int, f32: bool = False):
    """A UnetUp stage's forward: conv1 over the two maps [skip (Cs) | up
    (Cx)] into y1, conv2 over y1, both with bias + ReLU; at Cs = 0 (the
    ``up_conv`` head, #10 / #11) conv1 reads the one map up.  In bf16 both
    convs run on the conv core at the tile of :func:`conv_tile_m`; in
    float32 at the head and where F ≤ 256 (both models' up1-up3) on the
    halo mainloop (:func:`halo_conv_launch`: conv1 over the two maps; at F
    = 128 and 256 the 128-wide tile), else (up4) on the conv core.  The
    readings that fixed it (an H100, 700 W, in turns, ms, core → halo):
    per conv by the profiler, conv1 at vgg up1 2.31-2.36 → 1.61-1.67, up2
    2.43-2.53 → 1.29-1.38, rn50 up1 0.60-0.62 → 0.41-0.44, up2 0.82-0.87 →
    0.41-0.43; conv2 at up1 0.80-0.83 → 0.63-0.66 and 0.21 → 0.17-0.18, at
    up2 0.55 → 0.49-0.52 and 0.14 → 0.12-0.13 (the 64-wide tile lost there:
    0.58, 0.15); by stage at up3 2.02-2.03 → 1.83-1.85 (vgg) and 0.616-0.618
    → 0.580-0.585 (rn50), but at up4 1.17-1.23 → 1.27-1.31 and 0.76-0.77 →
    0.79-0.80 (PERF.md, Findings)."""
    if f32 and (not Cs or F <= 256):
        return [halo_conv_launch(OP_FWD, B, H2, W2, Cs or Cx, F, Cx if Cs else 0),
                halo_conv_launch(OP_FWD, B, H2, W2, F, F)]
    tm = conv_tile_m(H2, F)
    conv1 = conv_launch(OP_FWD, B, H2, W2, Cs, F, Cx, tm, f32=f32) if Cs else \
        conv_launch(OP_FWD, B, H2, W2, Cx, F, 0, tm, f32=f32)
    return [conv1, conv_launch(OP_FWD, B, H2, W2, F, F, 0, tm, f32=f32)]


def unetup_bwd_launches(B: int, H2: int, W2: int, Cs: int, Cx: int, F: int, f32: bool = False):
    """#13's two dgrads, each at the tile of :func:`conv_tile_m` for its
    output: conv2's over g2 (F → F), masked by y1 > 0 into dz1
    (``OP_DGRAD_MASK``); conv1's over dz1 (F → Cs + Cx), split at Cs into
    dskip and dups (``OP_DGRAD_SPLIT``)."""
    return [conv_launch(OP_DGRAD_MASK, B, H2, W2, F, F, 0,
                        conv_tile_m(H2, F, OP_DGRAD_MASK, f32), f32=f32),
            conv_launch(OP_DGRAD_SPLIT, B, H2, W2, F, Cs + Cx, 0, conv_tile_m(H2, Cs + Cx),
                        split=Cs, f32=f32)]


def block_fwd_launches(B: int, H: int, W: int, chans, pool: bool, f32: bool = False):
    """A VGG16 block's forward (two or three convs), each conv bias + ReLU:
    ``OP_FWD``, the last conv ``OP_FWD_POOL`` when ``pool``, each at the
    tile of :func:`conv_tile_m` for its output (256 pixels at block 2)."""
    n = len(chans) - 1
    return [conv_launch(OP_FWD_POOL if pool and i == n - 1 else OP_FWD, B, H, W, chans[i],
                        chans[i + 1], 0, conv_tile_m(H, chans[i + 1]), f32=f32)
            for i in range(n)]


def block_bwd_launches(B: int, H: int, W: int, chans, want_dx: bool, f32: bool = False):
    """A VGG16 block's backward (two or three convs): per conv i, its weight
    gradient at 2i and its dgrad at 2i + 1 — masked by the ReLU of its input
    for i > 0, for conv 0 the plain store to dx (``OP_DGRAD_SPLIT`` with
    every channel to dx), None without dx — the dgrads at the tile of
    :func:`conv_tile_m`."""
    launches = []
    for i in range(len(chans) - 1):
        cin, cout = chans[i], chans[i + 1]
        op = OP_DGRAD_MASK if i > 0 else OP_DGRAD_SPLIT
        dgrad = conv_launch(op, B, H, W, cout, cin, 0, conv_tile_m(H, cin, op, f32), f32=f32) \
            if i > 0 or want_dx else None
        launches += [wgrad_launch(B, H, W, cin, cout, f32=f32), dgrad]
    return launches


def stem_bwd_launches(B: int, H: int, W: int, F: int, f32: bool = False):
    """The stem's backward (#20) laid out as a block's
    (:func:`block_bwd_launches`: conv i's weight gradient at 2i, its dgrad
    at 2i + 1): conv1_1's weight gradient over the image
    (:func:`wgrad_image_launch`) and no dgrad (the stem computes no image
    gradient); conv1_2's weight gradient over a1 (F → F; at F = 64 the 64
    f × 128-column tile) and its dgrad masked by a1 > 0 at the tile of
    :func:`conv_tile_m` — in float32 on the halo mainloop
    (:func:`halo_conv_launch`), as the head's masked dgrad of the same
    shape and op runs."""
    wgrad, dgrad = block_bwd_launches(B, H, W, [F, F, F], False, f32)[2:]
    if f32:
        dgrad = halo_conv_launch(OP_DGRAD_MASK, B, H, W, F, F)
    return [wgrad_image_launch(B, H, W, F, f32), None, wgrad, dgrad]


def stem_fwd_launches(B: int, H: int, W: int, F: int, f32: bool = False):
    """The stem's forward (#2): conv1_1 over the image into a1
    (:func:`image_fwd_launch`), then conv1_2 over a1 with bias + ReLU and
    the 2 × 2 max-pool in its epilogue (``OP_FWD_POOL``) at the tile of
    :func:`conv_tile_m`, as block 2's second conv runs."""
    return [image_fwd_launch(B, H, W, F, f32),
            conv_launch(OP_FWD_POOL, B, H, W, F, F, 0, conv_tile_m(H, F), f32=f32)]


def upconv_bwd_launches(B: int, H2: int, W2: int, Cx: int, F: int, f32: bool = False):
    """The ``up_conv`` head's backward (#12), the stage backward at Cs = 0:
    conv2's dgrad masked by y1 > 0 into dz1 (:func:`unetup_bwd_launches`'s
    first); conv1's dgrad over dz1 (F → Cx) with every channel to dups
    (``OP_DGRAD_SPLIT`` at split = Cx, as a block's conv 0 writes dx: the
    core takes 0 < split ≤ F); the weight gradients dk2 / db2 over (g2, y1)
    and dk1 / db1 over (dz1, up) (:func:`wgrad_launch`); in bf16 or
    (``f32``) float32, where the two dgrads run on the halo mainloop
    (:func:`halo_conv_launch`)."""
    if f32:
        return [halo_conv_launch(OP_DGRAD_MASK, B, H2, W2, F, F),
                halo_conv_launch(OP_DGRAD_SPLIT, B, H2, W2, F, Cx, split=Cx),
                wgrad_launch(B, H2, W2, F, F, f32=True), wgrad_launch(B, H2, W2, Cx, F, f32=True)]
    return [unetup_bwd_launches(B, H2, W2, 0, Cx, F, f32)[0],
            conv_launch(OP_DGRAD_SPLIT, B, H2, W2, F, Cx, 0, conv_tile_m(H2, Cx), f32=f32),
            wgrad_launch(B, H2, W2, F, F, f32=f32), wgrad_launch(B, H2, W2, Cx, F, f32=f32)]


def unetup_wgrad_launches(B: int, H2: int, W2: int, Cs: int, Cx: int, F: int,
                          f32: bool = False):
    """A UnetUp stage's weight gradients: dk1's skip channels from (dz1,
    skip) with db1, dk1's up channels from (dz1, up), dk2 from (g2, y1)
    with db2; each reduce pass writes its channel range of its gradient."""
    return [wgrad_launch(B, H2, W2, Cs, F, Cs + Cx, 0, True, f32),
            wgrad_launch(B, H2, W2, Cx, F, Cs + Cx, Cs, False, f32),
            wgrad_launch(B, H2, W2, F, F, f32=f32)]


def encode(launches) -> torch.Tensor:
    """(n, PLAN_WORDS) int64 records on the CPU: op, tile_n, grid x / y / z,
    split count, tile_m, a weight gradient's output channels, first channel
    and bias flag (a split dgrad's split in the first; a conv's mainloop in
    the third), the element type (0 bf16, 1 float32), then per map (three)
    its rank, dims (4), byte strides (3) and box (4); unused words and
    absent maps 0."""
    out = torch.zeros((len(launches), PLAN_WORDS), dtype=torch.int64)
    for i, ln in enumerate(launches):
        if ln is None:
            continue
        words = [ln["op"], ln["tile"][1], *ln["grid"], ln["nsplit"], ln["tile"][0],
                 *ln.get("out", (0, 0, 0)), int(ln.get("f32", False))]
        if "mainloop" in ln:
            words[9] = ln["mainloop"]
        for m in ln["maps"]:
            rank = len(m["dims"])
            words += [rank, *m["dims"], *([0] * (4 - rank)), *m["strides"],
                      *([0] * (3 - len(m["strides"]))), *m["box"], *([0] * (4 - rank))]
        out[i, :len(words)] = torch.tensor(words, dtype=torch.int64)
    return out
