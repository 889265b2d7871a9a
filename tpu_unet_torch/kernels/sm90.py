"""Host plan of the Hopper conv core (``csrc/conv3x3_sm90.cuh``) and
weight-gradient GEMM (``csrc/wgrad_sm90.cuh``).

Everything such a kernel is told comes from here: its tile, its grid, its
split count and the TMA tensor maps (dims, byte strides, boxes) of its two
operands.  :func:`encode` lays launches out as the int64 records that
``csrc/sm90.cuh::Launch`` reads; the C side binds the tensors' addresses,
picks the instantiation of the record's tile width and encodes the maps.
The ring's stages and shared memory follow from the tile width: the C side
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
RING_BYTES = 192 * 1024            # the TMA ring of either kernel
SMS = 132                          # an H100 SXM's streaming multiprocessors
OP_FWD, OP_FWD_POOL, OP_DGRAD_MASK, OP_DGRAD, OP_WGRAD = range(5)
HEAD_WORDS, MAP_WORDS = 6, 12
PLAN_WORDS = HEAD_WORDS + 2 * MAP_WORDS


def conv_stages(tile_n: int) -> int:
    """Ring stages of the conv kernel: an input box and a weight box a
    stage, as many as 192 KB hold."""
    return RING_BYTES // (BOX_BYTES + tile_n * SLICE_C * 2)


def conv_smem(tile_n: int) -> int:
    """Dynamic shared memory of the conv kernel: the ring (the bf16
    epilogue tile is staged in it afterwards), the barriers and 1024 bytes
    to align the ring."""
    n = conv_stages(tile_n)
    return n * (BOX_BYTES + tile_n * SLICE_C * 2) + 2 * n * 8 + 1024


def wgrad_stages(tile_n: int) -> int:
    """Ring stages of the weight-gradient kernel: two gradient boxes and
    tile_n / 64 input boxes a stage, as many as 192 KB hold."""
    return RING_BYTES // ((2 + tile_n // 64) * BOX_BYTES)


def wgrad_smem(tile_n: int) -> int:
    """Dynamic shared memory of the weight-gradient kernel: the ring, the
    bias partials (8 floats a consumer thread), the barriers and the
    alignment."""
    n = wgrad_stages(tile_n)
    return n * (2 + tile_n // 64) * BOX_BYTES + CONSUMERS * 8 * 4 + 2 * n * 8 + 1024


def widest_tile(n: int) -> int:
    """The widest N tile (256, 128 or 64) that divides ``n``."""
    return next(t for t in (256, 128, 64) if n % t == 0)


def tensor_map(dims, box) -> dict:
    """A bf16 tensor map: ``dims`` and ``box`` innermost first, the byte
    strides of dims 1.. of the dense tensor."""
    strides, s = [], 2
    for d in dims[:-1]:
        s *= d
        strides.append(s)
    return {"dims": tuple(dims), "strides": tuple(strides), "box": tuple(box)}


def nhwc_map(B: int, H: int, W: int, C: int) -> dict:
    """(B, H, W, C) activations; the box is a tile's 8 x 16 pixels by 64
    channels."""
    return tensor_map((C, W, H, B), (SLICE_C, PATCH_W, PATCH_H, 1))


def weight_map(C: int, F: int, tile_n: int) -> dict:
    """Packed weights (F, 9C) seen as (F, 9, C); the box is one tap's 64
    channels of tile_n output channels."""
    return tensor_map((C, 9, F), (SLICE_C, 1, tile_n))


def conv_launch(op: int, B: int, H: int, W: int, C: int, F: int) -> dict:
    """One 3×3 SAME conv (B, H, W, C) → (B, H, W, F) on the conv core: the
    forward (``OP_FWD`` / ``OP_FWD_POOL``) or a dgrad (``OP_DGRAD_MASK``, or
    ``OP_DGRAD`` unmasked; C is then the output gradient's width and F the
    input's).  Tile: 128 pixels × the widest of 256 / 128 / 64 channels
    that divides F: the widest reads the fewest L2 bytes a FLOP, and at
    VGG16's block 5 (8 × 32², 512 channels) its 128 blocks make one wave
    on the 132 SMs, so a narrower tile or a persistent tile loop has no
    tail to fill there.  The grid is 1-D, the F / tile_n tiles of one
    patch adjacent."""
    tile_n = widest_tile(F)
    tiles_m = B * (H // PATCH_H) * (W // PATCH_W)
    return {"op": op, "tile": (PATCH, tile_n), "grid": ((F // tile_n) * tiles_m, 1, 1),
            "smem": conv_smem(tile_n), "stages": conv_stages(tile_n), "nsplit": 1,
            "k_slices": 9 * -(-C // SLICE_C),
            "maps": [nhwc_map(B, H, W, C), weight_map(C, F, tile_n)]}


def wgrad_splits(tiles: int, npatch: int) -> int:
    """The split count of a weight-gradient GEMM with ``tiles`` output tiles
    over ``npatch`` pixel patches: the smallest that fills the last wave of
    blocks on the SMs to 85% or gives at least 4 waves, each split keeping
    at least 8 patches (else the best fill found)."""
    best, best_fill = 1, 0.0
    for ns in range(1, max(1, npatch // 8) + 1):
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


def wgrad_launch(B: int, H: int, W: int, C: int, F: int) -> dict:
    """The weight gradient (F, 9C) of a conv with input (B, H, W, C) and
    output gradient (B, H, W, F): tiles of 128 f × 128 K-columns (64 where
    C % 128 != 0), split over the 8 × 16 pixel patches."""
    tile_n = min(128, widest_tile(C))
    npatch = B * (H // PATCH_H) * (W // PATCH_W)
    grid_xy = ((9 * C) // tile_n, -(-F // 128))
    ns = wgrad_splits(grid_xy[0] * grid_xy[1], npatch)
    return {"op": OP_WGRAD, "tile": (128, tile_n), "grid": (*grid_xy, ns),
            "smem": wgrad_smem(tile_n), "stages": wgrad_stages(tile_n), "nsplit": ns,
            "npatch": npatch,
            "maps": [nhwc_map(B, H, W, F), nhwc_map(B, H, W, C)]}


def encode(launches) -> torch.Tensor:
    """(n, PLAN_WORDS) int64 records on the CPU: op, tile_n, grid x / y / z,
    split count, then per map its rank, dims (4), byte strides (3) and box
    (4), unused words 0."""
    out = torch.zeros((len(launches), PLAN_WORDS), dtype=torch.int64)
    for i, ln in enumerate(launches):
        if ln is None:
            continue
        words = [ln["op"], ln["tile"][1], *ln["grid"], ln["nsplit"]]
        for m in ln["maps"]:
            rank = len(m["dims"])
            words += [rank, *m["dims"], *([0] * (4 - rank)), *m["strides"],
                      *([0] * (3 - len(m["strides"]))), *m["box"], *([0] * (4 - rank))]
        out[i] = torch.tensor(words, dtype=torch.int64)
    return out
