"""Host-side checks of the serving tail's kernel (``csrc/tail_sm90.cu``) on
the CPU, no JAX:

- its plan (``kernels/postprocess.py::tail_plan``) at F = 22, 32 and 64:
  the padded class count, the tiles and the persistent grid (every pixel
  in exactly one tile, a block's tiles a contiguous range), each bulk copy
  a multiple of 16 bytes from a 16-aligned address with the ragged last
  tile's rest under 16, and the histogram's flushes per image;
- a numpy emulation of the A fragments that the F = 22 and 32 consumers
  build from the staged rows: every (row, feature) read once, from word
  r·F/2 + k/2 of the stage, the K columns no feature fills zero, the
  ragged last tile's rest from device memory, and the bank pattern of each
  load;
- that emulation's logits in the kernel's k16 order within 1e-12 of the
  plain version in float64, and the argmax (a thread's columns in order,
  then the quad reduction) giving the first maximum, ties included.
"""
import numpy as np
import pytest
import torch

from tpu_unet_torch.kernels.postprocess import (TAIL_KN, TAIL_SMS, final_argmax_plain, tail_ctas,
                                                tail_k_order, tail_plan, tail_tile, tail_word)


@pytest.mark.parametrize("n_pix,c,per_img,np_,tiles,grid", [
    (8 * 512 * 512, 21, 512 * 512, 24, 16384, 132),   # unet_vgg serving
    (1 * 512 * 512, 21, 512 * 512, 24, 2048, 132),    # the single image
    (2 * 32 * 32, 4, 32 * 32, 8, 16, 16),
    (3 * 64 * 128, 32, 64 * 128, 32, 192, 132),
    (8 * 500 * 500, 21, None, 24, 15625, 132),         # mask only, 500² is no multiple of 256
    (3 * 20 * 30, 1, None, 8, 15, 15),                 # mask only, a ragged last tile
    (1, 9, None, 16, 1, 1),
])
def test_tail_plan(n_pix, c, per_img, np_, tiles, grid):
    """The F = 64 tail's plan (128-pixel tiles)."""
    p = tail_plan(n_pix, c, per_img, f=64)
    assert (p.np, p.tiles, p.grid) == (np_, tiles, grid)
    assert p.grid <= TAIL_SMS and p.tiles * p.tile >= n_pix > (p.tiles - 1) * p.tile
    owner = np.concatenate([np.full(tiles * (g + 1) // grid - tiles * g // grid, g)
                            for g in range(grid)])
    assert len(owner) == tiles and (np.diff(owner) >= 0).all()  # contiguous ranges, in order
    if per_img is None:
        assert p.flushes == ()
        return
    # a block flushes an image's counts once if any of its tiles lies there
    img = np.arange(tiles) * p.tile // per_img
    want = tuple(len(set(owner[img == i])) for i in range(n_pix // per_img))
    assert p.flushes == want and min(want) >= 1
    if (n_pix, per_img) == (8 * 512 * 512, 512 * 512):
        assert p.flushes == (17,) * 8


# (images, H, W, histogram): the DataB serving batch, the mask-only 200²
# batch, small and ragged counts
PLAN_SHAPES = [(32, 256, 256, True), (32, 200, 200, False), (3, 16, 16, True),
               (2, 25, 25, False), (1, 7, 13, False), (1, 1, 1, False), (5, 16, 32, True)]


@pytest.mark.parametrize("f", [22, 32, 64])
@pytest.mark.parametrize("c", [1, 4, 21, 32])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tail_plan_covers_and_copies(f, c, shape):
    n, h, w, hist = shape
    n_pix, per_img = n * h * w, h * w if hist else None
    p = tail_plan(n_pix, c, per_img, f=f)
    assert p.tile == tail_tile(f) == (128 if f == 64 else 256)
    assert p.np == -(-c // 8) * 8 and p.np in (8, 16, 24, 32)
    assert p.grid == min(p.tiles, tail_ctas(f)) and tail_ctas(f) == (132 if f == 64 else 264)
    # every pixel in exactly one tile, every tile in exactly one block
    cover = np.zeros(p.tiles * p.tile, np.int64)
    for g in range(p.grid):
        t0, t1 = p.tiles * g // p.grid, p.tiles * (g + 1) // p.grid
        assert t1 > t0
        cover[t0 * p.tile:t1 * p.tile] += 1
    assert (cover == 1).all() and (p.tiles - 1) * p.tile < n_pix <= p.tiles * p.tile
    # each copy: a multiple of 16 bytes from a 16-aligned offset (the
    # features are 16-aligned), the ragged rest read by the consumers
    assert p.copy == p.tile * f * 2 and p.copy % 16 == 0
    assert all(t * p.copy % 16 == 0 for t in range(p.tiles))
    assert p.last_copy % 16 == 0 and 0 < p.last_copy <= p.copy and 0 <= p.rest < 16
    last_bytes = (n_pix - (p.tiles - 1) * p.tile) * f * 2
    if f == 64:  # a TMA box, zero past n
        assert (p.last_copy, p.rest) == (p.copy, 0)
    else:
        assert p.last_copy + p.rest == last_bytes and p.rest % 4 == 0
        assert p.rest < f * 2  # the rest lies in the last row
    if not hist:
        assert p.flushes == ()
        return
    assert per_img % p.tile == 0  # a tile never spans two images
    img = np.arange(p.tiles) * p.tile // per_img
    owner = np.concatenate([np.full(p.tiles * (g + 1) // p.grid - p.tiles * g // p.grid, g)
                            for g in range(p.grid)])
    assert p.flushes == tuple(len(set(owner[img == i])) for i in range(n))


def _fragments(f, stage, g, rows, ragged):
    """Emulate ``load_a<F, RG>`` for the 256 rows of a tile: A[s, r, k]
    (step s, row r, K column k of the step) as the word indices the four
    warpgroups' threads load (-1: a zero), and the (row, word) reads of the
    stage and of device memory.  ``stage`` / ``g`` hold each word's index,
    so the fragment names the word it holds."""
    fw = f // 2
    limw = (rows * f * 2 & ~15) // 4
    a = np.full((2, 256, 16), -2, np.int64)
    reads = []
    for wg in range(4):
        for warp in range(4):
            for lane in range(32):
                q, r0 = lane % 4, wg * 64 + warp * 16 + lane // 4
                for s in range(2):
                    for i in range(4):  # registers: (r0 | r0 + 8) x (cols 2q | 8 + 2q)
                        r, h = r0 + 8 * (i % 2), i // 2
                        word = tail_word(f, q, 2 * s + h)
                        if word < 0 or (ragged and r >= rows):
                            v = -1
                        else:
                            idx = r * fw + word
                            src = "stage" if not ragged or idx < limw else "global"
                            v = (stage if src == "stage" else g)[idx]
                            reads.append((src, r, word))
                        for e in range(2):
                            a[s, r, 8 * h + 2 * q + e] = -1 if v < 0 else 2 * v + e
    return a, reads


@pytest.mark.parametrize("f", [22, 32])
@pytest.mark.parametrize("rows", [256, 1, 3, 5, 7, 100, 255])
def test_fragment_map(f, rows):
    """Every (row, feature k < F) of the tile's valid rows is read once,
    from word r·F/2 + k/2 (the stage, or device memory past the copy in a
    ragged tile), and lands in the K column that ``tail_k_order`` names;
    the other columns and rows are zero."""
    fw = f // 2
    ragged = rows < 256
    words = np.arange(256 * fw)  # word i holds the index i: features 2i, 2i + 1
    a, reads = _fragments(f, words, words, rows, ragged)
    assert (a != -2).all()
    order = np.array(tail_k_order(f))
    assert order.shape == (TAIL_KN,)
    feats = sorted(order[order >= 0])
    assert feats == list(range(f))  # each feature in one column
    valid = rows if ragged else 256
    for r in range(256):
        for k in range(TAIL_KN):
            got = a[k // 16, r, k % 16]
            if r >= valid or order[k] < 0:
                assert got == -1
            else:  # the element r·F + feature: word r·F/2 + feature / 2
                assert got == r * f + order[k]
    assert sorted((r, w) for _, r, w in reads) == [(r, w) for r in range(valid)
                                                    for w in range(fw)]
    limw = (rows * f * 2 & ~15) // 4
    assert all((src == "global") == (r * fw + w >= limw) for src, r, w in reads if ragged)
    if ragged:  # device memory only for the last row's words past the copy
        assert {r for src, r, _ in reads if src == "global"} <= {rows - 1}


@pytest.mark.parametrize("f", [22, 32])
def test_stage_loads_bank_pattern(f):
    """The shared-memory loads of one warp and one A slot of a full tile:
    at F = 22 (rows of 11 words) each lane loads a word and at most two
    lanes share a bank; at F = 32 each lane loads its row's 16-byte run
    4q .. 4q + 3 and each quarter warp reads 128 contiguous bytes."""
    fw = f // 2
    for m in range(4 if f == 32 else 3):
        idx = [(lane // 4) * fw + tail_word(f, lane % 4, m) for lane in range(32)
               if tail_word(f, lane % 4, m) >= 0]
        if f == 22:
            assert np.bincount(np.array(idx) % 32).max() <= 2
    if f == 32:
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            start = {(lane // 4) * 64 + 16 * (lane % 4) for lane in lanes}
            assert sorted(start) == list(range(min(start), min(start) + 128, 16))
            assert all(tail_word(f, q, m) == 4 * q + m for q in range(4) for m in range(4))


def _kernel_masks(feats, w, b, f, c):
    """The kernel's logits and argmax, emulated in float64: A and W in the
    K order of ``tail_k_order``, each k16 step's products summed, the two
    steps added, the bias added; then each thread's columns 8j + 2q + e in
    order (strict >), and the quad's four candidates reduced as
    ``quad_best`` does (xor 1, then xor 2: the larger value, or the lower
    class of equal values)."""
    order = np.array(tail_k_order(f))
    np_ = -(-c // 8) * 8
    A = np.where(order >= 0, feats[:, np.maximum(order, 0)], 0.0)          # (n, 32)
    W = np.zeros((np_, TAIL_KN))
    W[:c] = np.where(order >= 0, w[:, np.maximum(order, 0)], 0.0)
    x = sum(A[:, 16 * s:16 * s + 16] @ W[:, 16 * s:16 * s + 16].T for s in range(2))
    bias = np.full(np_, -np.inf)
    bias[:c] = b
    logits = x + bias
    v = np.full((len(feats), 4), -np.inf)
    cls = np.zeros((len(feats), 4), np.int64)
    for q in range(4):
        for j in range(np_ // 8):
            for e in range(2):
                col = 8 * j + 2 * q + e
                better = logits[:, col] > v[:, q]
                v[:, q] = np.where(better, logits[:, col], v[:, q])
                cls[:, q] = np.where(better, col, cls[:, q])
    for o in (1, 2):
        ov, oc = v[:, [q ^ o for q in range(4)]], cls[:, [q ^ o for q in range(4)]]
        take = (ov > v) | ((ov == v) & (oc < cls))
        v, cls = np.where(take, ov, v), np.where(take, oc, cls)
    assert (cls == cls[:, :1]).all()  # the four lanes agree
    return logits[:, :c], cls[:, 0]


@pytest.mark.parametrize("f", [22, 32])
@pytest.mark.parametrize("c", [1, 4, 21, 32])
def test_emulated_logits_and_argmax(f, c):
    """The emulated logits lie within 1e-12 of the plain float64 product;
    the argmax equals the plain version's first maximum, with classes that
    tie exactly (equal weights and bias) going to the lower class."""
    rng = np.random.default_rng(100 * f + c)
    n = 512
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()  # noqa: E731
    feats = bf(np.maximum(rng.standard_normal((n, f)), 0))
    w = bf(rng.standard_normal((c, f)) / np.sqrt(f))
    b = bf(0.1 * rng.standard_normal(c))
    if c >= 4:  # exact ties: classes 1 / 3 share weights and bias, class 1 favoured
        w[3], b[1] = w[1], b[1] + 2.0
        b[3] = b[1]
    logits, cls = _kernel_masks(feats, w, b, f, c)
    plain = feats @ w.T + b
    assert np.abs(logits - plain).max() <= 1e-12 * max(np.abs(plain).max(), 1.0)
    np.testing.assert_array_equal(cls, plain.argmax(-1))
    if c >= 4:
        assert (cls == 1).any() and not (cls == 3).any()
    # the plain wrapper (float32) agrees away from near-ties
    ref = final_argmax_plain(torch.from_numpy(feats).float().reshape(1, 1, n, f),
                             torch.from_numpy(w).float().reshape(c, f, 1, 1),
                             torch.from_numpy(b).float(), c).reshape(-1).numpy()
    top2 = np.sort(plain, -1)[:, -2:] if c > 1 else np.zeros((n, 2))
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    np.testing.assert_array_equal(ref[clear], cls[clear])


def test_all_tied_pixels_take_class_0():
    """Zero weights and one bias for every class: every logit ties, and the
    quad reduction gives class 0 at every pixel, at every padded width."""
    for f in (22, 32):
        for c in (1, 4, 21, 32):
            feats = np.ones((64, f))
            _, cls = _kernel_masks(feats, np.zeros((c, f)), np.full(c, 0.5), f, c)
            assert (cls == 0).all()
