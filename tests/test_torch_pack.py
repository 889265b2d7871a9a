"""The pack kernel (``csrc/pack_weights.cu``) on the CPU: its tile walk
emulated in numpy from the host's plan (``sm90.pack_tiles``), every output
element written once and equal bit for bit to the plain pack
(``_build.pack_conv3x3``) in the forward and the dgrad layouts, with and
without ``k_pad``, bf16 weights into bf16 and float32 weights into float32
(TF32); and the plain pack's two layouts against the JAX package's
(``encoder._pack_im2col``, ``decoder_train._flip_t``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.decoder_train import _flip_t
from tpu_unet.kernels.encoder import _pack_im2col
from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import flip_t

T = sm90.PACK_TILE
TROW, SROW = 9 * T, 9 * T + 1  # csrc/pack_weights.cu: a tile's f row, its staged stride


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 → TF32 by round_tf32's integer rule, as the kernel stores it."""
    return ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bf16 bits, to nearest even (``__float2bfloat16_rn``; no NaN here)."""
    u = x.view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)


def _emulate(ws, flip, kps, out_f32):
    """The kernel's walk over weights ``ws`` (float32 OIHW arrays) in one
    launch: (outputs as float32 or bf16 bits, how often each element was
    written)."""
    ends, n = [], 0
    for w in ws:
        n += len(sm90.pack_tiles(*w.shape[:2]))
        ends.append(n)
    outs, writes = [], []
    for w, kp in zip(ws, kps):
        F, C = w.shape[:2]
        rows, taps = (C, 9 * F) if flip else (F, 9 * C)
        cols = max(taps, kp or 0)
        outs.append(np.full((rows * cols,), np.nan, np.float32))
        writes.append(np.zeros(rows * cols, np.int64))
    dims = [(*w.shape[:2], o.size // (w.shape[1] if flip else w.shape[0]))
            for w, o in zip(ws, outs)]
    V = sm90.pack_vector(dims, flip, out_f32)
    run = T // V
    e = np.arange(T * TROW)  # the read walk: row r, value k of its 9 nc
    rr, k = e // TROW, e % TROW
    e = np.arange(T * 9 * run)  # the write walk: V values a thread
    r, rem = e // (9 * run), e % (9 * run)
    tap = rem // run
    j = (rem % run)[:, None] * V + np.arange(V)[None, :]  # (threads, V)
    r, tap = r[:, None], tap[:, None]
    for block in range(ends[-1]):
        i = next(k for k in range(len(ws)) if block < ends[k])
        t = block - (ends[i - 1] if i else 0)
        w, out, cnt = ws[i].reshape(-1), outs[i], writes[i]
        F, C = ws[i].shape[:2]
        kp = outs[i].size // (C if flip else F)
        f0, c0 = sm90.pack_tiles(F, C)[t]
        nf, nc = min(T, F - f0), min(T, C - c0)
        s = np.full(T * SROW, np.nan, np.float32)
        ok = (rr < nf) & (k < 9 * nc)
        s[rr[ok] * SROW + k[ok]] = w[((f0 + rr[ok]) * C + c0) * 9 + k[ok]]
        # a thread writes its V values or none: its first value decides, and
        # a ragged run ends at a multiple of V
        rows, run_len = (nc, nf) if flip else (nf, nc)
        assert ((j < run_len) == (j[:, :1] < run_len)).all()
        ok = np.broadcast_to((r < rows) & (j[:, :1] < run_len), j.shape)
        if not flip:
            dst = (f0 + r) * kp + tap * C + c0 + j
            src = r * SROW + j * 9 + tap
        else:
            dst = (c0 + r) * kp + tap * F + f0 + j
            src = j * SROW + r * 9 + 8 - tap
        dst, val = dst[ok], s[src[ok]]
        if V > 1:  # 16-byte stores: aligned in the output's bytes
            assert (dst.reshape(-1, V)[:, 0] % V == 0).all()
        out[dst] = val
        np.add.at(cnt, dst, 1)
        rows, taps = (nc, 9 * F) if flip else (nf, 9 * C)
        if (f0 if flip else c0) == 0 and kp > taps:
            pad = kp - taps
            q = np.arange(rows * pad)
            dst = ((c0 if flip else f0) + q // pad) * kp + taps + q % pad
            out[dst] = 0.0
            np.add.at(cnt, dst, 1)
    shaped = []
    for out, w in zip(outs, ws):
        rows = w.shape[1] if flip else w.shape[0]
        out = out.reshape(rows, -1)
        shaped.append(_tf32(out) if out_f32 else _bf16_bits(out))
    return shaped, writes


# (F, C) of the weights of one launch: C and F no multiple of the tile,
# a tile's worth, the stem's conv1_1 (C = 3) and a decoder stage's conv1
CASES = [
    ([(40, 70)], False, [None]),
    ([(40, 70)], True, [None]),
    ([(64, 3), (64, 64)], False, [64, None]),       # the stem, bf16's pad
    ([(64, 3), (64, 64)], False, [32, None]),       # float32's
    ([(33, 65), (96, 33), (32, 32)], True, [None, None, None]),
    ([(33, 65)], True, [9 * 33 + 7]),               # a pad past the dgrad's taps
    ([(64, 192), (64, 64)], True, [None, None]),
    ([(65, 31)], False, [9 * 31 + 40]),
    ([(48, 40), (40, 48)], False, [None, None]),    # 16-byte stores, ragged tiles
    ([(48, 40), (40, 48)], True, [None, None]),
    ([(72, 96)], True, [9 * 72 + 8]),               # 16-byte stores and a pad
]


@pytest.mark.parametrize("shapes,flip,kps", CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_pack_walk_matches_plain_pack(shapes, flip, kps, dt):
    """Every element of every output written once, and the emulated walk
    over weights of ``dt`` bit-equal to the plain pack into ``dt`` (bf16,
    or float32 rounded to TF32): the kernel packs a weight into its own
    type."""
    rng = np.random.default_rng(sum(31 * f + c for f, c in shapes) + int(flip))
    ws = [torch.from_numpy(rng.standard_normal((f, c, 3, 3)).astype(np.float32)).to(dt)
          for f, c in shapes]
    outs, writes = _emulate([w.float().numpy() for w in ws], flip, kps, dt == torch.float32)
    plain = _build.pack_weights(ws, dt, flip, kps)
    for o, cnt, p, w, kp in zip(outs, writes, plain, ws, kps):
        assert (cnt == 1).all()
        assert torch.equal(p, _build.pack_conv3x3(w, kp, dt, flip))
        bits = p.view(torch.int16 if dt == torch.bfloat16 else torch.int32).numpy()
        assert np.array_equal(o.view(bits.dtype), bits)


def test_pack_tiles_cover_the_weight_once():
    """``sm90.pack_tiles`` numbers the tiles as the kernel decodes them: the
    c tiles of one f tile adjacent, every (f, c) of the weight in one."""
    for F, C in ((40, 70), (64, 3), (512, 3072), (33, 1)):
        hit = np.zeros((F, C), np.int64)
        tiles = sm90.pack_tiles(F, C)
        tc = -(-C // T)
        for t, (f0, c0) in enumerate(tiles):
            assert (f0, c0) == ((t // tc) * T, (t % tc) * T)
            hit[f0:f0 + T, c0:c0 + T] += 1
        assert (hit == 1).all() and len(tiles) == -(-F // T) * tc


@pytest.mark.parametrize("F,C", [(64, 128), (40, 128), (128, 256)])
def test_plain_pack_layouts_match_jax(F, C):
    """The plain pack's forward layout is ``_pack_im2col``'s (3, 3C, F) per
    ky without its zero fill, transposed; its dgrad layout is that of
    ``_flip_t``'s HWIO kernel (the tap reversed, Ci and Co swapped); both
    TF32-rounded in float32."""
    rng = np.random.default_rng(F + C)
    k = rng.standard_normal((3, 3, C, F)).astype(np.float32)  # HWIO, JAX's
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())       # OIHW
    fwd = np.asarray(_pack_im2col(jnp.asarray(k)))[:, :3 * C].reshape(9 * C, F).T
    dgr = np.asarray(_flip_t(jnp.asarray(k))).transpose(3, 0, 1, 2).reshape(C, 9 * F)
    assert torch.equal(_build.pack_conv3x3(w, dtype=torch.float32),
                       _build.round_tf32(torch.from_numpy(np.ascontiguousarray(fwd))))
    assert torch.equal(_build.pack_conv3x3(w, dtype=torch.float32, flip=True),
                       _build.round_tf32(torch.from_numpy(np.ascontiguousarray(dgr))))
    assert torch.equal(_build.pack_conv3x3(w, flip=True),
                       _build.pack_conv3x3(flip_t(w)))


def test_pack_weights_takes_the_plain_body_on_the_cpu_only():
    """CPU weights go through the plain body, any number of them; a weight
    on another device type is refused."""
    w = torch.zeros(64, 64, 3, 3)
    assert len(_build.pack_weights([w] * 4)) == 4
    with pytest.raises(ValueError):
        _build.pack_weights([w.to("meta")])
