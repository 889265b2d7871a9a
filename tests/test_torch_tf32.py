"""The float32 path on the CPU, before any card run: (a) the float32 launch
plans of the conv core, the weight-gradient GEMM and the image GEMMs at
every shape of unet_vgg's 512², batch 8 training step, of unet_resnet50's
four decoder stages and of both up_conv heads (unet_resnet50's and
self_net's) at their full shapes; (b) a float64 emulation of each float32
kernel with its TF32 operand rules, in its plan's K and split order
(``tests/_torch_tf32.py``), against the plain float32 versions and the JAX
package's float32 references (``reference_unetup``, ``reference_upconv``
and #10 / #12 in interpret mode, ``reference_vgg_block``,
``reference_vgg_stem``, ``encoder3_train._ref_diff``, their VJPs).  Each
emulation's distance from the plain version, times ``MARGIN``, must lie
within the bound the card is held to (``tpu_unet_torch/kernels/tf32.py``):
these readings fix the bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

import _torch_tf32 as emu
from tpu_unet.kernels.decoder_fuse import reference_unetup
from tpu_unet.kernels.encoder import reference_vgg_block
from tpu_unet.kernels.encoder3_train import _ref_diff
from tpu_unet.kernels.stem import reference_vgg_stem
from tpu_unet.kernels.upconv import reference_upconv
from tpu_unet_torch.kernels import sm90, tf32
from tpu_unet_torch.kernels._build import pack_conv3x3, round_tf32
from tpu_unet_torch.kernels.decoder_fuse import _unetup_plain_y1
from tpu_unet_torch.kernels.decoder_train import adjoint_plan, unetup_bwd_full_plain
from tpu_unet_torch.kernels.encoder import vgg_block_plain
from tpu_unet_torch.kernels.encoder_train import vgg_block_bwd_plain, vgg_stem_bwd_plain
from tpu_unet_torch.kernels.stem import vgg_stem_plain
from tpu_unet_torch.kernels.upconv import _upconv_plain_y1, upconv_bwd_plain

SMEM_LIMIT = 232448   # an H100 block's dynamic shared memory (227 KB)
SM_SMEM = 233472      # an H100 SM's shared memory (228 KB), two blocks' worth
# the margin between an emulation's reading and the card's bound
MARGIN = 4

# unet_vgg's float32 training step at 512², batch 8: the stem and blocks
# 2-5 (H, widths, pool) and the decoder stages (x's H, Cs, Cx, F)
B = 8
ENCODER = [(512, [3, 64, 64], True), (256, [64, 128, 128], True),
           (128, [128, 256, 256, 256], True), (64, [256, 512, 512, 512], True),
           (32, [512, 512, 512, 512], False)]
DECODER = [(256, 64, 128, 64), (128, 128, 256, 128), (64, 256, 512, 256),
           (32, 512, 512, 512)]
# unet_resnet50's decoder stages at 512², batch 8 (its stride-2 pyramid:
# Cs + Cx up to 3072), and the up_conv heads (x's H, Cx, F): unet_resnet50's
# after its up1, self_net's after unet_vgg's
RN50_DECODER = [(128, 64, 128, 64), (64, 256, 256, 128), (32, 512, 512, 256),
                (16, 1024, 2048, 512)]
HEADS = [(256, 64, 64), (512, 64, 64)]


def _launches():
    """Every float32 launch of the step: (what, launch, C (the conv's input
    or the GEMM's input width), F)."""
    out = []
    for H, chans, pool in ENCODER:
        if chans[0] == 3:
            img, conv = sm90.stem_fwd_launches(B, H, H, 64, True)
            out += [("image_fwd", img, 3, 64), ("fwd", conv, 64, 64)]
            bwd = sm90.stem_bwd_launches(B, H, H, 64, True)
            out += [("image_wgrad", bwd[0], 3, 64), ("wgrad", bwd[2], 64, 64),
                    ("dgrad", bwd[3], 64, 64)]
            continue
        for ln, c, f in zip(sm90.block_fwd_launches(B, H, H, chans, pool, True), chans[:-1],
                            chans[1:]):
            out.append(("fwd", ln, c, f))
        bwd = sm90.block_bwd_launches(B, H, H, chans, True, True)
        for i, (c, f) in enumerate(zip(chans[:-1], chans[1:])):
            out += [("wgrad", bwd[2 * i], c, f), ("dgrad", bwd[2 * i + 1], f, c)]
    for h, cs, cx, f in DECODER + RN50_DECODER:
        h2 = 2 * h
        c1, c2 = sm90.unetup_launches(B, h2, h2, cs, cx, f, True)
        d2, d1 = sm90.unetup_bwd_launches(B, h2, h2, cs, cx, f, True)
        w = sm90.unetup_wgrad_launches(B, h2, h2, cs, cx, f, True)
        out += [("fwd", c1, cs + cx, f), ("fwd", c2, f, f), ("dgrad", d2, f, f),
                ("dgrad", d1, f, cs + cx), ("wgrad", w[0], cs, f), ("wgrad", w[1], cx, f),
                ("wgrad", w[2], f, f)]
    for h, cx, f in HEADS:
        h2 = 2 * h
        c1, c2 = sm90.unetup_launches(B, h2, h2, 0, cx, f, True)
        d2, d1, w2, w1 = sm90.upconv_bwd_launches(B, h2, h2, cx, f, True)
        out += [("fwd", c1, cx, f), ("fwd", c2, f, f), ("dgrad", d2, f, f),
                ("dgrad", d1, f, cx), ("wgrad", w2, f, f), ("wgrad", w1, cx, f)]
    return out


@pytest.mark.parametrize("what", ["fwd", "dgrad", "wgrad", "image_fwd", "image_wgrad"])
def test_f32_plans_fit_the_card(what):
    """(a) Every float32 launch of unet_vgg's step, of unet_resnet50's
    decoder and of both heads: 4-byte tensor-map strides of
    the dense tensors (multiples of 16), boxes of 32 channels (128 bytes,
    the swizzle span), the record's element-type word 1; the conv core's K
    slices of 32 channels, its stage bytes and ring within 227 KB, its
    epilogue's float32 buffer (a chunk of columns, ``sm90.conv_chunk``)
    beside a ring of 4-8 stages: every tile persistent; the
    weight-gradient GEMM's float32 plan (TF32 wgmma):
    tiles of 64 f × 576 columns (a 64-channel slice's nine taps), six
    stages of 34 KB (two G boxes of 2 × 16 pixels, two halo boxes of 4 ×
    18, the restaged G) within 227 KB, its splits covering every patch
    once in order, each under the 1280-patch cap, its grid filling the
    last wave of the 132 SMs to 85% or running 4 waves; the image GEMMs
    two blocks an SM."""
    cases = [c for c in _launches() if c[0] == what]
    assert cases
    for _, ln, c, f in cases:
        rec = sm90.encode([ln])[0]
        assert rec[10] == 1 and ln["f32"]
        assert ln["smem"] <= SMEM_LIMIT
        for m in ln["maps"]:
            assert m["box"][0] == 32 and m["box"][0] * 4 == 128
            dense = [4 * m["dims"][0]]
            for d in m["dims"][1:-1]:
                dense.append(dense[-1] * d)
            assert list(m["strides"]) == dense and all(s % 16 == 0 for s in dense)
        tm, tn = ln["tile"]
        if what in ("fwd", "dgrad"):
            C = ln["maps"][0]["dims"][0] + (ln["maps"][2]["dims"][0] if len(ln["maps"]) > 2 else 0)
            assert ln["k_slices"] == 9 * sum(-(-m["dims"][0] // 32)
                                             for m in [ln["maps"][0], *ln["maps"][2:]])
            assert C == c
            stage = (tm + tn) * 128
            out = tm * (sm90.conv_chunk(tn, tm, True) + 4) * 4
            # every float32 tile persistent, its epilogue buffer a chunk
            # of columns beside a ring of 4-8 stages
            assert sm90.conv_own_staging(tn, tm, True)
            assert 4 <= ln["stages"] <= 8
            assert ln["smem"] == ln["stages"] * stage + out + 16 * ln["stages"] + 1024
            # a 128 x 192 or 256 x 64 tile is persistent in both types,
            # float32 through chunks narrower than the tile
            if (tm, tn) in ((128, 192), (256, 64)):
                assert sm90.conv_own_staging(tn, tm) and sm90.conv_own_staging(tn, tm, True)
                assert sm90.conv_chunk(tn, tm, True) < tn == sm90.conv_chunk(tn, tm)
        elif what == "wgrad":
            assert (tm, tn) == (64, 9 * 64) and ln["stages"] == 6
            assert ln["k"] == 9 * sm90.tap_width(c) == ln["grid"][0] * tn
            assert ln["grid"][1] * tm == f
            stage = sm90.wgrad_stage_bytes(tm, tn, True)
            assert stage == 2 * (2 * 16 * 128) + 2 * (4 * 18 * 128) + 64 * 128 == 34 * 1024
            assert ln["smem"] == 6 * stage + 128 * 4 * 4 + 3 * 6 * 8 + 1024
            assert [m["box"] for m in ln["maps"]] == [(32, 16, 2, 1), (32, 18, 4, 1)]
            assert ln["maps"][0]["dims"] == (f, *ln["maps"][1]["dims"][1:])
            waves = ln["grid"][0] * ln["grid"][1] * ln["nsplit"] / sm90.SMS
            assert waves / -(-waves // 1) >= 0.85 or waves >= 4, (c, f, waves)
        elif what == "image_wgrad":
            assert (tm, tn) == (64, 32) and ln["k"] == 32 and ln["stages"] == 2
            assert 2 * (ln["smem"] + 1024) <= SM_SMEM
        else:
            assert (tm, tn) == (128, 64) and ln["maps"] == []
            assert 2 * (ln["smem"] + 1024) <= SM_SMEM
        if what in ("wgrad", "image_wgrad"):
            ranges = sm90.split_ranges(ln["npatch"], ln["nsplit"])
            assert ranges[0][0] == 0 and ranges[-1][1] == ln["npatch"]
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(8 <= hi - lo <= sm90.MAX_SPLIT_PATCHES for lo, hi in ranges)


# every conv tile the plans make (pixels, channels): conv_tile_m's 256
# pixels only at N tiles of 128 or fewer
CONV_TILES = [(128, 256), (128, 192), (128, 128), (128, 64), (256, 128), (256, 64)]


@pytest.mark.parametrize("tm,tn", CONV_TILES)
def test_f32_epilogue_chunks_cover_the_tile(tm, tn):
    """The conv core's float32 epilogue (``csrc/conv3x3_sm90.cuh``), emulated
    thread by thread from the plan: the chunk is the widest of 64, 32 or 16
    columns whose buffer leaves the ring 4 stages (``sm90.conv_chunk``), the
    tile is persistent with 4-8 stages within 227 KB; the chunks' staging
    writes put each accumulator where the whole tile's staging put it
    (column c0 + 8 q + 2 (lane % 4) + {0, 1} of its fragment's column group
    c0 / 8 + q), every (pixel, column) of the tile once, inside the buffer;
    the store loop and the pool take each 16-byte piece of a chunk once."""
    cw = sm90.conv_chunk(tn, tm, True)
    fits = {w: sm90.conv_ring_fit(tn, tm, w, True) for w in sm90.CONV_F32_CHUNKS if w <= tn}
    assert fits[cw] >= 4 and all(fits[w] < 4 for w in fits if w > cw)
    assert tn % cw == 0 and sm90.conv_own_staging(tn, tm, True)
    assert sm90.conv_stages(tn, tm, True) == min(8, fits[cw]) >= 4
    assert sm90.conv_smem(tn, tm, True) <= SMEM_LIMIT
    assert sm90.conv_out_bytes(tn, tm, True) == tm * (cw + 4) * 4
    ldc, mt, ch = cw + 4, tm // 128, cw // 4
    per = tm * ch // 256
    assert tm * ch % 256 == 0 and per <= 16
    staged = np.zeros((tm, tn), np.int64)
    stored = np.zeros((tm, tn), np.int64)
    pooled = np.zeros((tm // 4, tn), np.int64)
    for k in range(tn // cw):
        c0 = k * cw
        buf = np.zeros(tm * ldc, np.int64)
        for tid in range(256):
            wg, lane = tid >> 7, tid & 31
            for i in range(mt):
                r = (wg * mt + i) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2)
                for q in range(cw // 8):
                    c, a = 8 * q + 2 * (lane & 3), 4 * (c0 // 8 + q)
                    # accumulator a's column in the whole tile's fragment
                    assert c0 + c == 8 * (a // 4) + 2 * (lane & 3)
                    for rr in (r, r + 8):
                        assert rr * ldc + c + 1 < tm * ldc
                        buf[rr * ldc + c:rr * ldc + c + 2] += 1
                        staged[rr, c0 + c:c0 + c + 2] += 1
        for tid in range(256):  # after the consumers' barrier
            for j in range(per):
                v = tid + j * 256
                px, sub = v // ch, v % ch
                assert (buf[px * ldc + 4 * sub:px * ldc + 4 * sub + 4] == 1).all()
                stored[px, c0 + 4 * sub:c0 + 4 * sub + 4] += 1
        for v in range(tm // 4 * ch):
            p2, sub = v // ch, v % ch
            py, px = p2 >> 3, p2 & 7
            base = ((2 * py) * 16 + 2 * px) * ldc + 4 * sub
            for off in (0, ldc, 16 * ldc, 16 * ldc + ldc):
                assert (buf[base + off:base + off + 4] == 1).all()
            pooled[p2, c0 + 4 * sub:c0 + 4 * sub + 4] += 1
    assert (staged == 1).all() and (stored == 1).all() and (pooled == 1).all()


def test_bf16_conv_plans_unchanged():
    """The bf16 plans keep the whole tile as their one chunk, and their
    persistence, stages and shared memory as before the float32 chunks."""
    want = {(128, 256): (False, 4, 197696), (128, 192): (True, 4, 216128),
            (128, 128): (True, 5, 199760), (128, 64): (True, 8, 216192),
            (256, 128): (False, 4, 197696), (256, 64): (True, 4, 201792)}
    for (tm, tn), (own, stages, smem) in want.items():
        assert sm90.conv_chunk(tn, tm) == tn
        assert (sm90.conv_own_staging(tn, tm), sm90.conv_stages(tn, tm),
                sm90.conv_smem(tn, tm)) == (own, stages, smem)


def test_f32_masked_dgrad_of_a_128_wide_tile_takes_128_pixels():
    """``sm90.conv_tile_m``'s float32 rule: every float32 masked dgrad of
    the step whose N tile is 128 wide (unet_vgg's up2 and block 2,
    unet_resnet50's up2) runs 128 × 128 tiles, two 64-column chunks beside
    5 stages, persistent; every other float32 launch, and every bf16
    launch, keeps the tile of the rule without it."""
    n = 0
    for _, ln, c, f in _launches():
        if ln["op"] not in (sm90.OP_FWD, sm90.OP_FWD_POOL, sm90.OP_DGRAD_MASK,
                            sm90.OP_DGRAD_SPLIT):
            continue
        tm, tn = ln["tile"]
        H = ln["maps"][0]["dims"][2]
        rule = 2 * sm90.PATCH if tn <= 128 and H % 16 == 0 else sm90.PATCH
        if ln["op"] == sm90.OP_DGRAD_MASK and tn == 128:
            n += 1
            assert (tm, sm90.conv_chunk(tn, tm, True), ln["stages"]) == (128, 64, 5)
            assert sm90.conv_own_staging(tn, tm, True) and rule == 256
            assert sm90.conv_tile_m(H, f, sm90.OP_DGRAD_MASK) == 256  # bf16's
        else:
            assert tm == rule
    assert n == 3


def _swizzled(rows):
    """A TMA box's image in shared memory under the 128-byte swizzle, as
    float32 words: row r's 16-byte unit u at unit u ^ (r % 8)."""
    out = np.zeros_like(rows)
    for r in range(rows.shape[0]):
        for u in range(8):
            p = u ^ (r & 7)
            out[r, 4 * p:4 * p + 4] = rows[r, 4 * u:4 * u + 4]
    return out


@pytest.mark.parametrize("fo", [64, 128])
def test_f32_wgrad_fragments_and_restaged_layout(fo):
    """The float32 GEMM's shared-memory images and register fragments,
    modelled thread by thread as ``csrc/wgrad_sm90.cuh::wgrad_tf32_kernel``
    forms them, at B = 1, 8 × 32 pixels, C = 96 (two 64-channel slices, the
    second past C), F = 64 or 128 (one or two 64-f tiles): per stage (a 2 ×
    16 sub-patch) the TMA images of the G boxes and the halo boxes
    (128-byte swizzle, zeros outside the image and past C); the restager's
    4 × 4 blocks write every (f, pixel) of the K-major canonical layout
    (row f, unit (k / 4) ^ (f % 8)) once, rounded to TF32, each
    quarter-warp's 16-byte loads and stores on 8 distinct units, and its
    threads round every 16 bytes of the halo boxes once in place, a
    quarter-warp on one 128-byte row; each consumer's (thread, register)
    of the m64nNk8 A fragment holds the rounded im2col element of its row's
    channel (``sm90.wgrad_f32_row_channel``) and k8 pixel at its block's
    tap, each half-warp's 8-byte loads on 16 distinct places; the products
    of these fragments and the restaged G, summed over every stage and
    scattered to (f, tap · Cp + channel) as the epilogue stores them, equal
    the float64 weight gradient of the rounded operands within 1e-12, and
    the restager's bias sums G's columns."""
    rng = np.random.default_rng(7)
    B, H, W, C = 1, 8, 32, 96
    a = np.maximum(rng.standard_normal((B, H, W, C)), 0).astype(np.float32)
    g = rng.standard_normal((B, H, W, fo)).astype(np.float32)
    gr = round_tf32(torch.from_numpy(g)).numpy()
    ln = sm90.wgrad_launch(B, H, W, C, fo, f32=True)
    cp = sm90.tap_width(C)
    assert ln["tile"] == (64, 576) and ln["grid"][:2] == (cp // 64, fo // 64)
    assert [m["box"] for m in ln["maps"]] == [(32, 16, 2, 1), (32, 18, 4, 1)]
    row_ch = [sm90.wgrad_f32_row_channel(r // 16, r % 8) + (r % 16) // 8 for r in range(64)]
    assert sorted(row_ch) == list(range(64))  # row 16 v + 8 h + g: each channel once
    chunks = sorted(rt + 128 * i for rt in range(128) for i in range(9))
    assert chunks == list(range(2 * 18 * 4 * 8))  # the in-place rounding: each 16 bytes once
    assert all(len({(rt + 128 * i) // 8 for rt in range(8 * q, 8 * q + 8)}) == 1
               for q in range(16) for i in range(9))
    part = np.zeros((fo, 9 * cp))
    bias = np.zeros(fo)
    apad = np.zeros((B, H + 2, W + 2, cp), np.float32)
    apad[:, 1:-1, 1:-1, :C] = a
    apr = round_tf32(torch.from_numpy(apad)).numpy()
    kk = np.arange(32)
    for cx in range(cp // 64):
        for fy in range(fo // 64):
            c0, f0 = 64 * cx, 64 * fy
            acc = np.zeros((3, 3, 64, 64))  # (tap row, tap column, M row, f)
            for q in range(ln["npatch"]):
                for sub in range(4):
                    y0, x0 = 2 * sub, 16 * q  # batch 1, one patch row
                    gbox = [_swizzled(g[0, y0:y0 + 2, x0:x0 + 16, f0 + 32 * h:f0 + 32 * h + 32]
                                      .reshape(32, 32)) for h in range(2)]
                    halo = [_swizzled(apad[0, y0:y0 + 4, x0:x0 + 18,
                                           c0 + 32 * h:c0 + 32 * h + 32].reshape(72, 32))
                            for h in range(2)]
                    halo = [round_tf32(torch.from_numpy(hb)).numpy() for hb in halo]  # in place
                    # the restager: block (bx, j, pq) of thread (warp r, lane)
                    rest = np.full((64, 32), np.nan, np.float32)
                    for r in range(4):
                        for lane in range(32):
                            bx, j, pq = sm90.wgrad_f32_restage_block(lane, r)
                            v = [gbox[bx][4 * pq + i].reshape(8, 4)[j ^ ((4 * pq + i) & 7)]
                                 for i in range(4)]
                            for e in range(4):
                                f = 32 * bx + 4 * j + e
                                u = pq ^ (f & 7)
                                assert np.isnan(rest[f, 4 * u:4 * u + 4]).all()
                                rest[f, 4 * u:4 * u + 4] = round_tf32(torch.tensor(
                                    [v[i][e] for i in range(4)])).numpy()
                                if cx == 0:
                                    bias[f0 + f] += ((v[0][e] + v[1][e]) + v[2][e]) + v[3][e]
                        for qw in range(4):  # a quarter-warp's 16-byte places, per instruction
                            blocks = [sm90.wgrad_f32_restage_block(8 * qw + k, r)
                                      for k in range(8)]
                            for i in range(4):
                                assert len({j ^ ((4 * pq + i) & 7) for _, j, pq in blocks}) == 8
                                assert len({pq ^ ((32 * bx + 4 * j + i) & 7)
                                            for bx, j, pq in blocks}) == 8
                    # K-major B: (n, k) at row n, unit (k / 4) ^ (n % 8)
                    bmat = np.stack([rest[n, 4 * ((kk // 4) ^ (n & 7)) + kk % 4]
                                     for n in range(64)])
                    assert np.array_equal(bmat, gr[0, y0:y0 + 2, x0:x0 + 16,
                                                   f0:f0 + 64].reshape(32, 64).T)
                    # the consumers' fragments: warpgroup w, block b at tap (w, b)
                    for w in range(3):
                        for b in range(3):
                            frag = np.zeros((64, 32), np.float32)
                            for v in range(4):
                                hb = halo[v >> 1]
                                for k in range(4):
                                    places = {}  # (load, half-warp) -> 8-byte bank places
                                    for lane in range(32):
                                        gg, t = lane >> 2, lane & 3
                                        chunk = 2 * (v & 1) + (gg >> 2) + 4 * ((gg & 3) >> 1)
                                        assert sm90.wgrad_f32_row_channel(v, gg) % 32 == \
                                            4 * chunk + 2 * (gg & 1)
                                        ra = ((k >> 1) + w) * 18 + 8 * (k & 1) + t + b
                                        regs = []
                                        for ld, rr in enumerate((ra, ra + 4)):
                                            u = chunk ^ (rr & 7)
                                            o = 4 * u + 2 * (gg & 1)
                                            regs += list(hb[rr, o:o + 2])
                                            places.setdefault((ld, lane >> 4), set()).add(
                                                2 * u + (gg & 1))
                                        m0, k0 = 16 * v + gg, 8 * k + t
                                        for mm, kq, val in ((m0, k0, regs[0]),
                                                            (m0 + 8, k0, regs[1]),
                                                            (m0, k0 + 4, regs[2]),
                                                            (m0 + 8, k0 + 4, regs[3])):
                                            frag[mm, kq] = val
                                            py, px = kq // 16, kq % 16
                                            want = apr[0, y0 + py + w, x0 + px + b,
                                                       c0 + row_ch[mm]]
                                            assert val == want, (w, b, v, k, lane)
                                    assert all(len(pl) == 16 for pl in places.values())
                            acc[w, b] += frag.astype(np.float64) @ bmat.T.astype(np.float64)
            for w in range(3):
                for b in range(3):
                    for m in range(64):
                        part[f0:f0 + 64, (3 * w + b) * cp + c0 + row_ch[m]] = acc[w, b, m]
    dk = part.reshape(fo, 9, cp)[:, :, :C].transpose(0, 2, 1).reshape(fo, C, 3, 3)
    ref = tf32.wgrad(torch.from_numpy(a), torch.from_numpy(g)).numpy()
    assert np.abs(dk - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(bias - g.astype(np.float64).sum((0, 1, 2))).max() <= 1e-4


def test_chip_smoke_holds_every_f32_gemm_shape():
    """``chip_smoke.py`` holds the float32 weight-gradient GEMM alone at
    every shape the float32 path launches it at (``WGRAD_F32_SHAPES``): the
    distinct (H, C, F) of ``_launches()``'s GEMMs, a dk1 over a concat
    [skip | up] as its pair (C = Cs, Cx), each once."""
    import chip_smoke

    shapes = set()
    for what, ln, c, f in _launches():
        if what != "wgrad":
            continue
        oc, off, _ = ln["out"]
        h = ln["maps"][0]["dims"][2]
        if off == 0:
            shapes.add((h, c, oc - c, f))
    listed = [s[1:] for s in chip_smoke.WGRAD_F32_SHAPES]
    assert len(listed) == len(set(listed)) == 20
    assert set(listed) == shapes


def test_f32_adjoint_plan():
    """(a) #19 in float32: the plan of bf16 with its stage bytes doubled,
    within the card's shared memory at the four stages' dx shapes."""
    for h, cs, cx, f in DECODER:
        p, q = adjoint_plan(B, h, h, cx, True), adjoint_plan(B, h, h, cx)
        assert p[:7] == q[:7] and p.stage_bytes == 2 * q.stage_bytes and p.smem <= SMEM_LIMIT


def test_f32_weight_packing():
    """float32 weights packed for the conv core are rounded to TF32 (ties
    away from zero, as cvt.rna): within 2^-11 relative of each weight, the
    low 13 bits zero, the layout of the bf16 packing."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 32, 3, 3)).astype(np.float32))
    p = pack_conv3x3(w, dtype=torch.float32)
    assert p.dtype == torch.float32 and p.shape == (64, 9 * 32)
    assert int((p.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    ref = w.permute(0, 2, 3, 1).reshape(64, -1)
    assert ((p - ref).abs() <= ref.abs() * 2.0 ** -11).all()
    assert torch.equal(round_tf32(torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)])),
                       torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10)]))
    assert torch.equal(tf32.trunc_tf32(torch.tensor([1 + 2 ** -10 + 2 ** -12])),
                       torch.tensor([1 + 2 ** -10]))


def _np(rng, *shape, relu=False, scale=1.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return np.maximum(a, 0) if relu else a


def _hwio(w):
    return jnp.asarray(w.permute(2, 3, 1, 0).numpy())


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _record(readings, key, value):
    readings[key] = max(readings.get(key, 0.0), value)


# small stages with the path's widths (the K depth is what the TF32 error
# grows with): up1's and up4's
STAGES = [(1, 8, 64, 128, 64), (1, 4, 512, 512, 512)]


@pytest.mark.parametrize("b,h,cs,cx,f", STAGES)
def test_f32_stage_emulation(b, h, cs, cx, f):
    """(b) #1 and the stage backward (#13, ``unetup_wgrad``, #19) emulated
    with their TF32 rules in their float32 plans' orders: the forward
    against ``unetup_plain`` (float32) and JAX's ``reference_unetup``; the
    backward against ``unetup_bwd_full_plain`` and the VJP of
    ``reference_unetup``: each reading times MARGIN within CONV_REL_TOL
    (activations) or WGRAD_CHAIN_REL_TOL (weight and bias gradients)."""
    rng = np.random.default_rng(h * cs + f)
    H2, W2 = 2 * h, 4 * h
    skip = _np(rng, b, H2, W2, cs, relu=True)
    x = _np(rng, b, h, 2 * h, cx, relu=True)
    w1 = torch.from_numpy(_np(rng, f, cs + cx, 3, 3, scale=(9 * (cs + cx)) ** -0.5))
    w2 = torch.from_numpy(_np(rng, f, f, 3, 3, scale=(9 * f) ** -0.5))
    b1 = torch.from_numpy(_np(rng, f, scale=0.1))
    b2 = torch.from_numpy(_np(rng, f, scale=0.1))
    g = torch.from_numpy(_np(rng, b, H2, W2, f))
    ts, tx = torch.from_numpy(skip), torch.from_numpy(x)
    readings = {}
    out, y1 = emu.stage_fwd(ts, tx, w1, b1, w2, b2)
    pout, py1 = _unetup_plain_y1(ts, tx, w1, b1, w2, b2)
    jfn = lambda s, xx, k1, k2: reference_unetup(s, xx, k1, jnp.asarray(b1.numpy()), k2,  # noqa
                                                 jnp.asarray(b2.numpy()))
    jout, vjp = jax.vjp(jfn, jnp.asarray(skip), jnp.asarray(x), _hwio(w1), _hwio(w2))
    _record(readings, "fwd_vs_plain", max(tf32.rel(out, pout), tf32.rel(y1, py1)))
    _record(readings, "fwd_vs_jax", tf32.rel(out, _torch(jout)))
    assert tf32.rel(pout, _torch(jout)) <= 1e-5  # the plain version is JAX's
    res = emu.stage_bwd(g, out, y1, ts, tx, w1, w2)
    ref = unetup_bwd_full_plain(g, out, y1, ts, tx, w1, w2)
    for name, a, r in zip(("dskip", "dx", "dk1", "db1", "dk2", "db2"), res, ref):
        _record(readings, name + "_vs_plain", tf32.rel(a, r))
    # JAX's VJP at JAX's own forward: dskip, dx, dk1, dk2 (HWIO → OIHW)
    jds, jdx, jdk1, jdk2 = vjp(jnp.asarray(g.numpy()))
    jres = emu.stage_bwd(g, *(t.float() for t in (pout, py1)), ts, tx, w1, w2)
    for name, a, r in (("dskip", jres[0], jds), ("dx", jres[1], jdx),
                       ("dk1", jres[2], np.transpose(np.asarray(jdk1), (3, 2, 0, 1))),
                       ("dk2", jres[4], np.transpose(np.asarray(jdk2), (3, 2, 0, 1)))):
        _record(readings, name + "_vs_jax", tf32.rel(a, _torch(r)))
    print((b, h, cs, cx, f), readings)
    for k, v in readings.items():
        tol = tf32.CONV_REL_TOL if k.startswith(("fwd", "dskip", "dx")) else \
            tf32.WGRAD_CHAIN_REL_TOL
        assert v * MARGIN <= tol, (k, v)
    # a single conv and a single weight gradient of exact inputs, against
    # their own bounds
    c1 = emu.conv_kwalk([py1], w2)
    assert tf32.rel(c1, torch.nn.functional.conv2d(
        py1.double().permute(0, 3, 1, 2), w2.double(), padding=1).permute(0, 2, 3, 1)) \
        * MARGIN <= tf32.CONV_REL_TOL
    lns = sm90.unetup_wgrad_launches(b, H2, W2, cs, cx, f, True)
    dk2, db2 = emu.wgrad_splits(py1, g, lns[2])
    like = torch.empty((f, f, 3, 3), dtype=torch.float64)
    dk2_64 = torch.ops.aten.convolution_backward(
        g.double().permute(0, 3, 1, 2), py1.double().permute(0, 3, 1, 2), like, None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]
    assert tf32.rel(dk2, dk2_64) * MARGIN <= tf32.WGRAD_REL_TOL
    assert tf32.rel(db2, g.double().sum((0, 1, 2))) <= 1e-12


# the up_conv head (b, H, W, Cx, F): x (b, H, W, Cx) → (b, 2H, 2W, F); at F
# = 64 JAX's #10 and #12 take the shape (F < 128), at Cx = F = 128 only
# reference_upconv does
HEAD_CASES = [(1, 8, 16, 64, 64), (1, 4, 8, 128, 128)]


@pytest.mark.parametrize("b,h,w,cx,f", HEAD_CASES)
def test_f32_head_emulation(b, h, w, cx, f):
    """(b) The up_conv head in float32, #10 / #11 and #12 emulated with
    their TF32 rules in their float32 plans' orders (``_torch_tf32.
    head_fwd`` / ``head_bwd``): the forward against ``upconv_plain`` in
    float32, JAX's ``reference_upconv`` and (F < 128) #10 in interpret
    mode; the backward against ``upconv_bwd_plain`` in float32, the VJP of
    ``reference_upconv`` and (F < 128) #12 in interpret mode on its own
    forward's out and y1: each reading times MARGIN within CONV_REL_TOL
    (out, y1, dx) or WGRAD_CHAIN_REL_TOL (dk1, db1, dk2, db2)."""
    from test_torch_upconv_train import _jax_bwd

    rng = np.random.default_rng(h * cx + f)
    x = _np(rng, b, h, w, cx, relu=True)
    w1 = torch.from_numpy(_np(rng, f, cx, 3, 3, scale=(9 * cx) ** -0.5))
    w2 = torch.from_numpy(_np(rng, f, f, 3, 3, scale=(9 * f) ** -0.5))
    b1 = torch.from_numpy(_np(rng, f, scale=0.1))
    b2 = torch.from_numpy(_np(rng, f, scale=0.1))
    g = torch.from_numpy(_np(rng, b, 2 * h, 2 * w, f))
    tx = torch.from_numpy(x)
    readings = {}
    out, y1 = emu.head_fwd(tx, w1, b1, w2, b2)
    pout, py1 = _upconv_plain_y1(tx, w1, b1, w2, b2)
    jfn = lambda xx, k1, jb1, k2, jb2: reference_upconv(xx, k1, jb1, k2, jb2)  # noqa: E731
    jargs = (jnp.asarray(x), _hwio(w1), jnp.asarray(b1.numpy()), _hwio(w2),
             jnp.asarray(b2.numpy()))
    jout, vjp = jax.vjp(jfn, *jargs)
    _record(readings, "fwd_vs_plain", max(tf32.rel(out, pout), tf32.rel(y1, py1)))
    _record(readings, "fwd_vs_jax", tf32.rel(out, _torch(jout)))
    assert tf32.rel(pout, _torch(jout)) <= 1e-5  # the plain version is JAX's
    names = ("dx", "dk1", "db1", "dk2", "db2")
    res = emu.head_bwd(g, out, y1, tx, w1, w2)
    for name, a, r in zip(names, res, upconv_bwd_plain(g, out, y1, tx, w1, w2)):
        _record(readings, name + "_vs_plain", tf32.rel(a, r))
    # JAX's VJP at JAX's own forward (HWIO → OIHW), the emulation at the
    # plain forward's out and y1 (the same ReLU masks)
    jdx, jdk1, jdb1, jdk2, jdb2 = vjp(jnp.asarray(g.numpy()))
    jres = emu.head_bwd(g, pout, py1, tx, w1, w2)
    oihw = lambda k: _torch(np.transpose(np.asarray(k), (3, 2, 0, 1)))  # noqa: E731
    for name, a, r in zip(names, jres, (_torch(jdx), oihw(jdk1), _torch(jdb1), oihw(jdk2),
                                        _torch(jdb2))):
        _record(readings, name + "_vs_jax", tf32.rel(a, r))
    if f < 128:
        args = (x, np.transpose(w1.numpy(), (2, 3, 1, 0)), b1.numpy(),
                np.transpose(w2.numpy(), (2, 3, 1, 0)), b2.numpy())
        (kout, ky1), kres = _jax_bwd(args, g.numpy())
        _record(readings, "fwd_vs_kernel", max(tf32.rel(out, _torch(kout)),
                                               tf32.rel(y1, _torch(ky1))))
        eres = emu.head_bwd(g, _torch(kout), _torch(ky1), tx, w1, w2)
        for name, a, r in zip(names, eres, kres):
            r = np.transpose(r, (3, 2, 0, 1)) if r.ndim == 4 and name != "dx" else r
            _record(readings, name + "_vs_kernel", tf32.rel(a, _torch(r)))
    print((b, h, w, cx, f), readings)
    for k, v in readings.items():
        tol = tf32.CONV_REL_TOL if k.startswith(("fwd", "dx")) else tf32.WGRAD_CHAIN_REL_TOL
        assert v * MARGIN <= tol, (k, v)


ENC = [(1, 16, 32, [64, 128, 128], True), (1, 8, 16, [256, 512, 512, 512], True),
       (1, 8, 16, [512, 512, 512, 512], False)]


@pytest.mark.parametrize("b,H,W,chans,pool", ENC)
def test_f32_block_emulation(b, H, W, chans, pool):
    """(b) A block's float32 forward (#3 / #21 / #23) and backward (#22 /
    #24) emulated: the forward against ``vgg_block_plain`` and JAX's
    ``reference_vgg_block``, the backward against ``vgg_block_bwd_plain``
    and the VJP of ``encoder3_train._ref_diff`` (three convs) or of
    ``reference_vgg_block`` (two): readings times MARGIN within
    CONV_REL_TOL (activations, dx) and WGRAD_REL_TOL (the last conv's
    gradients) / WGRAD_CHAIN_REL_TOL (the others)."""
    rng = np.random.default_rng(H * chans[0])
    n = len(chans) - 1
    x = _np(rng, b, H, W, chans[0], relu=True)
    ws = [torch.from_numpy(_np(rng, f, c, 3, 3, scale=(9 * c) ** -0.5))
          for c, f in zip(chans[:-1], chans[1:])]
    bs = [torch.from_numpy(_np(rng, f, scale=0.1)) for f in chans[1:]]
    tx = torch.from_numpy(x)
    acts, pooled = emu.block_fwd(tx, ws, bs, pool)
    ref = vgg_block_plain(tx, ws, bs, pool)
    readings = {"fwd_vs_plain": tf32.rel(acts[-1], ref[0])}
    jb = [jnp.asarray(t.numpy()) for t in bs]
    if n == 3:
        jfn = lambda xx, k1, k2, k3: _ref_diff(xx, k1, jb[0], k2, jb[1], k3, jb[2], pool)  # noqa
    else:
        jfn = lambda xx, k1, k2: reference_vgg_block(xx, [k1, k2], jb, pool)  # noqa
    jout, vjp = jax.vjp(jfn, jnp.asarray(x), *[_hwio(w) for w in ws])
    readings["fwd_vs_jax"] = tf32.rel(acts[-1], _torch(jout[0]))
    dskip = torch.from_numpy(_np(rng, b, H, W, chans[-1]))
    dpool = torch.from_numpy(_np(rng, b, H // 2, W // 2, chans[-1])) if pool else None
    mids, out = acts[:-1], acts[-1]
    dx, dks, dbs = emu.block_bwd(dskip, dpool, tx, mids, out, ws)
    pdx, pdks, pdbs = vgg_block_bwd_plain(dskip, dpool, tx, mids, out, ws)
    readings["dx_vs_plain"] = tf32.rel(dx, pdx)
    for i in range(n):
        readings[f"dk{i}_vs_plain"] = tf32.rel(dks[i], pdks[i])
        readings[f"db{i}_vs_plain"] = tf32.rel(dbs[i], pdbs[i])
    # JAX's VJP at JAX's own forward, the emulated backward at the plain one
    pacts = [vgg_block_plain(tx, ws[:i + 1], bs[:i + 1], False)[0] for i in range(n)]
    cot = (jnp.asarray(dskip.numpy()), None if dpool is None else jnp.asarray(dpool.numpy()))
    jgr = vjp(cot)
    edx, edks, _ = emu.block_bwd(dskip, dpool, tx, pacts[:-1], pacts[-1], ws)
    readings["dx_vs_jax"] = tf32.rel(edx, _torch(jgr[0]))
    for i in range(n):
        readings[f"dk{i}_vs_jax"] = tf32.rel(
            edks[i], _torch(np.transpose(np.asarray(jgr[1 + i]), (3, 2, 0, 1))))
    print((b, H, W, chans, pool), readings)
    for k, v in readings.items():
        tol = tf32.CONV_REL_TOL if k.startswith(("fwd", "dx")) else \
            tf32.WGRAD_REL_TOL if k[2] == str(n - 1) else tf32.WGRAD_CHAIN_REL_TOL
        assert v * MARGIN <= tol, (k, v)


def test_f32_stem_emulation():
    """(b) The stem's float32 forward (#2: the image rounded to TF32 by the
    gather, conv1_2 over a1 truncated) against ``vgg_stem_plain`` and JAX's
    ``reference_vgg_stem`` (its skip unpaired); its backward (#20: the
    image GEMM's rounded operands in its splits, conv1_2's weight gradient
    and masked dgrad) against ``vgg_stem_bwd_plain``'s and the VJP of
    ``reference_vgg_stem``: readings times MARGIN within the bounds."""
    rng = np.random.default_rng(3)
    b, H, W = 2, 16, 32
    img = rng.random((b, H, W, 3)).astype(np.float32)
    ws = [torch.from_numpy(_np(rng, 64, c, 3, 3, scale=(9 * c) ** -0.5)) for c in (3, 64)]
    bs = [torch.from_numpy(_np(rng, 64, scale=0.1)) for _ in range(2)]
    ti = torch.from_numpy(img)
    acts, pooled = emu.block_fwd(ti, ws, bs, True, image=True)
    ref = vgg_stem_plain(ti, ws[0], bs[0], ws[1], bs[1])
    readings = {"fwd_vs_plain": max(tf32.rel(acts[1], ref[0]), tf32.rel(pooled, ref[1]))}
    jb = [jnp.asarray(t.numpy()) for t in bs]
    jfn = lambda k1, k2: reference_vgg_stem(jnp.asarray(img), k1, jb[0], k2, jb[1])  # noqa
    (jskip, jpool), vjp = jax.vjp(jfn, _hwio(ws[0]), _hwio(ws[1]))
    readings["fwd_vs_jax"] = tf32.rel(acts[1], _torch(jskip).reshape(b, H, W, 64))
    dskip = torch.from_numpy(_np(rng, b, H, W, 64))
    dpool = torch.from_numpy(_np(rng, b, H // 2, W // 2, 64))
    _, dks, dbs = emu.block_bwd(dskip, dpool, ti, acts[:1], acts[1], ws, False, image=True)
    pacts = [ref[0] if i else torch.relu(torch.nn.functional.conv2d(
        ti.permute(0, 3, 1, 2), ws[0], bs[0], padding=1)).permute(0, 2, 3, 1)
        for i in range(2)]
    # the plain backward on the emulated forward's activations (the same
    # ReLU masks), as the card's checks hold the kernel to it
    pdks, pdbs = vgg_stem_bwd_plain(dskip, dpool, ti, acts[0], acts[1], *ws)
    for i in range(2):
        readings[f"dk{i}_vs_plain"] = tf32.rel(dks[i], pdks[i])
        readings[f"db{i}_vs_plain"] = tf32.rel(dbs[i], pdbs[i])
    jdk = vjp((jnp.asarray(dskip.numpy()).reshape(b, H, W // 2, 128),
               jnp.asarray(dpool.numpy())))
    _, edks, _ = emu.block_bwd(dskip, dpool, ti, [pacts[0].contiguous()], ref[0], ws, False,
                               image=True)
    for i in range(2):
        readings[f"dk{i}_vs_jax"] = tf32.rel(
            edks[i], _torch(np.transpose(np.asarray(jdk[i]), (3, 2, 0, 1))))
    print(readings)
    for k, v in readings.items():
        tol = tf32.CONV_REL_TOL if k.startswith("fwd") else \
            tf32.WGRAD_REL_TOL if k[2] == "1" else tf32.WGRAD_CHAIN_REL_TOL
        assert v * MARGIN <= tol, (k, v)


def _round_toward_zero_f32(x):
    """float64 ``x`` cut to float32's 24-bit significand, toward zero."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.trunc(m * 2.0 ** 24), (e - 24).double())


@pytest.mark.parametrize("k,rule", [(27, "round"), (9 * 64, "trunc"), (9 * 192, "trunc"),
                                    (9 * 1024, "trunc"), (128 * 8, "round")])
def test_tile_bound_holds_the_tensor_core_sum(k, rule):
    """(b) ``tf32.tile_rel_tol``, the bound of the single-tile witnesses,
    at the witnesses' reductions (the stem's 27 image columns, the conv
    core's 9 × 64 / 192 / 1024, a weight-gradient chain of 8 patches):
    128 pixels × 64 outputs from ReLU'd activations taken to TF32 by the
    operand's rule and rounded weights, summed as the bound's model has
    the tensor cores do it (each k8 step's products added to a float32
    accumulator rounded toward zero), lie within the bound of their
    float64 sum; and the bound lies under half the distance between the
    two operand rules, so a witness within it tells which one the card
    applied."""
    g = torch.Generator().manual_seed(k)
    x = torch.relu(torch.randn((128, k), generator=g))
    w = torch.randn((k, 64), generator=g) / k ** 0.5
    a, b = tf32.RULES[rule](x).double(), round_tf32(w).double()
    exact = a @ b
    acc = torch.zeros_like(exact)
    for k0 in range(0, k, 8):
        acc = _round_toward_zero_f32(acc + a[:, k0:k0 + 8] @ b[k0:k0 + 8])
    other = tf32.RULES["trunc" if rule == "round" else "round"](x).double() @ b
    reading, gap = tf32.rel(acc, exact), tf32.rel(other, exact)
    print(k, rule, {"model": reading, "bound": tf32.tile_rel_tol(k), "rules_apart": gap})
    assert reading <= tf32.tile_rel_tol(k) <= gap / 2


def test_step_loss_bounds_by_model():
    """The float32 step's loss bound a model is held to on the card: 4
    times its emulated step's reading, STEP_LOSS_EMULATED unless the model
    has a reading of its own (set from its emulation, above the shared
    one)."""
    for model in ("unet_vgg", "self_net", "traditional"):
        assert tf32.step_loss_emulated(model) == tf32.STEP_LOSS_EMULATED
        assert tf32.step_loss_rel_tol(model) == tf32.STEP_LOSS_REL_TOL
    for model, reading in tf32.STEP_LOSS_EMULATED_BY_MODEL.items():
        assert reading > tf32.STEP_LOSS_EMULATED
        assert tf32.step_loss_rel_tol(model) == 4 * reading
