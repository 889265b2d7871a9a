"""The halo mainloop's two-map forward (#1's conv1 over [skip | up]) and the
float32 launches it takes over (#1's two convs at F ≤ 256, #20's masked
dgrad), on the CPU: (a) their launch plans at the step's and small shapes,
held to the C side's checks (``test_torch_tf32._halo_refusal``); (b) the
two-map K walk against the packed weights, zero-filled channels included;
(c) the convs emulated under their plan's TF32 rule (``kernels/tf32.py``:
the halo mainloop's activation rounded) against the JAX package's float32
references on the same TF32 operands — ``reference_unetup`` for the stage's
conv1 and conv2, ``reference_vgg_block``'s VJP for the stem's dgrad —
within ``tile_rel_tol(k)``, while the other rule's emulation lies outside
it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

import _torch_tf32 as emu
from test_torch_tf32 import SMEM_LIMIT, _halo_refusal
from tpu_unet.kernels.decoder_fuse import reference_unetup
from tpu_unet.kernels.encoder import reference_vgg_block
from tpu_unet_torch.kernels import sm90, tf32
from tpu_unet_torch.kernels._build import pack_conv3x3
from tpu_unet_torch.kernels.decoder_fuse import unetup_shape_ok
from tpu_unet_torch.kernels.decoder_train import flip_t
from tpu_unet_torch.kernels.encoder_train import pool_relu_grad_plain
from tpu_unet_torch.nn.resize import upsample2x

# (B, 2H, 2W, Cs, Cx, F): both models' up1-up3 at 512², batch 8, then
# small ones (the 128-pixel tile at 2H = 8; Cs % 32 != 0, its last slice
# zero-filled past the map's width)
STAGES = [(8, 512, 512, 64, 128, 64), (8, 256, 256, 128, 256, 128),
          (8, 128, 128, 256, 512, 256), (8, 256, 256, 64, 128, 64),
          (8, 128, 128, 256, 256, 128), (8, 64, 64, 512, 512, 256),
          (1, 16, 32, 64, 128, 64), (1, 8, 16, 128, 256, 128), (1, 16, 16, 40, 24, 64),
          (2, 16, 16, 8, 56, 128)]
# the stem backward's conv1_2 dgrad (B, H, W): unet_vgg's 512², batch 8, small
STEMS = [(8, 512, 512), (2, 16, 32), (1, 8, 16)]


def _rec(ln):
    return sm90.encode([ln])[0].tolist()


def _check_halo_maps(ln, B, H, W, chans, F):
    """A halo launch's maps: a halo box of each input map (``chans``: one
    or two widths) at the tile's rows, the weights (F, 9, sum of chans) in
    boxes of the tile's channels; the grid, the shared memory."""
    ph, tn = ln["tile"][0] // 16, ln["tile"][1]
    assert tn == sm90.halo_tile_n(F, ln["op"]) and ln["w_stages"] == sm90.halo_w_stages(tn)
    ins = [ln["maps"][0], *ln["maps"][2:]]
    assert [m["dims"] for m in ins] == [(c, W, H, B) for c in chans]
    assert all(m["box"] == (32, 18, ph + 2, 1) for m in ins)
    assert ln["maps"][1]["dims"] == (sum(chans), 9, F) and ln["maps"][1]["box"] == (32, 1, tn)
    for m in ln["maps"]:
        dense = [4 * m["dims"][0]]
        for d in m["dims"][1:-1]:
            dense.append(dense[-1] * d)
        assert list(m["strides"]) == dense and all(q % 16 == 0 for q in dense)
    assert ln["k_slices"] == sum(-(-c // 32) for c in chans)
    assert ln["grid"] == (B * (H // ph) * (W // 16) * (F // tn), 1, 1)
    assert ln["smem"] == sm90.halo_smem(ln["tile"][0], ln["op"], tn) <= SMEM_LIMIT


@pytest.mark.parametrize("case", STAGES)
def test_f32_halo_two_map_plans(case):
    """(a) #1 in float32 at F ≤ 256: conv1 over the two maps [skip | up]
    and conv2 over y1 on the halo mainloop (``sm90.unetup_launches``; at F
    = 128 and 256 the 128-wide tile), each record naming it, within 227 KB,
    accepted by the C side's checks with the tensors it is given (map 2
    present exactly with Cx) and refused by the conv core (word 9); the
    bf16 stage's records, a two-map record as a dgrad (``OP_DGRAD_MASK`` /
    ``OP_DGRAD_SPLIT``), a two-map record given one map and a one-map
    record given two are refused; the plan refuses a second map outside a
    forward."""
    B, H2, W2, cs, cx, f = case
    assert unetup_shape_ok(H2, W2, cs, cx, f)
    c1, c2 = sm90.unetup_launches(B, H2, W2, cs, cx, f, True)
    assert c1["tile"] == (sm90.halo_tile_m(H2), min(f, 128))  # F ≥ 128: the 128-wide tile
    _check_halo_maps(c1, B, H2, W2, [cs, cx], f)
    assert c2["tile"] == c1["tile"]
    _check_halo_maps(c2, B, H2, W2, [f], f)
    r1, r2 = _rec(c1), _rec(c2)
    for ln, rec in ((c1, r1), (c2, r2)):
        assert ln["op"] == sm90.OP_FWD and ln["mainloop"] == rec[9] == sm90.MAINLOOP_HALO
        assert rec[9] != sm90.MAINLOOP_TAP  # the conv core's check refuses it
    assert _halo_refusal(r1, cs, f, cx) is None and _halo_refusal(r2, f, f) is None
    assert _halo_refusal(r1, cs, f) == "cudaErrorInvalidValue"      # given one map
    assert _halo_refusal(r2, f, f, 32) == "cudaErrorInvalidValue"   # given two
    b1, b2 = sm90.encode(sm90.unetup_launches(B, H2, W2, cs, cx, f)).tolist()
    assert b1[9] == b2[9] == sm90.MAINLOOP_TAP
    assert _halo_refusal(b1, cs, f, cx) == _halo_refusal(b2, f, f) == "cudaErrorInvalidValue"
    for op in (sm90.OP_DGRAD_MASK, sm90.OP_DGRAD_SPLIT):
        dgrad = list(r1)
        dgrad[0] = op
        assert _halo_refusal(dgrad, cs, f, cx) == "cudaErrorInvalidValue"
        with pytest.raises(ValueError, match="second input map"):
            sm90.halo_conv_launch(op, B, H2, W2, cs, f, cx)
    # the plan is the conv core's at F = 512 (up4), as in bf16
    for ln in sm90.unetup_launches(B, H2, W2, cs, cx, 512, True):
        assert ln.get("mainloop", sm90.MAINLOOP_TAP) == sm90.MAINLOOP_TAP


@pytest.mark.parametrize("case", STEMS)
def test_f32_stem_dgrad_halo_plan(case):
    """(a) #20 in float32: conv1_2's dgrad masked by a1 > 0 on the halo
    mainloop (``sm90.stem_bwd_launches``, at the head's masked dgrad's
    plan: ``halo_conv_launch(OP_DGRAD_MASK, ...)``), accepted by the C
    side's checks and refused by the conv core; the bf16 stem's dgrad
    record refused; the weight-gradient launches unchanged (the conv
    core's plan's)."""
    B, H, W = case
    lns = sm90.stem_bwd_launches(B, H, W, 64, True)
    dgrad = lns[3]
    assert dgrad == sm90.halo_conv_launch(sm90.OP_DGRAD_MASK, B, H, W, 64, 64)
    assert dgrad["op"] == sm90.OP_DGRAD_MASK and lns[1] is None
    _check_halo_maps(dgrad, B, H, W, [64], 64)
    rec = _rec(dgrad)
    assert rec[9] == sm90.MAINLOOP_HALO != sm90.MAINLOOP_TAP
    assert _halo_refusal(rec, 64, 64) is None
    bf = sm90.encode(sm90.stem_bwd_launches(B, H, W, 64))[3].tolist()
    assert _halo_refusal(bf, 64, 64) == "cudaErrorInvalidValue"
    core = sm90.block_bwd_launches(B, H, W, [64, 64, 64], False, True)
    assert lns[2] == core[2] and "mainloop" not in lns[0]


@pytest.mark.parametrize("cs,cx", [(64, 128), (128, 256), (256, 256), (40, 24), (8, 56),
                                   (96, 0)])
def test_halo_walk_two_maps(cs, cx):
    """(b) ``sm90.halo_walk(Cs, Cx)``: in's 32-channel slices, then in2's,
    each with its nine taps in order; every (tap, map, channel) of both
    maps once, at the weight channel the packed (F, 9, Cs + Cx) weights
    hold it (c, or Cs + c), as the conv core's ``k_walk`` has it per tap;
    a slice's products over its whole 32-channel boxes — the activation
    box zero-filled past its map's width, the weight box past Cs + Cx, as
    TMA fills them — summed in the walk's order equal the conv of the
    concat in float64."""
    rng = np.random.default_rng(cs + cx)
    f, ct = 64, cs + cx
    walk = sm90.halo_walk(cs, cx)
    slices = [(0, c0, c0) for c0 in range(0, cs, 32)] + \
        [(2, c0, cs + c0) for c0 in range(0, cx, 32)]
    assert walk == [(tap, *s) for s in slices for tap in range(9)]
    assert sorted(walk) == sorted(sm90.k_walk(cs, cx, True))
    seen = {0: np.zeros((9, cs), np.int64), 2: np.zeros((9, cx), np.int64)}
    w = rng.standard_normal((f, ct, 3, 3)).astype(np.float32)
    packed = pack_conv3x3(torch.from_numpy(w), dtype=torch.float32).numpy().reshape(f, 9, ct)
    wr = tf32.round_tf32(torch.from_numpy(w)).numpy()
    for tap, m, c0, wc in walk:
        width = cs if m == 0 else cx
        n = min(32, width - c0)
        seen[m][tap, c0:c0 + n] += 1
        ky, kx = divmod(tap, 3)
        concat = c0 if m == 0 else cs + c0
        assert wc == concat
        assert np.array_equal(packed[:, tap, wc:wc + n], wr[:, concat:concat + n, ky, kx])
    assert all((s == 1).all() for s in seen.values())
    # the products, box by box: (B, H, W) = (1, 4, 16)
    maps = [np.maximum(rng.standard_normal((1, 4, 16, c)), 0).astype(np.float32)
            for c in (cs, cx)]
    pads = [np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 32))) for a in maps]  # + the zero fill
    wpad = np.concatenate([packed, np.zeros((f, 9, 32), np.float32)], -1).astype(np.float64)
    out = np.zeros((1, 4, 16, f))
    for tap, m, c0, wc in walk:
        ky, kx = divmod(tap, 3)
        box = pads[m // 2][:, ky:ky + 4, kx:kx + 16, c0:c0 + 32].astype(np.float64)
        out += box @ wpad[:, tap, wc:wc + 32].T
    cc = torch.from_numpy(np.concatenate(maps, -1) if cx else maps[0])

    def conv64(v):
        y = torch.nn.functional.conv2d(v.double().permute(0, 3, 1, 2),
                                       torch.from_numpy(wr).double(), padding=1)
        return y.permute(0, 2, 3, 1).numpy()

    ref = conv64(cc)
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()
    if cx:  # the emulation's walk is this one, on the rounded maps
        e = emu.conv_halo([torch.from_numpy(a) for a in maps], torch.from_numpy(w)).numpy()
        ref = conv64(tf32.round_tf32(cc))
        assert np.abs(e - ref).max() <= 1e-12 * np.abs(ref).max()


def _center_identity(c_in, c_out):
    """HWIO weights whose conv copies the first ``c_out`` input channels
    (the centre tap's identity, every other product zero)."""
    k = np.zeros((3, 3, c_in, c_out), np.float32)
    k[1, 1, :c_out, :c_out] = np.eye(c_out, dtype=np.float32)
    return k


def _jax_conv_relu(v, k_hwio, b):
    """relu(conv(v, k) + b) through the JAX package's ``reference_unetup``
    in float32: ``v`` as the skip, an up of 8 zero channels (x zero: its
    products vanish), conv2 the centre tap's identity (exact products of a
    ReLU'd y1), so the output is conv1's."""
    B, H2, W2, c = v.shape
    f = k_hwio.shape[-1]
    k1 = np.concatenate([k_hwio, np.zeros((3, 3, 8, f), np.float32)], 2)
    x = np.zeros((B, H2 // 2, W2 // 2, 8), np.float32)
    out = reference_unetup(jnp.asarray(v), jnp.asarray(x), jnp.asarray(k1), jnp.asarray(b),
                           jnp.asarray(_center_identity(f, f)), jnp.zeros((f,), jnp.float32))
    return torch.from_numpy(np.array(out))


def _hwio(w):
    return np.transpose(tf32.round_tf32(w).numpy(), (2, 3, 1, 0))


@pytest.mark.parametrize("b,h,w,cs,cx,f", [(1, 8, 16, 64, 128, 64), (1, 4, 8, 128, 256, 128),
                                           (1, 8, 8, 40, 24, 64), (1, 4, 8, 256, 256, 256),
                                           (1, 4, 8, 256, 256, 512)])
def test_f32_stage_convs_against_jax_under_the_rule(b, h, w, cs, cx, f):
    """(c) #1 in float32 emulated on its plan (``_torch_tf32.stage_fwd``:
    the halo mainloop's two-map walk with the activations rounded for
    both convs at F ≤ 256, else the conv core's truncation, as at up4's F
    = 512) against the JAX
    package's ``reference_unetup`` in float32 on the same TF32 operands
    (``_jax_conv_relu``): y1 within ``tile_rel_tol(9 (Cs + Cx))`` and out
    within ``tile_rel_tol(9 F)`` of JAX's, relative to the largest output;
    the other rule's emulation outside that bound."""
    rng = np.random.default_rng(h * cs + f)
    skip = torch.from_numpy(np.maximum(rng.standard_normal((b, 2 * h, 2 * w, cs)), 0)
                            .astype(np.float32))
    x = torch.from_numpy(np.maximum(rng.standard_normal((b, h, w, cx)), 0).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((f, cs + cx, 3, 3)) * (9 * (cs + cx)) ** -0.5)
                          .astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((f, f, 3, 3)) * (9 * f) ** -0.5)
                          .astype(np.float32))
    b1, b2 = (torch.from_numpy((0.1 * rng.standard_normal(f)).astype(np.float32))
              for _ in range(2))
    l1, l2 = sm90.unetup_launches(b, 2 * h, 2 * w, cs, cx, f, True)
    rules = [tf32.launch_rule(ln) for ln in (l1, l2)]
    assert rules == ["round" if f <= 256 else "trunc"] * 2
    out, y1 = emu.stage_fwd(skip, x, w1, b1, w2, b2)
    cc = torch.cat([skip, upsample2x(x)], -1)
    for name, got, v, wt, bias, k, rule in (
            ("y1", y1, cc, w1, b1, 9 * (cs + cx), rules[0]),
            ("out", out, y1, w2, b2, 9 * f, rules[1])):
        ref = _jax_conv_relu(tf32.RULES[rule](v).numpy(), _hwio(wt), bias.numpy())
        reading, tol = tf32.rel(got, ref), tf32.tile_rel_tol(k)
        other = "trunc" if rule == "round" else "round"
        maps = [skip, upsample2x(x)] if name == "y1" else [v]
        walk = emu.conv_halo if other == "round" else emu.conv_kwalk
        apart = tf32.rel(torch.relu(walk(maps, wt, other) + bias.double()), ref)
        print(name, rule, {"vs_jax": reading, "bound": tol, "other_rule_vs_jax": apart})
        assert reading <= tol < apart, (name, rule, reading, tol, apart)


@pytest.mark.parametrize("b,H,W", [(2, 16, 32), (1, 8, 16)])
def test_f32_stem_dgrad_against_jax_under_the_rule(b, H, W):
    """(c) #20's masked dgrad emulated on its plan (the halo mainloop: the
    gradient g rounded, ``_torch_tf32.conv_planned``) against the JAX
    package's ``reference_vgg_block`` VJP in float32 (conv1_2 alone, at x
    = a1, its cotangent the skip's gradient taken to TF32 and the pooled
    one zero, so its g is the rounded g) masked by a1 > 0: within
    ``tile_rel_tol(9 · 64)`` of JAX's, relative to the largest output; the
    truncating rule's emulation outside it.  The stem's whole float32
    backward under the rule: ``test_torch_tf32.test_f32_stem_emulation``."""
    rng = np.random.default_rng(H * W)
    a1 = np.maximum(rng.standard_normal((b, H, W, 64)), 0).astype(np.float32)
    w12 = torch.from_numpy((rng.standard_normal((64, 64, 3, 3)) / 24).astype(np.float32))
    b12 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dskip = torch.from_numpy(rng.standard_normal((b, H, W, 64)).astype(np.float32))
    ds = tf32.round_tf32(dskip)
    jfn = lambda xx: reference_vgg_block(xx, [jnp.asarray(_hwio(w12))],  # noqa: E731
                                         [jnp.asarray(b12)], True)
    (jout, jpool), vjp = jax.vjp(jfn, jnp.asarray(a1))
    jdx, = vjp((jnp.asarray(ds.numpy()), jnp.zeros_like(jpool)))
    ta1 = torch.from_numpy(a1)
    ref = torch.where(ta1 > 0, torch.from_numpy(np.asarray(jdx)), 0)
    out = torch.from_numpy(np.asarray(jout))
    g = pool_relu_grad_plain(dskip, torch.zeros((b, H // 2, W // 2, 64)), out)
    lns = sm90.stem_bwd_launches(b, H, W, 64, True)
    assert tf32.launch_rule(lns[3]) == "round"
    got = torch.where(ta1 > 0, emu.conv_planned([g], flip_t(w12), lns[3]), 0)
    apart = tf32.rel(torch.where(ta1 > 0, emu.conv_kwalk([g], flip_t(w12)), 0), ref)
    reading, tol = tf32.rel(got, ref), tf32.tile_rel_tol(9 * 64)
    print({"vs_jax": reading, "bound": tol, "trunc_vs_jax": apart})
    assert reading <= tol < apart
