"""The float32 path's kernels emulated on the CPU in float64, in each float32
plan's order (``tpu_unet_torch/kernels/sm90.py`` with ``f32=True``), with
their TF32 operand rules (``tpu_unet_torch/kernels/tf32.py``): the conv
core by its K walk of 32-channel slices (activations truncated as a TMA box
hands them over, weights rounded as packed), the convs whose plan names the
halo mainloop (the up_conv head's four, #1's two at F ≤ 256, the stem's
masked dgrad) by its slice-major walk (activations rounded, as its
register fragments take them), the weight-gradient GEMMs by
their split-K ranges of 8 × 16 patches (both operands rounded: register
fragments and a restaged G in the GEMM on TF32 wgmma), the image
GEMMs with the gathered image rounded (the step's emulation is
``kernels/tf32.py::emulated_plain_versions``).  Used by
``test_torch_tf32.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import sm90, tf32
from tpu_unet_torch.kernels._build import round_tf32
from tpu_unet_torch.kernels.decoder_train import flip_t
from tpu_unet_torch.kernels.encoder_train import pool_relu_grad_plain
from tpu_unet_torch.nn.resize import upsample2x, upsample2x_adjoint_plain


def conv_kwalk(maps, w, rule="trunc"):
    """A 3×3 SAME conv of the channel concat of NHWC ``maps`` (one or two)
    with OIHW ``w``, no bias, as the float32 conv core's K walk takes it
    (``sm90.k_walk(C, C2, f32=True)``: per tap, in's 32-channel slices,
    then in2's; each (tap, channel) once, which is checked): the slices
    summed in the walk's order, a slice's nine taps in one float64 conv
    (in float64 the order within a slice does not move these readings)."""
    C = maps[0].shape[-1]
    C2 = maps[1].shape[-1] if len(maps) > 1 else 0
    xs = [tf32.RULES[rule](m).double().permute(0, 3, 1, 2) for m in maps]
    wt = round_tf32(w).double()
    seen = torch.zeros((9, C + C2), dtype=torch.int64)
    slices = []
    for tap, m, c0, wc in sm90.k_walk(C, C2, f32=True):
        n = min(32, (C if m == 0 else C2) - c0)
        seen[tap, wc:wc + n] += 1
        if (m, c0) not in slices:
            slices.append((m, c0))
    assert bool((seen == 1).all()), "the K walk takes every (tap, channel) once"
    out = 0
    for m, c0 in slices:
        n = min(32, (C if m == 0 else C2) - c0)
        wc = c0 if m == 0 else C + c0
        out = out + F.conv2d(xs[0 if m == 0 else 1][:, c0:c0 + n], wt[:, wc:wc + n], padding=1)
    return out.permute(0, 2, 3, 1)


def conv_halo(maps, w, rule="round"):
    """A 3×3 SAME conv of the channel concat of NHWC ``maps`` (one, or two
    in a forward) with OIHW ``w``, no bias, as the halo mainloop takes it
    (``sm90.halo_walk(C, C2)``: per 32-channel slice of in, then of in2,
    its nine taps; each (tap, channel) once at the weight channel of the
    packed (F, 9, C + C2), which is checked): the maps taken to TF32 by
    ``rule`` (``"round"``: the register fragments' rule), ``w`` rounded as
    packed, the slices summed in the walk's order, a slice's nine taps in
    one float64 conv."""
    C = maps[0].shape[-1]
    C2 = maps[1].shape[-1] if len(maps) > 1 else 0
    xs = [tf32.RULES[rule](m).double().permute(0, 3, 1, 2) for m in maps]
    wt = round_tf32(w).double()
    seen = torch.zeros((9, C + C2), dtype=torch.int64)
    slices = []
    for tap, m, c0, wc in sm90.halo_walk(C, C2):
        n = min(32, (C if m == 0 else C2) - c0)
        seen[tap, wc:wc + n] += 1
        if (m, c0, wc) not in slices:
            slices.append((m, c0, wc))
    assert bool((seen == 1).all()), "the halo walk takes every (tap, channel) once"
    out = 0
    for m, c0, wc in slices:
        n = min(32, (C if m == 0 else C2) - c0)
        out = out + F.conv2d(xs[m // 2][:, c0:c0 + n], wt[:, wc:wc + n], padding=1)
    return out.permute(0, 2, 3, 1)


def conv_planned(maps, w, launch):
    """A 3×3 SAME conv of ``maps`` as ``launch`` runs it: on the halo
    mainloop where its record names it (:func:`conv_halo`, rounded), else
    on the conv core (:func:`conv_kwalk`, truncated)."""
    if launch.get("mainloop") == sm90.MAINLOOP_HALO:
        return conv_halo(maps, w)
    return conv_kwalk(maps, w)


def wgrad_splits(v, g, launch):
    """The float32 weight-gradient GEMM's (F, C, 3, 3) and bias gradient of
    NHWC input ``v`` and output gradient ``g``: per split of ``launch``,
    over its contiguous 8 × 16 patches (which the kernel walks as four 2 ×
    16 stages of four k8 steps each; in float64 the order within a split
    does not move these readings), the products of both operands rounded
    to TF32 (the register fragments and the restaged G, the rule
    ``kernels/tf32.py`` states) in float64, then the splits added in
    order."""
    B, H, W, _ = g.shape
    th, tw = H // sm90.PATCH_H, W // sm90.PATCH_W
    dk, db = 0, 0
    for lo, hi in sm90.split_ranges(launch["npatch"], launch["nsplit"]):
        mask = torch.zeros(B * th * tw, dtype=torch.bool)
        mask[lo:hi] = True
        mask = mask.view(B, th, tw).repeat_interleave(sm90.PATCH_H, 1) \
            .repeat_interleave(sm90.PATCH_W, 2)[..., None]
        gs = torch.where(mask, g, torch.zeros((), dtype=g.dtype))
        dk = dk + tf32.wgrad(v, gs)
        db = db + gs.double().sum((0, 1, 2))
    return dk, db


def stage_fwd(skip, x, w1, b1, w2, b2):
    """#1 in float32 (``sm90.unetup_launches(..., f32=True)``): up (exact,
    float32), conv1 over [skip | up] and conv2 over y1 as the float32
    kernel stores it, each on its plan's mainloop (:func:`conv_planned`:
    the halo mainloop at F ≤ 256, the operands rounded; else the conv
    core, truncated) → (out, y1) float32."""
    B, H2, W2, cs = skip.shape
    l1, l2 = sm90.unetup_launches(B, H2, W2, cs, x.shape[-1], w1.shape[0], True)
    up = upsample2x(x)
    y1 = torch.relu(conv_planned([skip, up], w1, l1) + b1.double()).float()
    return torch.relu(conv_planned([y1], w2, l2) + b2.double()).float(), y1


def stage_bwd(g, out, y1, skip, x, w1, w2):
    """The float32 stage backward (#13, ``unetup_wgrad``, #19) → (dskip,
    dx, dk1, db1, dk2, db2), float32 activations as the kernels store them,
    the weight gradients in float64."""
    B, H2, W2, f = g.shape
    cs = skip.shape[-1]
    g2 = torch.where(out > 0, g, torch.zeros(()))
    dz1 = torch.where(y1 > 0, conv_kwalk([g2], flip_t(w2)), torch.zeros((),
                      dtype=torch.float64)).float()
    d = conv_kwalk([dz1], flip_t(w1)).float()
    dskip, dups = d[..., :cs], d[..., cs:]
    lns = sm90.unetup_wgrad_launches(B, H2, W2, cs, x.shape[-1], f, True)
    dk1s, db1 = wgrad_splits(skip, dz1, lns[0])
    dk1u, _ = wgrad_splits(upsample2x(x), dz1, lns[1])
    dk2, db2 = wgrad_splits(y1, g2, lns[2])
    dx = upsample2x_adjoint_plain(dups.contiguous(), x.shape[1], x.shape[2])
    return dskip, dx, torch.cat([dk1s, dk1u], 1), db1, dk2, db2


def head_fwd(x, w1, b1, w2, b2):
    """#10 / #11 in float32: up (exact, float32), conv1 over up and conv2
    over y1 on the halo mainloop (``sm90.unetup_launches`` at Cs = 0:
    :func:`conv_halo`, up and y1 rounded) → (out, y1) float32."""
    up = upsample2x(x)
    y1 = torch.relu(conv_halo([up], w1) + b1.double()).float()
    return torch.relu(conv_halo([y1], w2) + b2.double()).float(), y1


def head_bwd(g, out, y1, x, w1, w2):
    """#12 in float32 (``sm90.upconv_bwd_launches(..., f32=True)``): the
    mask pass, conv2's masked dgrad and conv1's dgrad into dups on the halo
    mainloop (:func:`conv_halo`, g2 and dz1 rounded), dk2 / db2 and dk1 /
    db1 in their plan's splits, the adjoint → (dx, dk1, db1, dk2, db2), dx
    float32, the weight and bias gradients in float64."""
    B, H2, W2, f = g.shape
    cx = x.shape[-1]
    g2 = torch.where(out > 0, g, torch.zeros(()))
    dz1 = torch.where(y1 > 0, conv_halo([g2], flip_t(w2)), torch.zeros((),
                      dtype=torch.float64)).float()
    dups = conv_halo([dz1], flip_t(w1)).float()
    lns = sm90.upconv_bwd_launches(B, H2, W2, cx, f, True)
    dk2, db2 = wgrad_splits(y1, g2, lns[2])
    dk1, db1 = wgrad_splits(upsample2x(x), dz1, lns[3])
    dx = upsample2x_adjoint_plain(dups.contiguous(), x.shape[1], x.shape[2])
    return dx, dk1, db1, dk2, db2


def block_fwd(x, ws, bs, pool=True, image=False):
    """A VGG block's (or, with ``image``, the stem's) float32 forward:
    each conv's input as the kernel takes it (the image rounded by the
    gather, every other activation truncated by TMA) → ([ReLU outputs],
    pooled or None), float32."""
    acts, y = [], x
    for i, (w, b) in enumerate(zip(ws, bs)):
        rule = "round" if image and i == 0 else "trunc"
        y = torch.relu(conv_kwalk([y], w, rule) + b.double()).float()
        acts.append(y)
    pooled = F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1) if pool else None
    return acts, pooled


def block_bwd(dskip, dpool, x, mids, out, ws, want_dx=True, image=False):
    """The float32 training encoder's backward (#20 / #22 / #24) → (dx or
    None, [dk_i], [db_i]): the exact pool / ReLU pass, then per conv, last
    first, the weight gradient in its plan's splits and the dgrad on its
    plan's mainloop (:func:`conv_planned`: the stem's masked dgrad on the
    halo mainloop, the gradient rounded; the blocks' on the conv core,
    truncated; rounded flipT(w))."""
    B, H, W, _ = x.shape
    chans = [x.shape[-1]] + [int(w.shape[0]) for w in ws]
    lns = sm90.stem_bwd_launches(B, H, W, chans[1], True) if image else \
        sm90.block_bwd_launches(B, H, W, chans, want_dx, True)
    g = pool_relu_grad_plain(dskip, dpool, out)
    ins = [x, *mids]
    n = len(ws)
    dks, dbs, dx = [None] * n, [None] * n, None
    for i in range(n - 1, -1, -1):
        dks[i], dbs[i] = wgrad_splits(ins[i], g, lns[2 * i])
        if i > 0:
            d = conv_planned([g], flip_t(ws[i]), lns[2 * i + 1])
            g = torch.where(ins[i] > 0, d, torch.zeros((), dtype=torch.float64)).float()
        elif want_dx:
            dx = conv_planned([g], flip_t(ws[0]), lns[1]).float()
    return dx, dks, dbs
