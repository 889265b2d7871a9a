"""The VGG16 encoder in training (counterpart of ``tpu_unet/kernels/
stem_train.py``, ``encoder_train.py`` and ``encoder3_train.py``): each stage
as one ``torch.autograd.Function`` whose forward keeps the ReLU outputs
between its convs and whose backward is one kernel.

- Forward: the serving kernels, keeping their intermediates — the stem
  (``csrc/stem.cu``, #2, as JAX's ``_stem_train_fwd`` runs #2 with a1 kept)
  and the block kernel ``csrc/encoder.cu`` on the Hopper conv core
  (``csrc/conv3x3_sm90.cuh``) for block 2 (counted as ``vgg_block2_fwd``:
  the port of ``fused_vgg_block2_fwd_impl``, encoder_train.py:139, #21, a5
  kept) and blocks 3-5 (counted as ``vgg_block3_fwd``:
  ``fused_vgg_block3_fwd_impl``, encoder3_train.py:279, #23, a1 and a2
  kept).
- Backward: :func:`vgg_stem_bwd` (#20, ``fused_vgg_stem_bwd_impl``,
  stem_train.py:245) and :func:`vgg_block_bwd` (#22 for two convs,
  ``fused_vgg_block2_bwd_impl`` at encoder_train.py:329; #24 for three,
  ``fused_vgg_block3_bwd_impl`` at encoder3_train.py:349), one CUDA source
  ``csrc/encoder_train.cu``: the pool's first-max routing with the skip's
  gradient and the last ReLU mask, then per conv the float32 weight and
  bias gradients and the masked dgrad on the Hopper kernels
  ``csrc/wgrad_sm90.cuh`` and ``csrc/conv3x3_sm90.cuh`` (the stem's conv1_1
  weight gradient over the 3-channel image on a GEMM of its own in
  ``csrc/encoder_train.cu``), planned by :mod:`tpu_unet_torch.kernels.sm90`.
  The stem computes no image gradient (JAX's VJP returns zeros for it;
  the step never needs it).

The TPU kernels' column-paired layouts, row tiles and P8 padding are TPU
layout; in natural NHWC there is one function per stage.  Bounds and
design are in the source note.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import conv3x3_relu, max_pool2x2, on_cpu
from tpu_unet_torch.kernels.decoder_train import _conv_nobias, conv_wgrad, flip_t
from tpu_unet_torch.kernels.encoder import _vgg_block_cuda, vgg_block_shape_ok
from tpu_unet_torch.kernels.stem import _vgg_stem_cuda, vgg_stem_shape_ok


def unpool_first_max(dpool, out):
    """(B, H/2, W/2, C) pooled gradient → (B, H, W, C): each value at the
    first maximum of its 2×2 window of ``out`` in row-major order (XLA's
    select-and-scatter), zeros elsewhere."""
    B, H, W, C = out.shape
    win = out.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
    first = win.reshape(B, H // 2, W // 2, C, 4).argmax(-1)  # first of equal maxima
    routed = F.one_hot(first, 4).to(dpool.dtype) * dpool[..., None]
    routed = routed.reshape(B, H // 2, W // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return routed.reshape(B, H, W, C)


def pool_relu_grad_plain(dskip, dpool, out):
    """g = (dskip + unpool(dpool)) · [out > 0], in ``out``'s dtype; without
    ``dpool`` (no pool) dskip · [out > 0]."""
    g = dskip if dpool is None else dskip + unpool_first_max(dpool, out)
    return torch.where(out > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def vgg_block_bwd_plain(dskip, dpool, x, mids, out, ws, want_dx=True):
    """The backward of ``relu(conv(… relu(conv(x)) …))`` (+ 2×2 max-pool when
    ``dpool`` is given) from the forward's intermediates: ``mids`` the ReLU
    outputs between the convs, ``out`` the last one (the skip).  Returns
    (dx or None, [dk_i] (F, C, 3, 3) float32, [db_i] float32); the
    activation gradients in ``out``'s dtype."""
    g = pool_relu_grad_plain(dskip, dpool, out)
    ins = [x, *mids]
    dks, dbs, dx = [None] * len(ws), [None] * len(ws), None
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for i in range(len(ws) - 1, -1, -1):
        dks[i], dbs[i] = conv_wgrad(ins[i], g), g.float().sum((0, 1, 2))
        if i > 0:
            g = torch.where(ins[i] > 0, _conv_nobias(g, flip_t(ws[i])), zero)
        elif want_dx:
            dx = _conv_nobias(g, flip_t(ws[0]))
    return dx, dks, dbs


def vgg_stem_bwd_plain(dskip, dpool, x, a1, out, w11, w12):
    """The stem's backward, no image gradient: ([dk11, dk12], [db11, db12])
    in float32."""
    _, dks, dbs = vgg_block_bwd_plain(dskip, dpool, x, [a1], out, [w11, w12], want_dx=False)
    return dks, dbs


def vgg_block_train_ok(H: int, W: int, chans) -> bool:
    """The shapes a block's training kernels tile: the forward's rule, and
    the input width % 64 (the dgrad to x and the weight-gradient tiles)."""
    return vgg_block_shape_ok(H, W, chans) and chans[0] % 64 == 0


@functools.lru_cache(maxsize=64)
def bwd_plan(B: int, H: int, W: int, chans: tuple, want_dx: bool):
    """The launch records of a stage's backward on the Hopper kernels and
    each conv's split count: a block's two or three convs
    (``sm90.block_bwd_launches``: conv i's weight gradient at 2i, its dgrad
    at 2i + 1; none for conv 0's without dx), or the stem's (``chans[0] ==
    3``, ``sm90.stem_bwd_launches``: conv1_1's weight gradient over the
    image, no dgrad; conv1_2's two)."""
    launches = sm90.stem_bwd_launches(B, H, W, chans[1]) if chans[0] == 3 else \
        sm90.block_bwd_launches(B, H, W, chans, want_dx)
    return sm90.encode(launches), tuple(ln["nsplit"] for ln in launches[0::2])


def _bwd_cuda(key, dskip, dpool, x, mids, out, ws, want_dx, is_image):
    _build.no_grad_inputs(key, dskip, dpool, x, mids, out, ws)
    n = len(ws)
    B, H, W, c0 = x.shape
    chans = [c0] + [int(w.shape[0]) for w in ws]
    bf = torch.bfloat16
    if n not in (2, 3) or len(mids) != n - 1:
        raise ValueError(f"{key} kernel takes 2 or 3 convs and their n - 1 intermediates")
    _build.check(x, "x", bf)
    ok = (vgg_stem_shape_ok(H, W, chans[1]) and chans == [3, chans[1], chans[1]]) if is_image \
        else vgg_block_train_ok(H, W, chans)
    if not ok:
        raise ValueError(f"{key} kernel: H={H} % 8, W={W} % 16 and the widths {chans} % 64 "
                         "(the stem's image 3) must all be 0")
    for i, w in enumerate(ws):
        _build.check(w, f"ws[{i}]", bf, (chans[i + 1], chans[i], 3, 3), x.device)
    for i, m in enumerate(mids):
        _build.check(m, f"mids[{i}]", bf, (B, H, W, chans[i + 1]), x.device)
    _build.check(out, "out", bf, (B, H, W, chans[-1]), x.device)
    _build.check(dskip, "dskip", bf, (B, H, W, chans[-1]), x.device)
    if dpool is not None:
        _build.check(dpool, "dpool", bf, (B, H // 2, W // 2, chans[-1]), x.device)
    # the dgrad weights flipT(w_i), (Cin_i, 9 Cout_i); conv 0's only for dx
    wts = [None if i == 0 and not want_dx else _build.pack_conv3x3(flip_t(w))
           for i, w in enumerate(ws)]
    kpad = [-(-9 * c // 64) * 64 for c in chans[:-1]]
    plan, ns = bwd_plan(B, H, W, tuple(chans), bool(want_dx))
    work = torch.empty(max(ns[i] * chans[i + 1] * (kpad[i] + 1) for i in range(n)),
                       dtype=torch.float32, device=x.device)
    ga, gb = torch.empty_like(out), torch.empty_like(out)
    dx = torch.empty_like(x) if want_dx else None
    dks = [torch.empty((chans[i + 1], chans[i], 3, 3), dtype=torch.float32, device=x.device)
           for i in range(n)]
    dbs = [torch.empty(chans[i + 1], dtype=torch.float32, device=x.device) for i in range(n)]
    pad = [None] * (3 - n)
    _build.call("tu_vgg_block_bwd", x.data_ptr(), int(is_image),
                *[m.data_ptr() for m in mids], *([None] * (2 - len(mids))), out.data_ptr(),
                dskip.data_ptr(), _build.ptr(dpool), *[_build.ptr(t) for t in wts], *pad,
                ga.data_ptr(), gb.data_ptr(), _build.ptr(dx), work.data_ptr(),
                *[t.data_ptr() for t in dks], *pad, *[t.data_ptr() for t in dbs], *pad,
                n, B, H, W, *chans, *([0] * (4 - len(chans))), plan.data_ptr())
    _build.launch_counts[key] += 1
    return dx, dks, dbs


def block_key(n_convs: int, phase: str) -> str:
    """Launch key of a block kernel in training: block 2 (two convs) stands
    for #21 / #22, blocks 3-5 (three) for #23 / #24."""
    return f"vgg_block{2 if n_convs == 2 else 3}_{phase}"


def vgg_block_bwd(dskip, dpool, x, mids, out, ws, want_dx=True):
    """Dispatching wrapper of #22 / #24: plain version for CPU tensors, the
    CUDA kernel for tensors on the card (bf16; the shapes of
    ``vgg_block_shape_ok``, every width % 64)."""
    if on_cpu(x):
        return vgg_block_bwd_plain(dskip, dpool, x, mids, out, ws, want_dx)
    return _bwd_cuda(block_key(len(ws), "bwd"), dskip, dpool, x, mids, out, ws, want_dx, False)


def vgg_stem_bwd(dskip, dpool, x, a1, out, w11, w12):
    """Dispatching wrapper of #20: plain version for CPU tensors, the CUDA
    kernel for tensors on the card (bf16 image; the stem kernel's shapes,
    ``vgg_stem_shape_ok``)."""
    if on_cpu(x):
        return vgg_stem_bwd_plain(dskip, dpool, x, a1, out, w11, w12)
    _, dks, dbs = _bwd_cuda("vgg_stem_bwd", dskip, dpool, x, [a1], out, [w11, w12], False, True)
    return dks, dbs


def _grad_or_zeros(g, shape, like):
    """An output's gradient in ``like``'s dtype, zeros of ``shape`` where
    autograd gives none."""
    if g is None:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return g.to(like.dtype).contiguous()


def _pooled_shape(skip):
    B, H, W, C = skip.shape
    return (B, H // 2, W // 2, C)


class _VggBlockTrain(torch.autograd.Function):
    """(x, pool, *ws, *bs) → (skip, pooled or None)."""

    @staticmethod
    def forward(ctx, x, pool, *wb):
        n = len(wb) // 2
        ws, bs = list(wb[:n]), list(wb[n:])
        if on_cpu(x):
            y, mids = x, []
            for w, b in zip(ws, bs):
                y = conv3x3_relu(y, w, b)
                mids.append(y)
            skip, mids = y, mids[:-1]
            pooled = max_pool2x2(skip) if pool else None
        else:
            skip, pooled, mids = _vgg_block_cuda(x, ws, bs, pool, block_key(n, "fwd"))
        ctx.n, ctx.pool = n, pool
        ctx.save_for_backward(x, skip, *mids, *ws, *bs)
        return skip, pooled

    @staticmethod
    def backward(ctx, dskip, dpool):
        n = ctx.n
        x, skip, *rest = ctx.saved_tensors
        mids, ws, bs = rest[:n - 1], rest[n - 1:2 * n - 1], rest[2 * n - 1:]
        dpool = _grad_or_zeros(dpool, _pooled_shape(skip), skip) if ctx.pool else None
        dx, dks, dbs = vgg_block_bwd(_grad_or_zeros(dskip, skip.shape, skip), dpool, x, list(mids), skip,
                                     list(ws), want_dx=ctx.needs_input_grad[0])
        return (None if dx is None else dx.to(x.dtype), None,
                *[dk.to(w.dtype) for dk, w in zip(dks, ws)],
                *[db.to(b.dtype) for db, b in zip(dbs, bs)])


class _VggStemTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w11, b11, w12, b12):
        if on_cpu(x):
            x = x.to(w11.dtype)
            a1 = conv3x3_relu(x, w11, b11)
            skip = conv3x3_relu(a1, w12, b12)
            pooled = max_pool2x2(skip)
        else:
            skip, pooled, a1 = _vgg_stem_cuda(x, w11, b11, w12, b12)
        ctx.save_for_backward(x, a1, skip, w11, b11, w12, b12)
        return skip, pooled

    @staticmethod
    def backward(ctx, dskip, dpool):
        x, a1, skip, w11, b11, w12, b12 = ctx.saved_tensors
        (dk11, dk12), (db11, db12) = vgg_stem_bwd(
            _grad_or_zeros(dskip, skip.shape, skip), _grad_or_zeros(dpool, _pooled_shape(skip), skip),
            x, a1, skip, w11, w12)
        # no image gradient, as _stem_train_bwd (stem_train.py:309-326)
        return (None, dk11.to(w11.dtype), db11.to(b11.dtype), dk12.to(w12.dtype),
                db12.to(b12.dtype))


def vgg_block_train(x, ws, bs, pool: bool = True):
    """One VGG block for training (``fused_vgg_block2_train`` /
    ``fused_vgg_block3_train``): (skip, pooled or None), the forward through
    the block kernel keeping its intermediates, the backward through
    :func:`vgg_block_bwd`.  CPU tensors take the plain versions both ways."""
    return _VggBlockTrain.apply(x, pool, *ws, *bs)


def vgg_stem_train(x, w11, b11, w12, b12):
    """The stem for training (``fused_vgg_stem_train``): (skip, pooled), the
    forward through the stem kernel keeping a1, the backward through
    :func:`vgg_stem_bwd`; ``x`` is the normalised image in the weights'
    dtype and gets no gradient."""
    return _VggStemTrain.apply(x, w11, b11, w12, b12)
