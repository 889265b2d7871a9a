"""One UnetUp decoder stage, forward:
``relu(conv2(relu(conv1(concat[skip, up2x(x)]))))`` with 3×3 SAME convs
(counterpart of ``tpu_unet/kernels/decoder_fuse.py``).

CUDA kernels: ``csrc/decoder_fuse.cu`` — replaces
``decoder_fuse.py::_fused_unetup_fwd_impl``.  ``decoder_train.up2x``
(``tu_upsample2x``, launch key ``upsample2x``) writes ``up2x(x)`` once in
bf16, bit-equal to ``nn/resize.py::upsample2x``; ``tu_unetup`` runs conv1
over the two maps [skip | up] and conv2 over its output y1 on the Hopper
conv core (``csrc/conv3x3_sm90.cuh``), the launches planned by
:func:`stage_plan` (``kernels/sm90.py``).  The concat is never stored.
Traced by ``torch.export``, the launches run as the operator
``tpu_unet_torch::unetup`` (:func:`unetup_op`, with a fake that gives its
output's shape), so the graph keeps the kernels; an eager call launches
them directly.  Bound and design in the source note.

Training, both run the same kernel forward keeping conv1's output y1:
- :func:`unetup_train` (the port of ``fused_unetup_train``,
  decoder_fuse.py:1245-1340, JAX's ``FUSED_TRAIN=1``) takes its backward
  through the ``unetup_bwd`` kernel (``kernels/decoder_train.py``, #13); the
  weight and bias gradients and the upsample's adjoint stay outside any
  kernel, as JAX's ``_train_bwd`` keeps them in XLA;
- :func:`unetup_train_full` (the port of both ``fused_unetup_train_paired``
  and ``fused_unetup_train_wide``, :1355-1496, JAX's ``PAIRED_TRAIN=1``:
  the two differ only in the stages JAX gives them and their TPU layouts;
  in natural layout they are one function) takes the whole stage backward
  through ``unetup_bwd_full`` (#14-#19: #13's dgrads, then the weight
  gradients and the upsample's adjoint as kernels).
"""
from __future__ import annotations

import functools

import torch

from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import conv3x3_relu, on_cpu
from tpu_unet_torch.kernels.decoder_train import _up2x_cuda, unetup_bwd, unetup_bwd_full
from tpu_unet_torch.nn.resize import upsample2x


def _unetup_plain_y1(skip, x, w1, b1, w2, b2):
    y1 = conv3x3_relu(torch.cat([skip, upsample2x(x)], dim=-1), w1, b1)
    return conv3x3_relu(y1, w2, b2), y1


def unetup_plain(skip, x, w1, b1, w2, b2):
    """skip (B, 2H, 2W, Cs), x (B, H, W, Cx) → (B, 2H, 2W, F); mirrors
    ``reference_unetup`` (decoder_fuse.py:1181), concat order [skip, up]."""
    return _unetup_plain_y1(skip, x, w1, b1, w2, b2)[0]


def unetup_shape_ok(H2: int, W2: int, cs: int, cx: int, f: int) -> bool:
    """#1's shape rule: 2H % 8, 2W % 16, Cs % 8, Cx % 8 (16-byte TMA
    strides), (Cs + Cx) % 32 and F % 64 all 0."""
    return not (H2 % 8 or W2 % 16 or cs % 8 or cx % 8 or (cs + cx) % 32 or f % 64)


@functools.lru_cache(maxsize=64)
def stage_plan(B: int, H2: int, W2: int, cs: int, cx: int, f: int,
               f32: bool = False) -> torch.Tensor:
    """The launch records of a stage's two convs on the Hopper core, in
    bf16 or (``f32``) float32."""
    return sm90.encode(sm90.unetup_launches(B, H2, W2, cs, cx, f, f32))


def _stage_convs(skip, up, wt1, b1f, wt2, b2f, plan):
    """conv1 over [skip | up] and conv2 per ``plan``: (out, y1), in
    ``skip``'s dtype."""
    B, H2, W2, cs = skip.shape
    cx, f = up.shape[-1], wt1.shape[0]
    y1 = torch.empty((B, H2, W2, f), dtype=skip.dtype, device=skip.device)
    out = torch.empty_like(y1)
    _build.call("tu_unetup", skip.data_ptr(), up.data_ptr(), wt1.data_ptr(), b1f.data_ptr(),
                wt2.data_ptr(), b2f.data_ptr(), y1.data_ptr(), out.data_ptr(),
                B, H2, W2, cs, cx, f, int(skip.dtype == torch.float32), plan.data_ptr())
    return out, y1


def _unetup_check(skip, x, w1, b1, w2, b2):
    """#1's checks, which read shapes, dtypes and devices only (so they run
    on fake tensors too): (B, H2, W2, Cs, Cx, F, dtype) or a raise."""
    B, H, W, cx = x.shape
    cs, f = skip.shape[-1], w1.shape[0]
    H2, W2 = 2 * H, 2 * W
    dt = _build.conv_dtype(x, "unetup")
    _build.check(x, "x", dt)
    _build.check(skip, "skip", dt, (B, H2, W2, cs), x.device)
    _build.check(w1, "w1", dt, (f, cs + cx, 3, 3), x.device)
    _build.check(w2, "w2", dt, (f, f, 3, 3), x.device)
    if not unetup_shape_ok(H2, W2, cs, cx, f):
        raise ValueError(f"unetup kernel: 2H={H2} % 8, 2W={W2} % 16, Cs={cs} "
                         f"% 8, Cx={cx} % 8, Cs+Cx % 32 and F={f} % 64 must "
                         "all be 0")
    return B, H2, W2, cs, cx, f, dt


def _unetup_cuda(skip, x, w1, b1, w2, b2, want_y1=False):
    _build.no_grad_inputs("unetup", skip, x, w1, b1, w2, b2)
    B, H2, W2, cs, cx, f, dt = _unetup_check(skip, x, w1, b1, w2, b2)
    up = _up2x_cuda(x)
    wt1, wt2 = _build.pack_weights([w1, w2], dt)
    out, y1 = _stage_convs(skip, up, wt1, b1.float().contiguous(), wt2, b2.float().contiguous(),
                           stage_plan(B, H2, W2, cs, cx, f, dt == torch.float32))
    _build.launch_counts[_build.count_key("unetup", dt)] += 1
    return (out, y1) if want_y1 else out


@torch.library.custom_op("tpu_unet_torch::unetup", mutates_args=(),
                         schema="(Tensor skip, Tensor x, Tensor w1, Tensor b1, Tensor w2, "
                                "Tensor b2) -> Tensor")
def unetup_op(skip, x, w1, b1, w2, b2):
    """#1's launches (the upsample, then the stage's two convs) as an
    operator: what a traced forward on the card calls and
    ``torch.export`` keeps in its graph (``tools/export.py``); the
    launch's checks refuse tensors off the card."""
    return _unetup_cuda(skip, x, w1, b1, w2, b2)


@unetup_op.register_fake
def _unetup_fake(skip, x, w1, b1, w2, b2):
    B, H2, W2, cs, cx, f, dt = _unetup_check(skip, x, w1, b1, w2, b2)
    return x.new_empty((B, H2, W2, f), dtype=dt)


def unetup(skip, x, w1, b1, w2, b2):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernels
    for tensors on the card, through :func:`unetup_op` while traced (bf16,
    or float32 on TF32 products; 2H % 8, 2W % 16, Cs % 8, Cx % 8, (Cs +
    Cx) % 32 and F % 64 all 0)."""
    if on_cpu(x):
        return unetup_plain(skip, x, w1, b1, w2, b2)
    if _build.traced(x):
        _build.no_grad_inputs("unetup", skip, x, w1, b1, w2, b2)
        return unetup_op(skip, x, w1, b1, w2, b2)
    return _unetup_cuda(skip, x, w1, b1, w2, b2)


def _conv_wgrad(v, g, w_like):
    """Weight gradient of a 3×3 SAME conv with NHWC input ``v`` and output
    gradient ``g`` (the weight output of ``convolution_backward`` only; JAX's
    ``_conv_wgrad``, decoder_fuse.py:1289-1295), in ``v``'s dtype."""
    return torch.ops.aten.convolution_backward(
        g.to(v.dtype).permute(0, 3, 1, 2), v.permute(0, 3, 1, 2), w_like.to(v.dtype),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]


def _forward_y1(ctx, skip, x, w1, b1, w2, b2):
    """The stage's forward (#1 on the card) keeping y1, saved for the
    backward with the inputs."""
    if on_cpu(x):
        out, y1 = _unetup_plain_y1(skip, x, w1, b1, w2, b2)
    else:
        out, y1 = _unetup_cuda(skip, x, w1, b1, w2, b2, want_y1=True)
    ctx.save_for_backward(skip, x, w1, b1, w2, b2, y1, out)
    return out


class _UnetUpTrain(torch.autograd.Function):
    forward = staticmethod(_forward_y1)

    @staticmethod
    def backward(ctx, g):
        skip, x, w1, b1, w2, b2, y1, out = ctx.saved_tensors
        cs = skip.shape[-1]
        dskip, dups, g2, dz1 = unetup_bwd(g.to(y1.dtype).contiguous(), out, y1, w1, w2, cs)
        db2 = g2.float().sum((0, 1, 2))
        dk2 = _conv_wgrad(y1, g2, w2)
        db1 = dz1.float().sum((0, 1, 2))
        dk1_sk = _conv_wgrad(skip, dz1, w1[:, :cs])
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            up = upsample2x(xg)
        dk1_up = _conv_wgrad(up.detach().to(skip.dtype), dz1, w1[:, cs:])
        dx, = torch.autograd.grad(up, xg, dups.to(up.dtype))
        dk1 = torch.cat([dk1_sk, dk1_up], dim=1)
        return (dskip, dx.to(x.dtype), dk1.to(w1.dtype), db1.to(b1.dtype),
                dk2.to(w2.dtype), db2.to(b2.dtype))


def unetup_train(skip, x, w1, b1, w2, b2):
    """One UnetUp stage for training (``fused_unetup_train``): the forward as
    :func:`unetup` (keeping y1), the backward through ``unetup_bwd`` (#13),
    then the bias sums, the weight gradients (skip and up halves of conv1's
    apart, so the concat is not stored) and the upsample's adjoint.  CPU
    tensors take the plain versions both ways."""
    return _UnetUpTrain.apply(skip, x, w1, b1, w2, b2)


class _UnetUpTrainFull(torch.autograd.Function):
    forward = staticmethod(_forward_y1)

    @staticmethod
    def backward(ctx, g):
        skip, x, w1, b1, w2, b2, y1, out = ctx.saved_tensors
        dskip, dx, dk1, db1, dk2, db2 = unetup_bwd_full(
            g.to(y1.dtype).contiguous(), out, y1, skip, x, w1, w2)
        # cast as _ptrain_bwd / _wtrain_bwd (decoder_fuse.py:1432-1436, 1490-1493)
        return (dskip, dx.to(x.dtype), dk1.to(w1.dtype), db1.to(b1.dtype),
                dk2.to(w2.dtype), db2.to(b2.dtype))


def unetup_train_full(skip, x, w1, b1, w2, b2):
    """One UnetUp stage for training in JAX's default configuration
    (``fused_unetup_train_paired`` for up1, ``fused_unetup_train_wide`` for
    the F ≥ 128 stages): the forward as :func:`unetup` keeping y1, the whole
    backward through ``unetup_bwd_full`` (#14-#19).  JAX's column-paired
    output is the free reshape of this one's natural (B, 2H, 2W, F)."""
    return _UnetUpTrainFull.apply(skip, x, w1, b1, w2, b2)
