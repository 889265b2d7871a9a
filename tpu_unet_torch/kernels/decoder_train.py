"""The backward of one UnetUp decoder stage (counterpart of
``tpu_unet/kernels/decoder_train.py``), and the ×2 upsample that the
stage's forward and weight gradients read.

- :func:`up2x`: ``up2x(x)`` in bf16, bit-equal to ``nn/resize.py::
  upsample2x``.  CUDA kernel ``csrc/decoder_fuse.cu::tu_upsample2x``
  (launch key ``upsample2x``), part of #1's port: the Hopper conv core and
  weight-gradient GEMM read ``up`` by TMA, so it is written once, where
  the TPU kernels lerp it inside the conv.
- :func:`unetup_bwd` (#13, ``fused_unetup_bwd_impl``): the
  activation-gradient chain

      g2           = g · [out > 0]                       (conv2's ReLU)
      dz1          = conv3x3(g2, flipT(w2)) · [y1 > 0]   (conv2 dgrad, conv1's ReLU)
      [dskip|dups] = conv3x3(dz1, flipT(w1))            (conv1 dgrad, split at Cs)

  with SAME 3×3 convs and no bias; ``flipT`` flips (ky, kx) and swaps the
  input and output channels (decoder_train.py:55-57).  CUDA kernel
  ``csrc/decoder_train.cu``: a ReLU mask pass writes g2, then two dgrads
  on the Hopper conv core ``csrc/conv3x3_sm90.cuh`` planned by
  :func:`dgrad_plan` — conv2's epilogue masks by y1 > 0, conv1's sends the
  skip and up channels into two tensors.
- :func:`unetup_wgrad`: both weight gradients and both bias sums in
  float32 (``_bwd_kernel_v2``, decoder_train.py:340-374, and #18's repack).
  CUDA kernel ``csrc/unetup_wgrad.cu``: three launches of the Hopper
  weight-gradient GEMM (``csrc/wgrad_sm90.cuh``) — dk1 over skip and over
  ``up2x(x)`` (recomputed by :func:`up2x`) into the channel ranges of one
  dk1, dk2 over y1 — planned by :func:`wgrad_plan`.
- :func:`upsample2x_adjoint`: dx at x's size from dups (the W- and H-lerp
  adjoints of :327-338 and #19's overlap-add).  CUDA kernel
  ``csrc/upsample_adjoint.cu``, a gather over the host tables of
  ``nn/resize.py::adjoint_tables``.
- :func:`unetup_bwd_full` (#14-#19, ``fused_unetup_bwd_paired_impl`` and
  ``fused_unetup_bwd_wide_impl`` with their low-res schedules): the whole
  stage backward, the three kernels in a row; one function for every F.

Bounds and designs are in the sources' notes.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import on_cpu
from tpu_unet_torch.nn.resize import (adjoint_tables, lerp_tables, upsample2x,
                                      upsample2x_adjoint_plain)


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights: OIHW (F, C, 3, 3) → (C, F, 3, 3), flipped in ky/kx."""
    return w.flip(2, 3).transpose(0, 1)


@functools.lru_cache(maxsize=32)
def up2x_tables(h: int, w: int, device: torch.device):
    """Row and column (idx, wts) tables of the ×2 align-corners upsample,
    with bf16-rounded weights, on ``device`` (what the upsample kernel
    reads)."""
    ridx, rw = lerp_tables(h, 2 * h, True, torch.bfloat16)
    cidx, cw = lerp_tables(w, 2 * w, True, torch.bfloat16)
    return tuple(t.contiguous().to(device) for t in (ridx, rw, cidx, cw))


def _up2x_cuda(x):
    _build.no_grad_inputs("upsample2x", x)
    B, H, W, cx = x.shape
    _build.check(x, "x", torch.bfloat16)
    if cx % 8 or B * 4 * H * W * cx // 8 >= 2**32:
        raise ValueError(f"upsample2x kernel: Cx={cx} % 8 must be 0 and the output "
                         "below 2^35 elements")
    ridx, rw, cidx, cw = up2x_tables(H, W, x.device)
    up = torch.empty((B, 2 * H, 2 * W, cx), dtype=torch.bfloat16, device=x.device)
    _build.call("tu_upsample2x", x.data_ptr(), ridx.data_ptr(), rw.data_ptr(), cidx.data_ptr(),
                cw.data_ptr(), up.data_ptr(), B, 2 * H, 2 * W, cx)
    _build.launch_counts["upsample2x"] += 1
    return up


def up2x(x):
    """Dispatching wrapper of the ×2 align-corners upsample of NHWC ``x``:
    ``nn/resize.py::upsample2x`` for CPU tensors, the CUDA kernel for
    tensors on the card (bf16, C % 8 == 0; bit-equal to the plain version
    in bf16)."""
    if on_cpu(x):
        return upsample2x(x)
    return _up2x_cuda(x)


@functools.lru_cache(maxsize=32)
def _adjoint_tables(h: int, w: int, device: torch.device):
    """Row and column gather tables of the upsample's adjoint, bf16
    weights, on ``device``."""
    return tuple(t.contiguous().to(device)
                 for t in (*adjoint_tables(h, torch.bfloat16), *adjoint_tables(w, torch.bfloat16)))


def _conv_nobias(x, w):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def unetup_bwd_plain(g, out, y1, w1, w2, cs: int):
    """g, out, y1 (B, 2H, 2W, F), conv weights w1 (F, Cs + Cx, 3, 3) and
    w2 (F, F, 3, 3) → (dskip (B, 2H, 2W, Cs), dups (B, 2H, 2W, Cx), g2,
    dz1), in g's dtype."""
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    g2 = torch.where(out > 0, g, zero)
    dz1 = torch.where(y1 > 0, _conv_nobias(g2, flip_t(w2)), zero)
    d = _conv_nobias(dz1, flip_t(w1))
    return d[..., :cs].contiguous(), d[..., cs:].contiguous(), g2, dz1


def stage_shape_ok(H2: int, W2: int, f: int, cp: int, cs: int) -> bool:
    """The stage kernels' shape rule (#1's forward and the stage backward):
    2H % 8, 2W % 16, F % 64, (Cs + Cx) % 64 and Cs % 8 all 0, Cx > 0."""
    return not (H2 % 8 or W2 % 16 or f % 64 or cp % 64 or cs % 8 or cp <= cs)


def _check_stage(name, H2, W2, f, cp, cs):
    if not stage_shape_ok(H2, W2, f, cp, cs):
        raise ValueError(f"{name} kernel: 2H={H2} % 8, 2W={W2} % 16, F={f} % 64, "
                         f"Cs+Cx={cp} % 64 and Cs={cs} % 8 must all be 0, Cx > 0")


@functools.lru_cache(maxsize=64)
def dgrad_plan(B: int, H2: int, W2: int, cs: int, cx: int, f: int) -> torch.Tensor:
    """The launch records of #13's two dgrads on the Hopper conv core
    (``sm90.unetup_bwd_launches``)."""
    return sm90.encode(sm90.unetup_bwd_launches(B, H2, W2, cs, cx, f))


def _unetup_bwd_cuda(g, out, y1, w1, w2, cs):
    _build.no_grad_inputs("unetup_bwd", g, out, y1, w1, w2)
    B, H2, W2, f = g.shape
    cp = w1.shape[1]
    cx = cp - cs
    bf = torch.bfloat16
    _build.check(g, "g", bf)
    for t, name in ((out, "out"), (y1, "y1")):
        _build.check(t, name, bf, tuple(g.shape), g.device)
    _build.check(w1, "w1", bf, (f, cp, 3, 3), g.device)
    _build.check(w2, "w2", bf, (f, f, 3, 3), g.device)
    _check_stage("unetup_bwd", H2, W2, f, cp, cs)
    w2t = _build.pack_conv3x3(flip_t(w2))
    w1t = _build.pack_conv3x3(flip_t(w1))
    g2, dz1 = torch.empty_like(g), torch.empty_like(g)
    dskip = torch.empty((B, H2, W2, cs), dtype=bf, device=g.device)
    dups = torch.empty((B, H2, W2, cx), dtype=bf, device=g.device)
    plan = dgrad_plan(B, H2, W2, cs, cx, f)
    _build.call("tu_unetup_bwd", g.data_ptr(), out.data_ptr(), y1.data_ptr(),
                w2t.data_ptr(), w1t.data_ptr(), g2.data_ptr(), dz1.data_ptr(),
                dskip.data_ptr(), dups.data_ptr(), B, H2, W2, cs, cx, f, plan.data_ptr())
    _build.launch_counts["unetup_bwd"] += 1
    return dskip, dups, g2, dz1


def unetup_bwd(g, out, y1, w1, w2, cs: int):
    """Dispatching wrapper of #13: plain version for CPU tensors, the CUDA
    kernel for tensors on the card (bf16; 2H % 8, 2W % 16, F % 64,
    (Cs + Cx) % 64 and Cs % 8 all 0)."""
    if on_cpu(g):
        return unetup_bwd_plain(g, out, y1, w1, w2, cs)
    return _unetup_bwd_cuda(g, out, y1, w1, w2, cs)


def conv_wgrad(v: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """float32 weight gradient (F, C, 3, 3) of a 3×3 SAME conv with NHWC
    input ``v`` (B, H, W, C) and output gradient ``gout`` (B, H, W, F),
    both taken in float32 (JAX's ``_mmT`` accumulates in float32)."""
    vf, gf = v.float().permute(0, 3, 1, 2), gout.float().permute(0, 3, 1, 2)
    like = torch.empty((gf.shape[1], vf.shape[1], 3, 3), device=v.device)
    return torch.ops.aten.convolution_backward(
        gf, vf, like, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]


def unetup_wgrad_plain(skip, x, dz1, y1, g2):
    """skip (B, 2H, 2W, Cs), x (B, H, W, Cx), dz1 / y1 / g2 (B, 2H, 2W, F)
    → (dk1 (F, Cs + Cx, 3, 3), db1 (F), dk2 (F, F, 3, 3), db2 (F)) in
    float32; conv1's input is the forward's [skip, up2x(x)] in x's dtype."""
    cc = torch.cat([skip, upsample2x(x).to(skip.dtype)], dim=-1)
    return (conv_wgrad(cc, dz1), dz1.float().sum((0, 1, 2)),
            conv_wgrad(y1, g2), g2.float().sum((0, 1, 2)))


@functools.lru_cache(maxsize=64)
def wgrad_plan(B: int, H2: int, W2: int, cs: int, cx: int, f: int):
    """The launch records of a stage's three weight-gradient GEMMs on the
    Hopper core, their split counts and the float32 words of the work area
    they share."""
    launches = sm90.unetup_wgrad_launches(B, H2, W2, cs, cx, f)
    return (sm90.encode(launches), tuple(ln["nsplit"] for ln in launches),
            sm90.wgrad_work(launches, f))


def _unetup_wgrad_cuda(skip, x, dz1, y1, g2):
    _build.no_grad_inputs("unetup_wgrad", skip, x, dz1, y1, g2)
    B, H, W, cx = x.shape
    H2, W2, f = 2 * H, 2 * W, dz1.shape[-1]
    cs = skip.shape[-1]
    cp = cs + cx
    bf = torch.bfloat16
    _build.check(x, "x", bf)
    _build.check(skip, "skip", bf, (B, H2, W2, cs), x.device)
    for t, name in ((dz1, "dz1"), (y1, "y1"), (g2, "g2")):
        _build.check(t, name, bf, (B, H2, W2, f), x.device)
    _check_stage("unetup_wgrad", H2, W2, f, cp, cs)
    plan, _, work_words = wgrad_plan(B, H2, W2, cs, cx, f)
    f32 = dict(dtype=torch.float32, device=x.device)
    work = torch.empty(work_words, **f32)
    dk1, db1 = torch.empty((f, cp, 3, 3), **f32), torch.empty(f, **f32)
    dk2, db2 = torch.empty((f, f, 3, 3), **f32), torch.empty(f, **f32)
    up = _up2x_cuda(x)
    _build.call("tu_unetup_wgrad", skip.data_ptr(), up.data_ptr(), dz1.data_ptr(),
                y1.data_ptr(), g2.data_ptr(), work.data_ptr(), dk1.data_ptr(), db1.data_ptr(),
                dk2.data_ptr(), db2.data_ptr(), B, H2, W2, cs, cx, f, plan.data_ptr())
    _build.launch_counts["unetup_wgrad"] += 1
    return dk1, db1, dk2, db2


def unetup_wgrad(skip, x, dz1, y1, g2):
    """Dispatching wrapper of the stage's weight and bias gradients: plain
    version for CPU tensors, the CUDA kernel for tensors on the card (bf16;
    the shapes of :func:`unetup_bwd`)."""
    if on_cpu(x):
        return unetup_wgrad_plain(skip, x, dz1, y1, g2)
    return _unetup_wgrad_cuda(skip, x, dz1, y1, g2)


def _upsample_adjoint_cuda(dup, h, w):
    _build.no_grad_inputs("upsample_adjoint", dup)
    B, c = dup.shape[0], dup.shape[-1]
    _build.check(dup, "dup", torch.bfloat16, (B, 2 * h, 2 * w, c))
    if c % 8:
        raise ValueError(f"upsample_adjoint kernel: C={c} % 8 must be 0")
    ridx, rw, cidx, cw = _adjoint_tables(h, w, dup.device)
    dx = torch.empty((B, h, w, c), dtype=torch.bfloat16, device=dup.device)
    _build.call("tu_upsample_adjoint", dup.data_ptr(), ridx.data_ptr(), rw.data_ptr(),
                ridx.shape[1], cidx.data_ptr(), cw.data_ptr(), cidx.shape[1], dx.data_ptr(),
                B, h, w, c)
    _build.launch_counts["upsample_adjoint"] += 1
    return dx


def upsample2x_adjoint(dup, h: int, w: int):
    """Dispatching wrapper of the ×2 upsample's adjoint, (B, 2h, 2w, C) →
    (B, h, w, C): plain version for CPU tensors, the CUDA kernel for tensors
    on the card (bf16, C % 8 == 0)."""
    if on_cpu(dup):
        return upsample2x_adjoint_plain(dup, h, w)
    return _upsample_adjoint_cuda(dup, h, w)


def unetup_bwd_full_plain(g, out, y1, skip, x, w1, w2):
    """The whole stage backward through the plain versions: g, out, y1
    (B, 2H, 2W, F), skip (B, 2H, 2W, Cs), x (B, H, W, Cx), w1, w2 OIHW →
    (dskip, dx (B, H, W, Cx), dk1, db1, dk2, db2), the gradients of the
    weights and biases in float32."""
    dskip, dups, g2, dz1 = unetup_bwd_plain(g, out, y1, w1, w2, skip.shape[-1])
    dk1, db1, dk2, db2 = unetup_wgrad_plain(skip, x, dz1, y1, g2)
    dx = upsample2x_adjoint_plain(dups, x.shape[1], x.shape[2])
    return dskip, dx, dk1, db1, dk2, db2


def unetup_bwd_full(g, out, y1, skip, x, w1, w2):
    """The port of #14-#19: the whole backward of one UnetUp stage,
    ``(dskip, dx, dk1, db1, dk2, db2)`` as :func:`unetup_bwd_full_plain`.
    CPU tensors take the plain version; on the card it launches #13
    (``unetup_bwd``), ``unetup_wgrad`` and ``upsample_adjoint`` in a row."""
    if on_cpu(g):
        return unetup_bwd_full_plain(g, out, y1, skip, x, w1, w2)
    dskip, dups, g2, dz1 = _unetup_bwd_cuda(g, out, y1, w1, w2, skip.shape[-1])
    dk1, db1, dk2, db2 = _unetup_wgrad_cuda(skip, x, dz1, y1, g2)
    dx = _upsample_adjoint_cuda(dups, x.shape[1], x.shape[2])
    return dskip, dx, dk1, db1, dk2, db2
