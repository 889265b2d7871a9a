"""The ``up_conv`` head of ``unet_resnet50`` and ``self_net``:
``relu(conv2(relu(conv1(up2x(x)))))`` with 3×3 SAME convs and no skip
(counterpart of ``tpu_unet/kernels/upconv.py``).

CUDA kernels in ``csrc/upconv.cu``:
- :func:`upconv`, the forward — replaces ``upconv.py::fused_upconv_impl``
  and ``_fused_upconv_call_p2`` (two TPU schedules of this function): a
  UnetUp stage (``kernels/decoder_fuse.py``) with no skip channels.
  ``decoder_train.up2x`` (``tu_upsample2x``, launch key ``upsample2x``)
  writes ``up2x(x)`` once; ``tu_upconv`` runs conv1 over ``up``
  and conv2 over its output y1 on the Hopper conv core
  (``csrc/conv3x3_sm90.cuh``) in bf16 and, in float32, on the halo
  mainloop (``csrc/conv3x3_halo_sm90.cuh``: one TMA halo box a 32-channel
  K slice serving all nine taps), the launches planned as a stage's at
  Cs = 0 (``decoder_fuse.stage_plan``, ``sm90.halo_conv_launch``);
- :func:`upconv_bwd`, the backward — replaces ``fused_upconv_bwd_impl``
  (#12): both ReLU VJPs, both dgrads, both weight gradients with their bias
  sums (float32) and the upsample's adjoint, the UnetUp stage backward of
  ``kernels/decoder_train.py`` at zero skip channels.  ``decoder_train.up2x``
  writes ``up2x(x)`` again (launch key ``upsample2x``, as a stage's weight
  gradients take it), then one C entry ``tu_upconv_bwd`` runs the ReLU mask
  pass, both dgrads on the Hopper conv core (in float32 on the halo
  mainloop), both weight gradients on the Hopper GEMM
  (``csrc/wgrad_sm90.cuh``) and the adjoint, planned by :func:`bwd_plan`
  (``sm90.upconv_bwd_launches``);
- :func:`upconv_train`, the head for training (``fused_upconv_train``): the
  forward kernel keeping y1, the backward kernel.

Both kernels take bf16 or, for the float32 training path (``fp16=False``),
float32 tensors: the C entries' float32 instantiations (TF32 products,
float32 storage and sums; the halo mainloop rounds the activation to TF32,
``kernels/tf32.py``), planned with ``f32=True`` and counted under
``upconv_f32`` / ``upconv_bwd_f32`` (``_build.count_key``).  Bounds and
designs are in the sources' notes.
"""
from __future__ import annotations

import functools

import torch

from tpu_unet_torch.kernels import _build, sm90
from tpu_unet_torch.kernels._plain import conv3x3_relu, on_cpu
from tpu_unet_torch.kernels.decoder_fuse import stage_plan
from tpu_unet_torch.kernels.decoder_train import (_adjoint_tables, _up2x_cuda,
                                                  unetup_bwd_full_plain)
from tpu_unet_torch.nn.resize import upsample2x


def _upconv_plain_y1(x, w1, b1, w2, b2):
    y1 = conv3x3_relu(upsample2x(x), w1, b1)
    return conv3x3_relu(y1, w2, b2), y1


def upconv_plain(x, w1, b1, w2, b2):
    """x (B, H, W, Cx) → (B, 2H, 2W, F); mirrors ``reference_upconv``
    (upconv.py:36-47)."""
    return _upconv_plain_y1(x, w1, b1, w2, b2)[0]


def _upconv_check(x, w1, b1, w2, b2):
    """#10's checks, which read shapes, dtypes and devices only (so they run
    on fake tensors too): (B, H2, W2, Cx, F, dtype) or a raise."""
    B, H, W, cx = x.shape
    f = w1.shape[0]
    H2, W2 = 2 * H, 2 * W
    if H2 % 8 or W2 % 16 or cx % 32 or f % 64:
        raise ValueError(f"upconv kernel: 2H={H2} % 8, 2W={W2} % 16, Cx={cx} "
                         f"% 32 and F={f} % 64 must all be 0")
    dt = _build.conv_dtype(x, "upconv")
    _build.check(x, "x", dt)
    _build.check(w1, "w1", dt, (f, cx, 3, 3), x.device)
    _build.check(w2, "w2", dt, (f, f, 3, 3), x.device)
    return B, H2, W2, cx, f, dt


def _upconv_cuda(x, w1, b1, w2, b2, want_y1=False):
    _build.no_grad_inputs("upconv", x, w1, b1, w2, b2)
    B, H2, W2, cx, f, dt = _upconv_check(x, w1, b1, w2, b2)
    f32 = dt == torch.float32
    up = _up2x_cuda(x)
    wt1, wt2 = _build.pack_weights([w1, w2], dt)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    y1 = torch.empty((B, H2, W2, f), dtype=dt, device=x.device)
    out = torch.empty_like(y1)
    _build.call("tu_upconv", up.data_ptr(), wt1.data_ptr(), b1f.data_ptr(), wt2.data_ptr(),
                b2f.data_ptr(), y1.data_ptr(), out.data_ptr(), B, H2, W2, cx, f, int(f32),
                stage_plan(B, H2, W2, 0, cx, f, f32).data_ptr())
    _build.launch_counts[_build.count_key("upconv", dt)] += 1
    return (out, y1) if want_y1 else out


@torch.library.custom_op("tpu_unet_torch::upconv", mutates_args=(),
                         schema="(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2)"
                                " -> Tensor")
def upconv_op(x, w1, b1, w2, b2):
    """#10's launches (the upsample, then the head's two convs) as an
    operator: what a traced forward on the card calls and
    ``torch.export`` keeps in its graph (``tools/export.py``); the
    launch's checks refuse tensors off the card."""
    return _upconv_cuda(x, w1, b1, w2, b2)


@upconv_op.register_fake
def _upconv_fake(x, w1, b1, w2, b2):
    B, H2, W2, cx, f, dt = _upconv_check(x, w1, b1, w2, b2)
    return x.new_empty((B, H2, W2, f), dtype=dt)


def upconv(x, w1, b1, w2, b2):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    for tensors on the card, through :func:`upconv_op` while traced (bf16,
    or float32 on TF32 products; 2H % 8, 2W % 16, Cx % 32 and F % 64 all
    0)."""
    if on_cpu(x):
        return upconv_plain(x, w1, b1, w2, b2)
    if _build.traced(x):
        _build.no_grad_inputs("upconv", x, w1, b1, w2, b2)
        return upconv_op(x, w1, b1, w2, b2)
    return _upconv_cuda(x, w1, b1, w2, b2)


def upconv_train_ok(H2: int, W2: int, cx: int, f: int) -> bool:
    """The training head's shape rule, in bf16 and float32 alike (the
    forward's, with Cx % 64 for the backward, whose conv1 dgrad writes Cx
    channels in N tiles of 64 or more, ``sm90.conv_tile_n``; float32's
    32-channel K slices would take Cx % 32 as input, not as output): 2H %
    8, 2W % 16, Cx % 64 and F % 64 all 0."""
    return not (H2 % 8 or W2 % 16 or cx % 64 or f % 64)


def upconv_bwd_plain(g, out, y1, x, w1, w2):
    """g, out, y1 (B, 2H, 2W, F), x (B, H, W, Cx), w1 (F, Cx, 3, 3),
    w2 (F, F, 3, 3) → (dx (B, H, W, Cx) in g's dtype, dk1, db1, dk2, db2 in
    float32): the VJP of :func:`upconv_plain` given its out and y1, which is
    what #12 computes (upconv.py:386-517) — the UnetUp stage backward with
    a zero-channel skip."""
    B, H2, W2, _ = g.shape
    skip = g.new_zeros((B, H2, W2, 0))
    return unetup_bwd_full_plain(g, out, y1, skip, x, w1, w2)[1:]


@functools.lru_cache(maxsize=16)
def bwd_plan(B: int, H2: int, W2: int, cx: int, f: int, f32: bool = False):
    """The launch records of #12 on the Hopper kernels
    (``sm90.upconv_bwd_launches``: conv2's masked dgrad, conv1's dgrad, the
    dk2 and dk1 GEMMs), the two GEMMs' split counts and the float32 words of
    the work area they share in turn, in bf16 or (``f32``) float32."""
    launches = sm90.upconv_bwd_launches(B, H2, W2, cx, f, f32)
    return (sm90.encode(launches), tuple(ln["nsplit"] for ln in launches[2:]),
            sm90.wgrad_work(launches[2:], f))


def _upconv_bwd_launch(g, out, y1, up, w1, w2):
    """``tu_upconv_bwd`` on the forward's out and y1 and a given ``up`` =
    up2x(x): (dx, dk1, db1, dk2, db2, dz1, dups), the last two the kernel's
    own intermediates, in g's dtype (bf16 or float32; the weight and bias
    gradients float32).  dups takes g2's memory: the kernel writes it after
    g2's last read."""
    B, H2, W2, f = g.shape
    cx = up.shape[-1]
    h, w, dev, dt = H2 // 2, W2 // 2, g.device, g.dtype
    f32 = dt == torch.float32
    plan, _, work_words = bwd_plan(B, H2, W2, cx, f, f32)
    aridx, arw, acidx, acw = _adjoint_tables(h, w, dev, dt)
    w2t, w1t = _build.pack_weights([w2, w1], dt, flip=True)
    n = B * H2 * W2
    g2_dups = torch.empty(n * max(f, cx), dtype=dt, device=dev)
    g2, dups = g2_dups[:n * f].view(g.shape), g2_dups[:n * cx].view(B, H2, W2, cx)
    dz1 = torch.empty_like(g)
    dx = torch.empty((B, h, w, cx), dtype=dt, device=dev)
    fl = dict(dtype=torch.float32, device=dev)
    work = torch.empty(work_words, **fl)
    dk1, db1 = torch.empty((f, cx, 3, 3), **fl), torch.empty(f, **fl)
    dk2, db2 = torch.empty((f, f, 3, 3), **fl), torch.empty(f, **fl)
    _build.call("tu_upconv_bwd", g.data_ptr(), out.data_ptr(), y1.data_ptr(), up.data_ptr(),
                aridx.data_ptr(), arw.data_ptr(), aridx.shape[1], acidx.data_ptr(),
                acw.data_ptr(), acidx.shape[1], w2t.data_ptr(), w1t.data_ptr(), g2.data_ptr(),
                dz1.data_ptr(), dups.data_ptr(), work.data_ptr(), dk1.data_ptr(),
                db1.data_ptr(), dk2.data_ptr(), db2.data_ptr(), dx.data_ptr(), B, H2, W2, cx, f,
                int(f32), plan.data_ptr())
    _build.launch_counts[_build.count_key("upconv_bwd", dt)] += 1
    return dx, dk1, db1, dk2, db2, dz1, dups


def _upconv_bwd_cuda(g, out, y1, x, w1, w2):
    _build.no_grad_inputs("upconv_bwd", g, out, y1, x, w1, w2)
    B, H2, W2, f = g.shape
    cx = x.shape[-1]
    if not upconv_train_ok(H2, W2, cx, f):
        raise ValueError(f"upconv_bwd kernel: 2H={H2} % 8, 2W={W2} % 16, Cx={cx} % 64 "
                         f"and F={f} % 64 must all be 0")
    dt = _build.conv_dtype(g, "upconv_bwd")
    _build.check(g, "g", dt)
    for t, name in ((out, "out"), (y1, "y1")):
        _build.check(t, name, dt, tuple(g.shape), g.device)
    _build.check(x, "x", dt, (B, H2 // 2, W2 // 2, cx), g.device)
    _build.check(w1, "w1", dt, (f, cx, 3, 3), g.device)
    _build.check(w2, "w2", dt, (f, f, 3, 3), g.device)
    return _upconv_bwd_launch(g, out, y1, _up2x_cuda(x), w1, w2)


def upconv_bwd(g, out, y1, x, w1, w2):
    """Dispatching wrapper of #12's port: plain version for CPU tensors, the
    CUDA kernel for tensors on the card (bf16, or float32 on TF32 products;
    :func:`upconv_train_ok`)."""
    if on_cpu(g):
        return upconv_bwd_plain(g, out, y1, x, w1, w2)
    return _upconv_bwd_cuda(g, out, y1, x, w1, w2)[:5]


class _UpconvTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        if on_cpu(x):
            out, y1 = _upconv_plain_y1(x, w1, b1, w2, b2)
        else:
            out, y1 = _upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
        ctx.save_for_backward(x, w1, b1, w2, b2, y1, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, y1, out = ctx.saved_tensors
        dx, dk1, db1, dk2, db2 = upconv_bwd(g.to(y1.dtype).contiguous(), out, y1, x, w1, w2)
        # cast as _t_bwd (upconv.py:574-575)
        return (dx.to(x.dtype), dk1.to(w1.dtype), db1.to(b1.dtype), dk2.to(w2.dtype),
                db2.to(b2.dtype))


def upconv_train(x, w1, b1, w2, b2):
    """The head for training (``fused_upconv_train``, upconv.py:544-578):
    the forward as :func:`upconv` keeping y1, the backward through
    :func:`upconv_bwd` (#12).  JAX's column-paired output is the free
    reshape of this one's natural (B, 2H, 2W, F).  CPU tensors take the
    plain versions both ways."""
    return _UpconvTrain.apply(x, w1, b1, w2, b2)
