"""The ``up_conv`` head of ``unet_resnet50`` and ``self_net``, forward:
``relu(conv2(relu(conv1(up2x(x)))))`` with 3×3 SAME convs and no skip
(counterpart of ``tpu_unet/kernels/upconv.py``).

CUDA kernel: ``csrc/upconv.cu`` on the conv core ``csrc/conv3x3.cuh`` —
replaces ``upconv.py::fused_upconv_impl`` and ``_fused_upconv_call_p2``
(two TPU schedules of this function).  conv1's operand loader lerps the up
elements from x's four neighbours, so ``up2x(x)`` is never stored; conv1's
output goes through device memory to conv2.  Bound and design in the
source note.
"""
from __future__ import annotations

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import conv3x3_relu, on_cpu
from tpu_unet_torch.kernels.decoder_train import up2x_tables
from tpu_unet_torch.nn.resize import upsample2x


def upconv_plain(x, w1, b1, w2, b2):
    """x (B, H, W, Cx) → (B, 2H, 2W, F); mirrors ``reference_upconv``
    (upconv.py:36-47)."""
    return conv3x3_relu(conv3x3_relu(upsample2x(x), w1, b1), w2, b2)


def _upconv_cuda(x, w1, b1, w2, b2):
    _build.no_grad_inputs("upconv", x, w1, b1, w2, b2)
    B, H, W, cx = x.shape
    f = w1.shape[0]
    H2, W2 = 2 * H, 2 * W
    if H2 % 8 or W2 % 16 or cx % 32 or f % 64:
        raise ValueError(f"upconv kernel: 2H={H2} % 8, 2W={W2} % 16, Cx={cx} "
                         f"% 32 and F={f} % 64 must all be 0")
    _build.check(x, "x", torch.bfloat16)
    _build.check(w1, "w1", torch.bfloat16, (f, cx, 3, 3), x.device)
    _build.check(w2, "w2", torch.bfloat16, (f, f, 3, 3), x.device)
    ridx, rw, cidx, cw = up2x_tables(H, W, x.device)
    wt1, wt2 = _build.pack_conv3x3(w1), _build.pack_conv3x3(w2)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    y1 = torch.empty((B, H2, W2, f), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(y1)
    _build.call("tu_upconv", x.data_ptr(), ridx.data_ptr(), rw.data_ptr(),
                cidx.data_ptr(), cw.data_ptr(), wt1.data_ptr(), b1f.data_ptr(),
                wt2.data_ptr(), b2f.data_ptr(), y1.data_ptr(), out.data_ptr(),
                B, H2, W2, cx, f)
    _build.launch_counts["upconv"] += 1
    return out


def upconv(x, w1, b1, w2, b2):
    """Dispatching wrapper: plain version for CPU tensors, the CUDA kernel
    for tensors on the card (bf16; 2H % 8, 2W % 16, Cx % 32 and F % 64
    all 0)."""
    if on_cpu(x):
        return upconv_plain(x, w1, b1, w2, b2)
    return _upconv_cuda(x, w1, b1, w2, b2)
