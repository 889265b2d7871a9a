"""The activation-gradient chain of one UnetUp decoder stage (counterpart of
``tpu_unet/kernels/decoder_train.py::fused_unetup_bwd_impl``):

    g2           = g · [out > 0]                       (conv2's ReLU)
    dz1          = conv3x3(g2, flipT(w2)) · [y1 > 0]   (conv2 dgrad, conv1's ReLU)
    [dskip|dups] = conv3x3(dz1, flipT(w1))            (conv1 dgrad, split at Cs)

with SAME 3×3 convs and no bias; ``flipT`` flips (ky, kx) and swaps the
input and output channels (decoder_train.py:55-57).

CUDA kernel: ``csrc/decoder_train.cu`` on the conv core
``csrc/conv3x3.cuh`` — replaces ``fused_unetup_bwd_impl`` (#13).  The
first conv masks g by out > 0 as its operand loader gathers it (and writes
g2 once), its epilogue masks by y1 > 0; the second conv's epilogue writes
the skip and up channels into two tensors.  Bound and design in the source
note.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights: OIHW (F, C, 3, 3) → (C, F, 3, 3), flipped in ky/kx."""
    return w.flip(2, 3).transpose(0, 1)


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
    if H2 % 8 or W2 % 16 or f % 64 or cp % 64 or cs % 8 or cx <= 0:
        raise ValueError(f"unetup_bwd kernel: 2H={H2} % 8, 2W={W2} % 16, F={f} "
                         f"% 64, Cs+Cx={cp} % 64 and Cs={cs} % 8 must all be 0")
    w2t = _build.pack_conv3x3(flip_t(w2))
    w1t = _build.pack_conv3x3(flip_t(w1))
    g2, dz1 = torch.empty_like(g), torch.empty_like(g)
    dskip = torch.empty((B, H2, W2, cs), dtype=bf, device=g.device)
    dups = torch.empty((B, H2, W2, cx), dtype=bf, device=g.device)
    _build.call("tu_unetup_bwd", g.data_ptr(), out.data_ptr(), y1.data_ptr(),
                w2t.data_ptr(), w1t.data_ptr(), g2.data_ptr(), dz1.data_ptr(),
                dskip.data_ptr(), dups.data_ptr(), B, H2, W2, cs, cx, f)
    _build.launch_counts["unetup_bwd"] += 1
    return dskip, dups, g2, dz1


def unetup_bwd(g, out, y1, w1, w2, cs: int):
    """Dispatching wrapper of #13: plain version for CPU tensors, the CUDA
    kernel for tensors on the card (bf16; 2H % 8, 2W % 16, F % 64,
    (Cs + Cx) % 64 and Cs % 8 all 0)."""
    if on_cpu(g):
        return unetup_bwd_plain(g, out, y1, w1, w2, cs)
    return _unetup_bwd_cuda(g, out, y1, w1, w2, cs)
