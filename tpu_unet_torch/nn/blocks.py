"""Shared blocks of the port's models (counterpart of ``tpu_unet/nn/blocks.py``).

- ``UnetUp``: the canonical UNet's decoder block (×2 align-corners upsample
  of the deep feature, concat [skip, up], two 3×3 conv + ReLU, no batch
  norm; parameter names of the reference torch module, ``conv1``,
  ``conv2``), on the ``unetup`` kernel; in training (``train=True``) routed
  by ``route`` (``train/step.py::StepConfig.train_route``): ``"paired"``
  (JAX's ``PAIRED_TRAIN=1``, its TPU default, which gives up1 the paired
  stage and up2-up4 the wide one, blocks.py:195-236) trains every stage the
  stage kernels tile through ``unetup_train_full`` (kernel forward, the
  whole stage backward #14-#19); ``"fused"`` (``FUSED_TRAIN=1``) gives every
  F < 128 stage ``unetup_train`` (kernel forward, #13 backward); any other
  stage runs the plain composition under autograd;
- ``DoubleConv``, ``Down``, ``Up``: the TraditionalUnet blocks,
  (3×3 conv → batch norm → ReLU) ×2, behind a 2×2 max-pool or an
  upsample + concat.  The JAX package runs them outside any Pallas kernel,
  so they are plain PyTorch here: ``F.conv2d`` on channels-last views of
  the NHWC tensors, batch norm through :func:`bn`;
- ``ConvBNReLU``, ``DWSeparable``, ``LightConvBlock``, ``SE`` (and its
  width rules ``se_quarter``, ``se_light``, ``se_light_large``,
  ``se_lightweight``) and ``ResidualBlock``: the blocks of the ladder
  family and of ``lightweight`` (JAX ``nn/blocks.py:96-105, 254-373``),
  plain PyTorch as the JAX package runs them outside any Pallas kernel;
  parameter names of the reference torch modules;
- the ceil-mode max-pool of the ResNet50 stem; :func:`bn`, the batch norm
  every block with batch norm shares (``train`` as flax's
  ``nn.BatchNorm(use_running_average=not train)``, ``nn/blocks.py:40-52``);
  :func:`dropout2d`, flax's ``nn.Dropout(broadcast_dims=(1, 2))``.

Every block with batch norm takes ``train`` (JAX's ``__call__(x, train)``).
NHWC activations in and out.  Inside a block the NHWC tensor is handed to
cuDNN as a channels-last NCHW view (``permute``, no copy).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.kernels.decoder_fuse import (unetup, unetup_plain, unetup_train,
                                                 unetup_train_full)
from tpu_unet_torch.kernels.decoder_train import stage_shape_ok
from tpu_unet_torch.nn.resize import upsample2x

# torch BN defaults, as the JAX package uses them: new = 0.9·old + 0.1·batch
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def bn(x: torch.Tensor, module: nn.BatchNorm2d, train: bool = False) -> torch.Tensor:
    """Batch norm of NCHW ``x`` with ``module``'s parameters, whatever the
    module's own mode.  Eval: the running statistics.  Train, as flax's
    ``nn.BatchNorm`` (``_compute_stats`` / ``_normalize``): the batch mean
    and the biased variance E[x²]−E[x]² (clipped at 0) over (N, H, W),
    which also update the running statistics in place (0.9·old + 0.1·batch,
    outside autograd; ``F.batch_norm`` would update them with the unbiased
    variance); statistics and normalisation in ``x``'s dtype promoted to at
    least float32 (float32 for bf16 or float32 input, float64 for float64,
    as flax computes them), the output in ``x``'s dtype.  The running
    statistics keep the module's dtype."""
    if not train:
        if x.is_cuda or x.dtype == module.running_mean.dtype:
            return F.batch_norm(x, module.running_mean, module.running_var, module.weight,
                                module.bias, False, 0.0, module.eps)
        # the CPU's batch_norm takes no bf16 input with float32 statistics
        return F.batch_norm(x.float(), module.running_mean, module.running_var,
                            module.weight.float(), module.bias.float(), False, 0.0,
                            module.eps).to(x.dtype)
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        for buf, stat in ((module.running_mean, mean), (module.running_var, var)):
            buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * stat)
    mul = torch.rsqrt(var + module.eps) * module.weight.to(dt)
    y = (xf - mean[:, None, None]) * mul[:, None, None] + module.bias.to(dt)[:, None, None]
    return y.to(x.dtype)


def dropout2d(x: torch.Tensor, p: float, generator: torch.Generator | None = None,
              train: bool = True) -> torch.Tensor:
    """Dropout2d of NHWC ``x`` (flax's ``nn.Dropout(p, broadcast_dims=(1,
    2))``): each (image, channel) is kept with probability 1 − p, where
    uniform < 1 − p, and scaled by 1 / (1 − p), or zeroed whole.  The
    identity in eval or at p = 0.  ``generator`` (on ``x``'s device) draws
    the (N, C) uniforms; ``None`` takes the default one."""
    if not train or p == 0.0:
        return x
    keep = 1.0 - p
    u = torch.rand((x.shape[0], 1, 1, x.shape[-1]), generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def max_pool_ceil(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max-pool of NHWC ``x`` with ``ceil_mode=True`` and no padding
    (reference: nets/resnet.py:113).  The JAX package pads the right and
    bottom edges with -inf up to the ceil size; torch's ceil mode takes the
    maximum over the valid part of the last window, which is the same."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


class UnetUp(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_size, out_size, kernel_size=3, padding=1)
        self.conv2 = nn.Conv2d(out_size, out_size, kernel_size=3, padding=1)

    def forward(self, skip: torch.Tensor, x: torch.Tensor, train: bool = False,
                route: str = "paired") -> torch.Tensor:
        args = (skip, x, self.conv1.weight, self.conv1.bias, self.conv2.weight,
                self.conv2.bias)
        if not train:
            return unetup(*args)
        f, cs = self.conv1.out_channels, skip.shape[-1]
        if route == "fused":
            # decoder_fuse.py::_train_kernel_ok: the kernel pair for F < 128
            ok = f < 128 and cs % 2 == 0 and f % 8 == 0
            return unetup_train(*args) if ok else unetup_plain(*args)
        if stage_shape_ok(skip.shape[1], skip.shape[2], f, cs + x.shape[-1], cs):
            return unetup_train_full(*args)
        return unetup_plain(*args)


class DoubleConv(nn.Module):
    """(3×3 conv → BN → ReLU) ×2 (reference: nets/TraditionalUnet.py:5-18).
    ``double_conv`` is the reference ``nn.Sequential`` (convs at 0 and 3,
    batch norms at 1 and 4), so the state dict has its key names; the
    forward calls the convs and :func:`bn` itself."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_size, out_size, kernel_size=3, padding=1),
            nn.BatchNorm2d(out_size, eps=BN_EPS), nn.ReLU(inplace=True),
            nn.Conv2d(out_size, out_size, kernel_size=3, padding=1),
            nn.BatchNorm2d(out_size, eps=BN_EPS), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.double_conv
        y = x.permute(0, 3, 1, 2)  # channels-last view, no copy
        for conv, norm in ((s[0], s[1]), (s[3], s[4])):
            y = torch.relu(bn(conv(y), norm, train))
        return y.permute(0, 2, 3, 1).contiguous()


class Down(nn.Module):
    """2×2 max-pool → DoubleConv (reference: nets/TraditionalUnet.py:21-30);
    keys ``maxpool_conv.1.*``."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_size, out_size))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.maxpool_conv[1](max_pool2x2(x), train)


class Up(nn.Module):
    """×2 align-corners upsample of the deep ``x`` → concat [skip, up] →
    DoubleConv (reference: nets/TraditionalUnet.py:33-42); keys ``conv.*``.
    The argument order is the JAX block's, ``(x, skip)``."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv = DoubleConv(in_size, out_size)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(torch.cat([skip, upsample2x(x)], dim=-1), train)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    """conv → BN → ReLU (reference ConvBlock, nets/LightWeightUnet.py:5-15);
    keys ``conv.0`` (conv), ``conv.1`` (batch norm)."""

    def __init__(self, in_size: int, out_size: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_size, out_size, kernel, padding=(kernel - 1) // 2),
            nn.BatchNorm2d(out_size, eps=BN_EPS), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _nhwc(torch.relu(bn(self.conv[0](_nchw(x)), self.conv[1], train)))


class DWSeparable(nn.Module):
    """Depthwise 3×3 (``groups`` = channels, with bias) → pointwise 1×1
    (with bias), no norm (reference: nets/UltraLightweightUnet.py:6-16)."""

    def __init__(self, in_size: int, out_size: int, kernel: int = 3):
        super().__init__()
        self.depthwise = nn.Conv2d(in_size, in_size, kernel,
                                   padding=(kernel - 1) // 2, groups=in_size)
        self.pointwise = nn.Conv2d(in_size, out_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.pointwise(self.depthwise(_nchw(x))))


class LightConvBlock(nn.Module):
    """1×1 reduce → BN/ReLU → DWSeparable → BN/ReLU (reference:
    nets/UltraLightweightUnet.py:19-35), ``mid = max(mid_floor,
    features // 2)``; keys ``conv.0``, ``conv.1``, ``conv.3.depthwise``,
    ``conv.3.pointwise``, ``conv.4``."""

    def __init__(self, in_size: int, features: int, mid_floor: int = 8):
        super().__init__()
        mid = max(mid_floor, features // 2)
        self.conv = nn.Sequential(
            nn.Conv2d(in_size, mid, 1), nn.BatchNorm2d(mid, eps=BN_EPS),
            nn.ReLU(inplace=True), DWSeparable(mid, features),
            nn.BatchNorm2d(features, eps=BN_EPS), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.conv
        y = torch.relu(bn(s[0](_nchw(x)), s[1], train))
        dw = s[3]
        y = dw.pointwise(dw.depthwise(y))
        return _nhwc(torch.relu(bn(y, s[4], train)))


class SE(nn.Module):
    """Squeeze-excitation: global average pool → Linear(reduced) → ReLU →
    Linear(C) → sigmoid → scale (reference: nets/LightWeightUnet.py:19-33
    and its flavours); keys ``fc.0``, ``fc.2``."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, reduced), nn.ReLU(inplace=True),
                                nn.Linear(reduced, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(1, 2))
        y = torch.sigmoid(self.fc[2](torch.relu(self.fc[0](y))))
        return x * y[:, None, None, :]


def se_quarter(c: int) -> int:
    return c // 4


def se_light(c: int) -> int:
    return max(4, c // 8)


def se_light_large(c: int) -> int:
    return max(8, c // 4)


def se_lightweight(c: int, reduction: int = 8) -> int:
    return max(8, c // reduction)


class ResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN-SE + residual + ReLU, 3×3 convs with bias
    (reference: nets/LightWeightUnet.py:36-57); keys ``conv1``, ``bn1``,
    ``conv2``, ``bn2``, ``se.fc.{0,2}``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels, eps=BN_EPS)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels, eps=BN_EPS)
        self.se = SE(channels, se_quarter(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(bn(self.conv1(_nchw(x)), self.bn1, train))
        y = _nhwc(bn(self.conv2(y), self.bn2, train))
        return torch.relu(self.se(y) + x)
