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
- the blocks of the last eight registry models (JAX ``nn/blocks.py:269-299,
  380-685``): ``DWSeparableBNReLU`` / ``DWConvBNReLU`` (the latter with an
  explicit padding and a dilation, AtrousConvBlock's), ``SKConv`` /
  ``LightSKBlock``, ``RepVGGBlock`` (and its deploy form) / ``FusedMBConv``
  / ``RepVGGStem``, ``STDCBlock`` / ``DecoderBlock``, the attention blocks
  (``ChannelAttention``, ``SpatialAttention``, ``CBAM``,
  ``LightweightSpatialAttention``, ``CRFSAttention``,
  ``EfficientAttention``, ``EfficientDecoderBlock``), and
  ``EdgeEnhancementBlock``, ``OptimizedMultiScaleBlock``, ``FeatureFusion``:
  plain PyTorch, as the JAX package runs them outside any Pallas kernel;
  parameter names of the reference torch modules, as JAX's bridge
  (``tpu_unet/infer/convert.py``) reads them; :func:`conv1x1`, a model's
  1×1 head as a matmul;
- the ceil-mode max-pool of the ResNet50 stem; :func:`bn`, the batch norm
  every block with batch norm shares (``train`` as flax's
  ``nn.BatchNorm(use_running_average=not train)``, ``nn/blocks.py:40-52``);
  :func:`dropout2d`, flax's ``nn.Dropout(broadcast_dims=(1, 2))``.

Every block with batch norm takes ``train`` (JAX's ``__call__(x, train)``).
NHWC activations in and out.  Inside a block the NHWC tensor is handed to
cuDNN as a channels-last NCHW view (``permute``, no copy).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_unet_torch.kernels._plain import max_pool2x2
from tpu_unet_torch.kernels.decoder_fuse import (unetup, unetup_plain, unetup_train,
                                                 unetup_train_full)
from tpu_unet_torch.kernels.decoder_train import stage_shape_ok
from tpu_unet_torch.nn.resize import resize_bilinear, upsample2x

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


def conv1x1(conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    """A 1×1 conv with bias (a classifier or lateral head) of NHWC ``h``
    as a matmul in ``h``'s dtype."""
    w = conv.weight.reshape(conv.out_channels, -1)
    return h @ w.t().to(h.dtype) + conv.bias.to(h.dtype)


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


def _conv(cin: int, cout: int, kernel: int = 3, stride: int = 1, padding=None,
          bias: bool = True, groups: int = 1, dilation: int = 1) -> nn.Conv2d:
    """``nn.Conv2d`` with JAX ``nn/blocks.py::conv``'s default padding,
    ``(kernel - 1) // 2 · dilation``."""
    if padding is None:
        padding = (kernel - 1) // 2 * dilation
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation, groups, bias)


def _bn2d(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


# ---------------------------------------------------------------------------
# The depthwise-separable family with batch norm
# ---------------------------------------------------------------------------

class DWSeparableBNReLU(nn.Module):
    """Depthwise 3×3 (+bias) → pointwise 1×1 (+bias) → BN → ReLU
    (reference: nets/HybridEfficientSeg.py:6-21); keys ``depthwise``,
    ``pointwise``, ``bn``."""

    def __init__(self, in_size: int, out_size: int, stride: int = 1, *, kernel: int = 3,
                 padding=None, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.depthwise = _conv(in_size, in_size, kernel, stride, padding, bias=bias,
                               groups=in_size, dilation=dilation)
        self.pointwise = _conv(in_size, out_size, 1, bias=bias)
        self.bn = _bn2d(out_size)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.pointwise(self.depthwise(_nchw(x)))
        return _nhwc(torch.relu(bn(y, self.bn, train)))


class DWConvBNReLU(DWSeparableBNReLU):
    """Bias-free depthwise (explicit ``padding``, ``dilation``) → pointwise
    → BN → ReLU (reference: nets/SegNets.py:270-285 LightweightConvBlock;
    with a dilation, AtrousConvBlock, :252-267); the same keys."""

    def __init__(self, in_size: int, out_size: int, kernel: int = 3, stride: int = 1,
                 padding=None, dilation: int = 1):
        super().__init__(in_size, out_size, stride, kernel=kernel, padding=padding,
                         dilation=dilation, bias=False)


# ---------------------------------------------------------------------------
# Selective kernel
# ---------------------------------------------------------------------------

class SKConv(nn.Module):
    """Selective-kernel conv (reference: nets/SK_UltraLightweightUnet.py:26-64):
    M grouped bias-free 3×3 convs at dilation 1..M (+BN+ReLU) → sum → global
    average pool → 1×1 (+BN+ReLU) to ``d = max(c_in // r, L)`` → 1×1 to M·C →
    softmax over the M branches of the ``(N, M, C)`` reshape → the weighted
    sum.  The group count is JAX's clamp ``gcd(groups, gcd(c_in,
    features))`` (the reference's fixed 32 does not construct at these
    widths).  Keys ``conv.{i}.{0,1}``, ``fc1.{0,1}``, ``fc2``."""

    def __init__(self, in_size: int, features: int, M: int = 2, r: int = 16, L: int = 32,
                 groups: int = 32):
        super().__init__()
        d = max(in_size // r, L)
        g = math.gcd(groups, math.gcd(in_size, features))
        self.M, self.features = M, features
        self.conv = nn.ModuleList(
            nn.Sequential(_conv(in_size, features, 3, bias=False, groups=g, dilation=1 + i),
                          _bn2d(features), nn.ReLU(inplace=True))
            for i in range(M))
        self.fc1 = nn.Sequential(_conv(features, d, 1, bias=False), _bn2d(d),
                                 nn.ReLU(inplace=True))
        self.fc2 = _conv(d, features * M, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xc = _nchw(x)
        branches = [torch.relu(bn(s[0](xc), s[1], train)) for s in self.conv]
        u = sum(branches)
        s = u.mean(dim=(2, 3), keepdim=True)
        z = torch.relu(bn(self.fc1[0](s), self.fc1[1], train))
        ab = torch.softmax(self.fc2(z).reshape(x.shape[0], self.M, self.features), dim=1)
        out = sum(b * ab[:, i, :, None, None] for i, b in enumerate(branches))
        return _nhwc(out)


class LightSKBlock(nn.Module):
    """1×1 (+bias) + BN + ReLU → SKConv → BN → ReLU, ``mid = max(16,
    features // 2)`` (reference: nets/SK_UltraLightweightUnet.py:66-83);
    keys ``conv1.{0,1}``, ``sk_conv``, ``bn``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        mid = max(16, features // 2)
        self.conv1 = nn.Sequential(_conv(in_size, mid, 1), _bn2d(mid), nn.ReLU(inplace=True))
        self.sk_conv = SKConv(mid, features)
        self.bn = _bn2d(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = _nhwc(torch.relu(bn(self.conv1[0](_nchw(x)), self.conv1[1], train)))
        y = self.sk_conv(y, train)
        return _nhwc(torch.relu(bn(_nchw(y), self.bn, train)))


# ---------------------------------------------------------------------------
# RepVGG
# ---------------------------------------------------------------------------

class RepVGGBlock(nn.Module):
    """Training form: bias-free 3×3 + BN ∥ bias-free 1×1 + BN ∥ identity BN
    (only where ``c_in == features``), summed, ReLU; deploy form: one biased
    3×3 ``reparam`` conv + ReLU (reference: nets/RepVGG_Unet.py:26-98).
    ``models/repvgg.py::fold_repvgg`` maps the one's state dict to the
    other's.  Keys ``conv1`` (3×3), ``bn1``, ``conv2`` (1×1), ``bn2``,
    ``id_bn``; deployed ``reparam``."""

    def __init__(self, in_size: int, features: int, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.reparam = _conv(in_size, features, 3)
            return
        self.conv1 = _conv(in_size, features, 3, bias=False)
        self.bn1 = _bn2d(features)
        self.conv2 = _conv(in_size, features, 1, bias=False)
        self.bn2 = _bn2d(features)
        self.id_bn = _bn2d(in_size) if in_size == features else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xc = _nchw(x)
        if self.deploy:
            return _nhwc(torch.relu(self.reparam(xc)))
        y = bn(self.conv1(xc), self.bn1, train) + bn(self.conv2(xc), self.bn2, train)
        if self.id_bn is not None:
            y = y + bn(xc, self.id_bn, train)
        return _nhwc(torch.relu(y))


class FusedMBConv(nn.Module):
    """Bias-free 3×3 expand (+BN + ReLU6, ``min(relu(x), 6)``) → bias-free 1×1
    project (+BN), + the input where the shapes match (reference:
    nets/RepVGG_Unet.py:101-123); keys ``expand``, ``bn1``, ``project``,
    ``bn2``."""

    def __init__(self, in_size: int, features: int, expansion: int = 4):
        super().__init__()
        self.expand = _conv(in_size, in_size * expansion, 3, bias=False)
        self.bn1 = _bn2d(in_size * expansion)
        self.project = _conv(in_size * expansion, features, 1, bias=False)
        self.bn2 = _bn2d(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.clamp_max(torch.relu(bn(self.expand(_nchw(x)), self.bn1, train)), 6.0)
        y = _nhwc(bn(self.project(y), self.bn2, train))
        return y + x if y.shape == x.shape else y


class RepVGGStem(nn.Module):
    """1×1 (+bias) + BN + ReLU → RepVGGBlock (or FusedMBConv), ``mid =
    max(16, features // 2)`` (reference: nets/RepVGG_Unet.py:126-147
    LightweightConvBlock); keys ``conv.{0,1}``, ``conv.3.*``."""

    def __init__(self, in_size: int, features: int, use_repvgg: bool = True,
                 deploy: bool = False):
        super().__init__()
        mid = max(16, features // 2)
        block = RepVGGBlock(mid, features, deploy) if use_repvgg else FusedMBConv(mid, features)
        self.conv = nn.Sequential(_conv(in_size, mid, 1), _bn2d(mid), nn.ReLU(inplace=True),
                                  block)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(bn(self.conv[0](_nchw(x)), self.conv[1], train))
        return self.conv[3](_nhwc(y), train)


# ---------------------------------------------------------------------------
# STDC / decoder blocks
# ---------------------------------------------------------------------------

class STDCBlock(nn.Module):
    """Two chained DWSeparableBNReLU to ``features // 2`` whose outputs are
    concatenated, + the input (through a DWSeparableBNReLU ``skip`` where
    the stride or width changes), then SE at ``max(se_floor, features //
    4)`` (reference: nets/HybridEfficientSeg.py:44-71); keys ``conv1``,
    ``conv2``, ``skip``, ``se``."""

    def __init__(self, in_size: int, features: int, stride: int = 1, se_floor: int = 8):
        super().__init__()
        mid = features // 2
        self.conv1 = DWSeparableBNReLU(in_size, mid, stride)
        self.conv2 = DWSeparableBNReLU(mid, mid)
        self.skip = DWSeparableBNReLU(in_size, features, stride) \
            if stride > 1 or in_size != features else None
        self.se = SE(features, max(se_floor, features // 4))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        o1 = self.conv1(x, train)
        out = torch.cat([o1, self.conv2(o1, train)], dim=-1)
        identity = x if self.skip is None else self.skip(x, train)
        return self.se(out + identity)


class DecoderBlock(nn.Module):
    """concat [x, skip] → DWSeparableBNReLU ×2 → SE at ``max(8, features //
    4)`` unless ``se_reduced`` (reference: nets/HybridEfficientSeg.py:74-90);
    keys ``conv.{0,1}``, ``se``."""

    def __init__(self, in_size: int, features: int, se_reduced=None):
        super().__init__()
        self.conv = nn.Sequential(DWSeparableBNReLU(in_size, features),
                                  DWSeparableBNReLU(features, features))
        self.se = SE(features, se_reduced if se_reduced is not None
                     else max(8, features // 4))

    def forward(self, x: torch.Tensor, skip=None, train: bool = False) -> torch.Tensor:
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.se(self.conv[1](self.conv[0](x, train), train))


# ---------------------------------------------------------------------------
# Attention blocks (CBAM / spatial / CRFS / efficient)
# ---------------------------------------------------------------------------

class ChannelAttention(nn.Module):
    """The gate ``sigmoid(mlp(avg) + mlp(max))`` over the global average and
    max pools, a shared bias-free MLP (reference: nets/SegNets.py:158-176);
    keys ``shared_mlp.{0,2}``.  Returns the (N, 1, 1, C) gate."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.shared_mlp = nn.Sequential(nn.Linear(channels, reduced, bias=False),
                                        nn.ReLU(inplace=True),
                                        nn.Linear(reduced, channels, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1, fc2 = self.shared_mlp[0], self.shared_mlp[2]
        avg = fc2(torch.relu(fc1(x.mean(dim=(1, 2)))))
        mx = fc2(torch.relu(fc1(x.amax(dim=(1, 2)))))
        return torch.sigmoid(avg + mx)[:, None, None, :]


class SpatialAttention(nn.Module):
    """[mean over channels, max over channels] → 7×7 conv to one channel →
    sigmoid (reference: nets/SegNets.py:179-190), bias-free in CBAM; key
    ``conv``.  Returns the (N, H, W, 1) gate."""

    def __init__(self, kernel: int = 7, use_bias: bool = False):
        super().__init__()
        self.conv = _conv(2, 1, kernel, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], dim=-1)
        return _nhwc(torch.sigmoid(self.conv(_nchw(y))))


class CBAM(nn.Module):
    """x · channel gate, then · spatial gate, the channel MLP at ``C //
    reduction`` (reference: nets/SegNets.py:193-203); keys ``channel``,
    ``spatial``.  No registry model runs it (the reference builds it in
    OptimizedBalancedSeg and never applies it)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.channel = ChannelAttention(channels, channels // reduction)
        self.spatial = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.channel(x)
        return x * self.spatial(x)


class LightweightSpatialAttention(SpatialAttention):
    """x · the spatial gate, its 7×7 conv with a bias (reference:
    nets/SegNets.py:310-322); key ``conv``."""

    def __init__(self, kernel: int = 7):
        super().__init__(kernel, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * super().forward(x)


class CRFSAttention(nn.Module):
    """Bias-free 1×1 ``theta`` and ``phi`` to ``C // reduction`` → sigmoid of
    their sum → 1×1 to one channel → ``sigmoid(x · attn)`` (reference:
    nets/SegNets.py:206-232, the outer sigmoid included).  ``conv_g``'s
    weights exist, as the reference's, and take no part in the output.
    Keys ``conv_theta``, ``conv_phi``, ``conv_g``, ``conv_attn``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        d = channels // reduction
        self.conv_theta = _conv(channels, d, 1, bias=False)
        self.conv_phi = _conv(channels, d, 1, bias=False)
        self.conv_g = _conv(channels, d, 1, bias=False)
        self.conv_attn = _conv(d, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = _nchw(x)
        attn = self.conv_attn(torch.sigmoid(self.conv_theta(xc) + self.conv_phi(xc)))
        return torch.sigmoid(x * _nhwc(attn))


class EfficientAttention(ChannelAttention):
    """x · the channel gate at ``max(8, C // reduction)`` (reference:
    nets/SegNets.py:394-414); keys ``shared_mlp.{0,2}``."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__(channels, max(8, channels // reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * super().forward(x)


class EfficientDecoderBlock(nn.Module):
    """concat [x, skip] → DWConvBNReLU ×2 → channel attention → spatial
    attention (reference: nets/SegNets.py:417-435); keys ``conv.{0,1}``,
    ``channel_attention``, ``spatial_attention``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(DWConvBNReLU(in_size, features),
                                  DWConvBNReLU(features, features))
        self.channel_attention = EfficientAttention(features)
        self.spatial_attention = LightweightSpatialAttention()

    def forward(self, x: torch.Tensor, skip=None, train: bool = False) -> torch.Tensor:
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        x = self.conv[1](self.conv[0](x, train), train)
        return self.spatial_attention(self.channel_attention(x))


# ---------------------------------------------------------------------------
# Multi-scale / edge / fusion
# ---------------------------------------------------------------------------

class EdgeEnhancementBlock(nn.Module):
    """Bias-free 3×3 to ``features // 2`` + BN + ReLU → bias-free 1×1 to
    ``features`` + BN + ReLU (reference: nets/SegNets.py:234-249); keys
    ``conv.{0,1,3,4}``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(
            _conv(in_size, features // 2, 3, bias=False), _bn2d(features // 2),
            nn.ReLU(inplace=True), _conv(features // 2, features, 1, bias=False),
            _bn2d(features), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.conv
        y = torch.relu(bn(s[0](_nchw(x)), s[1], train))
        return _nhwc(torch.relu(bn(s[3](y), s[4], train)))


class OptimizedMultiScaleBlock(nn.Module):
    """1×1 (+bias) to ``half = (features // 4) · 2`` → two DWConvBNReLU
    branches: one conv, and two whose second pads by 2 (its map grows by 2
    pixels and is resized back to the first branch's size, align corners)
    → concat (reference: nets/SegNets.py:288-307); keys ``reduce``,
    ``branch1``, ``branch2.{0,1}``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        half = (features // 4) * 2
        self.reduce = _conv(in_size, half, 1)
        self.branch1 = DWConvBNReLU(half, half)
        self.branch2 = nn.Sequential(DWConvBNReLU(half, half),
                                     DWConvBNReLU(half, half, padding=2))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _nhwc(self.reduce(_nchw(x)))
        b1 = self.branch1(x, train)
        b2 = self.branch2[1](self.branch2[0](x, train), train)
        b2 = resize_bilinear(b2, b1.shape[1:3], align_corners=True)
        return torch.cat([b1, b2], dim=-1)


class FeatureFusion(nn.Module):
    """concat [a, b] → 1×1 (+bias) → SE at ``se_light`` (reference:
    nets/ImprovedUltraLightweightUnet.py:55-65); keys ``conv1x1``, ``se``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        self.conv1x1 = _conv(in_size, features, 1)
        self.se = SE(features, se_light(features))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([a, b], dim=-1)
        return self.se(_nhwc(self.conv1x1(_nchw(x))))
