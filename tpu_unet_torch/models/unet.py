"""Canonical UNet with the VGG16 or ResNet50 encoder (counterpart of
``tpu_unet/models/unet.py``).  NHWC in and out; module names follow the
reference torch model (``vgg`` / ``resnet``, ``up_concat1..4``, ``up_conv``,
``final``).

``forward(x, features_out, train, generator, route)``: ``train=True`` is
the training forward, routed by ``route``
(``train/step.py::StepConfig.train_route``) as JAX's training switches
route ``Unet.__call__`` (models/unet.py:56-121): under ``"paired"`` the
VGG16 stages through their training kernels (``models/backbones.py::VGG16``),
every decoder stage through ``unetup_train_full`` and the ``up_conv`` head
through ``upconv_train`` (#10 forward, #12 backward), each where the
kernels tile its shape; under ``"fused"`` the VGG16 encoder as a plain
composition under autograd, up1 through ``unetup_train``, up2-up4 and the
head plain (``nn/blocks.py::UnetUp``; JAX's head under XLA autodiff,
models/unet.py:115-119).  The ResNet50 encoder trains plain under autograd
on both routes, batch norm on the batch statistics, as JAX runs it outside
any Pallas kernel.

The ResNet50 UNet, and ``self_net`` (VGG16 with ``force_up_conv``), end in
the ``up_conv`` head (reference: nets/unet.py:47-54): ×2 align-corners
upsample, two 3×3 conv(64) + ReLU.  Its convs carry the reference keys
``up_conv.1`` and ``up_conv.3``; the forward hands their weights to the
``upconv`` kernel wrapper instead of running the Sequential.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_unet_torch.kernels.upconv import upconv, upconv_plain, upconv_train, upconv_train_ok
from tpu_unet_torch.models.backbones import VGG16, ResNet50
from tpu_unet_torch.nn.blocks import UnetUp

# decoder output widths (reference: nets/unet.py:27-35)
_OUT_FILTERS = (64, 128, 256, 512)
# decoder input widths: [skip, up] concat of each stage, up1 … up4
_IN_FILTERS = {"vgg": (192, 384, 768, 1024), "resnet50": (192, 512, 1024, 3072)}


class Unet(nn.Module):
    def __init__(self, num_classes: int = 21, backbone: str = "vgg",
                 force_up_conv: bool = False):
        super().__init__()
        if backbone not in _IN_FILTERS:
            raise ValueError(f"Unsupported backbone `{backbone}`, use vgg or "
                             "resnet50.")
        self.num_classes = num_classes
        self.backbone = backbone
        if backbone == "vgg":
            self.vgg = VGG16()
        else:
            self.resnet = ResNet50()
        in_filters = _IN_FILTERS[backbone]
        self.up_concat4 = UnetUp(in_filters[3], _OUT_FILTERS[3])
        self.up_concat3 = UnetUp(in_filters[2], _OUT_FILTERS[2])
        self.up_concat2 = UnetUp(in_filters[1], _OUT_FILTERS[1])
        self.up_concat1 = UnetUp(in_filters[0], _OUT_FILTERS[0])
        self.up_conv = None
        if backbone == "resnet50" or force_up_conv:
            f = _OUT_FILTERS[0]
            self.up_conv = nn.Sequential(
                nn.UpsamplingBilinear2d(scale_factor=2),
                nn.Conv2d(f, f, kernel_size=3, padding=1), nn.ReLU(),
                nn.Conv2d(f, f, kernel_size=3, padding=1), nn.ReLU())
        self.final = nn.Conv2d(_OUT_FILTERS[0], num_classes, 1)

    def forward(self, x: torch.Tensor, features_out: bool = False,
                train: bool = False, generator: torch.Generator | None = None,
                route: str = "paired"):
        """(B, H, W, 3) → logits (B, H', W', C); with ``features_out`` the
        (B, H', W', 64) features before ``final``, for the fused tail
        (``kernels/postprocess.py``) or the fused loss
        (``kernels/loss.py``) that applies ``final`` itself.  H' = H,
        except for ``self_net``, whose head doubles it.  ``generator`` is
        unused (no dropout); ``route`` is the training route
        (``train/step.py::StepConfig.train_route``)."""
        if self.backbone == "vgg":
            feats = self.vgg(x, train, route)
        else:
            feats = self.resnet(x, train)
        feat1, feat2, feat3, feat4, feat5 = feats
        up4 = self.up_concat4(feat4, feat5, train, route)
        up3 = self.up_concat3(feat3, up4, train, route)
        up2 = self.up_concat2(feat2, up3, train, route)
        up1 = self.up_concat1(feat1, up2, train, route)
        if self.up_conv is not None:
            c1, c2 = self.up_conv[1], self.up_conv[3]
            head = upconv
            if train:
                _, h, w, cx = up1.shape
                head = upconv_train if route == "paired" and upconv_train_ok(
                    2 * h, 2 * w, cx, c1.out_channels) else upconv_plain
            up1 = head(up1, c1.weight, c1.bias, c2.weight, c2.bias)
        if features_out:
            return up1
        w = self.final.weight.reshape(self.num_classes, -1)
        return up1 @ w.t().to(up1.dtype) + self.final.bias.to(up1.dtype)


def unet_vgg(num_classes: int = 21) -> Unet:
    return Unet(num_classes=num_classes, backbone="vgg")


def unet_resnet50(num_classes: int = 21) -> Unet:
    return Unet(num_classes=num_classes, backbone="resnet50")


def self_net(num_classes: int = 21) -> Unet:
    """Unet_vgg (reference: self_net().py:68-71): VGG16 + forced up_conv."""
    return Unet(num_classes=num_classes, backbone="vgg", force_up_conv=True)
