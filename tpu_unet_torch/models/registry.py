"""Model registry of the port (counterpart of ``tpu_unet/models/registry.py``).

All 18 models of the JAX registry: the canonical UNets (``unet_vgg``,
``unet_resnet50``, ``self_net``), the TraditionalUnet family
(``traditional``, ``traditional22``), ``lightweight``, the ladder family
(``ultralight``, ``ultralight_large``, ``ultralight_large_optimized``,
``ultralight44``, ``sk_ultralight``, ``repvgg_segnet``),
``improved_ultralight``, ``hybrid_efficientseg`` and the OptimizedBalancedSeg
family (``balancedseg``, ``balancedseg_fpn``, ``balancedseg_fpn_sup``,
``balancedseg_crfs``).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from tpu_unet_torch.models.balancedseg import (balancedseg, balancedseg_crfs,
                                               balancedseg_fpn, balancedseg_fpn_sup)
from tpu_unet_torch.models.hybrid import hybrid_efficientseg
from tpu_unet_torch.models.improved import improved_ultralight
from tpu_unet_torch.models.ladder import (repvgg_segnet, sk_ultralight, ultralight,
                                          ultralight44, ultralight_large,
                                          ultralight_large_optimized)
from tpu_unet_torch.models.lightweight import lightweight
from tpu_unet_torch.models.traditional import traditional, traditional22
from tpu_unet_torch.models.unet import self_net, unet_resnet50, unet_vgg

MODELS: Dict[str, Callable[..., nn.Module]] = {
    "unet_vgg": unet_vgg,
    "unet_resnet50": unet_resnet50,
    "self_net": self_net,
    "traditional": traditional,
    "traditional22": traditional22,
    "lightweight": lightweight,
    "ultralight": ultralight,
    "ultralight_large": ultralight_large,
    "ultralight_large_optimized": ultralight_large_optimized,
    "ultralight44": ultralight44,
    "improved_ultralight": improved_ultralight,
    "sk_ultralight": sk_ultralight,
    "repvgg_segnet": repvgg_segnet,
    "hybrid_efficientseg": hybrid_efficientseg,
    "balancedseg": balancedseg,
    "balancedseg_fpn": balancedseg_fpn,
    "balancedseg_fpn_sup": balancedseg_fpn_sup,
    "balancedseg_crfs": balancedseg_crfs,
}

# flax's lecun_normal: truncated normal on (-2, 2), stddev corrected for the
# truncation (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def build_model(name: str, num_classes: int, **kwargs) -> nn.Module:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](num_classes=num_classes, **kwargs)


def count_params(net: nn.Module) -> int:
    """Elements of the net's parameters; its buffers (batch norm's running
    statistics) are not counted, as JAX counts ``variables["params"]`` and
    not ``batch_stats`` (``tpu_unet/models/registry.py:84-86``)."""
    return sum(p.numel() for p in net.parameters())


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    out = rng.standard_normal(shape)
    bad = np.abs(out) >= 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) >= 2.0
    return out


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation as flax does it for these layers
    (``nn/blocks.py:152-156``): lecun-normal fan-in conv and dense kernels
    (fan-in ``prod(shape[1:])``: a Linear's inputs, with or without a bias,
    a grouped kernel's ``in / groups · kh · kw``, a depthwise kernel's 9
    taps, as flax counts them on its ``(3, 3, 1, C)`` kernel, the spatial
    attention's 7×7 over 2 channels 98), zero biases;
    batch norm as ``flax.linen.BatchNorm`` starts (scale 1, bias 0, mean 0,
    var 1).  Draws come from ``numpy.random.default_rng(seed)`` in
    conv-parameter order, so a seed gives the same weights on every
    machine."""
    rng = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # weight 1, bias 0, mean 0, var 1, count 0
            continue
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
                continue
            fan_in = int(np.prod(p.shape[1:]))
            std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
            vals = _truncated_normal(rng, tuple(p.shape)) * std
            p.copy_(torch.from_numpy(vals.astype(np.float32)))
    return model
