"""Weight bridge: flax variables of ``tpu_unet`` → the port's state dict.

``tpu_unet/infer/convert.py::convert_unet`` read backwards: the caller hands
in the JAX variables as a nested dict of numpy arrays (so this package never
imports JAX), conv kernels go HWIO → OIHW, batch norm ``scale``/``bias``
become ``weight``/``bias`` and its ``batch_stats`` ``mean``/``var`` become
``running_mean``/``running_var`` (with ``num_batches_tracked`` 0), and the
keys are the reference torch names (``vgg.features.{i}``,
``resnet.layer{l}.{i}.conv{j}``, ``up_concat{i}.conv{1,2}``,
``up_conv.{1,3}``, ``final``; for the TraditionalUnet family
``convert_traditional`` read backwards: ``inc.double_conv.{0,1,3,4}``,
``down{i}.maxpool_conv.1.double_conv.*``, ``up{i}.conv.double_conv.*``,
``outc``), in the order of the torch model's state dict.  Load the result
with ``strict=True`` so every key is used.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from tpu_unet_torch.models.backbones import RESNET50_BLOCKS

_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# backbone and head of each bridged model
_MODELS = {"unet_vgg": ("vgg", False), "unet_resnet50": ("resnet50", True),
           "self_net": ("vgg", True)}
_TRADITIONAL = ("traditional", "traditional22")


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv(tree: Mapping, sd: dict, torch_key: str) -> None:
    k = np.asarray(tree["kernel"], np.float32)
    sd[f"{torch_key}.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    if "bias" in tree:
        sd[f"{torch_key}.bias"] = _f32(tree["bias"])


def _bn(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    sd[f"{torch_key}.weight"] = _f32(params["scale"])
    sd[f"{torch_key}.bias"] = _f32(params["bias"])
    sd[f"{torch_key}.running_mean"] = _f32(stats["mean"])
    sd[f"{torch_key}.running_var"] = _f32(stats["var"])
    sd[f"{torch_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resnet(params: Mapping, stats: Mapping, sd: dict) -> None:
    _conv(params["conv1"], sd, "resnet.conv1")
    _bn(params["bn1"], stats["bn1"], sd, "resnet.bn1")
    for li, blocks in enumerate(RESNET50_BLOCKS, start=1):
        for bi in range(blocks):
            fp, tp = f"layer{li}_{bi}", f"resnet.layer{li}.{bi}"
            p, s = params[fp], stats[fp]
            for ci in (1, 2, 3):
                _conv(p[f"conv{ci}"], sd, f"{tp}.conv{ci}")
                _bn(p[f"bn{ci}"], s[f"bn{ci}"], sd, f"{tp}.bn{ci}")
            if "downsample_0" in p:
                _conv(p["downsample_0"], sd, f"{tp}.downsample.0")
                _bn(p["downsample_1"], s["downsample_1"], sd,
                    f"{tp}.downsample.1")


def _double_conv(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """DoubleConv ``conv1/bn1/conv2/bn2`` → ``double_conv.{0,1,3,4}``."""
    for i, (c, b) in zip((0, 3), (("conv1", "bn1"), ("conv2", "bn2"))):
        _conv(params[c], sd, f"{torch_key}.double_conv.{i}")
        _bn(params[b], stats[b], sd, f"{torch_key}.double_conv.{i + 1}")


def _traditional(params: Mapping, stats: Mapping, sd: dict) -> None:
    _double_conv(params["inc"], stats["inc"], sd, "inc")
    for i in (1, 2, 3):
        d = f"down{i}"
        _double_conv(params[d]["conv"], stats[d]["conv"], sd, f"{d}.maxpool_conv.1")
    for i in (1, 2, 3):
        u = f"up{i}"
        _double_conv(params[u]["conv"], stats[u]["conv"], sd, f"{u}.conv")
    _conv(params["outc"], sd, "outc")


def state_dict_from_flax(variables_np: Mapping, model: str = "unet_vgg"):
    """Nested numpy dict (``{"params": {...}, "batch_stats": {...}}``, or
    the params tree itself for a model without batch norm) →
    ``OrderedDict`` of torch tensors in reference key names."""
    if model not in _MODELS and model not in _TRADITIONAL:
        raise ValueError(f"weight bridge covers {sorted((*_MODELS, *_TRADITIONAL))}, "
                         f"not {model!r}")
    params = variables_np.get("params", variables_np)
    sd: dict = OrderedDict()
    if model in _TRADITIONAL:
        _traditional(params, variables_np["batch_stats"], sd)
        return sd
    backbone, head = _MODELS[model]
    if backbone == "vgg":
        for i in _VGG_CONV_IDX:
            _conv(params["vgg"][f"features_{i}"], sd, f"vgg.features.{i}")
    else:
        _resnet(params["resnet"], variables_np["batch_stats"]["resnet"], sd)
    for i in (4, 3, 2, 1):
        for c in ("conv1", "conv2"):
            _conv(params[f"up_concat{i}"][c], sd, f"up_concat{i}.{c}")
    if head:
        _conv(params["up_conv_1"], sd, "up_conv.1")
        _conv(params["up_conv_3"], sd, "up_conv.3")
    _conv(params["final"], sd, "final")
    return sd
