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
``outc``; for the ladder family ``enc{i}.conv.{0,1,3,4}`` with
``conv.3.{depthwise,pointwise}``, ``se{i}.fc.{0,2}``, ``bridge``,
``dec{i}``, ``final``; for ``lightweight`` ``backbone.stage{i}.{0,1}``,
``up_concat{i}.conv.{0,1}``, ``final_conv.{0,2,3}``), in the order of the
torch model's state dict.  Dense kernels ``(in, out)`` become Linear
weights ``(out, in)``.  Load the result with ``strict=True`` so every key
is used.

:func:`load_state_dict` loads a reference ``.pth`` into a port model the
way ``tpu_unet/infer/convert.py:28-36`` reads it.
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
# ladder models and whether each has an SE gate after its encoder stages
_LADDER = {"ultralight": False, "ultralight_large": True,
           "ultralight_large_optimized": True, "ultralight44": True}
_BN_COUNTER = "num_batches_tracked"


def load_state_dict(net: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the reference ``.pth`` at ``path`` into ``net`` as
    ``tpu_unet/infer/convert.py:28-36`` reads it: the EarlyStopping wrapper
    ``{"model_state_dict": ...}`` (reference: utils/callbacks.py:129-134)
    is unwrapped and ``num_batches_tracked`` may be present or not on
    either side; every other key is strict, and a missing or unexpected
    weight raises with its name, as ``_check_consumed`` does there."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    sd = {k: v for k, v in sd.items() if _BN_COUNTER not in k}
    own = [k for k in net.state_dict() if _BN_COUNTER not in k]
    missing = [k for k in own if k not in sd]
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint {path!r} does not match "
                         f"{type(net).__name__}: missing {missing[:10]}, "
                         f"unexpected {extra[:10]}")
    net.load_state_dict(sd, strict=False)  # only the BN counters are left out
    return net


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


def _dense(tree: Mapping, sd: dict, torch_key: str) -> None:
    sd[f"{torch_key}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(tree["kernel"], np.float32).T))
    sd[f"{torch_key}.bias"] = _f32(tree["bias"])


def _light_block(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """LightConvBlock ``reduce/bn1/dw/bn2`` → ``conv.{0,1,3,4}``."""
    _conv(params["reduce"], sd, f"{torch_key}.conv.0")
    _bn(params["bn1"], stats["bn1"], sd, f"{torch_key}.conv.1")
    for part in ("depthwise", "pointwise"):
        _conv(params["dw"][part], sd, f"{torch_key}.conv.3.{part}")
    _bn(params["bn2"], stats["bn2"], sd, f"{torch_key}.conv.4")


def _se(params: Mapping, sd: dict, torch_key: str) -> None:
    _dense(params["fc1"], sd, f"{torch_key}.fc.0")
    _dense(params["fc2"], sd, f"{torch_key}.fc.2")


def _ladder(params: Mapping, stats: Mapping, sd: dict, se: bool) -> None:
    for i in range(1, 5):
        _light_block(params[f"enc{i}"], stats[f"enc{i}"], sd, f"enc{i}")
    if se:
        for i in range(1, 5):
            _se(params[f"se{i}"], sd, f"se{i}")
    _light_block(params["bridge"], stats["bridge"], sd, "bridge")
    for i in (4, 3, 2, 1):
        _light_block(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
    _conv(params["final"], sd, "final")


def _conv_bn_relu(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """ConvBNReLU ``conv/bn`` → ``conv.{0,1}``."""
    _conv(params["conv"], sd, f"{torch_key}.conv.0")
    _bn(params["bn"], stats["bn"], sd, f"{torch_key}.conv.1")


def _residual(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    for i in (1, 2):
        _conv(params[f"conv{i}"], sd, f"{torch_key}.conv{i}")
        _bn(params[f"bn{i}"], stats[f"bn{i}"], sd, f"{torch_key}.bn{i}")
    _se(params["se"], sd, f"{torch_key}.se")


def _lightweight(params: Mapping, stats: Mapping, sd: dict) -> None:
    for i in range(1, 6):
        p, s = params[f"stage{i}"], stats[f"stage{i}"]
        _conv_bn_relu(p["conv"], s["conv"], sd, f"backbone.stage{i}.0")
        _residual(p["res"], s["res"], sd, f"backbone.stage{i}.1")
    for i in (4, 3, 2, 1):
        p, s = params[f"up_concat{i}"], stats[f"up_concat{i}"]
        _conv_bn_relu(p["conv"], s["conv"], sd, f"up_concat{i}.conv.0")
        _residual(p["res"], s["res"], sd, f"up_concat{i}.conv.1")
    _conv_bn_relu(params["final_conv"], stats["final_conv"], sd, "final_conv.0")
    _residual(params["final_res"], stats["final_res"], sd, "final_conv.2")
    _conv(params["final"], sd, "final_conv.3")


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
    covered = (*_MODELS, *_TRADITIONAL, *_LADDER, "lightweight")
    if model not in covered:
        raise ValueError(f"weight bridge covers {sorted(covered)}, not {model!r}")
    params = variables_np.get("params", variables_np)
    sd: dict = OrderedDict()
    if model in _TRADITIONAL:
        _traditional(params, variables_np["batch_stats"], sd)
        return sd
    if model in _LADDER:
        _ladder(params, variables_np["batch_stats"], sd, _LADDER[model])
        return sd
    if model == "lightweight":
        _lightweight(params, variables_np["batch_stats"], sd)
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
