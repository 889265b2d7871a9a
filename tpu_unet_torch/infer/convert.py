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
``up_concat{i}.conv.{0,1}``, ``final_conv.{0,2,3}``; for the other eight
models JAX's ``sk_conv``, ``light_sk_block``, ``repvgg_block`` /
``repvgg_stem``, ``fusion_block``, ``convert_improved_ultralight``,
``convert_hybrid`` and the ``convert_balancedseg*`` family read backwards,
``repvgg_segnet``'s deploy form, ``reparam``, and its FusedMBConv form,
``expand`` / ``bn1`` / ``project`` / ``bn2``, included), in the order of
the torch model's state dict.  Dense kernels ``(in, out)`` become Linear
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
from tpu_unet_torch.models.balancedseg import UNUSED_REFERENCE_KEYS

_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# backbone and head of each bridged model
_MODELS = {"unet_vgg": ("vgg", False), "unet_resnet50": ("resnet50", True),
           "self_net": ("vgg", True)}
_TRADITIONAL = ("traditional", "traditional22")
# ladder models and whether each has an SE gate after its encoder stages
_LADDER = {"ultralight": False, "ultralight_large": True,
           "ultralight_large_optimized": True, "ultralight44": True,
           "sk_ultralight": True, "repvgg_segnet": True}
_BN_COUNTER = "num_batches_tracked"
# a reference checkpoint's modules that the model's forward never applies
# and the port does not build, by model
_UNUSED = {"balancedseg": UNUSED_REFERENCE_KEYS}


def read_state_dict(path: str) -> dict:
    """The weights of the ``.pth`` at ``path``: the EarlyStopping wrapper
    ``{"model_state_dict": ...}`` (reference: utils/callbacks.py:129-134),
    or a full-state checkpoint's, unwrapped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model_state_dict"] if "model_state_dict" in sd else sd


def load_state_dict(net: torch.nn.Module, path, model: str = "") -> torch.nn.Module:
    """Load the reference ``.pth`` at ``path`` into ``net`` as
    ``tpu_unet/infer/convert.py:28-36`` reads it: the EarlyStopping wrapper
    is unwrapped and ``num_batches_tracked`` may be present or not on
    either side; a reference ``balancedseg``'s CBAM and edge-enhancement
    weights, which its forward never applies, are skipped (as
    ``convert_balancedseg`` skips them); every other key is strict, and a
    missing or unexpected weight raises with its name, as
    ``_check_consumed`` does there.  ``path`` may also be the weights
    :func:`read_state_dict` gave."""
    unused = _UNUSED.get(model, ())
    raw = read_state_dict(path) if isinstance(path, str) else path
    sd = {k: v for k, v in raw.items()
          if _BN_COUNTER not in k and not k.startswith(unused)}
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
    if "bias" in tree:
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


def _sk_conv(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """SKConv ``branch{i}/branch{i}_bn/fc1/fc1_bn/fc2`` → ``conv.{i}.{0,1}``,
    ``fc1.{0,1}``, ``fc2`` (JAX ``sk_conv`` :222)."""
    i = 0
    while f"branch{i}" in params:
        _conv(params[f"branch{i}"], sd, f"{torch_key}.conv.{i}.0")
        _bn(params[f"branch{i}_bn"], stats[f"branch{i}_bn"], sd, f"{torch_key}.conv.{i}.1")
        i += 1
    _conv(params["fc1"], sd, f"{torch_key}.fc1.0")
    _bn(params["fc1_bn"], stats["fc1_bn"], sd, f"{torch_key}.fc1.1")
    _conv(params["fc2"], sd, f"{torch_key}.fc2")


def _sk_block(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """LightSKBlock ``reduce/bn1/sk/bn2`` → ``conv1.{0,1}``, ``sk_conv``,
    ``bn`` (JAX ``light_sk_block`` :231)."""
    _conv(params["reduce"], sd, f"{torch_key}.conv1.0")
    _bn(params["bn1"], stats["bn1"], sd, f"{torch_key}.conv1.1")
    _sk_conv(params["sk"], stats["sk"], sd, f"{torch_key}.sk_conv")
    _bn(params["bn2"], stats["bn2"], sd, f"{torch_key}.bn")


def _repvgg_block(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """RepVGGBlock ``conv3/bn3/conv1/bn1/bnid`` → ``conv1`` (3×3), ``bn1``,
    ``conv2`` (1×1), ``bn2``, ``id_bn`` (JAX ``repvgg_block`` :238), or
    deployed, ``reparam``; a FusedMBConv keeps its names."""
    if "reparam" in params:
        _conv(params["reparam"], sd, f"{torch_key}.reparam")
        return
    names = ((("expand", "expand"), ("bn1", "bn1"), ("project", "project"), ("bn2", "bn2"))
             if "expand" in params else
             (("conv3", "conv1"), ("bn3", "bn1"), ("conv1", "conv2"), ("bn1", "bn2"),
              ("bnid", "id_bn")))
    for name, key in names:
        if not name.startswith("bn"):
            _conv(params[name], sd, f"{torch_key}.{key}")
        elif name in params:
            _bn(params[name], stats[name], sd, f"{torch_key}.{key}")


def _repvgg_stem(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """RepVGGStem ``reduce/bn/block`` → ``conv.{0,1,3}`` (JAX ``repvgg_stem``
    :247)."""
    _conv(params["reduce"], sd, f"{torch_key}.conv.0")
    _bn(params["bn"], stats["bn"], sd, f"{torch_key}.conv.1")
    _repvgg_block(params["block"], stats.get("block", {}), sd, f"{torch_key}.conv.3")


_LADDER_BLOCK = {"sk_ultralight": _sk_block, "repvgg_segnet": _repvgg_stem}


def _ladder(params: Mapping, stats: Mapping, sd: dict, se: bool, block=_light_block) -> None:
    for i in range(1, 5):
        block(params[f"enc{i}"], stats[f"enc{i}"], sd, f"enc{i}")
    if se:
        for i in range(1, 5):
            _se(params[f"se{i}"], sd, f"se{i}")
    block(params["bridge"], stats["bridge"], sd, "bridge")
    for i in (4, 3, 2, 1):
        block(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
    _conv(params["final"], sd, "final")


def _se_light(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """improved_ultralight's stage ``conv/se`` → ``conv.*``, ``se.fc.*``."""
    _light_block(params["conv"], stats["conv"], sd, torch_key)
    _se(params["se"], sd, f"{torch_key}.se")


def _fusion(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """FeatureFusion ``fuse/se`` → ``conv1x1``, ``se.fc.*`` (JAX
    ``fusion_block`` :253)."""
    _conv(params["fuse"], sd, f"{torch_key}.conv1x1")
    _se(params["se"], sd, f"{torch_key}.se")


def _improved(params: Mapping, stats: Mapping, sd: dict) -> None:
    """JAX ``convert_improved_ultralight`` (:338) read backwards."""
    for i in range(1, 5):
        _se_light(params[f"enc{i}"], stats[f"enc{i}"], sd, f"enc{i}")
    _se_light(params["bridge"], stats["bridge"], sd, "bridge")
    for i in (4, 3, 2, 1):
        _fusion(params[f"fusion{i}"], {}, sd, f"fusion{i}")
        _se_light(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
    _conv(params["final"], sd, "final")
    for i in (4, 3, 2):
        _conv(params[f"aux_out{i}"], sd, f"aux_out{i}")


def _dw_bn(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """DWSeparableBNReLU / DWConvBNReLU: ``depthwise``, ``pointwise``, ``bn``."""
    _conv(params["depthwise"], sd, f"{torch_key}.depthwise")
    _conv(params["pointwise"], sd, f"{torch_key}.pointwise")
    _bn(params["bn"], stats["bn"], sd, f"{torch_key}.bn")


def _stdc(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    for part in ("conv1", "conv2", "skip"):
        if part in params:
            _dw_bn(params[part], stats[part], sd, f"{torch_key}.{part}")
    _se(params["se"], sd, f"{torch_key}.se")


def _decoder_block(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """DecoderBlock ``conv1/conv2/se`` → ``conv.{0,1}``, ``se.fc.*``."""
    _dw_bn(params["conv1"], stats["conv1"], sd, f"{torch_key}.conv.0")
    _dw_bn(params["conv2"], stats["conv2"], sd, f"{torch_key}.conv.1")
    _se(params["se"], sd, f"{torch_key}.se")


def _hybrid(params: Mapping, stats: Mapping, sd: dict) -> None:
    """JAX ``convert_hybrid`` (:356) read backwards."""
    for key in ("enc1", "enc2", "enc3", "enc4", "bridge"):
        _stdc(params[key], stats[key], sd, key)
    for i in (4, 3, 2, 1):
        _decoder_block(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
    _dw_bn(params["final_dw"], stats["final_dw"], sd, "final_conv.0")
    _conv(params["final"], sd, "final_conv.1")


def _multiscale(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    _conv(params["reduce"], sd, f"{torch_key}.reduce")
    for part, key in (("branch1", "branch1"), ("branch2a", "branch2.0"),
                      ("branch2b", "branch2.1")):
        _dw_bn(params[part], stats[part], sd, f"{torch_key}.{key}")


def _balanced_encoder(params: Mapping, stats: Mapping, sd: dict) -> None:
    """JAX ``_convert_balanced_encoder`` (:372) read backwards."""
    for i in range(1, 5):
        _multiscale(params[f"enc{i}"], stats[f"enc{i}"], sd, f"enc{i}")
    _multiscale(params["bridge"], stats["bridge"], sd, "bridge.0")


def _channel_attention(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """ChannelAttention / EfficientAttention ``fc1/fc2`` (bias-free dense) →
    ``shared_mlp.{0,2}``."""
    _dense(params["fc1"], sd, f"{torch_key}.shared_mlp.0")
    _dense(params["fc2"], sd, f"{torch_key}.shared_mlp.2")


def _cbam(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """CBAM ``channel/spatial`` → ``channel.shared_mlp.*``, ``spatial.conv``."""
    _channel_attention(params["channel"], {}, sd, f"{torch_key}.channel")
    _conv(params["spatial"]["conv"], sd, f"{torch_key}.spatial.conv")


def _efficient_decoder(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    _dw_bn(params["conv1"], stats["conv1"], sd, f"{torch_key}.conv.0")
    _dw_bn(params["conv2"], stats["conv2"], sd, f"{torch_key}.conv.1")
    _channel_attention(params["channel"]["mlp"], {}, sd, f"{torch_key}.channel_attention")
    _conv(params["spatial"]["attn"]["conv"], sd, f"{torch_key}.spatial_attention.conv")


def _crfs(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """CRFSAttention ``theta/phi/g/attn`` → ``conv_{theta,phi,g,attn}``."""
    for leaf in ("theta", "phi", "g", "attn"):
        _conv(params[leaf], sd, f"{torch_key}.conv_{leaf}")


def _edge(params: Mapping, stats: Mapping, sd: dict, torch_key: str) -> None:
    """EdgeEnhancementBlock ``conv1/bn1/conv2/bn2`` → ``conv.{0,1,3,4}``."""
    for i, (c, b) in zip((0, 3), (("conv1", "bn1"), ("conv2", "bn2"))):
        _conv(params[c], sd, f"{torch_key}.conv.{i}")
        _bn(params[b], stats[b], sd, f"{torch_key}.conv.{i + 1}")


def _final_conv(params: Mapping, stats: Mapping, sd: dict) -> None:
    _dw_bn(params["final_conv"], stats["final_conv"], sd, "final_conv.0")
    _conv(params["final"], sd, "final_conv.1")


def _balancedseg(params: Mapping, stats: Mapping, sd: dict) -> None:
    """JAX ``convert_balancedseg`` (:380) read backwards."""
    _balanced_encoder(params, stats, sd)
    for i in range(1, 5):
        _se(params[f"enc{i}_se"], sd, f"enc{i}_se")
    for i in (4, 3, 2, 1):
        _efficient_decoder(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
        _conv(params[f"dec{i}_spa"]["attn"]["conv"], sd, f"dec{i}_spa.conv")
    _final_conv(params, stats, sd)
    _conv(params["aux_head"], sd, "aux_head")


def _balancedseg_fpn(params: Mapping, stats: Mapping, sd: dict) -> None:
    """JAX ``convert_balancedseg_fpn`` (:402) read backwards, the aux heads
    (``balancedseg_fpn_sup``) in flax's order, 3, 2, 1."""
    params, stats = params["body"], stats["body"]
    _balanced_encoder(params["encoder"], stats["encoder"], sd)
    for i in range(1, 5):
        _conv(params[f"lateral{i}"], sd, f"lateral{i}")
    for i in (4, 3, 2, 1):
        _efficient_decoder(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
    _edge(params["edge"], stats["edge"], sd, "edge_enhancement")
    _final_conv(params, stats, sd)
    for i in (3, 2, 1):
        if f"aux_output{i}" in params:
            _conv(params[f"aux_output{i}"], sd, f"aux_output{i}")


def _balancedseg_crfs(params: Mapping, stats: Mapping, sd: dict) -> None:
    """JAX ``convert_balancedseg_crfs`` (:424) read backwards."""
    _balanced_encoder(params["encoder"], stats["encoder"], sd)
    for i in (4, 3, 2, 1):
        _efficient_decoder(params[f"dec{i}"], stats[f"dec{i}"], sd, f"dec{i}")
        _crfs(params[f"crfs{i}"], {}, sd, f"crfs_att{i}")
    _edge(params["edge"], stats["edge"], sd, "edge_enhancement")
    _final_conv(params, stats, sd)


_OTHER = {"improved_ultralight": _improved, "hybrid_efficientseg": _hybrid,
          "balancedseg": _balancedseg, "balancedseg_fpn": _balancedseg_fpn,
          "balancedseg_fpn_sup": _balancedseg_fpn, "balancedseg_crfs": _balancedseg_crfs}


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
    covered = (*_MODELS, *_TRADITIONAL, *_LADDER, "lightweight", *_OTHER)
    if model not in covered:
        raise ValueError(f"weight bridge covers {sorted(covered)}, not {model!r}")
    params = variables_np.get("params", variables_np)
    sd: dict = OrderedDict()
    if model in _TRADITIONAL:
        _traditional(params, variables_np["batch_stats"], sd)
        return sd
    if model in _LADDER:
        _ladder(params, variables_np["batch_stats"], sd, _LADDER[model],
                _LADDER_BLOCK.get(model, _light_block))
        return sd
    if model in _OTHER:
        _OTHER[model](params, variables_np["batch_stats"], sd)
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
