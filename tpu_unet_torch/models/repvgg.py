"""RepVGG structural re-parameterisation on the port's state dict
(counterpart of ``tpu_unet/models/repvgg.py``; reference:
nets/RepVGG_Unet.py:63-98, ``get_equivalent_kernel_bias`` /
``_fuse_bn_tensor`` / ``switch_to_deploy``).

:func:`fold_repvgg` maps the state dict of a model built with
``deploy=False`` to that of the same model built with ``deploy=True``:
each RepVGGBlock's three branches (bias-free 3×3 + BN, bias-free 1×1 + BN,
and the identity BN where it exists) become one biased 3×3 ``reparam``
conv, and the folded batch norms' running statistics are dropped.  Every
other entry is kept, in the deploy model's state-dict order.  Float32
arithmetic with the port's ``BN_EPS``, in JAX's order of sums.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import torch
import torch.nn.functional as F

from tpu_unet_torch.nn.blocks import BN_EPS

_PARTS = ("conv1", "bn1", "conv2", "bn2", "id_bn")


def _fuse_conv_bn(kernel: torch.Tensor, sd: Mapping, bn: str):
    """Fold the batch norm ``bn`` into an OIHW ``kernel`` → (kernel', bias')."""
    t = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + BN_EPS)
    return (kernel.float() * t[:, None, None, None],
            sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * t)


def _is_block(sd: Mapping, p: str) -> bool:
    """``p`` holds a training-form RepVGGBlock: a bias-free 3×3 ``conv1`` and
    a 1×1 ``conv2``, each followed by its batch norm."""
    k3, k1 = sd.get(f"{p}.conv1.weight"), sd.get(f"{p}.conv2.weight")
    return (k3 is not None and k1 is not None and k3.dim() == 4
            and tuple(k3.shape[2:]) == (3, 3) and tuple(k1.shape[2:]) == (1, 1)
            and f"{p}.conv1.bias" not in sd and f"{p}.bn1.running_var" in sd
            and f"{p}.bn2.running_var" in sd)


def fold_block(sd: Mapping, p: str):
    """The ``reparam`` (weight, bias) of the RepVGGBlock at prefix ``p``."""
    k3, b3 = _fuse_conv_bn(sd[f"{p}.conv1.weight"], sd, f"{p}.bn1")
    k1, b1 = _fuse_conv_bn(sd[f"{p}.conv2.weight"], sd, f"{p}.bn2")
    kernel, bias = k3 + F.pad(k1, (1, 1, 1, 1)), b3 + b1
    if f"{p}.id_bn.weight" in sd:
        c = kernel.shape[1]
        ident = torch.zeros(c, c, 3, 3)
        ident[torch.arange(c), torch.arange(c), 1, 1] = 1.0
        kid, bid = _fuse_conv_bn(ident, sd, f"{p}.id_bn")
        kernel, bias = kernel + kid, bias + bid
    return kernel, bias


def fold_repvgg(state_dict: Mapping[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """A ``deploy=False`` state dict → the ``deploy=True`` one."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    blocks = {k[:-len(".conv1.weight")] for k in sd if k.endswith(".conv1.weight")}
    blocks = {p for p in blocks if _is_block(sd, p)}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in sd.items():
        head, _, rest = k.rpartition(".")
        p, _, part = head.rpartition(".")
        if p not in blocks or part not in _PARTS:
            out[k] = v
        elif f"{p}.reparam.weight" not in out:
            out[f"{p}.reparam.weight"], out[f"{p}.reparam.bias"] = fold_block(sd, p)
    return out
