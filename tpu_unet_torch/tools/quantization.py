"""Post-training int8 weight quantization (counterpart of
``tpu_unet/tools/quantization.py``; reference: quantization.py:1-60).

Symmetric per-output-channel int8 quantization of every 4-D weight (the
convolutions', OIHW): int8 values and one float32 scale per output channel,
``max|w| / 127`` floored at 1e-12, the weight divided by it, rounded half to
even and clipped to ±127 — JAX's float32 arithmetic (``quantization.py:
35-38``), reduced over (I, H, W) where JAX reduces over its HWIO kernel's
(H, W, I).  Every other parameter passes through in float32; batch norm's
running statistics go aside as ``batch_stats`` and stay out of the byte
count.  :func:`quantized_apply` dequantizes and runs the net in float32: on
the card through the float32 instantiations of its kernels.

Where JAX takes a variables tree, the port takes the net (``nn.Module``):
its parameters are JAX's ``params``, its buffers JAX's ``batch_stats``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


def quantize_params(params: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """Parameters by name → (quantized: each 4-D (OIHW) weight as
    {"values": int8 OIHW, "scale": float32 (O, 1, 1, 1)}, rest: every other
    parameter in float32)."""
    quantized, rest = {}, {}
    for name, p in params.items():
        w = p.detach().float()
        if w.ndim != 4:
            rest[name] = w.clone()  # a copy, not the net's own tensor
            continue
        scale = (w.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0).clamp_min(1e-12)
        quantized[name] = {"values": torch.round(w / scale).clamp(-127, 127).to(torch.int8),
                           "scale": scale}
    return quantized, rest


def dequantize_params(quantized: dict, rest: dict) -> Dict[str, torch.Tensor]:
    """The float32 parameters back from :func:`quantize_params`' two dicts."""
    out = dict(rest)
    for name, q in quantized.items():
        out[name] = q["values"].float() * q["scale"]
    return out


def quantize_variables(net: nn.Module) -> dict:
    """The net → {"quantized", "rest", "batch_stats"}."""
    q, rest = quantize_params(dict(net.named_parameters()))
    return {"quantized": q, "rest": rest,
            "batch_stats": {k: b.detach().clone() for k, b in net.named_buffers()}}


def quantized_apply(net: nn.Module, bundle: dict, x, train: bool = False):
    """The net's forward on ``x`` with the bundle's dequantized weights
    (``torch.func.functional_call``: the net's own tensors are left as they
    are)."""
    state = {**dequantize_params(bundle["quantized"], bundle["rest"]), **bundle["batch_stats"]}
    with torch.no_grad():
        return torch.func.functional_call(net, state, (x,), {"train": train})


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def quantization_report(net: nn.Module) -> dict:
    """Bytes of the float32 parameters and of the quantized bundle (int8
    values, float32 scales and the rest; batch norm's statistics in
    neither), as the reference's before / after printout."""
    f32_bytes = _nbytes(p.detach().float() for p in net.parameters())
    bundle = quantize_variables(net)
    q_bytes = _nbytes(t for q in bundle["quantized"].values() for t in q.values())
    q_bytes += _nbytes(bundle["rest"].values())
    return {"f32_bytes": f32_bytes, "int8_bytes": q_bytes,
            "ratio": q_bytes / max(f32_bytes, 1)}
