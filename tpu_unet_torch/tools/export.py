"""Model export (counterpart of ``tpu_unet/tools/export.py``): the
wrapper's forward + softmax as a ``torch.export`` program in one file.

JAX serialises its forward as StableHLO (``export_stablehlo``); the port
saves the ``torch.export`` graph of the same function with
``torch.export.save``.  The contract is JAX's (``tools/export.py:13-29``,
``wrapper.py:130-153``): a ``(1, H, W, 3)`` float32 image in [0, 1] (the
float branch, no /255), the net in float32 (JAX computes in the input's
dtype, ``models/unet.py:70``, so the wrapper's float32 ``net`` is traced and
not its bf16 serving copy), a tuple's first element, an align-corners
resize where the logits are at another size (self_net), softmax; out come
float32 probabilities ``(1, H, W, C)``.

A program runs on the device it was exported for, as a StableHLO export is
lowered for one platform.  Exported from a wrapper on the card, its graph
holds the hand-written kernels as the operators ``tpu_unet_torch::vgg_stem``,
``::vgg_block``, ``::unetup`` and ``::upconv`` (their float32
instantiations), so running it launches them, never a plain version or a
cuDNN convolution in their place; exported on the CPU it is plain aten
operators.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from tpu_unet_torch.infer.wrapper import input_res_logits


class ProbsForward(nn.Module):
    """The exported function: float32 image ``(1, H, W, 3)`` → float32
    probabilities ``(1, H, W, C)`` through ``net`` (its dtype)."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(input_res_logits(self.net(x), x.shape[1:3]), dim=-1)


def export_program(wrapper, path: str) -> str:
    """Trace the wrapper's float32 forward + softmax at its input size on
    its device and save the program to ``path``.  The net's parameters are
    traced as constants of the program, without gradients (the kernels'
    wrappers refuse inputs that autograd would record)."""
    h, w = wrapper.input_shape
    example = torch.zeros((1, h, w, 3), dtype=torch.float32, device=wrapper.device)
    params = list(wrapper.net.parameters())
    was = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(False)
        program = torch.export.export(ProbsForward(wrapper.net).eval(), (example,),
                                      strict=False)
    finally:
        for p, r in zip(params, was):
            p.requires_grad_(r)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    print(f"torch.export program saved to {path} ({os.path.getsize(path)} bytes)")
    return path


def load_program(path: str):
    """The program at ``path`` as a callable (the counterpart of
    ``load_stablehlo`` and of the reference's ``Unet_ONNX``): an image
    ``(1, H, W, 3)`` float32 (array or tensor) → float32 probabilities on
    the device the program was exported for.  Importing the kernel modules
    registers the operators its graph may hold."""
    from tpu_unet_torch.kernels import decoder_fuse, encoder, stem, upconv  # noqa: F401

    program = torch.export.load(path)
    user = set(program.graph_signature.user_inputs)
    device = next(n.meta["val"].device for n in program.graph.nodes
                  if n.op == "placeholder" and n.name in user)
    module = program.module()

    @torch.no_grad()
    def call(x):
        return module(torch.as_tensor(x, dtype=torch.float32, device=device))

    return call
