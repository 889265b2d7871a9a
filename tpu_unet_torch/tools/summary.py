"""Model profiling: parameters and FLOPs (counterpart of
``tpu_unet/tools/summary.py``; reference: summary.py:10-30, torchsummary +
thop with FLOPs ×2).

Parameters are counted as JAX counts them (``models/registry.py::
count_params``: the parameters, not batch norm's running statistics), and
equal JAX's for every registry model.

FLOPs: JAX reads XLA's cost analysis of its compiled forward, which the
port cannot reproduce.  The port counts what PyTorch executes instead:
``torch.utils.flop_counter.FlopCounterMode`` over the eval forward on the
CPU, 2 × the multiply-adds of each convolution and matrix product (no
bias, activation, pooling or resize).  The count belongs to the model, not
to a device, so it is taken on the CPU, with the kernels' plain versions,
even where a card is present.  It differs from XLA's in both directions
(ultralight at 64² 0.73×, traditional at 32² 1.11×, unet_vgg at 64² 1.08×
of XLA's number).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_unet_torch.models.registry import MODELS, build_model, count_params


def summarize(model_name: str, input_shape=(512, 512), num_classes: int = 21,
              batch: int = 1, verbose: bool = True) -> dict:
    """{"params", "flops"} of ``model_name`` at ``input_shape`` and
    ``batch`` (neither depends on the weights' values); prints JAX's three
    lines."""
    net = build_model(model_name, num_classes).eval()
    params = count_params(net)
    x = torch.zeros((batch, input_shape[0], input_shape[1], 3), dtype=torch.float32)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net(x)
    flops = float(counter.get_total_flops())
    if verbose:
        print(f"model: {model_name} @ {input_shape} batch={batch}")
        print(f"Total params:  {params:,}")
        print(f"Total GFLOPs:  {flops / 1e9:.3f}")
    return {"params": params, "flops": flops}


def summarize_all(input_shape=(256, 256), num_classes: int = 4) -> dict:
    """The params / GFLOPs table over the registry (the get_parameters.py /
    test.py comparison's counterpart)."""
    rows = {}
    print(f"{'model':32s} {'params':>12s} {'GFLOPs':>10s}")
    for name in sorted(MODELS):
        res = summarize(name, input_shape, num_classes, verbose=False)
        rows[name] = res
        print(f"{name:32s} {res['params']:>12,d} {res['flops'] / 1e9:>10.2f}")
    return rows
