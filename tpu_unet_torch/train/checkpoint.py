"""Checkpoint save / restore of the port (counterpart of
``tpu_unet/train/checkpoint.py``), as ``torch.save`` files with the
reference's names (utils/utils_fit.py:153-172):

- ``best_epoch_weights.pth``: the state dict alone (it exists to be served);
- ``ep%03d-loss%.3f-val_loss%.3f.pth`` and ``last_epoch_weights.pth``: the
  full state ``{"model_state_dict", "optimizer", "epoch", "best_val",
  "step"}`` for a true resume (``epoch`` = completed epochs).

Both load in ``Unet(model_path=...)`` through ``infer/convert.py::
load_state_dict``, which unwraps ``model_state_dict``.
"""
from __future__ import annotations

import os

import torch


def _host_state_dict(model: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_variables(path: str, model: torch.nn.Module) -> None:
    """Weights only: the model's state dict."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_host_state_dict(model), path)


def save_full_state(path: str, state, epoch: int, best_val: float) -> None:
    """Full state for a true resume: weights, optimizer (moments included),
    completed epochs, best validation loss and steps taken."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model_state_dict": _host_state_dict(state.model),
                "optimizer": state.optimizer.state_dict(),
                "epoch": int(epoch), "best_val": float(best_val),
                "step": int(state.step)}, path)


def load_any(path: str) -> dict:
    """A checkpoint as saved here: a state dict, or a full-state dict."""
    return torch.load(path, map_location="cpu", weights_only=True)


def partial_load(template: dict, loaded: dict, verbose: bool = True):
    """Shape-matched key-by-key merge (reference: train.py:292-302): keys
    present in both with the same shape come from ``loaded``, everything
    else keeps the template's value.  Returns (merged state dict, loaded
    keys, skipped keys)."""
    out = dict(template)
    ok, skipped = [], []
    for k, v in loaded.items():
        if k in template and tuple(v.shape) == tuple(template[k].shape):
            out[k] = v
            ok.append(k)
        else:
            skipped.append(k)
    if verbose:
        print(f"checkpoint: loaded {len(ok)} tensors, "
              f"skipped {len(skipped)} (missing/shape-mismatched)")
    return out, ok, skipped
