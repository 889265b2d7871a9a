"""Segmentation losses of the port (counterpart of ``tpu_unet/train/losses.py``,
reference: nets/unet_training.py), plain PyTorch as JAX runs them outside any
Pallas kernel: the eval step's losses and the plain train step's.

- ``ce_loss``: weighted pixel CE, ignore index ``num_classes``, the mean
  divided by the sum of the weights of the contributing pixels;
- ``focal_loss``: α = 0.5, γ = 2 on the weighted per-pixel CE, the mean
  over all pixels (ignored ones included);
- ``dice_loss``: soft dice against the one-hot labels (the ignore channel
  dropped), β = 1, smooth = 1e-5;
- ``f_score``: the thresholded (0.5) train-time dice metric;
- ``deep_supervision_loss``: main + aux heads at decaying weights.

Logits are NHWC ``(N, H, W, C)``; ``target`` an int map ``(N, H, W)``,
``num_classes`` marking ignored pixels; ``onehot`` ``(N, H, W, C + 1)``.
Logits of another size than the target are first resized (bilinear,
align-corners).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.nn.resize import resize_bilinear


def one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, H, W) int → float32 (N, H, W, C + 1); a label above C is the
    ignore class, as ``jax.nn.one_hot`` gives such a label no class and the
    ignore channel is dropped by every loss."""
    return F.one_hot(torch.clamp_max(target.long(), num_classes),
                     num_classes + 1).float()


def _match_size(logits, spatial):
    if tuple(logits.shape[1:3]) != tuple(spatial):
        logits = resize_bilinear(logits, spatial, align_corners=True)
    return logits


def _per_pixel_weighted_ce(logits, target, cls_weights, num_classes):
    """(per-pixel weighted NLL, per-pixel weight), ignored pixels weight 0."""
    logits = _match_size(logits, target.shape[1:3]).float()
    target = target.long()
    valid = target < num_classes
    t = torch.where(valid, target, torch.zeros_like(target))
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(t, num_classes).float()
    nll = -(logp * onehot).sum(-1)
    cw = torch.as_tensor(cls_weights, dtype=torch.float32, device=logits.device)
    w = (onehot @ cw) * valid.float()
    return nll * w, w


def ce_loss(logits, target, cls_weights, num_classes: int = 21):
    """Weighted cross-entropy (reference: nets/unet_training.py:9-19)."""
    wnll, w = _per_pixel_weighted_ce(logits, target, cls_weights, num_classes)
    return wnll.sum() / torch.clamp_min(w.sum(), 1e-12)


def focal_loss(logits, target, cls_weights, num_classes: int = 21,
               alpha: float = 0.5, gamma: float = 2.0):
    """Focal loss (reference: nets/unet_training.py:21-36), the mean over
    all pixels, ignored ones included (their term is 0)."""
    wnll, _ = _per_pixel_weighted_ce(logits, target, cls_weights, num_classes)
    logpt = -wnll
    pt = torch.exp(logpt)
    return (-((1.0 - pt) ** gamma) * (logpt * alpha)).mean()


def _dice_parts(logits, onehot):
    logits = _match_size(logits, onehot.shape[1:3]).float()
    probs = torch.softmax(logits, dim=-1)
    n = probs.shape[0]
    return probs.reshape(n, -1, probs.shape[-1]), \
        onehot.reshape(n, -1, onehot.shape[-1])[..., :-1]


def _score(tp, fp, fn, beta, smooth):
    b2 = beta ** 2
    return ((1 + b2) * tp + smooth) / ((1 + b2) * tp + b2 * fn + fp + smooth)


def dice_loss(logits, onehot, beta: float = 1.0, smooth: float = 1e-5):
    """Soft dice vs the one-hot labels (reference: nets/unet_training.py:38-56)."""
    probs, target = _dice_parts(logits, onehot)
    tp = (target * probs).sum((0, 1))
    fp = probs.sum((0, 1)) - tp
    fn = target.sum((0, 1)) - tp
    return 1.0 - _score(tp, fp, fn, beta, smooth).mean()


def f_score(logits, onehot, beta: float = 1.0, smooth: float = 1e-5,
            threshold: float = 0.5):
    """Train-time thresholded dice (reference: utils/utils_metrics.py:12-31)."""
    probs, target = _dice_parts(logits, onehot)
    probs = (probs > threshold).float()
    tp = (target * probs).sum((0, 1))
    fp = probs.sum((0, 1)) - tp
    fn = target.sum((0, 1)) - tp
    return _score(tp, fp, fn, beta, smooth).mean()


def deep_supervision_loss(outputs, target, onehot, cls_weights,
                          num_classes: int, use_focal: bool = False,
                          use_dice: bool = False,
                          aux_weights=(1.0, 0.4, 0.3, 0.2)):
    """Weighted main + aux loss: each output with the same CE / focal
    (+ dice) recipe, main at weight 1.0."""
    if not isinstance(outputs, (tuple, list)):
        outputs = (outputs,)
    total = 0.0
    for out, w in zip(outputs, aux_weights):
        base = (focal_loss if use_focal else ce_loss)(
            out, target, cls_weights, num_classes)
        if use_dice:
            base = base + dice_loss(out, onehot)
        total = total + w * base
    return total
