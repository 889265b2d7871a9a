"""Learning-rate schedules (counterpart of ``tpu_unet/train/schedules.py``;
reference: nets/unet_training.py:78-108 and train.py:393-397), a plain
copy: epoch-granular ``cos`` with a quadratic warm-up and a min-lr tail, the
10-step geometric ``step`` decay, and the batch-size-adaptive initial and
minimum lr."""
from __future__ import annotations

import math
from functools import partial


def _warm_cos_lr(lr, min_lr, total_iters, warmup_total_iters, warmup_lr_start,
                 no_aug_iter, iters):
    if iters <= warmup_total_iters:
        return (lr - warmup_lr_start) * pow(
            iters / float(warmup_total_iters), 2) + warmup_lr_start
    if iters >= total_iters - no_aug_iter:
        return min_lr
    return min_lr + 0.5 * (lr - min_lr) * (
        1.0 + math.cos(
            math.pi * (iters - warmup_total_iters)
            / (total_iters - warmup_total_iters - no_aug_iter)))


def _step_lr(lr, decay_rate, step_size, iters):
    if step_size < 1:
        raise ValueError("step_size must be above 1.")
    return lr * decay_rate ** (iters // step_size)


def get_lr_scheduler(lr_decay_type: str, lr: float, min_lr: float,
                     total_iters: int, warmup_iters_ratio: float = 0.05,
                     warmup_lr_ratio: float = 0.1,
                     no_aug_iter_ratio: float = 0.05, step_num: int = 10):
    """An epoch → lr function (reference: nets/unet_training.py:78-108)."""
    if lr_decay_type == "cos":
        warmup_total_iters = min(max(warmup_iters_ratio * total_iters, 1), 3)
        warmup_lr_start = max(warmup_lr_ratio * lr, 1e-6)
        no_aug_iter = min(max(no_aug_iter_ratio * total_iters, 1), 15)
        return partial(_warm_cos_lr, lr, min_lr, total_iters,
                       warmup_total_iters, warmup_lr_start, no_aug_iter)
    decay_rate = (min_lr / lr) ** (1 / (step_num - 1))
    step_size = total_iters / step_num
    return partial(_step_lr, lr, decay_rate, step_size)


def adaptive_lr(init_lr: float, min_lr: float, batch_size: int,
                optimizer_type: str = "adam", nbs: int = 16):
    """``clip(batch_size / nbs · lr, lo, hi)`` with caps (1e-4, 1e-4) for
    adam and (5e-4, 1e-1) for sgd; the min lr with the caps times 1e-2
    (reference: train.py:393-397)."""
    if optimizer_type == "adam":
        lr_limit_max, lr_limit_min = 1e-4, 1e-4
    else:
        lr_limit_max, lr_limit_min = 1e-1, 5e-4
    init_lr_fit = min(max(batch_size / nbs * init_lr, lr_limit_min), lr_limit_max)
    min_lr_fit = min(max(batch_size / nbs * min_lr, lr_limit_min * 1e-2),
                     lr_limit_max * 1e-2)
    return init_lr_fit, min_lr_fit
