"""Confusion-matrix mIoU evaluation (counterpart of
``tpu_unet/eval/metrics.py``; reference: utils/utils_metrics.py:34-126).

The confusion matrix is one ``torch.bincount(n·gt + pred)`` on the tensors'
device, counted in int64, so it is exact at any image size without the JAX
package's 2²⁴ chunking.  The IoU / recall / precision reductions run on the
host in float64, as JAX's do.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(gt, pred, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts, rows ground truth, columns
    prediction, over flat int arrays or tensors.  Pixels whose ground truth
    lies outside ``[0, num_classes)`` (255 borders) are ignored; predictions
    are clipped to ``[0, num_classes - 1]``."""
    gt = gt if torch.is_tensor(gt) else torch.from_numpy(np.array(gt))
    pred = (pred if torch.is_tensor(pred) else torch.from_numpy(np.array(pred))).to(gt.device)
    g = gt.reshape(-1).long()
    p = pred.reshape(-1).long().clamp(0, num_classes - 1)
    valid = (g >= 0) & (g < num_classes)
    hist = torch.bincount(num_classes * g[valid] + p[valid],
                          minlength=num_classes * num_classes)
    return hist.reshape(num_classes, num_classes)


def per_class_iou(hist):
    hist = np.asarray(hist, np.float64)
    denom = np.maximum(hist.sum(1) + hist.sum(0) - np.diag(hist), 1)
    return np.diag(hist) / denom


def per_class_pa_recall(hist):
    hist = np.asarray(hist, np.float64)
    return np.diag(hist) / np.maximum(hist.sum(1), 1)


def per_class_precision(hist):
    hist = np.asarray(hist, np.float64)
    return np.diag(hist) / np.maximum(hist.sum(0), 1)


def per_accuracy(hist):
    hist = np.asarray(hist, np.float64)
    return np.diag(hist).sum() / np.maximum(hist.sum(), 1)


def compute_miou_from_hist(hist, name_classes=None, verbose: bool = True):
    """Summary dict matching compute_mIoU's printout
    (reference: utils/utils_metrics.py:97-126)."""
    ious = per_class_iou(hist)
    recalls = per_class_pa_recall(hist)
    precisions = per_class_precision(hist)
    acc = per_accuracy(hist)
    result = {
        "per_class_iou": ious,
        "per_class_recall": recalls,
        "per_class_precision": precisions,
        "miou": float(np.nanmean(ious)),
        "mpa": float(np.nanmean(recalls)),
        "accuracy": float(acc),
    }
    if verbose:
        names = name_classes or [str(i) for i in range(len(ious))]
        for n, i, r, p in zip(names, ious, recalls, precisions):
            print(f"===> {n}:\tIou-{100 * i:.2f}; Recall-{100 * r:.2f}; "
                  f"Precision-{100 * p:.2f}")
        print(f"===> mIoU: {100 * result['miou']:.2f}; "
              f"mPA: {100 * result['mpa']:.2f}; "
              f"Accuracy: {100 * result['accuracy']:.2f}")
    return result
