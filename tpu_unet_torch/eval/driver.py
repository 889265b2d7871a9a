"""Offline evaluation — the get_miou.py counterpart (counterpart of
``tpu_unet/eval/driver.py``; reference: get_miou.py:17-65,
utils/utils_metrics.py:57-203).  Each prediction comes from
``wrapper.get_miou_png`` and its confusion matrix is counted on the
wrapper's device, then summed on the host in int64.
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np

from tpu_unet_torch.eval.metrics import compute_miou_from_hist, confusion_matrix


def evaluate(wrapper, ids: Sequence[str], gt_dir: str, num_classes: int,
             name_classes: Optional[Sequence[str]] = None,
             image_dir: Optional[str] = None, image_ext: str = ".jpg",
             pred_dir: Optional[str] = None, verbose: bool = True):
    """``wrapper.get_miou_png`` over ``ids`` against the ground-truth PNGs;
    returns the metric summary (with ``"hist"``).  A pair whose sizes
    differ is skipped (reference: utils/utils_metrics.py:85-90)."""
    import torch
    from PIL import Image

    if pred_dir:
        os.makedirs(pred_dir, exist_ok=True)
    hist = np.zeros((num_classes, num_classes), np.int64)
    device = getattr(wrapper, "device", "cpu")
    skipped = 0
    for name in ids:
        pred = wrapper.get_miou_png(Image.open(os.path.join(image_dir, name + image_ext)))
        if pred_dir:
            pred.save(os.path.join(pred_dir, name + ".png"))
        gt = np.asarray(Image.open(os.path.join(gt_dir, name + ".png")))
        pr = np.asarray(pred)
        if gt.shape != pr.shape:
            skipped += 1
            continue
        hist += confusion_matrix(torch.from_numpy(np.array(gt)).to(device),
                                 torch.from_numpy(np.array(pr)).to(device),
                                 num_classes).cpu().numpy()
    if verbose and skipped:
        print(f"skipped {skipped} size-mismatched pairs")
    result = compute_miou_from_hist(hist, name_classes, verbose)
    result["hist"] = hist
    return result


def evaluate_npy(pred_dir: str, gt_dir: str, num_classes: int,
                 name_classes=None, verbose: bool = True):
    """mIoU over ``prediction_%06d.npy`` / ``ground_truth_%06d.npy`` dumps,
    the competition format (reference: utils/utils_metrics.py:134-203); a
    prediction without its ground truth, or of another shape, is skipped."""
    hist = np.zeros((num_classes, num_classes), np.int64)
    for p in sorted(glob.glob(os.path.join(pred_dir, "prediction_*.npy"))):
        idx = os.path.basename(p)[len("prediction_"):-len(".npy")]
        g = os.path.join(gt_dir, f"ground_truth_{idx}.npy")
        if not os.path.exists(g):
            continue
        pred, gt = np.load(p), np.load(g)
        if pred.shape != gt.shape:
            continue
        hist += confusion_matrix(gt, pred, num_classes).numpy()
    result = compute_miou_from_hist(hist, name_classes, verbose)
    result["hist"] = hist
    return result


def show_results(result: dict, out_dir: str, name_classes=None,
                 foreground_only: bool = True):
    """Bar plots (where matplotlib imports) and the confusion matrix as CSV
    (reference: utils/utils_metrics.py:238-265).  ``foreground_only``
    averages classes 1..n-1 for the title, as the reference does
    (:241-243).  Returns that title mIoU."""
    os.makedirs(out_dir, exist_ok=True)
    ious = result["per_class_iou"]
    title_miou = np.nanmean(ious[1:]) if foreground_only and len(ious) > 1 \
        else result["miou"]
    try:
        import matplotlib
    except ImportError:
        matplotlib = None
    if matplotlib is not None:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names = name_classes or [str(i) for i in range(len(ious))]
        for key, vals in (("mIoU", ious),
                          ("mPA_Recall", result["per_class_recall"]),
                          ("Precision", result["per_class_precision"])):
            plt.figure()
            plt.barh(range(len(vals)), [100 * v for v in vals])
            plt.yticks(range(len(vals)), names)
            plt.title(f"{key} = {100 * title_miou:.2f}%" if key == "mIoU" else key)
            plt.tight_layout()
            plt.savefig(os.path.join(out_dir, f"{key}.png"))
            plt.close("all")
    np.savetxt(os.path.join(out_dir, "confusion_matrix.csv"),
               np.asarray(result.get("hist", [[0]])), fmt="%d", delimiter=",")
    return title_miou
