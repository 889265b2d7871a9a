"""The competition export (counterpart of ``tpu_unet/tools/results_export.py``;
reference: "results__exported .py":14-195): per model its parameter count,
FPS from a timed ``get_miou_png`` loop, ``.npy`` dumps of each prediction
and ground truth, the foreground IoUs and mIoU over them, and the metrics
dict written to ``关键指标数据文档.txt`` as its ``repr``; the packed
submission and the NaN audit of the dumps.  On the card ``get_miou_png``
runs the normalize kernel (#9) and the net's bf16 kernels.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Sequence

import numpy as np

from tpu_unet_torch.eval.metrics import confusion_matrix, per_class_iou
from tpu_unet_torch.models.registry import count_params

METRICS_FILE = "关键指标数据文档.txt"


def calculate_fps(wrapper, image, iters: int = 100) -> float:
    """Images a second of a timed ``get_miou_png`` loop, after one warm-up
    call (reference: results__exported .py:48-55); each call ends with its
    mask on the host, so the host clock times the device's work."""
    wrapper.get_miou_png(image)
    t0 = time.time()
    for _ in range(iters):
        wrapper.get_miou_png(image)
    return iters / (time.time() - t0)


def export_results(models: dict, ids: Sequence[str], image_dir: str, gt_dir: str,
                   num_classes: int, out_dir: str, image_ext: str = ".jpg",
                   fps_iters: int = 100, save_npy: bool = True) -> dict:
    """``models``: {name: wrapper}.  Writes each model's
    ``prediction_%06d.npy`` / ``ground_truth_%06d.npy`` under
    ``out_dir/<name>`` and the metrics dict (reference: results__exported
    .py:58-186); returns it."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    metrics = {}
    for mname, wrapper in models.items():
        hist = np.zeros((num_classes, num_classes), np.int64)
        npy_dir = os.path.join(out_dir, mname)
        if save_npy:
            os.makedirs(npy_dir, exist_ok=True)
        first_img = None
        for i, name in enumerate(ids):
            img = Image.open(os.path.join(image_dir, name + image_ext))
            if first_img is None:
                first_img = img
            pred = np.asarray(wrapper.get_miou_png(img))
            gt = np.asarray(Image.open(os.path.join(gt_dir, name + ".png")))
            if save_npy:
                np.save(os.path.join(npy_dir, f"prediction_{i:06d}.npy"), pred)
                np.save(os.path.join(npy_dir, f"ground_truth_{i:06d}.npy"), gt)
            if gt.shape == pred.shape:
                hist += confusion_matrix(gt, pred, num_classes).numpy()
        ious = per_class_iou(hist)
        entry = {f"Class{c}_IoU": float(ious[c]) for c in range(1, num_classes)}
        entry["mIoU"] = float(np.nanmean(ious[1:]))  # foreground classes only
        entry["FPS"] = calculate_fps(wrapper, first_img, fps_iters)
        entry["Parameters"] = count_params(wrapper.net)
        metrics[mname] = entry
    with open(os.path.join(out_dir, METRICS_FILE), "w", encoding="utf-8") as f:
        f.write(repr(metrics))
    return metrics


def pack_submission(src_dir: str, out_path: str) -> str:
    """Archive ``src_dir`` (the output.py counterpart, reference:
    output.py:1-37; zip, tar or gztar by ``out_path``'s extension, zip
    otherwise)."""
    base, ext = os.path.splitext(out_path)
    fmt = {".zip": "zip", ".tar": "tar", ".gz": "gztar"}.get(ext, "zip")
    archive = shutil.make_archive(base, fmt, src_dir)
    print(f"packed {src_dir} -> {archive}")
    return archive


def check_nan_in_npy(npy_dir: str) -> int:
    """Count the ``.npy`` files under ``npy_dir`` that hold a NaN
    (reference: check_nan_in_npy.py:4-22)."""
    bad = 0
    for fname in sorted(os.listdir(npy_dir)):
        if fname.endswith(".npy"):
            arr = np.load(os.path.join(npy_dir, fname))
            if np.isnan(arr.astype(np.float64)).any():
                print(f"NaN found in {fname}")
                bad += 1
    print(f"{bad} files with NaN")
    return bad
