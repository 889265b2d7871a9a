"""Dataset preparation tooling (counterpart of ``tpu_unet/tools/annotation.py``,
host-only: the same files and prints).

Parity targets:
- voc_annotation.py:22-98 — train/val split txt generation + label-value
  audit (256-bin bincount, binary-mask warning)
- voc_annotation_medical.py:15-56 — medical split generation
- json_to_dataset.py:19-69 — labelme JSON → jpg + class-index png masks
"""
from __future__ import annotations

import os
import random
from typing import Sequence

import numpy as np


def generate_splits(seg_dir: str, out_dir: str, trainval_percent: float = 1.0,
                    train_percent: float = 0.9, seed: int = 0):
    """Write train.txt/val.txt/trainval.txt/test.txt of png ids
    (reference: voc_annotation.py:22-64)."""
    ids = [f[:-4] for f in os.listdir(seg_dir) if f.endswith(".png")]
    rng = random.Random(seed)
    rng.shuffle(ids)
    n = len(ids)
    tv = int(n * trainval_percent)
    tr = int(tv * train_percent)
    os.makedirs(out_dir, exist_ok=True)
    splits = {
        "trainval": ids[:tv],
        "train": ids[:tr],
        "val": ids[tr:tv],
        "test": ids[tv:],
    }
    for name, split in splits.items():
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(split) + ("\n" if split else ""))
    print(f"train and val size: {tv}; train size: {tr}")
    return splits


def audit_labels(seg_dir: str, ids: Sequence[str], num_classes: int):
    """256-bin pixel-value audit with the reference's warnings
    (reference: voc_annotation.py:65-94)."""
    from PIL import Image

    classes_nums = np.zeros(256, np.int64)
    for name in ids:
        png = np.asarray(Image.open(os.path.join(seg_dir, name + ".png")))
        if png.ndim > 2:
            print(f"标签图片 {name}.png 不是灰度图或八位彩图, shape {png.shape}")
        classes_nums += np.bincount(png.reshape(-1), minlength=256)
    print("-" * 37)
    print("| %15s | %15s |" % ("Key", "Value"))
    print("-" * 37)
    for i in range(256):
        if classes_nums[i] > 0:
            print("| %15s | %15s |" % (str(i), str(classes_nums[i])))
    if classes_nums[255] > 0 and classes_nums[0] > 0 \
            and (classes_nums[np.arange(1, 255)] == 0).all():
        print("检测到标签中像素点的值仅包含0与255，数据格式有误。")
    elif num_classes <= 2 and (classes_nums[2:] > 0).any():
        print("检测到标签中包含大于1的像素值，二类数据格式可能有误。")
    return classes_nums


def json_to_dataset(json_dir: str, out_jpg_dir: str, out_png_dir: str,
                    classes: Sequence[str]):
    """labelme JSON → jpg + class-index png (reference: json_to_dataset.py:19-69).
    ``classes`` maps label name → index by position (index 0 = background)."""
    import base64
    import io
    import json as jsonlib

    from PIL import Image, ImageDraw

    os.makedirs(out_jpg_dir, exist_ok=True)
    os.makedirs(out_png_dir, exist_ok=True)

    for fname in sorted(os.listdir(json_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(json_dir, fname), encoding="utf-8") as f:
            data = jsonlib.load(f)
        img = Image.open(io.BytesIO(base64.b64decode(data["imageData"])))
        img = img.convert("RGB")
        mask = Image.new("L", img.size, 0)
        draw = ImageDraw.Draw(mask)
        for shape in data.get("shapes", []):
            label = shape["label"]
            cls = classes.index(label) if label in classes else 0
            pts = [tuple(p) for p in shape["points"]]
            draw.polygon(pts, fill=cls)
        stem = fname[:-5]
        img.save(os.path.join(out_jpg_dir, stem + ".jpg"))
        mask.save(os.path.join(out_png_dir, stem + ".png"))
