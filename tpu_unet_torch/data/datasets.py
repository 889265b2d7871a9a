"""Dataset readers of the port (counterpart of ``tpu_unet/data/datasets.py``):
VOC, VOC2007, the steel-defect DataB layout, the medical cell set and the
heavy-augmentation VOC set of the DataB presets (reference:
utils/dataloader.py:14-226, utils/dataloader_medical.py:12-136,
utils/dataloader_defect.py:12-135), and the layout audit.

A sample is the uint8 image and the int32 label map (values ≥ C become the
ignore class C); /255 and the one-hot run on the device in the step.  Each
sample draws its augmentation from ``np.random.RandomState`` seeded by
``(seed · 1000003 + epoch · 10007 + index) mod 2³¹``, as JAX's, so the
same ids, seed and epoch give byte-equal samples.  PIL is imported inside
the functions.
"""
from __future__ import annotations

import os

import numpy as np

from tpu_unet_torch.data import transforms as T


def read_split(path: str):
    """Read a VOC-style split file of image ids (reference: train.py:355-358)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


class _SegDataset:
    """Common read → augment → label-encode path."""

    image_dir: str
    label_dir: str
    image_ext: str = ".jpg"
    heavy: bool = False   # letterbox + the heavy suite instead of the VOC aug

    def __init__(self, ids, input_shape, num_classes, train: bool,
                 dataset_path: str, seed: int = 11):
        self.ids = list(ids)
        self.input_shape = tuple(input_shape)
        self.num_classes = num_classes
        self.train = train
        self.dataset_path = dataset_path
        self.seed = seed

    def __len__(self):
        return len(self.ids)

    def _paths(self, name):
        return (os.path.join(self.dataset_path, self.image_dir, name + self.image_ext),
                os.path.join(self.dataset_path, self.label_dir, name + ".png"))

    def _encode_label(self, png: np.ndarray) -> np.ndarray:
        png = png.copy()
        png[png >= self.num_classes] = self.num_classes
        return png.astype(np.int32)

    def __getitem__(self, index: int, epoch: int = 0):
        from PIL import Image

        img_path, lbl_path = self._paths(self.ids[index])
        image = T.cvt_rgb(Image.open(img_path))
        label = Image.open(lbl_path)
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 10_007 + index) % (2**31))
        if self.train and not self.heavy:
            img, lbl = T.random_voc_aug(image, label, self.input_shape, rng)
        else:
            im, lb = T.letterbox_pair(image, label, self.input_shape)
            img, lbl = np.array(im, np.uint8), np.array(lb, np.uint8)
            if self.train:
                img, lbl = T.heavy_aug(img, lbl, rng)
        return img, self._encode_label(lbl)


class VOCSegDataset(_SegDataset):
    image_dir = "VOC2012/JPEGImages"
    label_dir = "VOC2012/SegmentationClass"


class VOC2007SegDataset(_SegDataset):
    image_dir = "VOC2007/JPEGImages"
    label_dir = "VOC2007/SegmentationClass"


class DefectSegDataset(_SegDataset):
    """Steel-defect DataB (reference: utils/dataloader_defect.py:32-33)."""
    image_dir = "DataB/JPEGImages"
    label_dir = "DataB/SegmentationClass"


class HeavyAugDataset(VOCSegDataset):
    """UltraLightweightUnetDataset counterpart (reference:
    utils/dataloader.py:143-226): the letterbox, then the heavy augmentation
    suite in train only, as JAX's (which fixes the reference applying it in
    eval too and skipping the image resize)."""
    heavy = True


class MedicalSegDataset(_SegDataset):
    """Medical cell dataset (reference: utils/dataloader_medical.py:32-47):
    Images/{id}.png + Labels/{id}.png, label ≤ 127.5 → class 1."""
    image_dir = "Images"
    label_dir = "Labels"
    image_ext = ".png"

    def _encode_label(self, png: np.ndarray) -> np.ndarray:
        out = np.zeros_like(png, dtype=np.int32)
        out[png <= 127.5] = 1
        return out


def validate_layout(ds_cls, dataset_path: str, train_ids, val_ids,
                    num_classes: int, probe: int = 4) -> dict:
    """Audit a dataset layout before a long run: the directories exist, the
    train split is not empty, the first ``probe`` samples of each split open
    and pair up, and the label values are sane (a {0, 255} mask is flagged,
    values ≥ C other than 255 are reported).  Raises ``ValueError`` with
    every fatal problem; returns a report dict."""
    from PIL import Image

    problems, warnings_ = [], []
    for d in (os.path.join(dataset_path, ds_cls.image_dir),
              os.path.join(dataset_path, ds_cls.label_dir)):
        if not os.path.isdir(d):
            problems.append(f"missing directory: {d}")
    if not train_ids:
        problems.append("empty train split")
    if problems:
        raise ValueError("dataset layout invalid:\n  " + "\n  ".join(problems))

    counts = np.zeros(256, np.int64)
    checked = 0
    for split, ids in (("train", train_ids), ("val", val_ids or [])):
        for name in ids[:probe]:
            img_path = os.path.join(dataset_path, ds_cls.image_dir, name + ds_cls.image_ext)
            lbl_path = os.path.join(dataset_path, ds_cls.label_dir, name + ".png")
            for p in (img_path, lbl_path):
                if not os.path.isfile(p):
                    problems.append(f"{split} id {name!r}: missing {p}")
            if problems:
                continue
            try:
                img = Image.open(img_path)
                img.verify()
                lbl = np.asarray(Image.open(lbl_path))
            except Exception as e:  # a corrupt file
                problems.append(f"{split} id {name!r}: unreadable ({e})")
                continue
            counts += np.bincount(lbl.reshape(-1) if lbl.ndim == 2
                                  else lbl[..., 0].reshape(-1), minlength=256)[:256]
            checked += 1
    if problems:
        raise ValueError("dataset layout invalid:\n  " + "\n  ".join(problems))

    observed = np.nonzero(counts)[0]
    in_range = observed[observed < num_classes]
    out_of_range = observed[(observed >= num_classes) & (observed != 255)]
    custom_encode = ds_cls._encode_label is not _SegDataset._encode_label
    if not custom_encode and len(observed) and set(observed.tolist()) <= {0, 255}:
        warnings_.append(
            "labels look binary {0,255} — if this is a 2-class task the "
            "values must be class INDICES (reference audit: "
            "voc_annotation.py:80-94)")
    if not custom_encode and len(out_of_range):
        warnings_.append(
            f"label values {out_of_range.tolist()} are >= num_classes="
            f"{num_classes} (and not 255); they will be clamped to the "
            f"ignore class")
    return {"train_ids": len(train_ids), "val_ids": len(val_ids or []),
            "probed": checked, "label_values": observed.tolist(),
            "classes_seen": in_range.tolist(), "warnings": warnings_}
