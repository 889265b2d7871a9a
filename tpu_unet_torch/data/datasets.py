"""Dataset helpers of the port (counterpart of ``tpu_unet/data/datasets.py``).
Only the split reader is ported; the dataset classes come with the
training slice."""
from __future__ import annotations


def read_split(path: str):
    """Read a VOC-style split file of image ids (reference: train.py:355-358)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]
