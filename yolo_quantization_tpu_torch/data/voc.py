"""darknet-style image lists and label files.

The evaluation readers of ``yolo_quantization_tpu/data/voc.py``:
  - image list files: one image path per line;
  - label files: images/x.jpg -> labels/x.txt, lines "cls x y w h" in
    relative center format (darknet's find_replace chain).
The training augmentation is not ported yet (ROADMAP queue 1.9).
"""

from __future__ import annotations

import os

import numpy as np


def read_image_list(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def label_path_for(image_path: str) -> str:
    """darknet's find_replace chain (examples/detector.c:828-833)."""
    p = image_path.replace("images", "labels").replace("JPEGImages", "labels")
    for ext in (".jpg", ".JPEG", ".jpeg", ".png", ".JPG"):
        if p.endswith(ext):
            return p[: -len(ext)] + ".txt"
    return os.path.splitext(p)[0] + ".txt"


def read_boxes(label_path: str) -> np.ndarray:
    """(N, 5) [cls, x, y, w, h] relative; empty array if file missing."""
    if not os.path.exists(label_path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(label_path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 5:
                rows.append([float(v) for v in parts[:5]])
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)
