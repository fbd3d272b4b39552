"""Detection dataset: darknet-style lists, label files and augmentation.

The counterpart of ``yolo_quantization_tpu/data/voc.py`` (darknet's data
path), vectorized numpy on the host:
  - image list files: one image path per line;
  - label files: images/x.jpg -> labels/x.txt, lines "cls x y w h" in
    relative center format (darknet's find_replace chain);
  - training augmentation (load_data_detection): a jittered aspect and
    scale, placement on a 0.5-gray canvas, HSV distortion, horizontal flip,
    and the boxes transformed and cleaned up alike.
The fused per-pixel chain runs the native C++ kernel (``utils/native.py``)
where it is built, and ``place_distort_flip_numpy`` otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from yolo_quantization_tpu_torch.data.image import (
    letterbox,
    letterbox_params,
    load_image_rgb,
    resize_bilinear_darknet,
)
from yolo_quantization_tpu_torch.train.loss import MAX_BOXES
from yolo_quantization_tpu_torch.utils import native


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


def boxes_to_truth(boxes: np.ndarray) -> np.ndarray:
    """(MAX_BOXES, 5) [x, y, w, h, cls] zero-padded: the loss's layout."""
    out = np.zeros((MAX_BOXES, 5), np.float32)
    n = min(len(boxes), MAX_BOXES)
    if n:
        out[:n, :4] = boxes[:n, 1:5]
        out[:n, 4] = boxes[:n, 0]
    return out


@dataclass
class AugmentConfig:
    """darknet's [net]/[yolo] augmentation knobs."""

    jitter: float = 0.3
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5
    flip: bool = True


def _rand_scale(rng: np.random.Generator, s: float) -> float:
    """darknet rand_scale: uniform in [1, s], inverted half the time."""
    scale = rng.uniform(1.0, s)
    return scale if rng.random() < 0.5 else 1.0 / scale


def distort_hsv(im: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig) -> np.ndarray:
    """Random hue shift and saturation/exposure scale."""
    dhue = rng.uniform(-cfg.hue, cfg.hue)
    dsat = _rand_scale(rng, cfg.saturation)
    dexp = _rand_scale(rng, cfg.exposure)
    return distort_hsv_params(im, dhue, dsat, dexp)


def distort_hsv_params(im: np.ndarray, dhue: float, dsat: float, dexp: float) -> np.ndarray:
    """Deterministic HSV distortion (darknet distort_image): RGB -> HSV, hue
    shift mod 1, saturation and value scaled and clamped, HSV -> RGB."""
    r, g, b = im[..., 0], im[..., 1], im[..., 2]
    mx = im.max(axis=-1)
    mn = im.min(axis=-1)
    v = mx
    delta = mx - mn
    s = np.where(mx > 0, delta / np.maximum(mx, 1e-12), 0.0)
    h = np.zeros_like(v)
    safe = delta > 0
    d = np.maximum(delta, 1e-12)
    h = np.where(safe & (mx == r), (g - b) / d % 6.0, h)
    h = np.where(safe & (mx == g), (b - r) / d + 2.0, h)
    h = np.where(safe & (mx == b), (r - g) / d + 4.0, h)
    h = h / 6.0
    h = (h + dhue) % 1.0
    s = np.clip(s * dsat, 0, 1)
    v = np.clip(v * dexp, 0, 1)
    h6 = h * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    f = h6 - np.floor(h6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = np.zeros_like(im)
    for idx, (rr, gg, bb) in enumerate(conds):
        m = i == idx
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out.astype(np.float32)


def place_distort_flip_numpy(im: np.ndarray, out_w: int, out_h: int, nw: int, nh: int, dx: int,
                             dy: int, dhue: float, dsat: float, dexp: float,
                             flip: bool) -> np.ndarray:
    """darknet-bilinear resize to (nh, nw), placement at (dx, dy) on a
    0.5-gray canvas, HSV distortion, optional horizontal flip."""
    resized = resize_bilinear_darknet(im, nw, nh)
    canvas = np.full((out_h, out_w, 3), 0.5, np.float32)
    sy0, sy1 = max(0, -dy), min(nh, out_h - dy)
    sx0, sx1 = max(0, -dx), min(nw, out_w - dx)
    if sy1 > sy0 and sx1 > sx0:
        canvas[dy + sy0 : dy + sy1, dx + sx0 : dx + sx1] = resized[sy0:sy1, sx0:sx1]
    canvas = distort_hsv_params(canvas, dhue, dsat, dexp)
    if flip:
        canvas = canvas[:, ::-1].copy()
    return canvas


def augment_detection(im: np.ndarray, boxes: np.ndarray, out_w: int, out_h: int,
                      rng: np.random.Generator,
                      cfg: AugmentConfig = AugmentConfig()) -> tuple[np.ndarray, np.ndarray]:
    """One training sample: a jittered aspect ratio and scale, the image
    resized and placed at a random offset on a 0.5-gray canvas, colours
    distorted, maybe flipped; the boxes get the same affine and flip, are
    clipped to the canvas, and those under 1e-3 wide or high dropped.  The
    draws come from ``rng`` in the reference's order."""
    h, w, _ = im.shape
    dw, dh = w * cfg.jitter, h * cfg.jitter
    new_ar = (w + rng.uniform(-dw, dw)) / max(h + rng.uniform(-dh, dh), 1e-6)
    scale = rng.uniform(0.25, 2.0)
    if new_ar < 1:
        nh = int(scale * out_h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * out_w)
        nh = int(nw / new_ar)
    nw, nh = max(nw, 1), max(nh, 1)
    dx = int(rng.uniform(0, max(out_w - nw, 0))) if out_w > nw else int(rng.uniform(out_w - nw, 0))
    dy = int(rng.uniform(0, max(out_h - nh, 0))) if out_h > nh else int(rng.uniform(out_h - nh, 0))
    dhue = rng.uniform(-cfg.hue, cfg.hue)
    dsat = _rand_scale(rng, cfg.saturation)
    dexp = _rand_scale(rng, cfg.exposure)
    flip = cfg.flip and rng.random() < 0.5

    canvas = native.augment_place(im, out_w, out_h, nw, nh, dx, dy, dhue, dsat, dexp, flip)

    out_boxes = []
    for cls, x, y, bw, bh in boxes:
        nx = (x * nw + dx) / out_w
        ny = (y * nh + dy) / out_h
        nbw = bw * nw / out_w
        nbh = bh * nh / out_h
        if flip:
            nx = 1.0 - nx
        x1 = np.clip(nx - nbw / 2, 0, 1)
        x2 = np.clip(nx + nbw / 2, 0, 1)
        y1 = np.clip(ny - nbh / 2, 0, 1)
        y2 = np.clip(ny + nbh / 2, 0, 1)
        nbw, nbh = x2 - x1, y2 - y1
        nx, ny = (x1 + x2) / 2, (y1 + y2) / 2
        if nbw > 1e-3 and nbh > 1e-3:
            out_boxes.append([cls, nx, ny, nbw, nbh])
    out = np.asarray(out_boxes, np.float32) if out_boxes else np.zeros((0, 5), np.float32)
    return canvas, out


class DetectionDataset:
    """Image list + labels; ``sample`` returns (augmented image, truth array)."""

    def __init__(self, list_file: str, net_w: int, net_h: int, augment: bool = True,
                 aug_cfg: AugmentConfig = AugmentConfig(), seed: int = 0):
        self.paths = read_image_list(list_file)
        self.net_w, self.net_h = net_w, net_h
        self.augment = augment
        self.aug_cfg = aug_cfg
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def set_size(self, net_w: int, net_h: int) -> None:
        """Switch the target resolution (multi-scale training) for the
        batches built from now on."""
        self.net_w, self.net_h = net_w, net_h

    def sample(self, idx: int, rng: np.random.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One (image, truth) draw.  Pass ``rng`` from several threads: a
        shared Generator would make the augmentation depend on scheduling."""
        path = self.paths[idx % len(self.paths)]
        im = load_image_rgb(path)
        boxes = read_boxes(label_path_for(path))
        if self.augment:
            im, boxes = augment_detection(im, boxes, self.net_w, self.net_h,
                                          rng if rng is not None else self.rng, self.aug_cfg)
        else:
            h, w, _ = im.shape
            im = letterbox(im, self.net_w, self.net_h)
            boxes = letterbox_boxes(boxes, w, h, self.net_w, self.net_h)
        return im, boxes_to_truth(boxes)


def letterbox_boxes(boxes: np.ndarray, img_w: int, img_h: int, net_w: int, net_h: int) -> np.ndarray:
    """The letterbox affine applied to truth boxes (relative -> relative)."""
    if len(boxes) == 0:
        return boxes
    new_w, new_h = letterbox_params(img_w, img_h, net_w, net_h)
    dx, dy = (net_w - new_w) // 2, (net_h - new_h) // 2
    out = boxes.copy()
    out[:, 1] = (boxes[:, 1] * new_w + dx) / net_w
    out[:, 2] = (boxes[:, 2] * new_h + dy) / net_h
    out[:, 3] = boxes[:, 3] * new_w / net_w
    out[:, 4] = boxes[:, 4] * new_h / net_h
    return out
