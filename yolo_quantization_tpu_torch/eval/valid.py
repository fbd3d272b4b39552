"""Detection-format writers and mAP evaluation.

The counterpart of ``yolo_quantization_tpu/eval/valid.py`` (darknet's
validate_detector family): VOC comp4 per-class result files, COCO-format
JSON and the ImageNet detection text file, each image one forward of the
engine, plus ``voc_map``, which computes AP and mAP from the detections
directly (all-point interpolation, or VOC2007's 11 points).  Letterbox and
per-class NMS go through the native host runtime (``utils/native.py``)
where it is built.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from yolo_quantization_tpu_torch.data.image import load_image_rgb
from yolo_quantization_tpu_torch.data.voc import label_path_for, read_boxes, read_image_list
from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.utils import native


def read_map(path: str) -> list[int]:
    """Class-index map file, one int per line (darknet's read_map): eval
    class j takes the model's class map[j]."""
    with open(path) as f:
        return [int(ln) for ln in f if ln.strip()]


def _predict(engine, path, flip: bool = False, class_map=None):
    """One image through ``engine.predict``: (boxes relative to the image,
    objectness, class probs, width, height)."""
    im = load_image_rgb(path)
    h, w, _ = im.shape
    net = engine.program.net
    x = native.letterbox(im, net.width, net.height)
    boxes, obj, cls = engine.predict(x[None], flip=flip)
    cls = cls[0]
    if class_map is not None:
        cls = cls[:, np.asarray(class_map, np.int64)]
    boxes = detect.correct_boxes(boxes[0], w, h, net.width, net.height)
    return boxes, obj[0], cls, w, h


def _paths(list_file: str, max_images: int | None) -> list[str]:
    paths = read_image_list(list_file)
    return paths[:max_images] if max_images else paths


def _probs(boxes, obj, cls, nms: float) -> np.ndarray:
    """objectness x class probs, suppressed per class (do_nms_sort)."""
    return native.nms_sort(boxes, obj[:, None] * cls, nms)


def image_id(path: str) -> int:
    """The COCO image id: the digits of the file stem, else a hash of it."""
    stem = os.path.splitext(os.path.basename(path))[0]
    digits = "".join(ch for ch in stem if ch.isdigit())
    return int(digits) if digits else abs(hash(stem)) % 10**9


def write_voc_results(
    engine, list_file: str, out_dir: str, class_names: list[str],
    thresh: float = 0.005, nms: float = 0.45, max_images: int | None = None,
    flip: bool = False, class_map: list[int] | None = None,
) -> dict[str, str]:
    """VOC comp4_det_test_<class>.txt files (print_detector_detections): one
    line per detection, "<image_id> <score> <x1> <y1> <x2> <y2>" in 1-based
    pixel coordinates."""
    os.makedirs(out_dir, exist_ok=True)
    files = {c: open(os.path.join(out_dir, f"comp4_det_test_{c}.txt"), "w") for c in class_names}
    try:
        for p in _paths(list_file, max_images):
            stem = os.path.splitext(os.path.basename(p))[0]
            boxes, obj, cls, w, h = _predict(engine, p, flip=flip, class_map=class_map)
            probs = _probs(boxes, obj, cls, nms)
            for k in range(len(boxes)):
                x, y, bw, bh = boxes[k]
                x1 = max(x - bw / 2, 0.0) * w + 1
                x2 = min(x + bw / 2, 1.0) * w + 1
                y1 = max(y - bh / 2, 0.0) * h + 1
                y2 = min(y + bh / 2, 1.0) * h + 1
                for ci, cname in enumerate(class_names):
                    if probs[k, ci] > thresh:
                        files[cname].write(
                            f"{stem} {probs[k, ci]:.6f} {x1:.6f} {y1:.6f} {x2:.6f} {y2:.6f}\n")
    finally:
        for f in files.values():
            f.close()
    return {c: os.path.join(out_dir, f"comp4_det_test_{c}.txt") for c in class_names}


def write_coco_results(
    engine, list_file: str, out_path: str, thresh: float = 0.005,
    nms: float = 0.45, max_images: int | None = None, flip: bool = False,
    class_map: list[int] | None = None,
) -> str:
    """COCO-format JSON (print_cocos): image_id, category_id, bbox as
    [x, y, w, h] in pixels, score."""
    results = []
    for p in _paths(list_file, max_images):
        iid = image_id(p)
        boxes, obj, cls, w, h = _predict(engine, p, flip=flip, class_map=class_map)
        probs = _probs(boxes, obj, cls, nms)
        for k in range(len(boxes)):
            x, y, bw, bh = boxes[k]
            bx = (x - bw / 2) * w
            by = (y - bh / 2) * h
            for ci in range(probs.shape[1]):
                if probs[k, ci] > thresh:
                    results.append({
                        "image_id": iid,
                        "category_id": ci,
                        "bbox": [float(bx), float(by), float(bw * w), float(bh * h)],
                        "score": float(probs[k, ci]),
                    })
    with open(out_path, "w") as f:
        json.dump(results, f)
    return out_path


def write_imagenet_results(
    engine, list_file: str, out_path: str, thresh: float = 0.005,
    nms: float = 0.45, max_images: int | None = None, flip: bool = False,
    class_map: list[int] | None = None,
) -> str:
    """ImageNet detection text (print_imagenet_detections): one file,
    "<image_index> <cls+1> <score> <x1> <y1> <x2> <y2>" with pixel
    coordinates clamped to the image, image_index 1-based over the list."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for idx, p in enumerate(_paths(list_file, max_images), start=1):
            boxes, obj, cls, w, h = _predict(engine, p, flip=flip, class_map=class_map)
            probs = _probs(boxes, obj, cls, nms)
            for k in range(len(boxes)):
                x, y, bw, bh = boxes[k]
                x1 = max((x - bw / 2) * w, 0.0)
                x2 = min((x + bw / 2) * w, float(w))
                y1 = max((y - bh / 2) * h, 0.0)
                y2 = min((y + bh / 2) * h, float(h))
                for ci in range(probs.shape[1]):
                    if probs[k, ci] > thresh:
                        f.write(f"{idx} {ci + 1} {probs[k, ci]:.6f} "
                                f"{x1:.6f} {y1:.6f} {x2:.6f} {y2:.6f}\n")
    return out_path


def voc_map(
    engine, list_file: str, num_classes: int, iou_thresh: float = 0.5,
    thresh: float = 0.005, nms: float = 0.45, max_images: int | None = None,
    use_07_metric: bool = False, flip: bool = False,
    class_map: list[int] | None = None,
) -> dict:
    """VOC mAP over the list: per class, detections by descending score
    matched greedily to unused truths at IoU >= ``iou_thresh``.  Returns
    {"map": float, "ap": [per class, NaN without truths], "num_truths": [...]}."""
    dets = defaultdict(list)    # class -> [(score, image index, box)]
    truths = defaultdict(list)  # (class, image index) -> [box]
    n_truth = np.zeros(num_classes, np.int64)
    for idx, p in enumerate(_paths(list_file, max_images)):
        boxes, obj, cls, w, h = _predict(engine, p, flip=flip, class_map=class_map)
        probs = _probs(boxes, obj, cls, nms)
        for k in range(len(boxes)):
            for ci in range(num_classes):
                if probs[k, ci] > thresh:
                    dets[ci].append((float(probs[k, ci]), idx, boxes[k]))
        for t in read_boxes(label_path_for(p)):
            ci = int(t[0])
            if ci < num_classes:
                truths[(ci, idx)].append(t[1:5])
                n_truth[ci] += 1

    aps = []
    for ci in range(num_classes):
        d = sorted(dets[ci], key=lambda r: -r[0])
        npos = int(n_truth[ci])
        if npos == 0:
            aps.append(float("nan"))
            continue
        used: dict[tuple[int, int], np.ndarray] = {}
        tp = np.zeros(len(d))
        fp = np.zeros(len(d))
        for di, (_, idx, box) in enumerate(d):
            key = (ci, idx)
            gt = truths.get(key, [])
            if not gt:
                fp[di] = 1
                continue
            if key not in used:
                used[key] = np.zeros(len(gt), bool)
            ious = detect.box_iou(np.asarray(gt, np.float32), box)
            best = int(np.argmax(ious))
            if ious[best] >= iou_thresh and not used[key][best]:
                tp[di] = 1
                used[key][best] = True
            else:
                fp[di] = 1
        rec = np.cumsum(tp) / npos
        prec = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-9)
        aps.append(_average_precision(rec, prec, use_07_metric))
    valid = [a for a in aps if not np.isnan(a)]
    return {"map": float(np.mean(valid)) if valid else 0.0, "ap": aps,
            "num_truths": n_truth.tolist()}


def _average_precision(rec, prec, use_07_metric: bool) -> float:
    """Area under the precision-recall curve: VOC2007's 11-point mean, or
    all points under the monotone precision envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
