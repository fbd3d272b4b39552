"""F1 / recall evaluation harnesses with darknet's counting protocols.

The counterpart of ``yolo_quantization_tpu/eval/f1.py``.  ``f1_sweep`` is
the benchmark harness of darknet's validate_detector_f1:

  for thresh in 0.1..0.7 step 0.1:
    per image: detections with objectness > thresh
               class-agnostic NMS 0.1
               TP_FP += ALL returned boxes (NMS-zeroed ones included)
               per truth: TP_FN++; TP++ if best IoU over
                          above-thresh dets > 0.1
    precision = TP/TP_FP, recall = TP/TP_FN, F1 = 2TP/(TP_FP+TP_FN)

``recall_eval`` mirrors validate_detector_recall.  NMS and truth matching
are the numpy versions in ``eval/detect.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from yolo_quantization_tpu_torch.data.image import letterbox, load_image_rgb
from yolo_quantization_tpu_torch.data.voc import label_path_for, read_boxes, read_image_list
from yolo_quantization_tpu_torch.eval import detect

THRESHOLDS = tuple(round(0.1 * i, 1) for i in range(1, 7))


@dataclass
class F1Row:
    thresh: float
    tp: int
    tp_fp: int
    tp_fn: int
    avg_iou: float

    @property
    def precision(self) -> float:
        return 100.0 * self.tp / max(self.tp_fp, 1)

    @property
    def recall(self) -> float:
        return 100.0 * self.tp / max(self.tp_fn, 1)

    @property
    def f1(self) -> float:
        return 100.0 * 2 * self.tp / max(self.tp_fp + self.tp_fn, 1)


def predict_batched(engine, paths: list[str], batch_size: int = 16):
    """Run a path list through the engine in fixed-size batches (padded);
    yields per-image (boxes_rel_to_image, obj, cls)."""
    net = engine.program.net
    for start in range(0, len(paths), batch_size):
        chunk = paths[start : start + batch_size]
        sizes = []
        batch = np.zeros((batch_size, net.height, net.width, 3), np.float32)
        for k, p in enumerate(chunk):
            im = load_image_rgb(p)
            sizes.append(im.shape[:2])
            batch[k] = letterbox(im, net.width, net.height)
        boxes, obj, cls = engine.predict(batch)
        for k in range(len(chunk)):
            h, w = sizes[k]
            yield (
                detect.correct_boxes(boxes[k], w, h, net.width, net.height),
                obj[k],
                cls[k],
            )


def f1_sweep(
    engine,
    list_file: str,
    thresholds=THRESHOLDS,
    iou_thresh: float = 0.1,
    nms: float = 0.1,
    max_images: int | None = None,
    verbose: bool = False,
) -> list[F1Row]:
    paths = read_image_list(list_file)
    if max_images:
        paths = paths[:max_images]
    # run the network once per image (batched); reuse detections across thresholds
    cache = []
    for p, (boxes, obj, _cls) in zip(paths, predict_batched(engine, paths)):
        cache.append((boxes, obj, read_boxes(label_path_for(p))))
    return f1_rows(cache, thresholds, iou_thresh, nms, verbose)


def f1_rows(
    cache,
    thresholds=THRESHOLDS,
    iou_thresh: float = 0.1,
    nms: float = 0.1,
    verbose: bool = False,
) -> list[F1Row]:
    """The detector-f1 counting protocol over precomputed per-image
    (boxes, obj, truths) triples; truths rows are [cls, x, y, w, h]."""
    rows = []
    for thresh in thresholds:
        tp = tp_fp = tp_fn = 0
        avg_iou = 0.0
        for boxes, obj, truths in cache:
            keep = obj > thresh
            b, o = boxes[keep], obj[keep]
            b, o, _ = detect.nms_obj(b, o, np.zeros((len(o), 1), np.float32), nms)
            tp_fp += len(o)  # includes NMS-zeroed entries, as darknet counts
            if len(truths):
                n_tp, iou_acc = detect.match_truths(b, o, truths[:, 1:5], thresh, iou_thresh)
                tp += n_tp
                tp_fn += len(truths)
                avg_iou += iou_acc
        row = F1Row(thresh, tp, tp_fp, tp_fn, avg_iou / max(tp_fn, 1))
        rows.append(row)
        if verbose:
            print(
                f"thresh {thresh:.1f}: recall {row.recall:.2f} "
                f"precision {row.precision:.2f} F1 {row.f1:.2f} "
                f"(TP {tp} / TP_FP {tp_fp} / TP_FN {tp_fn})"
            )
    return rows


def recall_eval(
    engine, list_file: str, thresh: float = 0.25, iou_thresh: float = 0.5,
    nms: float = 0.4, max_images: int | None = None,
) -> dict:
    """Proposals / IoU / recall per darknet's validate_detector_recall."""
    paths = read_image_list(list_file)
    if max_images:
        paths = paths[:max_images]
    total = correct = proposals = 0
    iou_sum = 0.0
    for p, (boxes, obj, _) in zip(paths, predict_batched(engine, paths, batch_size=1)):
        keep = obj > thresh
        b, o = boxes[keep], obj[keep]
        b, o, _ = detect.nms_obj(b, o, np.zeros((len(o), 1), np.float32), nms)
        live = o > thresh
        proposals += int(live.sum())
        for t in read_boxes(label_path_for(p)):
            total += 1
            best = float(np.max(detect.box_iou(b[live], t[1:5]))) if live.any() else 0.0
            iou_sum += best
            if best > iou_thresh:
                correct += 1
    return {
        "recall": 100.0 * correct / max(total, 1),
        "avg_iou": 100.0 * iou_sum / max(total, 1),
        "proposals_per_image": proposals / max(len(paths), 1),
        "total_truths": total,
    }
