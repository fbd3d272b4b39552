"""Head decode (yolo, region, detection), flip-TTA averaging, top-k
prefilter, box correction, NMS and truth matching.

The counterpart of ``yolo_quantization_tpu/eval/detect.py``: decode and
top-k run on the engine's device in PyTorch; box correction, NMS (darknet's
do_nms_obj and do_nms_sort) and the F1 harness's truth matching run on the
host in numpy with darknet's semantics: the fallbacks of the native host
runtime (``utils/native.py``), which the harnesses call.  A WordTree region
head decodes to joint path probabilities on the device, and
``tree_top_probs`` picks each detection's node on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_quantization_tpu_torch.core.tree import hierarchy_predictions, hierarchy_top_prediction
from yolo_quantization_tpu_torch.nn.graph import DetectionSpec, RegionSpec, YoloSpec


def decode_head(
    raw: torch.Tensor,
    anchors: torch.Tensor,
    num_classes: int,
    net_w: int,
    net_h: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one YOLO head.

    raw: (N, H, W, A*(5+C)) float; anchors: (A, 2) anchor (w, h) in input
    pixels.  Returns boxes (N, H*W*A, 4) center-format relative to the
    network input, objectness (N, H*W*A) and class probs (N, H*W*A, C):
    bx=(i+sig(tx))/W, by=(j+sig(ty))/H, bw=exp(tw)*aw/net_w, bh=exp(th)*ah/net_h.
    """
    n, h, w, _ = raw.shape
    a = anchors.shape[0]
    raw = raw.reshape(n, h, w, a, 5 + num_classes)
    tx, ty, tw, th = raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3]
    obj = torch.sigmoid(raw[..., 4])
    cls = torch.sigmoid(raw[..., 5:])
    cols = torch.arange(w, dtype=torch.float32, device=raw.device).reshape(1, 1, w, 1)
    rows = torch.arange(h, dtype=torch.float32, device=raw.device).reshape(1, h, 1, 1)
    bx = (torch.sigmoid(tx) + cols) / w
    by = (torch.sigmoid(ty) + rows) / h
    bw = torch.exp(tw) * anchors[:, 0].reshape(1, 1, 1, a) / net_w
    bh = torch.exp(th) * anchors[:, 1].reshape(1, 1, 1, a) / net_h
    boxes = torch.stack([bx, by, bw, bh], dim=-1)
    return (
        boxes.reshape(n, h * w * a, 4),
        obj.reshape(n, h * w * a),
        cls.reshape(n, h * w * a, num_classes),
    )


def decode_region_head(out: torch.Tensor, spec) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode a YOLOv2 [region] head from its forward output (x, y and
    objectness already logistic, classes already softmaxed).  Region
    anchors are in feature-grid units: bw = exp(tw) * anchor_w / W.  With a
    WordTree the classes become joint path probabilities
    (get_region_detections' hierarchy_predictions, src/region_layer.c:414-416);
    ``tree_top_probs`` then picks each detection's node on the host."""
    n, h, w, _ = out.shape
    a = spec.num
    r = out.reshape(n, h, w, a, 5 + spec.classes)
    anchors = torch.tensor(spec.anchors, dtype=torch.float32, device=out.device)
    cols = torch.arange(w, dtype=torch.float32, device=out.device).reshape(1, 1, w, 1)
    rows = torch.arange(h, dtype=torch.float32, device=out.device).reshape(1, h, 1, 1)
    bx = (r[..., 0] + cols) / w
    by = (r[..., 1] + rows) / h
    bw = torch.exp(r[..., 2]) * anchors[:, 0].reshape(1, 1, 1, a) / w
    bh = torch.exp(r[..., 3]) * anchors[:, 1].reshape(1, 1, 1, a) / h
    boxes = torch.stack([bx, by, bw, bh], dim=-1)
    cls = r[..., 5:]
    if spec.tree is not None:
        cls = hierarchy_predictions(cls, spec.tree)
    return (
        boxes.reshape(n, h * w * a, 4),
        r[..., 4].reshape(n, h * w * a),
        cls.reshape(n, h * w * a, spec.classes),
    )


def tree_top_probs(cls: np.ndarray, obj: np.ndarray, tree, thresh: float,
                   tree_thresh: float = 0.5) -> np.ndarray:
    """Sparse per-detection class probabilities of a WordTree region head
    (the reference's map-less tree branch, src/region_layer.c:424-426): for
    each detection above ``thresh``, the greedy descent over the joint
    probabilities ``decode_region_head`` gives, and the detection's
    objectness on the node it picks."""
    cls = np.asarray(cls)
    obj = np.asarray(obj)
    out = np.zeros_like(cls)
    for d in np.nonzero(obj > thresh)[0]:
        out[d, hierarchy_top_prediction(cls[d], tree, tree_thresh)] = obj[d]
    return out


def decode_detection_head(out: torch.Tensor, spec) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode a YOLOv1 [detection] head: the flat layout [S*S*C class
    probs][S*S*B confidences][S*S*B*4 boxes], w and h squared with
    ``sqrt``; the B boxes of a cell share its class probs."""
    n = out.shape[0]
    s2, b, c = spec.side * spec.side, spec.num, spec.classes
    probs = out[:, : s2 * c].reshape(n, s2, c)
    confs = out[:, s2 * c : s2 * (c + b)].reshape(n, s2, b)
    boxes = out[:, s2 * (c + b) :].reshape(n, s2, b, 4)
    cells = torch.arange(s2, device=out.device)
    col = (cells % spec.side).to(torch.float32)
    row = (cells // spec.side).to(torch.float32)
    bx = (boxes[..., 0] + col[None, :, None]) / spec.side
    by = (boxes[..., 1] + row[None, :, None]) / spec.side
    bw = boxes[..., 2] ** 2 if spec.sqrt else boxes[..., 2]
    bh = boxes[..., 3] ** 2 if spec.sqrt else boxes[..., 3]
    out_boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(n, s2 * b, 4)
    return out_boxes, confs.reshape(n, s2 * b), probs[:, :, None, :].expand(n, s2, b, c).reshape(n, s2 * b, c)


def flip_average_head(a: torch.Tensor, b: torch.Tensor, classes: int) -> torch.Tensor:
    """Average a yolo head's raw output over the horizontal-flip TTA pair
    (darknet's avg_flipped_yolo).  ``a`` is the head on the image, ``b`` on
    its W-mirror, both (N, H, W, A*(5+C)); ``b`` is mirrored back and its tx
    entries negated (sig(-t) = 1 - sig(t) mirrors bx exactly)."""
    n, h, w, c = a.shape
    blk = 5 + classes
    bf = b.flip(2).reshape(n, h, w, c // blk, blk).clone()
    bf[..., 0] *= -1.0
    return (a + bf.reshape(n, h, w, c)) / 2.0


def decode_all_heads(heads, net):
    """Decode every head (yolo, region, detection) and concat along the
    candidate axis."""
    head_specs = [
        s for s in net.specs if isinstance(s, (YoloSpec, RegionSpec, DetectionSpec))
    ]
    assert len(head_specs) == len(heads)
    parts = []
    for raw, spec in zip(heads, head_specs):
        if isinstance(spec, YoloSpec):
            anchors = torch.tensor(
                [spec.anchors[m] for m in spec.mask], dtype=torch.float32, device=raw.device
            )
            parts.append(decode_head(raw, anchors, spec.classes, net.width, net.height))
        elif isinstance(spec, RegionSpec):
            parts.append(decode_region_head(raw, spec))
        else:
            parts.append(decode_detection_head(raw, spec))
    boxes = torch.cat([p[0] for p in parts], dim=1)
    obj = torch.cat([p[1] for p in parts], dim=1)
    cls = torch.cat([p[2] for p in parts], dim=1)
    return boxes, obj, cls


def top_k_detections(boxes, obj, cls, max_det: int = 256, approx: bool = False):
    """Device-side top-k by objectness, so only O(max_det) boxes reach the host.

    Ties keep the lower index first, as ``lax.top_k`` does: dequantized heads
    take only 256 values per channel, so equal objectness is common, and
    ``torch.topk`` promises no order among ties.  A stable descending sort
    does.  ``approx`` (the reference's TPU approximate top-k, which may drop
    a low-ranked candidate) is accepted and runs this exact top-k: CUDA has
    no counterpart, and the port invents no lossy path.
    """
    del approx
    max_det = min(max_det, obj.shape[1])
    val, idx = torch.sort(obj, dim=1, descending=True, stable=True)
    val, idx = val[:, :max_det], idx[:, :max_det]
    return (
        torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[2])),
        val,
        torch.gather(cls, 1, idx[..., None].expand(-1, -1, cls.shape[2])),
    )


def correct_boxes(
    boxes: np.ndarray, img_w: int, img_h: int, net_w: int, net_h: int
) -> np.ndarray:
    """Invert the letterbox transform (relative coords)."""
    if net_w / img_w < net_h / img_h:
        new_w, new_h = net_w, (img_h * net_w) // img_w
    else:
        new_w, new_h = (img_w * net_h) // img_h, net_h
    out = boxes.astype(np.float64).copy()
    out[:, 0] = (out[:, 0] - (net_w - new_w) / 2.0 / net_w) / (new_w / net_w)
    out[:, 1] = (out[:, 1] - (net_h - new_h) / 2.0 / net_h) / (new_h / net_h)
    out[:, 2] *= net_w / new_w
    out[:, 3] *= net_h / new_h
    return out.astype(np.float32)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (..., 4) center-format boxes."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ay1, ay2 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bx1, bx2 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    by1, by2 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iw = np.maximum(0.0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0.0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def nms_obj(
    boxes: np.ndarray, obj: np.ndarray, cls: np.ndarray, nms_thresh: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """darknet do_nms_obj: class-agnostic greedy NMS.

    Sorts by objectness descending; a later box with IoU > thresh against a
    surviving box gets its objectness and class probs zeroed but stays in the
    arrays (the F1 harness counts zeroed entries).
    """
    order = np.argsort(-obj, kind="stable")
    boxes, obj, cls = boxes[order].copy(), obj[order].copy(), cls[order].copy()
    for i in range(len(obj)):
        if obj[i] == 0:
            continue
        suppress = box_iou(boxes[i + 1 :], boxes[i]) > nms_thresh
        obj[i + 1 :][suppress] = 0.0
        cls[i + 1 :][suppress] = 0.0
    return boxes, obj, cls


def nms_sort_per_class(boxes: np.ndarray, probs: np.ndarray, nms_thresh: float) -> np.ndarray:
    """darknet do_nms_sort: per-class greedy suppression.  probs (M, C) =
    objectness * class prob; returns a copy with the suppressed entries
    zeroed, each class on its own."""
    probs = probs.copy()
    for c in range(probs.shape[1]):
        order = np.argsort(-probs[:, c], kind="stable")
        for oi, i in enumerate(order):
            if probs[i, c] == 0:
                continue
            rest = order[oi + 1 :]
            ious = box_iou(boxes[rest], boxes[i])
            probs[rest[ious > nms_thresh], c] = 0.0
    return probs


def match_truths(
    det_boxes: np.ndarray, det_obj: np.ndarray, truth_boxes: np.ndarray,
    thresh: float, iou_thresh: float,
) -> tuple[int, float]:
    """(TP count, sum of best IoUs) for the F1 harness: per truth, the best
    IoU over detections with objectness > thresh; a TP when above
    ``iou_thresh`` (darknet's validate_detector_f1 inner loop)."""
    db, do, tb = (np.asarray(a, np.float32) for a in (det_boxes, det_obj, truth_boxes))
    live = do > thresh
    tp, acc = 0, 0.0
    for t in tb:
        best = float(np.max(box_iou(db[live], t))) if live.any() else 0.0
        acc += best
        if best > iou_thresh:
            tp += 1
    return tp, acc
