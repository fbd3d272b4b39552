"""YOLO head decode, flip-TTA averaging, top-k prefilter, box correction,
NMS and truth matching.

The counterpart of ``yolo_quantization_tpu/eval/detect.py`` for yolo heads:
decode and top-k run on the engine's device in PyTorch; box correction, NMS
and the F1 harness's truth matching run on the host in numpy with darknet's
semantics (the numpy forms of ``yolo_quantization_tpu/utils/native.py``).
Region (yolov2) and detection (yolov1) heads are not ported yet (ROADMAP
queue 1.4).
"""

from __future__ import annotations

import numpy as np
import torch

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
    """Decode every yolo head and concat along the candidate axis."""
    head_specs = [
        s for s in net.specs if isinstance(s, (YoloSpec, RegionSpec, DetectionSpec))
    ]
    assert len(head_specs) == len(heads)
    parts = []
    for raw, spec in zip(heads, head_specs):
        if not isinstance(spec, YoloSpec):
            raise NotImplementedError(
                f"{type(spec).__name__} decode is not ported yet (ROADMAP queue 1.4)"
            )
        anchors = torch.tensor(
            [spec.anchors[m] for m in spec.mask], dtype=torch.float32, device=raw.device
        )
        parts.append(decode_head(raw, anchors, spec.classes, net.width, net.height))
    boxes = torch.cat([p[0] for p in parts], dim=1)
    obj = torch.cat([p[1] for p in parts], dim=1)
    cls = torch.cat([p[2] for p in parts], dim=1)
    return boxes, obj, cls


def top_k_detections(boxes, obj, cls, max_det: int = 256, approx: bool = False):
    """Device-side top-k by objectness, so only O(max_det) boxes reach the host.

    Ties keep the lower index first, as ``lax.top_k`` does: dequantized heads
    take only 256 values per channel, so equal objectness is common, and
    ``torch.topk`` promises no order among ties.  A stable descending sort
    does.
    """
    if approx:
        raise NotImplementedError("approx top-k is not ported yet (ROADMAP queue 1.4)")
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
