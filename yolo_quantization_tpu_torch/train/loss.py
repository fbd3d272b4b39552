"""YOLOv3 detection loss (static shapes, scatter-based truth assignment).

The counterpart of ``yolo_quantization_tpu/train/loss.py``: darknet's
delta-based yolo loss as a scalar objective with the same gradients.

- x/y/obj/class: darknet back-propagates (target - logistic(z)), which is
  d/dz of sigmoid cross-entropy, so those terms are BCE-with-logits;
- w/h: squared error on the raw outputs, half-weighted;
- box terms scaled by (2 - w*h);
- objectness target 0 everywhere, ignored where the predicted box overlaps a
  truth with IoU > ignore_thresh, 1 at assigned cells;
- each truth goes to the anchor with the best wh-IoU over all the network's
  anchors; the head whose mask holds that anchor owns it.

Truths are (B, MAX_BOXES, 5) [x, y, w, h, class], relative, zero-padded.

Two truths of one image that land in one cell and anchor write the same
target slot.  The reference scatters in truth order and the last write
stays (darknet's loop order); ``index_put_`` with repeated indices promises
no order on CUDA, so the scatter here keeps only the last truth of each slot
and writes unique indices.  The class target is written for every assigned
truth, as in the reference: two classes in one slot both get target 1.
The region and detection (yolov2/yolov1) losses belong to ROADMAP queue 1.8.
"""

from __future__ import annotations

import torch

MAX_BOXES = 90  # darknet's truth bound


def _bce_logits(logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy, numerically stable, with the reference's
    gradient at z = 0, where fake-quantized heads often sit: its max(z, 0)
    splits a tie in halves and its |z| has slope 1 at 0, so the gradient
    there is -target (not sigmoid(0) - target)."""
    abs_z = torch.where(logit >= 0, logit, -logit)
    return (torch.maximum(logit, logit.new_tensor(0.0)) - logit * target
            + torch.log1p(torch.exp(-abs_z)))


def _wh_iou(w1, h1, w2, h2):
    """IoU of origin-centred boxes (anchor matching)."""
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    union = w1 * h1 + w2 * h2 - inter
    return inter / torch.clamp(union, min=1e-12)


def _box_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of centre-format boxes, broadcasting on leading dims."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ay1, ay2 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bx1, bx2 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    by1, by2 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(union))


def _last_writer(slot: torch.Tensor, assign: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For (B, M) target slots, True where the entry is assigned and no later
    assigned entry (in row-major truth order) writes the same slot."""
    order = torch.arange(slot.numel(), device=slot.device).reshape(slot.shape)
    dest = torch.where(assign, slot, torch.full_like(slot, n_slots))
    last = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=slot.device)
    last = last.scatter_reduce(0, dest.reshape(-1), order.reshape(-1), reduce="amax")
    return assign & (last[dest] == order)


def yolo_head_loss(raw: torch.Tensor, truths: torch.Tensor, mask: tuple[int, ...],
                   anchors: tuple[tuple[float, float], ...], classes: int, net_w: int, net_h: int,
                   ignore_thresh: float = 0.7):
    """(loss, stats) of one yolo head: raw (B, H, W, A*(5+C)) conv output."""
    b, h, w, _ = raw.shape
    a = len(mask)
    dev = raw.device
    raw = raw.reshape(b, h, w, a, 5 + classes)
    anchors_arr = torch.tensor(anchors, dtype=torch.float32, device=dev)   # (total, 2)
    mask_arr = torch.tensor(mask, dtype=torch.int64, device=dev)
    head_anchors = anchors_arr[mask_arr]                                    # (a, 2)

    # predicted boxes, for the ignore mask (no gradient flows through it)
    with torch.no_grad():
        rd = raw.detach()
        cols = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w, 1)
        rows = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1, 1)
        px = (torch.sigmoid(rd[..., 0]) + cols) / w
        py = (torch.sigmoid(rd[..., 1]) + rows) / h
        pw = torch.exp(rd[..., 2]) * head_anchors[:, 0].reshape(1, 1, 1, a) / net_w
        ph = torch.exp(rd[..., 3]) * head_anchors[:, 1].reshape(1, 1, 1, a) / net_h
        pred_boxes = torch.stack([px, py, pw, ph], dim=-1)                  # (B,H,W,A,4)
        valid = truths[..., 2] > 0                                          # (B, M)
        ious = _box_iou_xywh(pred_boxes[:, :, :, :, None, :], truths[:, None, None, None, :, :4])
        best_iou = torch.amax(torch.where(valid[:, None, None, None, :], ious,
                                          torch.zeros_like(ious)), dim=-1)
        ignore = best_iou > ignore_thresh

        # truth -> anchor assignment
        t_xy = truths[..., 0:2]
        t_wh = truths[..., 2:4]
        t_cls = truths[..., 4].to(torch.int64)
        wh_ious = _wh_iou(t_wh[..., 0:1] * net_w, t_wh[..., 1:2] * net_h,
                          anchors_arr[None, None, :, 0], anchors_arr[None, None, :, 1])
        best_n = torch.argmax(wh_ious, dim=-1)                              # (B, M)
        hit = best_n[..., None] == mask_arr[None, None, :]
        in_head = hit.any(dim=-1)
        anchor_slot = torch.argmax(hit.to(torch.int32), dim=-1)
        gi = torch.clamp((t_xy[..., 0] * w).to(torch.int64), 0, w - 1)
        gj = torch.clamp((t_xy[..., 1] * h).to(torch.int64), 0, h - 1)
        assign = valid & in_head

        # targets in network units
        tx = t_xy[..., 0] * w - gi
        ty = t_xy[..., 1] * h - gj
        anchor_wh = anchors_arr[best_n]                                     # (B, M, 2)
        tw = torch.log(torch.clamp(t_wh[..., 0] * net_w / anchor_wh[..., 0], min=1e-9))
        th = torch.log(torch.clamp(t_wh[..., 1] * net_h / anchor_wh[..., 1], min=1e-9))
        box_scale = 2.0 - t_wh[..., 0] * t_wh[..., 1]

        # scatter onto the (B*H*W*A) grid; slot n_slots is the drop slot
        n_slots = b * h * w * a
        bi = torch.arange(b, device=dev)[:, None].expand_as(gi)
        slot = ((bi * h + gj) * w + gi) * a + anchor_slot
        winner = _last_writer(slot, assign, n_slots)
        dest = torch.where(winner, slot, torch.full_like(slot, n_slots)).reshape(-1)
        obj_target = torch.zeros(n_slots + 1, device=dev)
        obj_target[torch.where(assign, slot, torch.full_like(slot, n_slots)).reshape(-1)] = 1.0
        scale_grid = torch.zeros(n_slots + 1, device=dev)
        scale_grid[dest] = box_scale.reshape(-1)
        box_target = torch.zeros(n_slots + 1, 4, device=dev)
        box_target[dest] = torch.stack([tx, ty, tw, th], dim=-1).reshape(-1, 4)
        cls_target = torch.zeros((n_slots + 1) * classes, device=dev)
        cls_dest = torch.where(assign, slot * classes + t_cls, torch.full_like(slot, n_slots * classes))
        cls_target[cls_dest.reshape(-1)] = 1.0
        obj_target = obj_target[:n_slots].reshape(b, h, w, a)
        scale_grid = scale_grid[:n_slots].reshape(b, h, w, a)
        box_target = box_target[:n_slots].reshape(b, h, w, a, 4)
        cls_target = cls_target[: n_slots * classes].reshape(b, h, w, a, classes)
        assigned = obj_target > 0

    # loss terms (gradient-equivalent to darknet's deltas)
    zero = raw.new_tensor(0.0)
    xy_loss = scale_grid[..., None] * _bce_logits(raw[..., 0:2], box_target[..., 0:2])
    wh_loss = 0.5 * scale_grid[..., None] * (raw[..., 2:4] - box_target[..., 2:4]) ** 2
    obj_bce = _bce_logits(raw[..., 4], obj_target)
    obj_loss = torch.where(assigned, obj_bce, torch.where(ignore, zero, obj_bce))
    cls_loss = torch.where(assigned[..., None], _bce_logits(raw[..., 5:], cls_target), zero)
    total = (torch.sum(torch.where(assigned[..., None], xy_loss, zero))
             + torch.sum(torch.where(assigned[..., None], wh_loss, zero))
             + torch.sum(obj_loss) + torch.sum(cls_loss))
    with torch.no_grad():
        n_assigned = torch.sum(assigned)
        stats = {
            "obj_count": n_assigned,
            "avg_obj": torch.sum(torch.sigmoid(raw[..., 4]) * assigned) / torch.clamp(n_assigned, min=1),
            "best_iou_mean": torch.mean(best_iou),
        }
    return total, stats


def total_loss(heads, truths, net, input_hw: tuple[int, int] | None = None, seen=None):
    """Sum of the per-head losses over every detection head, divided by the
    batch.  ``input_hw`` is the resolution this batch ran at (multi-scale
    training), the network's nominal size by default.  ``seen`` gates the
    yolov2/yolov1 heads' early-training terms, which are not ported."""
    from yolo_quantization_tpu_torch.nn.graph import HEAD_SPECS, YoloSpec

    del seen
    net_h, net_w = input_hw if input_hw is not None else (net.height, net.width)
    specs = [s for s in net.specs if isinstance(s, HEAD_SPECS)]
    loss = 0.0
    all_stats = []
    with torch.profiler.record_function("yolo_loss"):
        for raw, s in zip(heads, specs):
            if not isinstance(s, YoloSpec):
                raise NotImplementedError(
                    f"the {type(s).__name__} loss belongs to the yolov2/yolov1 models and is "
                    "not ported yet (ROADMAP queue 1.8)")
            l, st = yolo_head_loss(raw, truths, s.mask, s.anchors, s.classes, net_w, net_h)
            loss = loss + l
            all_stats.append(st)
        return loss / heads[0].shape[0], all_stats
