"""Detection losses (static shapes, scatter-based truth assignment): the
yolo (v3), region (v2) and detection (v1) heads.

The counterpart of ``yolo_quantization_tpu/train/loss.py``: darknet's
delta-based losses as scalar objectives with the same gradients.  The yolo
loss:

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
truth, as in the reference: two classes in one slot both get target 1.  The
region loss resolves its slots the same way; the detection loss's truth
grid keeps the first box of a cell (darknet's fill_truth_region).  No
scatter here adds values (no ``index_add_``, ``scatter_add_`` or
accumulating ``index_put_``), so the losses and their gradients are a fixed
function of their inputs on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_quantization_tpu_torch.core.tree import path_rows, sibling_rows

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
    zero = a.new_tensor(0.0)
    iw = torch.maximum(zero, torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1))
    ih = torch.maximum(zero, torch.minimum(ay2, by2) - torch.maximum(ay1, by1))
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(union > 0, inter / torch.maximum(union, a.new_tensor(1e-12)), zero)


def _last_writer(slot: torch.Tensor, assign: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For (B, M) target slots, True where the entry is assigned and no later
    assigned entry (in row-major truth order) writes the same slot."""
    order = torch.arange(slot.numel(), device=slot.device).reshape(slot.shape)
    dest = torch.where(assign, slot, torch.full_like(slot, n_slots))
    last = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=slot.device)
    last = last.scatter_reduce(0, dest.reshape(-1), order.reshape(-1), reduce="amax")
    return assign & (last[dest] == order)


def _scatter_targets(slot, assign, t_cls, box_scale, box, grid_shape, classes):
    """The (B, M) assigned truths scattered onto the (B, H, W, A) grid, slot
    by slot: (assigned mask, box scale, box target (4), class target (C)).
    A slot written by several truths keeps the last one's scale and box
    (``_last_writer``) and gets target 1 for every one of their classes."""
    n_slots = int(np.prod(grid_shape))
    drop = torch.full_like(slot, n_slots)  # the extra slot that takes unassigned entries
    dest = torch.where(_last_writer(slot, assign, n_slots), slot, drop).reshape(-1)
    assigned = torch.zeros(n_slots + 1, dtype=torch.bool, device=slot.device)
    assigned[torch.where(assign, slot, drop).reshape(-1)] = True
    scale = box_scale.new_zeros(n_slots + 1)
    scale[dest] = box_scale.reshape(-1)
    target = box.new_zeros(n_slots + 1, 4)
    target[dest] = box.reshape(-1, 4)
    cls_target = box.new_zeros((n_slots + 1) * classes)
    cls_target[torch.where(assign, slot * classes + t_cls, drop * classes).reshape(-1)] = 1.0
    return (assigned[:n_slots].reshape(grid_shape), scale[:n_slots].reshape(grid_shape),
            target[:n_slots].reshape(*grid_shape, 4),
            cls_target[: n_slots * classes].reshape(*grid_shape, classes))


def _scatter_rows(slot, assign, rows, grid_shape):
    """(B, M, C) per-truth rows onto the (B, H, W, A) grid, a slot several
    truths write keeping the last one's row; zeros elsewhere."""
    n_slots = int(np.prod(grid_shape))
    dest = torch.where(_last_writer(slot, assign, n_slots), slot, torch.full_like(slot, n_slots))
    c = rows.shape[-1]
    grid = rows.new_zeros(n_slots + 1, c)
    grid[dest.reshape(-1)] = rows.reshape(-1, c)
    return grid[:n_slots].reshape(*grid_shape, c)


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

        bi = torch.arange(b, device=dev)[:, None].expand_as(gi)
        slot = ((bi * h + gj) * w + gi) * a + anchor_slot
        assigned, scale_grid, box_target, cls_target = _scatter_targets(
            slot, assign, t_cls, box_scale, torch.stack([tx, ty, tw, th], dim=-1), (b, h, w, a), classes)
        obj_target = assigned.to(raw.dtype)

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


def region_head_loss(out: torch.Tensor, truths: torch.Tensor, anchors: tuple[tuple[float, float], ...],
                     classes: int, ignore_thresh: float = 0.6, object_scale: float = 5.0,
                     noobject_scale: float = 1.0, class_scale: float = 1.0, coord_scale: float = 1.0,
                     rescore: bool = True, tree=None, seen=None):
    """YOLOv2 [region] loss on the head's forward output (x, y and
    objectness logistic, classes softmaxed), as darknet's deltas: squared
    errors times the term's scale; the objectness target is the predicted
    box's best IoU with ``rescore`` (its gradient flows into the box, as in
    the reference's autodiff), 1 otherwise.  With ``seen`` (images so far)
    below 12,800, every anchor not assigned a truth is pulled toward the
    prior centred in its cell (x = y = 0.5, raw w = h = 0) at weight .01.
    With a WordTree (``tree``) the class targets are hierarchical
    (delta_region_class's tree branch, src/region_layer.c:117-129): 1 on the
    truth's node and each ancestor, 0 on the rest of their sibling groups,
    and every other node's class term masked out; a slot several truths
    write keeps the last one's rows."""
    b, h, w, _ = out.shape
    a = len(anchors)
    dev = out.device
    r = out.reshape(b, h, w, a, 5 + classes)
    anchors_arr = torch.tensor(anchors, dtype=torch.float32, device=dev)  # grid units

    cols = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w, 1)
    rows = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1, 1)
    px = (r[..., 0] + cols) / w
    py = (r[..., 1] + rows) / h
    pw = torch.exp(r[..., 2]) * anchors_arr[:, 0].reshape(1, 1, 1, a) / w
    ph = torch.exp(r[..., 3]) * anchors_arr[:, 1].reshape(1, 1, 1, a) / h
    pred_boxes = torch.stack([px, py, pw, ph], dim=-1)
    obj = r[..., 4]
    cls = r[..., 5:]

    valid = truths[..., 2] > 0
    ious = _box_iou_xywh(pred_boxes[:, :, :, :, None, :], truths[:, None, None, None, :, :4])
    best_iou = torch.amax(torch.where(valid[:, None, None, None, :], ious, ious.new_tensor(0.0)), dim=-1)

    with torch.no_grad():
        ignore = best_iou > ignore_thresh
        # truth assignment: the cell of the centre, the best wh-IoU anchor
        t_xy, t_wh = truths[..., 0:2], truths[..., 2:4]
        t_cls = truths[..., 4].to(torch.int64)
        wh_ious = _wh_iou(t_wh[..., 0:1] * w, t_wh[..., 1:2] * h,
                          anchors_arr[None, None, :, 0], anchors_arr[None, None, :, 1])
        best_n = torch.argmax(wh_ious, dim=-1)
        gi = torch.clamp((t_xy[..., 0] * w).to(torch.int64), 0, w - 1)
        gj = torch.clamp((t_xy[..., 1] * h).to(torch.int64), 0, h - 1)
        tx = t_xy[..., 0] * w - gi
        ty = t_xy[..., 1] * h - gj
        anchor_wh = anchors_arr[best_n]
        tw = torch.log(torch.clamp(t_wh[..., 0] * w / anchor_wh[..., 0], min=1e-9))
        th = torch.log(torch.clamp(t_wh[..., 1] * h / anchor_wh[..., 1], min=1e-9))
        box_scale = coord_scale * (2.0 - t_wh[..., 0] * t_wh[..., 1])

        bi = torch.arange(b, device=dev)[:, None].expand_as(gi)
        slot = ((bi * h + gj) * w + gi) * a + best_n
        assigned, scale_grid, box_target, cls_target = _scatter_targets(
            slot, valid, t_cls, box_scale, torch.stack([tx, ty, tw, th], dim=-1), (b, h, w, a), classes)
        cls_mask = None
        if tree is not None:
            label = torch.where(valid, t_cls, torch.zeros_like(t_cls))
            cls_target = _scatter_rows(slot, valid, path_rows(tree, label), (b, h, w, a))
            cls_mask = _scatter_rows(slot, valid, sibling_rows(tree, label), (b, h, w, a))

    zero = out.new_tensor(0.0)
    coord_loss = 0.5 * scale_grid[..., None] * ((r[..., 0:2] - box_target[..., 0:2]) ** 2
                                                + (r[..., 2:4] - box_target[..., 2:4]) ** 2)
    iou_at_cell = torch.where(assigned, best_iou, zero)
    obj_tgt = torch.where(assigned, iou_at_cell if rescore else out.new_tensor(1.0), zero)
    obj_w = torch.where(assigned, out.new_tensor(object_scale),
                        torch.where(ignore, zero, out.new_tensor(noobject_scale)))
    obj_loss = 0.5 * obj_w * (obj - obj_tgt) ** 2
    cls_sq = 0.5 * class_scale * (cls - cls_target) ** 2
    if cls_mask is not None:
        cls_sq = cls_sq * cls_mask
    cls_loss = torch.where(assigned[..., None], cls_sq, zero)
    total = (torch.sum(torch.where(assigned[..., None], coord_loss, zero))
             + torch.sum(obj_loss) + torch.sum(cls_loss))
    if seen is not None and int(seen) < 12800:
        # the reference writes the prior's delta and then overwrites it at
        # the assigned anchor's box: assigned anchors see only the truth
        prior = 0.5 * 0.01 * ((r[..., 0] - 0.5) ** 2 + (r[..., 1] - 0.5) ** 2
                              + r[..., 2] ** 2 + r[..., 3] ** 2)
        total = total + torch.sum(prior * (1.0 - assigned.to(prior.dtype)))
    with torch.no_grad():
        n_assigned = torch.sum(assigned)
        stats = {"obj_count": n_assigned,
                 "avg_obj": torch.sum(obj * assigned) / torch.clamp(n_assigned, min=1)}
    return total, stats


def encode_detection_truth(truths: torch.Tensor, side: int, classes: int) -> torch.Tensor:
    """(B, MAX_BOXES, 5) box lists -> the YOLOv1 truth grid (B, S*S, 1 + C +
    4): per box, cell floor(x*S), floor(y*S), holding [1, class one-hot,
    x*S - col, y*S - row, w, h]; boxes with w or h below .005 are skipped,
    and the first box of a cell wins."""
    b, m, _ = truths.shape
    s2 = side * side
    x, y, w, h = truths[..., 0], truths[..., 1], truths[..., 2], truths[..., 3]
    cls = truths[..., 4].to(torch.int64)
    valid = (w >= 0.005) & (h >= 0.005)
    col = torch.clamp((x * side).to(torch.int64), 0, side - 1)
    row = torch.clamp((y * side).to(torch.int64), 0, side - 1)
    one_hot = (cls[..., None] == torch.arange(classes, device=truths.device)).to(truths.dtype)
    feat = torch.cat([torch.ones_like(x)[..., None], one_hot,
                      torch.stack([x * side - col, y * side - row, w, h], dim=-1)], dim=-1)
    slot = torch.arange(b, device=truths.device)[:, None] * s2 + row * side + col
    # the first writer of each slot is the last one in reversed truth order
    winner = _last_writer(slot.flip(1), valid.flip(1), b * s2).flip(1)
    dest = torch.where(winner, slot, torch.full_like(slot, b * s2)).reshape(-1)
    grid = truths.new_zeros((b * s2 + 1, 1 + classes + 4))
    grid[dest] = feat.reshape(b * m, -1)
    return grid[: b * s2].reshape(b, s2, -1)


_M32 = np.uint64(0xFFFFFFFF)


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of the reference's PRNG, on
    uint32 scalars or arrays (held in uint64): key (k1, k2), counter words
    (x1, x2)."""
    k1, k2 = np.uint64(k1), np.uint64(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    x = [(np.asarray(x1, np.uint64) + ks[0]) & _M32, (np.asarray(x2, np.uint64) + ks[1]) & _M32]
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for rr in rot[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = ((x[1] << np.uint64(rr)) | (x[1] >> np.uint64(32 - rr))) & _M32
            x[1] = x[1] ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x[0], x[1]


def _reference_randint(seed: int, shape: tuple[int, ...], span: int) -> np.ndarray:
    """randint(fold_in(PRNGKey(17), seed), shape, 0, span) of the
    reference's counter-based PRNG, bit for bit: the key folded with the
    seed, split in two, 32 random bits per element from each half, and the
    modular combination of the two draws."""
    key = _threefry2x32(0, 17, 0, np.uint32(seed & 0xFFFFFFFF))
    k_hi = _threefry2x32(key[0], key[1], 0, 0)
    k_lo = _threefry2x32(key[0], key[1], 0, 1)
    count = np.arange(int(np.prod(shape)), dtype=np.uint64)

    def bits(k):
        b1, b2 = _threefry2x32(k[0], k[1], np.zeros_like(count), count)
        return b1 ^ b2

    span = np.uint64(span)
    mult = (np.uint64(2**16) % span) ** np.uint64(2) % span
    off = ((bits(k_hi) % span) * mult + bits(k_lo) % span) % span
    return off.astype(np.int64).reshape(shape)


def detection_head_loss(out: torch.Tensor, truth_grid: torch.Tensor, classes: int, num: int,
                        side: int, sqrt: bool = False, rescore: bool = False,
                        object_scale: float = 1.0, noobject_scale: float = 1.0,
                        class_scale: float = 1.0, coord_scale: float = 1.0, forced: bool = False,
                        random: bool = False, seen=None):
    """YOLOv1 [detection] loss on the head's output, terms 0.5*scale*(t-p)^2
    whose gradients are darknet's deltas.  The responsible predictor of an
    object cell has the best IoU with its truth (in the cell-relative frame
    over ``side``), or the lowest box RMSE when every IoU is 0; ``forced``
    picks predictor 1 for truths of area < .1 and 0 otherwise, and
    ``random`` a counter-based random predictor (the reference's draw, bit
    for bit) while ``seen`` < 64,000.  With ``rescore`` the confidence
    target is that IoU (its gradient flows into the box), else 1."""
    b = out.shape[0]
    s2 = side * side
    probs = out[:, : s2 * classes].reshape(b, s2, classes)
    confs = out[:, s2 * classes : s2 * (classes + num)].reshape(b, s2, num)
    boxes = out[:, s2 * (classes + num) :].reshape(b, s2, num, 4)

    is_obj = truth_grid[..., 0] > 0
    t_cls = truth_grid[..., 1 : 1 + classes]
    t_box = truth_grid[..., 1 + classes :]

    pw = boxes[..., 2] ** 2 if sqrt else boxes[..., 2]
    ph = boxes[..., 3] ** 2 if sqrt else boxes[..., 3]
    pred = torch.stack([boxes[..., 0] / side, boxes[..., 1] / side, pw, ph], dim=-1)
    tr = torch.stack([t_box[..., 0] / side, t_box[..., 1] / side, t_box[..., 2], t_box[..., 3]],
                     dim=-1)[:, :, None, :]
    ious = _box_iou_xywh(pred, tr)
    with torch.no_grad():
        rmse = torch.sqrt(torch.sum((pred - tr) ** 2, dim=-1))
        any_iou = torch.amax(ious, dim=-1) > 0
        best = torch.where(any_iou, torch.argmax(ious, dim=-1), torch.argmin(rmse, dim=-1))
        if forced:
            # predictor num-1 at num == 1 (the reference would index past its deltas)
            area = t_box[..., 2] * t_box[..., 3]
            best = torch.where(area < 0.1, min(1, num - 1), 0)
        if random and seen is not None and int(seen) < 64000:
            best = torch.from_numpy(_reference_randint(int(seen), tuple(best.shape), num)).to(best.device)
        best_oh = (best[..., None] == torch.arange(num, device=out.device)).to(out.dtype)
    best_iou = torch.gather(ious, -1, best[..., None])[..., 0]

    conf_tgt = (best_iou if rescore else torch.ones_like(best_iou))[..., None] * best_oh
    resp = is_obj[..., None] * best_oh
    conf_w = torch.where(resp > 0, out.new_tensor(object_scale), out.new_tensor(noobject_scale))
    conf_loss = 0.5 * conf_w * (confs - conf_tgt * resp) ** 2
    zero = out.new_tensor(0.0)
    cls_loss = torch.where(is_obj[..., None], 0.5 * class_scale * (probs - t_cls) ** 2, zero)
    tw = torch.sqrt(t_box[..., 2]) if sqrt else t_box[..., 2]
    th = torch.sqrt(t_box[..., 3]) if sqrt else t_box[..., 3]
    coord_tgt = torch.stack([t_box[..., 0], t_box[..., 1], tw, th], dim=-1)
    coord_loss = torch.where(resp[..., None] > 0,
                             0.5 * coord_scale * (boxes - coord_tgt[:, :, None, :]) ** 2, zero)
    total = torch.sum(conf_loss) + torch.sum(cls_loss) + torch.sum(coord_loss)
    with torch.no_grad():
        n_obj = torch.clamp(torch.sum(is_obj), min=1)
        stats = {"obj_count": torch.sum(is_obj),
                 "avg_iou": torch.sum(best_iou * is_obj) / n_obj,
                 "avg_obj": torch.sum(torch.sum(confs * resp, -1) * is_obj) / n_obj}
    return total, stats


def total_loss(heads, truths, net, input_hw: tuple[int, int] | None = None, seen=None):
    """Sum of the per-head losses over every detection head, divided by the
    batch.  ``input_hw`` is the resolution this batch ran at (multi-scale
    training), the network's nominal size by default.  ``seen`` (images so
    far, a host int) gates the region head's anchor-prior warm-up and the
    detection head's random predictor."""
    from yolo_quantization_tpu_torch.nn.graph import HEAD_SPECS, RegionSpec, YoloSpec

    net_h, net_w = input_hw if input_hw is not None else (net.height, net.width)
    specs = [s for s in net.specs if isinstance(s, HEAD_SPECS)]
    loss = 0.0
    all_stats = []
    with torch.profiler.record_function("yolo_loss"):
        for raw, s in zip(heads, specs):
            if isinstance(s, YoloSpec):
                l, st = yolo_head_loss(raw, truths, s.mask, s.anchors, s.classes, net_w, net_h)
            elif isinstance(s, RegionSpec):
                l, st = region_head_loss(
                    raw, truths, s.anchors, s.classes, ignore_thresh=s.thresh,
                    object_scale=s.object_scale, noobject_scale=s.noobject_scale,
                    class_scale=s.class_scale, coord_scale=s.coord_scale, rescore=s.rescore,
                    tree=s.tree, seen=seen)
            else:
                grid = encode_detection_truth(truths, s.side, s.classes)
                l, st = detection_head_loss(
                    raw, grid, s.classes, s.num, s.side, sqrt=s.sqrt, rescore=s.rescore,
                    object_scale=s.object_scale, noobject_scale=s.noobject_scale,
                    class_scale=s.class_scale, coord_scale=s.coord_scale, forced=s.forced,
                    random=s.random, seen=seen)
            loss = loss + l
            all_stats.append(st)
        return loss / heads[0].shape[0], all_stats
