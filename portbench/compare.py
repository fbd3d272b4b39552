"""The comparison that decides ``correct``: the answers the timed path
returned, against the plain reference's detections of the same frames.

An answer is the program's top-k for a batch: boxes (B, k, 4), objectness
(B, k) and class probabilities (B, k, C).  Per image, each returned
detection is matched, greedily in the order returned, to the nearest
unused reference candidate by box and objectness, among the reference's
top-k and the candidates whose objectness lies within ``TIE`` of its k-th
(so that two objectness values that round alike may trade places at the
boundary).  Its gap is the largest difference over every number of the
detection, boxes, objectness and classes, each relative to
max(1, |reference value|): box widths grow as exp of a head value, so
their rounding grows with them.

The number compared, ``det_gap``, is the largest gap over the sampled
answers; an answer that failed, never came, or is not (B, k, ...) of
finite numbers has an infinite gap.
"""

from __future__ import annotations

import numpy as np

TIE = 1e-5  # objectness closer than this to the k-th may trade places


def answer_rows(answer, batch: int, max_det: int):
    """(B, k, 5 + C) float64 rows of an answer, or None where malformed."""
    try:
        boxes, obj, cls = (np.asarray(a, np.float64) for a in answer)
    except (TypeError, ValueError):
        return None
    k = obj.shape[1] if obj.ndim == 2 else -1
    if (boxes.shape[:2] != (batch, k) or obj.shape != (batch, k) or cls.shape[:2] != (batch, k)
            or boxes.ndim != 3 or boxes.shape[2] != 4 or cls.ndim != 3 or k != max_det):
        return None
    rows = np.concatenate([boxes, obj[..., None], cls], axis=-1)
    return rows if np.isfinite(rows).all() else None


def image_gap(rows: np.ndarray, ref: np.ndarray) -> float:
    """The largest gap of one image's detections ``rows`` (k, 5 + C) to their
    greedy matches among the reference candidates ``ref`` (M, 5 + C)."""
    if ref.shape[0] < rows.shape[0] or ref.shape[1] != rows.shape[1]:
        return float("inf")
    scale = np.maximum(1.0, np.abs(ref))
    key = np.abs(rows[:, None, :5] - ref[None, :, :5]) / scale[None, :, :5]
    dist = key.max(axis=2)
    used = np.zeros(ref.shape[0], bool)
    gap = 0.0
    for i in range(rows.shape[0]):
        d = np.where(used, np.inf, dist[i])
        j = int(np.argmin(d))
        used[j] = True
        gap = max(gap, float((np.abs(rows[i] - ref[j]) / scale[j]).max()))
    return gap


def judge(answers: list, reference_rows, batch: int, max_det: int) -> dict:
    """``answers``: [(pool index, answer or None)]; ``reference_rows(pool)``
    gives the reference candidates of that pool batch, one array an image.
    Returns {"det_gap": float}."""
    gap = 0.0
    for pool, answer in answers:
        rows = None if answer is None else answer_rows(answer, batch, max_det)
        if rows is None:
            return {"det_gap": float("inf")}
        for n, ref in enumerate(reference_rows(pool)):
            gap = max(gap, image_gap(rows[n], ref))
    return {"det_gap": gap}
