"""Faults planted under the timed path, for the tests (and the chip's
readings) that show the check fails them.  Each wraps the entry,
``submit(frames) -> resolver``, and returns the broken one."""

from __future__ import annotations

import numpy as np


def altered(entry):
    """One number of the answer changed where it is produced: the first box
    of the first image moved by 0.01 of the width (four pixels at 416)."""
    def submit(frames):
        resolve = entry(frames)

        def answer():
            boxes, obj, cls = resolve()
            boxes = boxes.copy()
            boxes[0, 0, 0] += 0.01
            return boxes, obj, cls
        return answer
    return submit


def half_batch(entry):
    """Half of the batch left out: the first half computed, and its answers
    standing in for the rest."""
    def submit(frames):
        n = frames.shape[0]
        resolve = entry(frames[:(n + 1) // 2])

        def answer():
            return tuple(np.concatenate([t, t])[:n] for t in resolve())
        return answer
    return submit


def stale(entry):
    """State left unchanged: each request gets the answer of the one before."""
    last: list = []

    def submit(frames):
        resolve = entry(frames)

        def answer():
            now = resolve()
            before = last[0] if last else now
            last[:] = [now]
            return before
        return answer
    return submit


FAULTS = {"altered": altered, "half_batch": half_batch, "stale": stale}
