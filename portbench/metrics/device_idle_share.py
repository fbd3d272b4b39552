"""Device: the share (%) of the traced stretch in which no operation ran
on the card (one stream), 1 - busy / wall."""

from __future__ import annotations


def read(summary):
    t = summary["trace"]
    if t["window_s"] <= 0 or not t["device_ops"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
