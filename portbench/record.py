"""What a traffic generator records of each request, on the host clock
(``time.perf_counter``, seconds)."""

from __future__ import annotations

from typing import NamedTuple


class Request(NamedTuple):
    index: int
    pool: int          # which batch of the frame pool it sent
    images: int
    t_send: float      # the call to the entry
    t_sent: float      # the entry returned (dispatch done)
    t_done: float      # the answer on the host
    error: str | None  # why it failed, else None
