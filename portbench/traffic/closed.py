"""Closed loop: one client sends a batch, waits for its boxes on the host,
then sends the next.

Parameters: ``batch`` (frames a request).  Each request is the next batch
of the frame pool, in turn.
"""

from __future__ import annotations

import time

from portbench.record import Request


def run(submit, pool, params: dict, stop, on_done) -> list[Request]:
    """Send until ``stop(now, sent)`` is true; every request sent is waited
    for.  ``submit(frames)`` returns a resolver; ``on_done(request,
    answer)`` sees each answer (None where it failed)."""
    batch = int(params["batch"])
    done = []
    i = 0
    while not stop(time.perf_counter(), i):
        p = i % len(pool)
        t_send = time.perf_counter()
        answer = error = None
        t_sent = t_send
        try:
            resolve = submit(pool[p])
            t_sent = time.perf_counter()
            answer = resolve()
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            error = f"{type(e).__name__}: {e}"
        r = Request(i, p, batch, t_send, t_sent, time.perf_counter(), error)
        done.append(r)
        on_done(r, answer)
        i += 1
    return done
