"""Offline batches through a pipeline as the program's ``Server`` runs one:
a dispatching thread keeps a fixed number of batches in flight, and a
resolving thread takes their answers in order; each answer back frees a
place for the next batch.

Parameters: ``batch`` (frames a request) and ``in_flight``.  Each request
is the next batch of the frame pool, in turn.
"""

from __future__ import annotations

import queue
import threading
import time

from portbench.record import Request


def run(submit, pool, params: dict, stop, on_done) -> list[Request]:
    """Send until ``stop(now, sent)`` is true, then wait for every answer.
    ``submit(frames)`` returns a resolver; ``on_done(request, answer)`` sees
    each answer (None where it failed), on the resolving thread."""
    batch, depth = int(params["batch"]), int(params["in_flight"])
    places = threading.Semaphore(depth)
    out: queue.Queue = queue.Queue()
    done: list = []
    broken: list = []

    def resolving():
        while (item := out.get()) is not None:
            idx, p, t_send, t_sent, resolve, error = item
            answer = None
            if resolve is not None:
                try:
                    answer = resolve()
                except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                    error = f"{type(e).__name__}: {e}"
            r = Request(idx, p, batch, t_send, t_sent, time.perf_counter(), error)
            done.append(r)
            try:
                on_done(r, answer)
            except BaseException as e:  # noqa: BLE001 - raised again on the caller's thread
                broken.append(e)
            places.release()

    resolver = threading.Thread(target=resolving, name="portbench-resolve", daemon=True)
    resolver.start()
    i = 0
    try:
        while not broken:
            places.acquire()
            if stop(time.perf_counter(), i):
                break
            p = i % len(pool)
            t_send = time.perf_counter()
            try:
                resolve, error = submit(pool[p]), None
            except Exception as e:  # noqa: BLE001
                resolve, error = None, f"{type(e).__name__}: {e}"
            out.put((i, p, t_send, time.perf_counter(), resolve, error))
            i += 1
    finally:
        out.put(None)
        resolver.join()
    if broken:
        raise broken[0]
    return done
