"""Continuous-batching inference server over the port's Engine.

Callers submit single images (any size) and get detection futures; a
batcher thread letterboxes on host worker threads, groups requests into the
smallest batch bucket of the ladder that holds them (one input shape per
bucket), enqueues the device work, and a resolver thread copies results back
and resolves the futures with box-corrected, NMS'd detections — so batch
N+1 is gathered and enqueued while batch N is still on the device.
``uint8_io`` stages frames as uint8 pixel codes (4x fewer bytes to the
device).  Letterbox and NMS go through the native host runtime
(``utils/native.py``) where it is built, and numpy otherwise.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.utils import native


@dataclass
class Detection:
    box: np.ndarray       # (4,) center-format, relative to the ORIGINAL image
    objectness: float
    class_probs: np.ndarray


@dataclass
class _Request:
    image: np.ndarray     # original HWC float32
    future: Future
    thresh: float
    nms: float
    enqueue_time: float = 0.0


class Server:
    """Continuous batching over an Engine.

    submit() is thread-safe and non-blocking; the returned Future resolves to
    a list[Detection].  max_delay_ms bounds added latency: a partial batch is
    flushed when the oldest request has waited that long.
    """

    def __init__(
        self,
        engine,
        batch_size: int | tuple[int, ...] = (1, 4, 16),
        max_delay_ms: float = 5.0,
        preprocess_workers: int = 4,
        pipeline_depth: int = 2,
        uint8_io: bool = False,
    ):
        self.engine = engine
        self.net = engine.program.net
        buckets = (batch_size,) if isinstance(batch_size, int) else tuple(
            sorted(set(batch_size))
        )
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"invalid batch buckets {buckets}")
        self.buckets = buckets
        self.batch_size = buckets[-1]  # gather cap
        self.uint8_io = uint8_io
        self.max_delay = max_delay_ms / 1e3
        self._q: queue.Queue[_Request] = queue.Queue()
        # serializes late submit() against close()'s final queue drain, so a
        # racing submit either lands before the drain or is rejected
        self._submit_lock = threading.Lock()
        self._closed = False
        self._pre = ThreadPoolExecutor(max_workers=preprocess_workers)
        self._stop = threading.Event()
        # bounded: the backpressure that keeps device-side queueing shallow
        self._inflight: queue.Queue = queue.Queue(maxsize=pipeline_depth)
        self.stats = {
            "batches": 0, "images": 0, "batch_fill_sum": 0.0, "bucket_hist": {},
        }
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True)
        self._thread.start()
        self._resolver.start()

    def submit(self, image: np.ndarray, thresh: float = 0.5, nms: float = 0.45) -> Future:
        if image.dtype == np.uint8:
            # raw frames: normalize once; letterbox and box correction take [0,1]
            image = image.astype(np.float32) / np.float32(255.0)
        fut: Future = Future()
        req = _Request(image=image, future=fut, thresh=thresh, nms=nms,
                       enqueue_time=time.monotonic())
        with self._submit_lock:
            if self._closed:
                fut.set_exception(RuntimeError("server closed"))
            else:
                self._q.put(req)
        return fut

    def _gather_batch(self) -> list[_Request]:
        reqs: list[_Request] = []
        try:
            reqs.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return reqs
        # drain the backlog first: queued requests are already past their
        # window, and waiting per request would flush singletons under load
        while len(reqs) < self.batch_size:
            try:
                reqs.append(self._q.get_nowait())
            except queue.Empty:
                break
        deadline = reqs[0].enqueue_time + self.max_delay
        while len(reqs) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                reqs.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return reqs

    @staticmethod
    def _fail(reqs: list[_Request], e: BaseException):
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(e)

    def _loop(self):
        while not self._stop.is_set():
            reqs = self._gather_batch()
            if not reqs:
                continue
            try:
                self._dispatch_batch(reqs)
            except Exception as e:  # resolve futures with the error
                self._fail(reqs, e)

    def _dispatch_batch(self, reqs: list[_Request]):
        net = self.net
        letterboxed = list(
            self._pre.map(lambda r: native.letterbox(r.image, net.width, net.height), reqs)
        )
        bucket = next(b for b in self.buckets if b >= len(reqs))
        if self.uint8_io:
            batch = np.zeros((bucket, net.height, net.width, 3), np.uint8)
            for i, x in enumerate(letterboxed):
                batch[i] = (x * 255.0 + 0.5).astype(np.uint8)
        else:
            batch = np.zeros((bucket, net.height, net.width, 3), np.float32)
            for i, x in enumerate(letterboxed):
                batch[i] = x
        resolve = self.engine.predict_async(batch)
        while True:
            try:
                self._inflight.put((reqs, resolve, bucket), timeout=0.25)
                return
            except queue.Full:
                if self._stop.is_set():
                    # shutting down with the pipeline full: resolve inline so
                    # no submitter is left on an abandoned future
                    self._finish(reqs, resolve, bucket)
                    return

    def _finish(self, reqs, resolve, bucket):
        try:
            self._finish_batch(reqs, resolve(), bucket)
        except Exception as e:
            self._fail(reqs, e)

    def _resolve_loop(self):
        # keeps draining after stop until the pipeline is empty, so no future
        # completes after close() returns
        while True:
            try:
                reqs, resolve, bucket = self._inflight.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            self._finish(reqs, resolve, bucket)

    def _finish_batch(self, reqs: list[_Request], outputs, bucket: int):
        net = self.net
        boxes, obj, cls = outputs
        self.stats["batches"] += 1
        self.stats["images"] += len(reqs)
        self.stats["batch_fill_sum"] += len(reqs) / bucket
        self.stats["bucket_hist"][bucket] = self.stats["bucket_hist"].get(bucket, 0) + 1
        for i, r in enumerate(reqs):
            h, w, _ = r.image.shape
            b = detect.correct_boxes(boxes[i], w, h, net.width, net.height)
            keep = obj[i] > r.thresh
            bb, oo, cc = native.nms_obj(b[keep], obj[i][keep], cls[i][keep], r.nms)
            dets = [
                Detection(box=bb[j], objectness=float(oo[j]), class_probs=cc[j])
                for j in np.argsort(-oo)
                if oo[j] > r.thresh
            ]
            # a client may have cancelled its future mid-batch; that must not
            # poison the other requests of the batch
            if not r.future.cancelled():
                try:
                    r.future.set_result(dets)
                except Exception:
                    pass

    def close(self):
        self._stop.set()
        # the dispatch loop's waits are all bounded and on stop it resolves
        # inline, so join without a cap (a capped join could return while a
        # batch is still being enqueued)
        self._thread.join()
        self._resolver.join()
        # batches enqueued between the resolver's last empty check and the
        # dispatch thread's exit
        try:
            while True:
                self._finish(*self._inflight.get_nowait())
        except queue.Empty:
            pass
        # fail what is still queued; the lock makes the closed flag and the
        # drain atomic against racing submit() calls
        with self._submit_lock:
            self._closed = True
            try:
                while True:
                    r = self._q.get_nowait()
                    if not r.future.done():
                        r.future.set_exception(RuntimeError("server closed"))
            except queue.Empty:
                pass
        self._pre.shutdown(wait=True)
