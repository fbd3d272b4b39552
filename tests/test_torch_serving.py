"""The port's continuous-batching Server: concurrent requests, the same
detections as Engine.predict + nms_obj on the Server's host path (the
native letterbox and NMS where the library builds), and close() resolving
every future."""

import threading

import numpy as np
import pytest
import torch

from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.infer.engine import Engine
from yolo_quantization_tpu_torch.infer.serving import Detection, Server
from yolo_quantization_tpu_torch.models.presets import flagship_program
from yolo_quantization_tpu_torch.utils import native

torch.set_num_threads(2)

SIZE = 64
# Batches of different composition run the float decode at other positions of
# torch's vectorized CPU sigmoid/exp loops, which can differ by an ulp.
DECODE_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def engine():
    return Engine(flagship_program(classes=5, size=SIZE), max_det=32, device="cpu")


def reference_detections(engine, image, thresh=0.5, nms=0.45):
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / np.float32(255.0)
    h, w, _ = image.shape
    boxes, obj, cls = engine.predict(native.letterbox(image, SIZE, SIZE)[None])
    b = detect.correct_boxes(boxes[0], w, h, SIZE, SIZE)
    keep = obj[0] > thresh
    bb, oo, cc = native.nms_obj(b[keep], obj[0][keep], cls[0][keep], nms)
    order = [j for j in np.argsort(-oo) if oo[j] > thresh]
    return bb[order], oo[order], cc[order]


def assert_same(dets, ref):
    bb, oo, cc = ref
    assert len(dets) == len(oo)
    for d, b, o, c in zip(dets, bb, oo, cc):
        assert isinstance(d, Detection)
        np.testing.assert_allclose(d.box, b, **DECODE_TOL)
        np.testing.assert_allclose(d.objectness, o, **DECODE_TOL)
        np.testing.assert_allclose(d.class_probs, c, **DECODE_TOL)


def test_concurrent_requests_match_engine(engine):
    rng = np.random.default_rng(3)
    images = [
        rng.uniform(0, 1, (40 + 8 * i, 96 - 4 * i, 3)).astype(np.float32) if i % 3
        else rng.integers(0, 256, (50 + i, 70, 3), dtype=np.uint8)
        for i in range(10)
    ]
    server = Server(engine, batch_size=(1, 4, 16), max_delay_ms=20)
    futures = [None] * len(images)

    def client(idx):
        for i in idx:
            futures[i] = server.submit(images[i], thresh=0.5, nms=0.45)

    threads = [threading.Thread(target=client, args=(range(k, 10, 3),)) for k in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        results = [f.result(timeout=120) for f in futures]
    finally:
        server.close()
    assert server.stats["images"] == len(images)
    assert server.stats["batches"] < len(images)  # requests were batched
    assert set(server.stats["bucket_hist"]) <= {1, 4, 16}
    for im, dets in zip(images, results):
        assert_same(dets, reference_detections(engine, im))


def test_uint8_io_single_bucket(engine):
    rng = np.random.default_rng(4)
    im = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
    server = Server(engine, batch_size=4, uint8_io=True)
    try:
        dets = server.submit(im, thresh=0.3).result(timeout=60)
    finally:
        server.close()
    assert server.stats["bucket_hist"] == {4: 1}
    for d in dets:
        assert d.box.shape == (4,) and 0.3 < d.objectness <= 1.0
        assert d.class_probs.shape == (5,)


def test_close_resolves_every_future(engine):
    rng = np.random.default_rng(6)
    server = Server(engine, batch_size=(1, 4), max_delay_ms=1)
    futures = [server.submit(rng.uniform(0, 1, (48, 48, 3)).astype(np.float32))
               for _ in range(12)]
    server.close()
    for f in futures:
        assert f.done()
        if f.exception() is None:
            assert isinstance(f.result(), list)
        else:
            assert "closed" in str(f.exception())
    late = server.submit(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        late.result(timeout=1)


def test_engine_errors_fail_the_batch():
    class Broken:
        program = flagship_program(classes=5, size=SIZE)

        def predict_async(self, images):
            raise RuntimeError("device lost")

    server = Server(Broken(), batch_size=2)
    try:
        fut = server.submit(np.zeros((16, 16, 3), np.float32))
        with pytest.raises(RuntimeError, match="device lost"):
            fut.result(timeout=30)
    finally:
        server.close()
