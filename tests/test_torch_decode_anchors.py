"""Each head's anchors staged on the device once: ``eval/detect.py::
head_anchors`` gives the decode the tensors it built per call, bit for bit,
and an engine's request builds no tensor from host data there.  On the
card, an engine's ``predict_async`` enqueues without waiting for the device
(``torch.cuda.set_sync_debug_mode("error")`` raises on any wait)."""

import sys

import numpy as np
import pytest
import torch

from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.infer.engine import Engine
from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine
from yolo_quantization_tpu_torch.models import presets, zoo
from yolo_quantization_tpu_torch.nn.graph import (
    HEAD_SPECS,
    DetectionSpec,
    RegionSpec,
    YoloSpec,
    init_params_numpy,
)

torch.set_num_threads(2)

SIZE = 64
NETS = {
    "flagship": lambda: presets.flagship_network(size=SIZE),
    "yolov3": lambda: zoo.yolov3(classes=3, width=SIZE, height=SIZE),
    "region": lambda: zoo.yolov2_tiny(classes=3, width=SIZE, height=SIZE),
    "detection": lambda: zoo.yolov1_tiny(classes=3, width=SIZE, height=SIZE),
}
HEADS = {"flagship": 2, "yolov3": 3, "region": 1, "detection": 1}


def _random_heads(net, n: int = 2, seed: int = 0) -> list[torch.Tensor]:
    """Raw head outputs of ``net``'s shapes: (N, H, W, C), or (N, C) for a
    detection head."""
    rng = np.random.default_rng(seed)
    shapes = net.shapes()
    heads = []
    for i, s in enumerate(net.specs):
        if isinstance(s, HEAD_SPECS):
            shape = (n, int(np.prod(shapes[i]))) if isinstance(s, DetectionSpec) else (n, *shapes[i])
            heads.append(torch.from_numpy(rng.uniform(-3, 3, shape).astype(np.float32)))
    return heads


@pytest.mark.parametrize("name", list(NETS))
def test_staged_anchors_decode_bit_for_bit(name):
    net = NETS[name]()
    heads = _random_heads(net)
    anchors = detect.head_anchors(net, "cpu")
    specs = [s for s in net.specs if isinstance(s, HEAD_SPECS)]
    assert len(anchors) == len(specs) == len(heads) == HEADS[name]
    for spec, a in zip(specs, anchors):
        if isinstance(spec, DetectionSpec):
            assert a is None
            continue
        want = ([spec.anchors[m] for m in spec.mask] if isinstance(spec, YoloSpec)
                else list(spec.anchors))
        assert isinstance(spec, (YoloSpec, RegionSpec)) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(want, np.float32))
    staged = detect.decode_all_heads(heads, net, anchors)
    built = detect.decode_all_heads(heads, net)
    for got, want in zip(staged, built):
        assert torch.equal(got, want)
    for got, want in zip(detect.top_k_detections(*staged, 16), detect.top_k_detections(*built, 16)):
        assert torch.equal(got, want)


def _host_tensor_callers(monkeypatch) -> list[str]:
    """Record the module of every caller of ``torch.tensor`` and
    ``torch.as_tensor`` from now on."""
    callers = []
    for fn in ("tensor", "as_tensor"):
        real = getattr(torch, fn)

        def wrapped(*args, _real=real, **kwargs):
            callers.append(sys._getframe(1).f_globals.get("__name__", "?"))
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, fn, wrapped)
    return callers


@pytest.fixture(scope="module")
def cpu_engine():
    return Engine(presets.flagship_program(size=SIZE), max_det=32, device="cpu")


@pytest.mark.parametrize("flip", [False, True])
def test_second_predict_builds_no_host_tensor_in_the_decode(cpu_engine, monkeypatch, flip):
    engine = cpu_engine
    x = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    first = engine.predict(x, flip=flip)
    callers = _host_tensor_callers(monkeypatch)
    second = engine.predict(x, flip=flip)
    assert detect.__name__ not in callers, callers
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def _card_engines():
    net = presets.flagship_network(size=SIZE)
    return {
        "flagship": Engine(presets.flagship_program(size=SIZE), max_det=32, device="cuda"),
        "yolov3": Engine(presets.v3_program(classes=3, size=SIZE), max_det=32, device="cuda"),
        "float": FloatEngine(net, init_params_numpy(0, net), max_det=32, device="cuda"),
    }


@pytest.mark.cuda
def test_cuda_predict_async_enqueues_without_waiting():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the conv kernels have no CPU mode)")
    engines = _card_engines()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (4, SIZE, SIZE, 3), generator=g, dtype=torch.uint8, device="cuda")
    xf = x.to(torch.float32) / 255.0
    inputs = {"flagship": x, "yolov3": x, "float": xf}
    want = {k: e.predict(inputs[k]) for k, e in engines.items()}  # builds and warms every path
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resolvers = {k: e.predict_async(inputs[k]) for k, e in engines.items()}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for k, resolve in resolvers.items():
        for a, b in zip(resolve(), want[k]):
            np.testing.assert_array_equal(a, b)
