"""The port's profiler ranges (``utils/profiling.py::span``): the Engine's
stages on the thread that runs each, nested and in order; nothing opened
while no profiler runs; the same answers either way; the training ranges
under the names ``tools/profile_train.py`` reads."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from yolo_quantization_tpu_torch.core import quant
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.infer.engine import Engine
from yolo_quantization_tpu_torch.models import presets
from yolo_quantization_tpu_torch.models.cfg import parse_cfg
from yolo_quantization_tpu_torch.nn.graph import init_params_numpy, init_quant_state
from yolo_quantization_tpu_torch.ops import cuda_spp
from yolo_quantization_tpu_torch.utils import profiling

torch.set_num_threads(2)

SIZE = 64
ENQUEUE = [("engine.predict_async", None), ("engine.input", "engine.predict_async"),
           ("engine.quantize", "engine.predict_async"), ("engine.layers", "engine.predict_async"),
           ("engine.decode", "engine.predict_async"), ("engine.topk", "engine.predict_async")]
RESOLVE = [("engine.resolve", None), ("engine.wait", "engine.resolve"),
           ("engine.copy", "engine.resolve")]


@pytest.fixture(scope="module")
def engine():
    return Engine(presets.flagship_program(size=SIZE), max_det=32, device="cpu")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)


def every_thread():
    """The profiler over every thread: a range opened on a thread started
    under a default profiler is left out of its trace."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def ranges(prof, tmp_path, prefix: str) -> list[dict]:
    """The trace's user ranges whose names start with ``prefix``, in start
    order, each with ``parent``: the name of the innermost such range that
    encloses it on its thread, or None."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(({"name": e["name"], "tid": e["tid"], "a": float(e["ts"]),
                     "b": float(e["ts"]) + float(e["dur"])}
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith(prefix)),
                   key=lambda s: (s["a"], -s["b"]))
    for s in spans:
        outer = [o for o in spans if o is not s and o["tid"] == s["tid"]
                 and o["a"] <= s["a"] and s["b"] <= o["b"]]
        s["parent"] = min(outer, key=lambda o: o["b"] - o["a"])["name"] if outer else None
    return spans


@pytest.mark.parametrize("flip", [False, True])
def test_every_stage_nested_in_order(engine, images, flip, tmp_path):
    with every_thread() as prof:
        engine.predict(images, flip=flip)
    spans = ranges(prof, tmp_path, "engine.")
    assert [(s["name"], s["parent"]) for s in spans] == ENQUEUE + RESOLVE
    assert len({s["tid"] for s in spans}) == 1
    enqueue = spans[:len(ENQUEUE)]
    for a, b in zip(enqueue[1:], enqueue[2:]):  # the stages follow each other
        assert a["b"] <= b["a"], (a["name"], b["name"])


def test_a_resolver_on_another_thread_records_there(engine, images, tmp_path):
    with every_thread() as prof:
        resolve = engine.predict_async(images)
        out = {}
        worker = threading.Thread(target=lambda: out.update(answer=resolve()))
        worker.start()
        worker.join()
    assert len(out["answer"]) == 3
    spans = ranges(prof, tmp_path, "engine.")
    assert [(s["name"], s["parent"]) for s in spans] == ENQUEUE + RESOLVE
    enqueue_tids = {s["tid"] for s in spans[:len(ENQUEUE)]}
    resolve_tids = {s["tid"] for s in spans[len(ENQUEUE):]}
    assert len(enqueue_tids) == len(resolve_tids) == 1
    assert enqueue_tids != resolve_tids


def test_no_profiler_opens_nothing(engine, images, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("engine.input") is profiling.span("fake_quant")
    with profiling.span("engine.input") as inside:
        assert inside is None
    engine.predict(images, flip=True)


def test_the_flag_reads_on_every_thread():
    seen = {}

    def look():
        seen["flag"] = torch.autograd.profiler._is_profiler_enabled
        seen["span"] = profiling.span("worker")

    with profile(activities=[ProfilerActivity.CPU]):
        worker = threading.Thread(target=look)
        worker.start()
        worker.join()
    assert seen["flag"] is True
    assert isinstance(seen["span"], torch.profiler.record_function)
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiling.span("after") is profiling.span("again")


@pytest.mark.parametrize("flip", [False, True])
def test_answers_equal_with_the_profiler_on(engine, images, flip):
    off = engine.predict(images, flip=flip)
    with every_thread():
        on = engine.predict(images, flip=flip)
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def v4_engine(device: str) -> Engine:
    """YOLOv4 (the benchmark's configuration) at 64 on ``device``."""
    config = Path(__file__).resolve().parents[1] / "portbench/configs/yolov4-coco80-608.json"
    lines = json.loads(config.read_text())["cfg"]
    text = "\n".join(f"{ln.split('=')[0]}={SIZE}" if ln.startswith(("width=", "height=")) else ln
                     for ln in lines)
    net, _ = parse_cfg(text)
    quant_ranges = {k: {"min": -0.3, "max": 6.0} for k in init_quant_state(net)}
    quant_ranges["input"] = {"min": 0.0, "max": 1.0}
    return Engine(convert(net, init_params_numpy(0, net), quant_ranges), max_det=32, device=device)


def spp_ranges(device, images, tmp_path):
    """The Engine's ranges of one predict of YOLOv4, and its SPP kernel
    launches."""
    v4 = v4_engine(device)
    before = cuda_spp.launches
    with every_thread() as prof:
        v4.predict(images)
    spans = ranges(prof, tmp_path, "engine.")
    assert len({s["tid"] for s in spans}) == 1
    return [(s["name"], s["parent"]) for s in spans], cuda_spp.launches - before


def test_the_spp_block_is_a_range_inside_the_layers(images, tmp_path):
    """YOLOv4's SPP block (the benchmark's configuration, at 64) runs under
    ``engine.spp``, inside ``engine.layers``: off the card as its layers,
    with no kernel launch."""
    spans, launches = spp_ranges("cpu", images, tmp_path)
    assert spans == ENQUEUE[:4] + [("engine.spp", "engine.layers")] + ENQUEUE[4:] + RESOLVE
    assert launches == 0


@pytest.mark.cuda
def test_the_spp_kernel_is_a_range_inside_the_layers(images, tmp_path):
    """On the card the range holds the block's one ``spp_kernel`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spans, launches = spp_ranges("cuda", images, tmp_path)
    assert spans == ENQUEUE[:4] + [("engine.spp", "engine.layers")] + ENQUEUE[4:] + RESOLVE
    assert launches == 1


def test_training_ranges_keep_their_names(tmp_path):
    x = torch.linspace(-1.0, 2.0, 64).reshape(4, 16).requires_grad_(True)
    lo, hi = torch.tensor(-0.5), torch.tensor(1.5)
    with every_thread() as prof:
        quant.fake_quant(x, lo, hi).sum().backward()
        quant.ema_update(lo, hi, lo * 2, hi * 2)
    names = [s["name"] for s in ranges(prof, tmp_path, "")]
    assert names == ["fake_quant", "ema_update"]
