"""The port's benchmarks on the CPU at small sizes: ``tools/bench.py``
(the counterpart of ``bench.py`` and ``scripts/bench_v3.py``),
``tools/bench_serving.py`` and ``tools/bench_train.py``.  The MAC count is
``bench.py``'s; the JSON line carries ``bench.py``'s field names; the
serving load loop stamps each latency when its request completes; every
tool of the slice raises where there is no GPU unless the CPU is asked
for.  Device numbers come from the card only (``chip_smoke.py`` phase 19)."""

import json
import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import bench as jbench
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu_torch.infer.engine import Engine
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.models.presets import flagship_program
from yolo_quantization_tpu_torch.tools import bench, bench_serving, bench_train, crossf1, dryrun, parity_check

torch.set_num_threads(2)

# the fields of bench.py's JSON line (bench.py:158-173)
JAX_FIELDS = {"metric", "value", "unit", "vs_baseline", "batch", "device_images_per_sec",
              "device_ms_per_batch", "mfu_int8", "conv_gmacs_per_image", "p50_latency_batch1_ms",
              "device_latency_batch1_ms", "images_per_sec_by_batch", "conv_path", "device"}


@pytest.mark.parametrize("model,macs", [("tiny", 2_724_074_496), ("v3", 32_932_037_632)])
def test_mac_count_is_bench_py_s(model, macs):
    jnet = jzoo.yolov3_tiny() if model == "tiny" else jzoo.yolov3(classes=80, width=416, height=416)
    tnet = tzoo.yolov3_tiny() if model == "tiny" else tzoo.yolov3(classes=80, width=416, height=416)
    got = bench.conv_macs_per_image(types.SimpleNamespace(net=tnet))
    assert got == jbench.conv_macs_per_image(types.SimpleNamespace(net=jnet)) == macs


def test_bench_prints_bench_py_s_fields_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--size", "32", "--batches", "2,3", "--more-batches", "1",
                       "--chain", "3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_FIELDS <= set(line)
    assert line["unit"] == "images/sec" and line["conv_path"] == "k1" and line["device"] == "cpu"
    assert line["batch"] in (2, 3) and set(line["images_per_sec_by_batch"]) == {"1", "2", "3"}
    assert line["value"] == line["images_per_sec_by_batch"][str(line["batch"])] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / bench.BASELINE_IMG_PER_SEC, abs=0.1)
    net = tzoo.yolov3_tiny(width=32, height=32)
    assert line["conv_gmacs_per_image"] == round(bench.conv_macs_per_image(types.SimpleNamespace(net=net)) / 1e9, 3)
    # a CPU run reports no device metric
    for key in ("device_images_per_sec", "device_ms_per_batch", "mfu_int8", "device_latency_batch1_ms"):
        assert line[key] is None
    assert line["p50_latency_batch1_ms"] > 0


def test_bench_v3_on_the_cpu():
    r = bench.bench(v3=True, batches=(1,), more_batches=(), size=64, device="cpu", chain=1)
    assert JAX_FIELDS <= set(r) and r["quantized_shortcuts"] is True
    assert r["metric"].startswith("yolov3-full") and r["batch"] == 1


def test_run_load_stamps_latency_at_completion():
    """Requests that complete 40 ms after submission read about 40 ms,
    however long the load loop runs after them."""
    class Server:
        def submit(self, image, thresh=0.5):
            fut = Future()
            threading.Timer(0.04, fut.set_result, ([],)).start()
            return fut

    lat, n = bench_serving.run_load(Server(), [np.zeros((4, 4, 3), np.float32)], 50.0, 0.6)
    assert n >= 10 and len(lat) == n
    assert 0.035 <= lat.min() and lat.max() < 0.3


def test_serving_bench_at_a_low_rate_on_the_cpu():
    engine = Engine(flagship_program(size=64), max_det=16, device="cpu")
    rows = bench_serving.serve_rates(engine, [20.0], 1.0, buckets=(1, 4), log=lambda m: None)
    (row,) = rows
    assert row["completed"] >= 5 and row["batches"] >= 1
    assert 0 < row["p50_ms"] <= row["p90_ms"] <= row["p99_ms"]
    assert sum(row["bucket_hist"].values()) == row["batches"]
    assert set(row["bucket_hist"]) <= {"1", "4"} and 0 < row["avg_batch_fill"] <= 1
    assert "| offered req/s |" in bench_serving.table(rows)
    assert bench_serving.suggest_rates(200.0, 1600.0) == [50.0, 100.0, 200.0, 300.0]
    assert bench_serving.suggest_rates(200.0, 500.0)[-1] == 250.0


def test_train_bench_on_the_cpu(capsys):
    out = bench_train.bench_chip(batch=2, steps=1, size=64, device="cpu")
    assert out["metric"] == "qat_train_step" and out["peak_mib"] is None and np.isfinite(out["loss"])
    assert out["first_step_s"] > 0 and out["step_ms"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_train_scaling_skips_counts_above_the_ranks(capsys):
    out = bench_train.bench_scaling(size=32, per_device_batch=2, iters=1, device="cpu", counts=(1, 2))
    assert out["world"] == 1 and set(out["images_per_sec"]) == {"1"}
    assert out["skipped"] == ["scaling_efficiency: 2 devices skipped; the world has 1"]
    assert not torch.distributed.is_initialized()


TOOLS = {
    "bench": lambda d: bench.bench(size=64),
    "bench_serving": lambda d: bench_serving.main(["--rates", "1", "--duration", "0.1"]),
    "bench_train": lambda d: bench_train.bench_chip(batch=1, steps=1, size=64),
    "entry": lambda d: dryrun.entry(),
    "dryrun_multichip": lambda d: dryrun.dryrun_multichip(1),
    "parity_check": lambda d: parity_check.check(d),
    "crossf1": lambda d: crossf1.run(d, steps=1, n_train=1, n_eval=1),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_each_tool_raises_without_a_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the failure where there is no GPU")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TOOLS[tool](str(tmp_path))
    assert time.perf_counter() - t0 < 30
