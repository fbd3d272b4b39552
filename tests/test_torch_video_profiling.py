"""The port's ``data/video.py`` and ``utils/profiling.py`` against the JAX
package's: the synthetic clip round trip and ``demo`` on a video file
(skipped only where OpenCV is missing, as ``tests/test_video_demo.py``
does), ``MetricsWriter`` records, ``StepTimer``'s moving average, and a
Chrome trace written by ``trace`` on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from yolo_quantization_tpu.utils import profiling as jprof
from yolo_quantization_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

MODEL = ["--model", "yolov3-tiny", "--size", "64", "--classes", "5", "--device", "cpu"]


def _cv2():
    return pytest.importorskip("cv2", reason="OpenCV (cv2) is not installed")


def test_video_round_trip_matches_jax(tmp_path):
    _cv2()
    from yolo_quantization_tpu.data import video as jvideo
    from yolo_quantization_tpu_torch.data import video as tvideo

    path = tvideo.synthesize_clip(str(tmp_path / "clip.mp4"), n_frames=10, size=96)
    frames, fps, (w, h) = tvideo.read_video(path)
    frames = list(frames)
    assert len(frames) == 10 and (w, h) == (96, 96) and fps == pytest.approx(12.0)
    assert frames[0].dtype == np.float32 and 0.0 <= frames[0].min() and frames[0].max() <= 1.0
    assert not np.allclose(frames[0], frames[-1])  # the rectangle moves
    jframes, jfps, jsize = jvideo.read_video(path)
    assert (jfps, jsize) == (fps, (w, h))
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    # the JAX package's writer gives the same file for the same frames
    jpath = jvideo.synthesize_clip(str(tmp_path / "jclip.mp4"), n_frames=10, size=96)
    for a, b in zip(frames, tvideo.read_video(jpath)[0]):
        np.testing.assert_array_equal(a, b)


def test_missing_cv2_names_opencv(monkeypatch):
    import sys

    from yolo_quantization_tpu_torch.data import video as tvideo

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        tvideo.read_video("clip.mp4")


def test_demo_on_a_video_file(tmp_path, capsys):
    _cv2()
    from yolo_quantization_tpu_torch.cli.main import main
    from yolo_quantization_tpu_torch.data.video import read_video, synthesize_clip
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.models.darknet_weights import save_darknet_weights
    from yolo_quantization_tpu_torch.nn.graph import init_params_numpy

    net = zoo.yolov3_tiny(classes=5, width=64, height=64)
    weights = str(tmp_path / "m.weights")
    save_darknet_weights(weights, net, init_params_numpy(0, net))  # float layout: FloatEngine
    clip = synthesize_clip(str(tmp_path / "clip.mp4"), n_frames=12, size=96)
    out = str(tmp_path / "out.mp4")
    main(["demo", *MODEL, "--weights", weights, "--frames", clip, "--out-video", out,
          "--thresh", "0.99", "--batch-size", "4"])
    printed = capsys.readouterr().out
    assert "running FLOAT inference" in printed and "12 frames" in printed
    frames, _, (w, h) = read_video(out)
    assert len(list(frames)) == 12 and (w, h) == (96, 96)


def test_metrics_writer_records_match_jax(tmp_path):
    records = [(0, dict(loss=np.float32(1.5), lr=1e-3, note="warm")),
               (1, dict(loss=torch.tensor(0.25), images=64, phase=None)),
               (10, dict(sparsity=np.float64(0.125)))]
    lines = {}
    for name, mod in (("jax", jprof), ("torch", tprof)):
        path = tmp_path / name / "metrics.jsonl"
        w = mod.MetricsWriter(str(path))
        for step, m in records:
            w.write(step, **m)
        w.close()
        lines[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
    for a, b in zip(lines["torch"], lines["jax"]):
        assert isinstance(a.pop("time"), float) and isinstance(b.pop("time"), float)
        assert a == b
    assert len(lines["torch"]) == 3 and lines["torch"][1] == {"step": 1, "loss": 0.25, "images": 64.0,
                                                             "phase": None}


def test_step_timer_ema_matches_jax(monkeypatch):
    import time

    ticks = [0.0, 0.5, 1.0, 1.25, 3.0, 3.5, 4.0, 7.0]
    timers = (jprof.StepTimer(decay=0.8), tprof.StepTimer(decay=0.8, device="cpu"))
    for timer in timers:
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))  # both modules' clock
        dts = []
        for _ in range(4):
            timer.start()
            dts.append(timer.stop())
        assert dts == [0.5, 0.25, 0.5, 3.0]
    assert timers[1].avg == timers[0].avg == pytest.approx(
        0.8 * (0.8 * (0.8 * 0.5 + 0.2 * 0.25) + 0.2 * 0.5) + 0.2 * 3.0)


@pytest.mark.cuda
def test_step_timer_synchronizes_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x = torch.randn(4096, 4096, device="cuda")
    timer = tprof.StepTimer(device="cuda")
    timer.start()
    for _ in range(20):
        x = x @ x.T / 4096
    assert timer.stop() > 1e-3  # 20 GEMMs of 137 GFLOP: the timer waited for them


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with torch.profiler.record_function("port_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    data = json.loads((tmp_path / "trace" / files[0]).read_text())
    assert any(e.get("name") == "port_step" for e in data["traceEvents"])
    assert any(e.key == "port_step" for e in prof.key_averages())
