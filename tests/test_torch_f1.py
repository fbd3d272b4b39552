"""The port's F1 counting, NMS, truth matching and label readers equal the
JAX package's on the same seeded detections, truths and files."""

import os

import numpy as np
import pytest
import torch

from test_torch_native import jax_binding_whole
from yolo_quantization_tpu.data import voc as jvoc
from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.eval import f1 as jf1
from yolo_quantization_tpu.utils import native as jnative
from yolo_quantization_tpu_torch.data import voc as tvoc
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.eval import f1 as tf1

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    """The JAX binding holds the whole native library (``test_torch_native``)."""
    with jax_binding_whole():
        yield


def _cache(seed: int, images: int = 6, dets: int = 60):
    """Seeded per-image (boxes, obj, truths): detections clustered around
    the truths so that NMS suppresses and IoUs straddle the thresholds."""
    rng = np.random.default_rng(seed)
    cache = []
    for _ in range(images):
        nt = int(rng.integers(0, 5))
        truths = np.zeros((nt, 5), np.float32)
        truths[:, 0] = rng.integers(0, 5, nt)
        truths[:, 1:3] = rng.uniform(0.2, 0.8, (nt, 2))
        truths[:, 3:5] = rng.uniform(0.05, 0.4, (nt, 2))
        boxes = rng.uniform(0.1, 0.9, (dets, 4)).astype(np.float32)
        boxes[:, 2:] = rng.uniform(0.02, 0.5, (dets, 2))
        if nt:
            near = rng.integers(0, nt, dets // 2)
            boxes[: dets // 2] = truths[near, 1:5] + rng.normal(0, 0.03, (dets // 2, 4))
        obj = rng.uniform(0, 1, dets).astype(np.float32)
        obj[rng.uniform(size=dets) < 0.1] = 0.5  # ties on a threshold edge
        cache.append((boxes.astype(np.float32), obj, truths))
    return cache


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1_rows_count_as_jax(seed):
    cache = _cache(seed)
    got = tf1.f1_rows(cache)
    want = jf1.f1_rows(cache)
    assert [(r.thresh, r.tp, r.tp_fp, r.tp_fn) for r in got] == \
        [(r.thresh, r.tp, r.tp_fp, r.tp_fn) for r in want]
    assert any(r.tp for r in got) and any(r.tp_fp > r.tp for r in got)
    for a, b in zip(got, want):
        assert a.avg_iou == pytest.approx(b.avg_iou, rel=1e-5)  # float32 vs float64 sums
        assert (a.precision, a.recall, a.f1) == pytest.approx((b.precision, b.recall, b.f1))


def test_nms_and_match_truths_match_jax():
    for boxes, obj, truths in _cache(4):
        cls = np.random.default_rng(0).uniform(0, 1, (len(obj), 3)).astype(np.float32)
        tb, to, tc = tdetect.nms_obj(boxes, obj, cls, 0.3)
        jb, jo, jc = jdetect.nms_obj(boxes, obj, cls, 0.3)
        for a, b in ((tb, jb), (to, jo), (tc, jc)):
            np.testing.assert_array_equal(a, b)
        if len(truths):
            for thresh in (0.1, 0.5):
                tp, acc = tdetect.match_truths(tb, to, truths[:, 1:5], thresh, 0.1)
                jtp, jacc = jnative.match_truths(jb, jo, truths[:, 1:5], thresh, 0.1)
                assert tp == jtp
                assert acc == pytest.approx(jacc, rel=1e-5)


def test_label_readers_match_jax(tmp_path):
    img_dir = tmp_path / "JPEGImages"
    lab_dir = tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    (lab_dir / "a.txt").write_text("1 0.5 0.5 0.2 0.3\n0 0.1 0.2 0.05 0.05 extra\nbad line\n")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{img_dir / 'a.jpg'}\n\n{img_dir / 'b.png'}\n")
    assert tvoc.read_image_list(str(lst)) == jvoc.read_image_list(str(lst))
    for p in tvoc.read_image_list(str(lst)) + ["x/images/c.JPEG", "d.bmp"]:
        assert tvoc.label_path_for(p) == jvoc.label_path_for(p)
        np.testing.assert_array_equal(tvoc.read_boxes(tvoc.label_path_for(p)),
                                      jvoc.read_boxes(jvoc.label_path_for(p)))


def test_f1_sweep_and_recall_match_jax(tmp_path):
    """End to end on a tiny dataset of network-size PNGs (lossless, so the
    two decoders agree): the port's CPU engine counts what the JAX engine
    counts."""
    from PIL import Image

    from yolo_quantization_tpu.infer.engine import Engine as JEngine
    from yolo_quantization_tpu.models import presets as jpresets
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models import presets as tpresets

    size = 64
    rng = np.random.default_rng(9)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    paths = []
    for i in range(3):
        p = tmp_path / "images" / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(p)
        rows = [f"{int(rng.integers(0, 5))} {rng.uniform(0.2, 0.8):.4f} {rng.uniform(0.2, 0.8):.4f} "
                f"{rng.uniform(0.1, 0.5):.4f} {rng.uniform(0.1, 0.5):.4f}" for _ in range(3)]
        (tmp_path / "labels" / f"{i}.txt").write_text("\n".join(rows) + "\n")
        paths.append(str(p))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    teng = Engine(tpresets.flagship_program(size=size), max_det=64, device="cpu")
    jeng = JEngine(jpresets.flagship_program(size=size), max_det=64)
    thresholds = (0.3, 0.5, 0.7)
    got = tf1.f1_sweep(teng, str(lst), thresholds=thresholds)
    want = jf1.f1_sweep(jeng, str(lst), thresholds=thresholds)
    assert [(r.tp, r.tp_fp, r.tp_fn) for r in got] == [(r.tp, r.tp_fp, r.tp_fn) for r in want]
    assert got[0].tp_fn == 9
    tr = tf1.recall_eval(teng, str(lst), thresh=0.5)
    jr = jf1.recall_eval(jeng, str(lst), thresh=0.5)
    assert tr["total_truths"] == jr["total_truths"] == 9
    assert tr["proposals_per_image"] == jr["proposals_per_image"]
    assert tr["recall"] == jr["recall"]
    assert tr["avg_iou"] == pytest.approx(jr["avg_iou"], rel=1e-5)
    assert os.path.exists(tvoc.label_path_for(paths[0]))
