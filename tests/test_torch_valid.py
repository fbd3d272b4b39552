"""The port's ``eval/valid.py`` against the JAX package's: one integer
program, written by the JAX package's ``save_program`` and read by each
package's loader, served by the JAX ``Engine`` and the port's
``Engine(device="cpu")`` over the same images; each writer's files and
``voc_map`` compared, with and without flip TTA and a class map.

Both sides decode, letterbox and suppress on the same native host path.
The heads are bit-equal; the decoded floats differ by ulps (XLA's and
torch's sigmoid and exp), so the numbers in the files agree within the
decode tolerance of ``PERF.md`` section 2 (rtol 1e-6, atol 1e-7) plus the
``%.6f`` rounding of each side.  Under flip TTA two mirrored candidates
can have objectness an ulp apart, and that ulp decides their top-k order,
so there the lines are compared in a canonical order within each image
(the same lines, at most reordered among one image's detections)."""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_native import jax_binding_whole
from yolo_quantization_tpu.eval import valid as jvalid
from yolo_quantization_tpu.infer import serialize as jserialize
from yolo_quantization_tpu.infer.engine import Engine as JEngine
from yolo_quantization_tpu.models import presets as jpresets
from yolo_quantization_tpu_torch.eval import valid as tvalid
from yolo_quantization_tpu_torch.infer import serialize as tserialize
from yolo_quantization_tpu_torch.infer.engine import Engine

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    """The JAX binding holds the whole native library (``test_torch_native``)."""
    with jax_binding_whole():
        yield

SIZE = 64
NAMES = [f"c{i}" for i in range(5)]
CLASS_MAP = [2, 0, 1, 4, 3]
ATOL = 1e-7 + 1e-6  # the decode atol, plus each side's %.6f rounding (half a unit each)
RTOL = 1e-6


def make_dataset(root, n=4, size=SIZE, seed=0):
    """Seeded images of mixed sizes and formats (JPEG and PNG, digit and
    digit-free stems) with darknet labels; returns the list file."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    shapes = [(size, size), (size - 16, size + 24), (size + 32, size), (size, size + 8)]
    paths = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        im = (rng.uniform(0, 0.3, (h, w, 3)) * 255).astype(np.uint8)
        rows = []
        for _ in range(1 + i % 3):
            bw, bh = rng.uniform(0.2, 0.5, 2)
            x, y = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            cls = int(rng.integers(0, 5))
            im[int((y - bh / 2) * h):int((y + bh / 2) * h),
               int((x - bw / 2) * w):int((x + bw / 2) * w)] = rng.integers(120, 256, 3)
            rows.append(f"{cls} {x:.4f} {y:.4f} {bw:.4f} {bh:.4f}")
        stem = f"{i:06d}" if i % 2 == 0 else f"img_{'abcd'[i]}"
        ext = "jpg" if i % 2 == 0 else "png"
        Image.fromarray(im).save(os.path.join(root, "images", f"{stem}.{ext}"))
        with open(os.path.join(root, "labels", f"{stem}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        paths.append(os.path.join(root, "images", f"{stem}.{ext}"))
    list_file = os.path.join(root, "list.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def read_rows(path, keys: int):
    """(key fields, numbers) per line of a result text file."""
    rows = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            rows.append((tuple(parts[:keys]), np.array([float(v) for v in parts[keys:]])))
    return rows


def coco_rows(path):
    with open(path) as f:
        data = json.load(f)
    for d in data:
        assert set(d) == {"image_id", "category_id", "bbox", "score"}
    return [((d["image_id"], d["category_id"]), np.array([d["score"], *d["bbox"]])) for d in data]


def canonical(rows):
    return sorted(rows, key=lambda r: (r[0], -r[1][0], *r[1][1:]))


def assert_same_rows(got, want, strict_order=True, rtol=RTOL, atol=ATOL):
    """The same lines (keys equal, numbers within tolerance); in the same
    order, or with ``strict_order=False`` in a canonical order.  A row is a
    score and four pixel coordinates.  Each coordinate is a sum of two
    decoded terms (centre and half-size times the image side, e.g.
    ``(x - w/2) * W``) that can cancel, and both terms are bounded by the
    row's coordinates, so the decode rtol applies to their sum of
    magnitudes."""
    assert len(got) == len(want)
    if not strict_order:
        got, want = canonical(got), canonical(want)
    for k, ((gk, gv), (wk, wv)) in enumerate(zip(got, want)):
        assert gk == wk, f"line {k}: {gk} != {wk}"
        scale = np.r_[abs(wv[0]), np.full(len(wv) - 1, np.abs(wv[1:]).sum())]
        bad = np.abs(gv - wv) > atol + rtol * scale
        assert not bad.any(), f"line {k} ({gk}): {gv} != {wv}"


def assert_same_map(got, want, tol=1e-6):
    assert got["num_truths"] == want["num_truths"]
    assert [math.isnan(a) for a in got["ap"]] == [math.isnan(a) for a in want["ap"]]
    for a, b in zip(got["ap"], want["ap"]):
        if not math.isnan(b):
            assert a == pytest.approx(b, abs=tol)
    assert got["map"] == pytest.approx(want["map"], abs=tol)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("valid"))
    program = os.path.join(root, "program.npz")
    jserialize.save_program(program, jpresets.flagship_program(classes=5, size=SIZE))
    jeng = JEngine(jserialize.load_program(program), max_det=32)
    teng = Engine(tserialize.load_program(program), max_det=32, device="cpu")
    return root, make_dataset(root), jeng, teng


@pytest.mark.parametrize("flip", [False, True])
def test_voc_and_imagenet_files_match_jax(setup, flip):
    root, lst, jeng, teng = setup
    cm = CLASS_MAP if flip else None
    out = {}
    for name, mod, eng in (("jax", jvalid, jeng), ("torch", tvalid, teng)):
        d = os.path.join(root, f"voc_{name}_{flip}")
        files = mod.write_voc_results(eng, lst, d, NAMES, flip=flip, class_map=cm)
        inet = mod.write_imagenet_results(eng, lst, os.path.join(d, "imagenet-detection.txt"),
                                          flip=flip, class_map=cm)
        out[name] = ([read_rows(files[c], 1) for c in NAMES], read_rows(inet, 2))
    assert sum(len(r) for r in out["torch"][0]) > 20
    for got, want in zip(out["torch"][0], out["jax"][0]):
        assert_same_rows(got, want, strict_order=not flip)
    assert_same_rows(out["torch"][1], out["jax"][1], strict_order=not flip)
    assert {k[0] for k, _ in out["torch"][1]} == {"1", "2", "3", "4"}  # 1-based image indices


@pytest.mark.parametrize("flip", [False, True])
def test_coco_results_match_jax(setup, flip):
    root, lst, jeng, teng = setup
    out = {}
    for name, mod, eng in (("jax", jvalid, jeng), ("torch", tvalid, teng)):
        path = os.path.join(root, f"coco_{name}_{flip}.json")
        mod.write_coco_results(eng, lst, path, flip=flip, class_map=CLASS_MAP, max_images=3)
        out[name] = coco_rows(path)
    assert len(out["torch"]) > 10
    assert_same_rows(out["torch"], out["jax"], strict_order=not flip)
    assert {k[0] for k, _ in out["torch"]} == {0, 2, tvalid.image_id("img_b.png")}


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_voc_map_matches_jax(setup, flip, use_07):
    _, lst, jeng, teng = setup
    kw = dict(flip=flip, use_07_metric=use_07, class_map=CLASS_MAP if use_07 else None,
              thresh=0.3, iou_thresh=0.1)
    got = tvalid.voc_map(teng, lst, 5, **kw)
    want = jvalid.voc_map(jeng, lst, 5, **kw)
    assert_same_map(got, want)
    assert sum(got["num_truths"]) == 1 + 2 + 3 + 1
    assert any(math.isnan(a) for a in got["ap"]) or all(n > 0 for n in got["num_truths"])


def test_average_precision_equals_jax_on_random_curves():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 50, 300):
        tp = (rng.uniform(size=n) < 0.6).astype(np.float64)
        npos = max(int(tp.sum()) + int(rng.integers(0, 4)), 1)
        rec = np.cumsum(tp) / npos
        prec = np.cumsum(tp) / np.maximum(np.arange(1, n + 1), 1e-9)
        for use_07 in (False, True):
            got = tvalid._average_precision(rec, prec, use_07)
            assert got == jvalid._average_precision(rec, prec, use_07)
            assert 0.0 <= got <= 1.0


def test_perfect_detector_gets_map_1(setup, monkeypatch):
    """Feed each image's truths back as detections: every AP is 1."""
    from yolo_quantization_tpu_torch.data.voc import label_path_for, read_boxes

    _, lst, _, teng = setup

    def fake_predict(engine, path, flip=False, class_map=None):
        t = read_boxes(label_path_for(path))
        cls = np.zeros((len(t), 5), np.float32)
        cls[np.arange(len(t)), t[:, 0].astype(int)] = 1.0
        return t[:, 1:5].copy(), np.full(len(t), 0.9, np.float32), cls, SIZE, SIZE

    monkeypatch.setattr(tvalid, "_predict", fake_predict)
    for use_07 in (False, True):
        res = tvalid.voc_map(teng, lst, 5, use_07_metric=use_07)
        assert res["map"] == pytest.approx(1.0)
        assert all(a == pytest.approx(1.0) for a in res["ap"] if not math.isnan(a))


def test_image_id_rule(tmp_path):
    """Digits of the stem, else abs(hash(stem)) % 10**9, as the JAX writer
    computes it inline; and read_map as the JAX package's."""
    assert tvalid.image_id("/a/b/000044.jpg") == 44
    assert tvalid.image_id("COCO_val2014_000000391895.jpg") == 2014000000391895
    assert tvalid.image_id("x/img_7b3.png") == 73
    assert tvalid.image_id("x/dog.png") == abs(hash("dog")) % 10**9
    p = tmp_path / "map.txt"
    p.write_text("3\n\n1\n7\n")
    assert tvalid.read_map(str(p)) == jvalid.read_map(str(p)) == [3, 1, 7]
