"""The port's training data path against the JAX package's, on the CPU:
the truth layout, the HSV distortion, the fused place/distort/flip chain,
``augment_detection`` (the same draws from the same seed), the dataset and
the batch loader.  Both packages' ``augment_detection`` take their native
kernel when that library builds; these tests hold the port's numpy chain
against the JAX package's numpy chain (``place_distort_flip_numpy``), the
native kernel's own golden reference, and both decode through PIL
(``tests/test_torch_native.py`` holds the native kernels against these)."""

import numpy as np
import pytest
import torch
from PIL import Image

from yolo_quantization_tpu.data import loader as jloader
from yolo_quantization_tpu.data import voc as jvoc
from yolo_quantization_tpu_torch.data import loader as tloader
from yolo_quantization_tpu_torch.data import voc as tvoc

torch.set_num_threads(2)


@pytest.fixture
def numpy_chain(monkeypatch):
    """Both packages' augment_detection on their numpy chain, and their
    image decode on PIL (the native decoder, where it builds, rounds the
    /255 its own way), so both sides run the same host path."""
    from yolo_quantization_tpu.utils import native as jnative
    from yolo_quantization_tpu_torch.utils import native as tnative

    monkeypatch.setattr(jnative, "augment_place", jvoc.place_distort_flip_numpy)
    monkeypatch.setattr(jnative, "decode_image", lambda path: None)
    monkeypatch.setattr(tnative, "augment_place", tvoc.place_distort_flip_numpy)
    monkeypatch.setattr(tnative, "decode_image", lambda path: None)


def test_boxes_to_truth_and_letterbox_boxes():
    boxes = np.random.default_rng(0).uniform(0.05, 0.9, (7, 5)).astype(np.float32)
    boxes[:, 0] = np.arange(7)
    np.testing.assert_array_equal(tvoc.boxes_to_truth(boxes), jvoc.boxes_to_truth(boxes))
    many = np.tile(boxes, (20, 1))
    np.testing.assert_array_equal(tvoc.boxes_to_truth(many), jvoc.boxes_to_truth(many))
    np.testing.assert_array_equal(tvoc.letterbox_boxes(boxes, 640, 480, 416, 416),
                                  jvoc.letterbox_boxes(boxes, 640, 480, 416, 416))
    assert tvoc.letterbox_boxes(boxes[:0], 640, 480, 416, 416).shape == (0, 5)


@pytest.mark.parametrize("dhue,dsat,dexp", [(0.0, 1.0, 1.0), (0.07, 1.4, 0.8), (-0.1, 0.7, 1.5)])
def test_distort_hsv_params_matches_jax(dhue, dsat, dexp):
    rng = np.random.default_rng(1)
    im = rng.uniform(0, 1, (23, 31, 3)).astype(np.float32)
    im[0, :3] = [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.2, 0.2]]  # gray, black, a red hue
    np.testing.assert_array_equal(tvoc.distort_hsv_params(im, dhue, dsat, dexp),
                                  jvoc.distort_hsv_params(im, dhue, dsat, dexp))
    cfg_t, cfg_j = tvoc.AugmentConfig(), jvoc.AugmentConfig()
    np.testing.assert_array_equal(tvoc.distort_hsv(im, np.random.default_rng(5), cfg_t),
                                  jvoc.distort_hsv(im, np.random.default_rng(5), cfg_j))


@pytest.mark.parametrize("nw,nh,dx,dy,flip", [(40, 30, 5, 7, False), (70, 50, -10, -6, True),
                                               (64, 64, 0, 0, True), (10, 90, 30, -20, False)])
def test_place_distort_flip_matches_jax(nw, nh, dx, dy, flip):
    im = np.random.default_rng(2).uniform(0, 1, (37, 45, 3)).astype(np.float32)
    args = (64, 64, nw, nh, dx, dy, 0.03, 1.2, 0.9, flip)
    np.testing.assert_array_equal(tvoc.place_distort_flip_numpy(im, *args),
                                  jvoc.place_distort_flip_numpy(im, *args))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_detection_matches_jax(numpy_chain, seed):
    rng = np.random.default_rng(10 + seed)
    im = rng.uniform(0, 1, (48 + 8 * seed, 64, 3)).astype(np.float32)
    boxes = np.array([[1, 0.5, 0.5, 0.4, 0.3], [0, 0.1, 0.9, 0.15, 0.1], [2, 0.95, 0.2, 0.2, 0.3]],
                     np.float32)
    cfg = dict(jitter=0.3, hue=0.1, saturation=1.5, exposure=1.5, flip=True)
    ti, tb = tvoc.augment_detection(im, boxes, 96, 96, np.random.default_rng(seed), tvoc.AugmentConfig(**cfg))
    ji, jb = jvoc.augment_detection(im, boxes, 96, 96, np.random.default_rng(seed), jvoc.AugmentConfig(**cfg))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)


def _dataset(root, n=5, size=40):
    rng = np.random.default_rng(3)
    (root / "images").mkdir()
    (root / "labels").mkdir()
    paths = []
    for i in range(n):
        p = root / "images" / f"im{i}.png"
        Image.fromarray((rng.uniform(0, 255, (size, size + 8 * i, 3))).astype(np.uint8)).save(p)
        (root / "labels" / f"im{i}.txt").write_text(f"{i % 3} 0.5 0.5 0.3 0.4\n1 0.2 0.3 0.1 0.1\n")
        paths.append(str(p))
    lst = root / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


@pytest.mark.parametrize("augment", [True, False])
def test_dataset_samples_match_jax(numpy_chain, tmp_path, augment):
    lst = _dataset(tmp_path)
    td = tvoc.DetectionDataset(lst, 64, 64, augment=augment)
    jd = jvoc.DetectionDataset(lst, 64, 64, augment=augment)
    assert len(td) == len(jd) == 5
    for i in range(5):
        ti, tt = td.sample(i, np.random.default_rng(i))
        ji, jt = jd.sample(i, np.random.default_rng(i))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tt, jt)
    td.set_size(96, 64)
    assert td.sample(0, np.random.default_rng(0))[0].shape == (64, 96, 3)


def test_batch_loader_batches_match_jax(numpy_chain, tmp_path):
    """Batches depend only on the loader's seed (per-sample generators), not
    on thread scheduling: the same as the JAX package's loader's."""
    lst = _dataset(tmp_path)
    tl = tloader.BatchLoader(tvoc.DetectionDataset(lst, 64, 64), 3, workers=2, seed=7)
    jl = jloader.BatchLoader(jvoc.DetectionDataset(lst, 64, 64), 3, workers=2, seed=7)
    try:
        for _ in range(2):
            (ti, tt), (ji, jt) = tl.next(), jl.next()
            assert ti.shape == (3, 64, 64, 3) and tt.shape == (3, 90, 5)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tt, jt)
    finally:
        tl.close()
        jl.close()
    assert not tl._feeder.is_alive()


@pytest.mark.cuda
def test_batch_loader_pins_memory_for_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (page-locked memory)")
    lst = _dataset(tmp_path)
    loader = tloader.BatchLoader(tvoc.DetectionDataset(lst, 64, 64), 2, workers=1, pin_memory=True)
    try:
        images, truths = loader.next()
        assert isinstance(images, torch.Tensor) and images.is_pinned() and truths.is_pinned()
    finally:
        loader.close()
