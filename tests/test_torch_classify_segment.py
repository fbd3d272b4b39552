"""The classifier and segmenter trainers (``train/classify.py``,
``train/segment.py``) through the port on the CPU, mirroring
``tests/test_classify_segment.py`` (small synthetic images: a classifier
learns three colours, a segmenter two halves), and held against the JAX
package's trainers on the same seeded params and batches: two steps with
flat cross entropy, with the WordTree's hierarchical cross entropy and of
the segmenter, losses within rel 1e-5 and params within rtol 1e-4, atol
1e-6 (the jitted JAX step sums in other orders); ``evaluate_top_k`` (flat
and tree) equal to JAX's on the same params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_native import jax_binding_whole
from yolo_quantization_tpu.core.tree import parse_tree as jparse
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.train import classify as jclassify
from yolo_quantization_tpu.train import segment as jsegment
from yolo_quantization_tpu_torch.core.tree import parse_tree
from yolo_quantization_tpu_torch.models.presets import synthetic_tree_lines
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.nn.graph import params_to_numpy
from yolo_quantization_tpu_torch.train.classify import (
    ClassificationDataset,
    ClassifierTrainer,
    evaluate_top_k,
    label_from_path,
)
from yolo_quantization_tpu_torch.train.segment import SegmentationDataset, SegmenterTrainer, mask_path_for

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    """The JAX binding holds the whole native library (``test_torch_native``)."""
    with jax_binding_whole():
        yield

LOSS_REL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def tiny_classifier(G, classes=3, size=32, tree=None):
    return G.NetworkDef(
        specs=(G.ConvSpec(filters=8, quantized=False), G.MaxPoolSpec(2, 2),
               G.ConvSpec(filters=16, quantized=False), G.AvgPoolSpec(),
               G.ConnectedSpec(outputs=classes, activation="linear"), G.SoftmaxSpec(tree=tree)),
        width=size, height=size)


def seg_net(G, size=32):
    return G.NetworkDef(specs=(G.ConvSpec(filters=8, quantized=False),
                               G.ConvSpec(filters=2, size=1, pad=0, activation="linear",
                                          batch_normalize=False, quantized=False)),
                        width=size, height=size)


@pytest.fixture(scope="module")
def class_dataset(tmp_path_factory):
    """3 classes told apart by the dominant colour; directories named by class."""
    root = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(0)
    names = ["red", "green", "blue"]
    paths = []
    for ci, name in enumerate(names):
        d = root / name
        d.mkdir()
        for i in range(6):
            im = rng.uniform(0, 0.3, (32, 32, 3))
            im[..., ci] += 0.7
            p = d / f"{i}.jpg"
            Image.fromarray((im * 255).astype(np.uint8)).save(p)
            paths.append(str(p))
    lf = root / "list.txt"
    lf.write_text("\n".join(paths))
    return str(lf), names


@pytest.fixture(scope="module")
def seg_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    (root / "images").mkdir()
    (root / "mask").mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        im = rng.uniform(0, 0.3, (32, 32, 3))
        mask = np.zeros((32, 32), np.uint8)
        im[:, 16:, 0] += 0.6  # the right half is class 1
        mask[:, 16:] = 1
        p = root / "images" / f"s{i}.jpg"
        Image.fromarray((im * 255).astype(np.uint8)).save(p)
        Image.fromarray(mask).save(root / "mask" / f"s{i}.png")
        paths.append(str(p))
    lf = root / "list.txt"
    lf.write_text("\n".join(paths))
    return str(lf)


def test_label_and_mask_paths():
    assert label_from_path("/data/green/1.jpg", ["red", "green"]) == 1
    with pytest.raises(ValueError, match="no class name"):
        label_from_path("/data/x.jpg", ["red"])
    assert mask_path_for("/d/images/a.jpg") == "/d/mask/a.png"


def test_datasets_match_jax(class_dataset, seg_dataset):
    lf, names = class_dataset
    for a, b in zip(ClassificationDataset(lf, names, 32, 32).sample(7),
                    jclassify.ClassificationDataset(lf, names, 32, 32).sample(7)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(SegmentationDataset(seg_dataset, 32, 32, 2).sample(2),
                    jsegment.SegmentationDataset(seg_dataset, 32, 32, 2).sample(2)):
        np.testing.assert_array_equal(a, b)


def test_training_learns_colors(class_dataset):
    lf, names = class_dataset
    net = tiny_classifier(TG)
    ds = ClassificationDataset(lf, names, 32, 32)
    trainer = ClassifierTrainer(net, lr=0.05, device="cpu")
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(30):
        samples = [ds.sample(int(i)) for i in rng.integers(0, len(ds), 6)]
        m = trainer.step(np.stack([s[0] for s in samples]), np.asarray([s[1] for s in samples]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert evaluate_top_k(net, trainer.params, ds, k=2, max_images=9)["top1"] > 0.6


def jax_trainer(jt, params_np):
    jt.params = jax.tree.map(jnp.asarray, params_np)
    jt.opt_state = jt.tx.init(jt.params)
    return jt


def assert_params_match(tparams, jparams):
    for i, p in params_to_numpy(tparams).items():
        for k, v in p.items():
            np.testing.assert_allclose(v, np.asarray(jparams[i][k]), **PARAM_TOL, err_msg=f"{i}/{k}")


@pytest.mark.parametrize("tree", [False, True], ids=["flat", "wordtree"])
def test_classifier_steps_and_evaluation_match_jax(class_dataset, tree):
    """Two steps of the port's and the JAX trainer from the same params; a
    WordTree classifier (a seeded 40-leaf tree, labels at its leaves) takes
    the hierarchical loss; then ``evaluate_top_k`` on the trained params."""
    lines = synthetic_tree_lines(leaves=40, max_depth=3, seed=2)
    ttree, jtree = (parse_tree(lines), jparse(lines)) if tree else (None, None)
    classes = ttree.n if tree else 3
    tnet, jnet = tiny_classifier(TG, classes, tree=ttree), tiny_classifier(JG, classes, tree=jtree)
    trainer = ClassifierTrainer(tnet, lr=0.05, device="cpu")
    jt = jax_trainer(jclassify.ClassifierTrainer(jnet, lr=0.05), TG.init_params_numpy(0, tnet))
    rng = np.random.default_rng(1)
    leaves = np.nonzero(ttree.leaf)[0] if tree else np.arange(3)
    for _ in range(2):
        images = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
        labels = leaves[rng.integers(0, len(leaves), 6)]
        m, jm = trainer.step(images, labels), jt.step(images, labels)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_REL)
        assert float(m["acc"]) == float(jm["acc"])
    assert_params_match(trainer.params, jt.params)
    lf, names = class_dataset
    ds = ClassificationDataset(lf, names, 32, 32)
    if tree:  # label the images with tree leaves
        ds.sample = lambda i, s=ds.sample: (s(i)[0], int(leaves[s(i)[1]]))
    got = evaluate_top_k(tnet, trainer.params, ds, k=3, max_images=9)
    assert got == jclassify.evaluate_top_k(jnet, jt.params, ds, k=3, max_images=9)


def test_segmenter_steps_and_predict_match_jax(seg_dataset):
    ds = SegmentationDataset(seg_dataset, 32, 32, classes=2)
    trainer = SegmenterTrainer(seg_net(TG), classes=2, lr=0.1, device="cpu")
    jt = jax_trainer(jsegment.SegmenterTrainer(seg_net(JG), classes=2, lr=0.1), TG.init_params_numpy(0, seg_net(TG)))
    images, masks = map(np.stack, zip(*[ds.sample(i) for i in range(4)]))
    for _ in range(2):
        m, jm = trainer.step(images, masks), jt.step(images, masks)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_REL)
    assert_params_match(trainer.params, jt.params)
    np.testing.assert_array_equal(trainer.predict(images[0]), jt.predict(images[0]))


def test_segmenter_training_and_predict(seg_dataset):
    ds = SegmentationDataset(seg_dataset, 32, 32, classes=2)
    trainer = SegmenterTrainer(seg_net(TG), classes=2, lr=0.1, device="cpu")
    losses = []
    # enough steps for the .99 rolling BN statistics to approach the batch's
    for step in range(300):
        im, mask = ds.sample(step)
        losses.append(float(trainer.step(im[None], mask[None])["loss"]))
    assert losses[-1] < losses[0] * 0.8
    im, mask = ds.sample(0)
    pred = trainer.predict(im)
    assert pred.shape == (32, 32)
    assert (pred == mask).mean() > 0.8
