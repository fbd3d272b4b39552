"""The WordTree, classifier and segmenter paths on one card against the CPU.

    python -m yolo_quantization_tpu_torch.tools.wordtree_check

- ``wordtree_detector``: yolov2-tiny's topology at 416 with its region head
  over a seeded WordTree of 9,418 nodes (the node count of yolo9000's
  ``9k.tree``; ``models/presets.py::synthetic_tree_lines``), 5 x 9,423 =
  47,115 channels in the last conv: cfg text with ``tree=``, a quantized
  ``.weights`` file, ``convert`` and ``Engine`` (K1) on the card and on
  the CPU.  Every integer layer's codes equal; the region layer and the
  decode are held to float64 computed from that (equal) head: the card's
  tree softmax within rtol 1e-5, atol 1e-6 (the CPU's within rtol 2e-4:
  PyTorch's CPU exp is off by up to 7e-5 on a first large multi-threaded
  call), the joint path probabilities within rtol 2e-5 (products of up to
  seven factors), and ``tree_top_probs`` picks float64's node, but where
  the descent passes two siblings within rtol 2e-5 of each other.  ``predict``'s K1 launches are counted; the decode and
  ``tree_top_probs`` are timed per image.
- ``tree_region_training``: 3 EMA-QAT steps of that detector (the tree
  region loss) at batch 8, card against CPU: the first step's loss within
  rel 1e-3 and the others within 1e-2 (a QAT step's loss moves with the
  order sums add in: 4.9e-4 to 7.0e-4 for one step of yolov3-tiny when
  only the rows' order changes, ``tools/parallel_check.py``).
- ``classifier``: darknet19 at 224, 1,000 classes, batch 16, under
  ``ClassifierTrainer``: 3 steps with flat cross entropy and 3 with a
  seeded 1,000-leaf tree's hierarchical loss, card against CPU (the first
  step's loss within rel 1e-5, the later ones within 1e-3: float32 sums in
  other orders, grown by the updates; the first step's update of each
  param tensor within 5% of the CPU's in norm: a deep BN net's gradients
  at initialization add in other orders on each device, up to 1.8e-2 for
  darknet19), then ``evaluate_top_k`` equal on both; ms per step on the
  card.
- ``segmenter``: 3 steps of a conv / upsample net at 416 with 21 classes
  (VOC's) at batch 4 under ``SegmenterTrainer``, card against CPU (as the
  classifier), then ``predict`` equal on at least 99.99% of the pixels
  (argmax at ulp ties).

``chip_smoke.py`` runs it as phase 17.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

NODES = 9418  # yolo9000's 9k.tree
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-6)
# PyTorch's CPU exp, on the first large call of a process with several
# threads, returns some values off by up to 7e-5 (the same input, another
# run: exact); the CPU engine's region layer is held to float64 by 2e-4
CPU_SOFTMAX_TOL = dict(rtol=2e-4, atol=1e-6)
JOINT_TOL = dict(rtol=2e-5, atol=1e-12)
# a deep BN net's first gradients at initialization add in other orders on
# each device: darknet19's first updates differ from the CPU's by up to
# 1.8e-2 in norm (median 5e-3; the segmenter's 3 layers 1.4e-3) on the card
UPDATE_NORM = 5e-2
LOSS_REL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def tree_cfg_text(classes: int, tree_file: str, size: int = 416) -> str:
    """yolov2-tiny's cfg (``models/zoo.py::yolov2_tiny``) with a WordTree
    region head of ``classes`` nodes."""
    text = f"[net]\nwidth={size}\nheight={size}\nchannels=3\n"
    for f, st in ((16, 2), (32, 2), (64, 2), (128, 2), (256, 2), (512, 1)):
        text += (f"[convolutional]\nbatch_normalize=1\nfilters={f}\nsize=3\nstride=1\npad=1\n"
                 f"activation=leaky\nquantized=1\n[maxpool]\nsize=2\nstride={st}\nquantized=1\n")
    text += ("[convolutional]\nbatch_normalize=1\nfilters=1024\nsize=3\nstride=1\npad=1\n"
             "activation=leaky\nquantized=1\n") * 2
    text += (f"[convolutional]\nsize=1\nstride=1\npad=1\nfilters={5 * (5 + classes)}\nactivation=linear\n"
             "quantized=1\nquant_stop=1\n[region]\nanchors=1.08,1.19, 3.42,4.41, 6.63,11.38, 9.42,5.11, "
             f"16.62,10.52\nclasses={classes}\ncoords=4\nnum=5\nsoftmax=1\nrescore=1\nthresh=.6\n"
             f"tree={tree_file}\n")
    return text


def _tie_on_path(p: np.ndarray, tree, rtol: float) -> bool:
    """Whether the greedy descent over ``p`` passes a group whose two largest
    members lie within ``rtol`` of each other."""
    group = 0
    while True:
        o, s = int(tree.group_offset[group]), int(tree.group_size[group])
        seg = np.sort(p[o : o + s])[::-1]
        if s > 1 and seg[0] - seg[1] <= rtol * abs(seg[0]):
            return True
        nxt = int(tree.child[o + int(np.argmax(p[o : o + s]))])
        if nxt < 0:
            return False
        group = nxt


def _region_f64(head: np.ndarray, spec) -> tuple[np.ndarray, np.ndarray]:
    """The region layer's output and the decode's joint class probabilities
    in float64 from the head: logistic x, y and objectness, raw w and h,
    the grouped softmax per WordTree group, then each node times its
    ancestors."""
    tree, n = spec.tree, spec.classes
    r = head.reshape(-1, 5 + n).astype(np.float64)
    out = r.copy()
    for j in (0, 1, 4):
        out[:, j] = 1.0 / (1.0 + np.exp(-r[:, j]))
    for g in range(tree.groups):
        o, s = int(tree.group_offset[g]), int(tree.group_size[g])
        e = np.exp(r[:, 5 + o:5 + o + s] - r[:, 5 + o:5 + o + s].max(1, keepdims=True))
        out[:, 5 + o:5 + o + s] = e / e.sum(1, keepdims=True)
    joint = out[:, 5:].copy()
    for d in range(1, tree.max_depth + 1):
        at = tree.depth == d
        joint[:, at] *= joint[:, tree.parent_or_self[at]]
    return out.reshape(head.shape), joint


def wordtree_detector(card: str, size: int = 416, nodes: int = NODES, batch: int = 2, device="cuda"):
    """Returns (the program, the net, K1 launches of one ``predict``)."""
    from yolo_quantization_tpu_torch.core.tree import hierarchy_top_prediction, parse_tree
    from yolo_quantization_tpu_torch.eval import detect
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models import cfg as C
    from yolo_quantization_tpu_torch.models import darknet_weights as D
    from yolo_quantization_tpu_torch.models.presets import synthetic_tree_lines, v2_quant_state
    from yolo_quantization_tpu_torch.nn.graph import RegionSpec, init_params_numpy
    from yolo_quantization_tpu_torch.ops import cuda_qconv

    t0 = time.perf_counter()
    lines = synthetic_tree_lines(nodes=nodes, max_depth=6, seed=0)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "9k.tree"), "w") as f:
            f.write("\n".join(lines) + "\n")
        net, _ = C.parse_cfg(tree_cfg_text(nodes, "9k.tree", size), base_dir=d)
        tree = net.specs[-1].tree
        if tree != parse_tree(lines) or net.specs[-2].filters != 5 * (5 + nodes):
            raise AssertionError("the cfg's tree= does not give the tree written")
        params = init_params_numpy(0, net)
        D.save_darknet_weights(os.path.join(d, "tree.weights"), net, params, v2_quant_state(net), seen=64)
        ck = D.load_darknet_weights(os.path.join(d, "tree.weights"), net)
        program = convert(net, ck.params, ck.quant_state)
    log(f"  {tree!r} ({int(tree.leaf.sum())} leaves); cfg text with tree= -> quantized .weights -> "
        f"convert: {net.specs[-2].filters} channels in the last conv ({time.perf_counter() - t0:.1f} s)")
    x = np.random.default_rng(11).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    gpu, cpu = Engine(program, max_det=64, device=device), Engine(program, max_det=64, device="cpu")
    heads_g, outs_g = gpu.raw_heads(x, return_outputs=True)
    heads_c, outs_c = cpu.raw_heads(x, return_outputs=True)
    for i, (g, c) in enumerate(zip(outs_g, outs_c)):
        if not isinstance(net.specs[i], RegionSpec) and (g.dtype != c.dtype or not np.array_equal(g, c)):
            raise AssertionError(f"WordTree detector: layer {i} differs between the card and the CPU")
    # the region layer and the decode against float64 from the (equal) head
    region, joint = _region_f64(outs_g[-2], net.specs[-1])
    np.testing.assert_allclose(outs_g[-1], region, **SOFTMAX_TOL, err_msg="the card's region layer")
    np.testing.assert_allclose(outs_c[-1], region, **CPU_SOFTMAX_TOL, err_msg="the CPU's region layer")
    _, obj, cls = (t.cpu().numpy() for t in detect.decode_region_head(torch.from_numpy(heads_g[0]).to(device),
                                                                        net.specs[-1]))
    np.testing.assert_allclose(cls, joint.reshape(cls.shape), **JOINT_TOL, err_msg="joint probabilities")
    picked, ties = 0, 0
    for b in range(batch):
        picks = detect.tree_top_probs(cls[b], obj[b], tree, thresh=0.0).argmax(-1)
        for d, p in zip(picks, joint.reshape(cls.shape)[b]):
            picked += 1
            if d != hierarchy_top_prediction(p, tree, 0.5):
                if not _tie_on_path(p, tree, JOINT_TOL["rtol"]):
                    raise AssertionError(f"tree_top_probs picks node {d} on the card, {hierarchy_top_prediction(p, tree, 0.5)} "
                                         "in float64")
                ties += 1
    log(f"  all {len(outs_g) - 1} integer layers equal to the CPU engine's; the region layer's tree softmax "
        f"within {SOFTMAX_TOL} of float64 on the card (within {CPU_SOFTMAX_TOL} on the CPU), joint "
        f"probabilities within {JOINT_TOL}; tree_top_probs picks float64's node for {picked - ties} of "
        f"{picked} detections, the other {ties} at a near tie")
    cuda_qconv.launches = 0
    boxes, obj, cls = gpu.predict(x)
    launches = cuda_qconv.launches
    if not (np.isfinite(boxes).all() and np.isfinite(cls).all()):
        raise AssertionError("WordTree predict: non-finite output")
    # the decode and the greedy descent per image, on one image
    head = torch.from_numpy(heads_g[0][:1]).to(device)
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        _, o, c = detect.decode_region_head(head, net.specs[-1])
        o, c = o[0].cpu().numpy(), c[0].cpu().numpy()
        t1 = time.perf_counter()
        detect.tree_top_probs(c, o, tree, thresh=0.0)
        t2 = time.perf_counter()
    log(f"  per image ({c.shape[0]} detections, {nodes} nodes): decode_region_head (tree softmax output -> "
        f"joint probabilities, copied to the host) {1e3 * (t1 - t0):.3f} ms, tree_top_probs over every "
        f"detection {1e3 * (t2 - t1):.3f} ms; predict {launches} K1 launches [{card}]")
    return program, net, launches


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _trainer_pair(make, steps: int, batches, device):
    """``steps`` steps of the trainer ``make(device)`` builds, on ``device``
    and on the CPU: (trainers, losses on each, seconds per step on
    ``device``, params before and after the first step on each)."""
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy

    runs = []
    for dev in (device, "cpu"):
        tr = make(dev)
        snaps = [params_to_numpy(tr.state.params)]
        losses, times = [], []
        for s in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(float(tr.step(*batches[s])["loss"]))
            times.append(time.perf_counter() - t0)
            if s == 0:
                snaps.append(params_to_numpy(tr.state.params))
        runs.append((tr, losses, times, snaps))
    (tg, lg, times, sg), (tc, lc, _, sc) = runs
    return tg, tc, lg, lc, times, (sg, sc)


def _check_float_pair(what: str, lg, lc, snaps) -> str:
    """Float training, card against CPU: the first step's loss within rel
    1e-5 and each later one within 1e-3 (float32 sums in other orders, grown
    by the updates); the first step's update of each param tensor within
    ``UPDATE_NORM`` of the CPU's in norm.  Returns a summary."""
    rel = [abs(a - b) / abs(b) for a, b in zip(lg, lc)]
    (init, first_g), (_, first_c) = snaps
    ratios = {}
    for i, p in first_c.items():
        for k, v in p.items():
            dg, dc = first_g[i][k] - init[i][k], v - init[i][k]
            ratios[f"{i}/{k}"] = float(np.linalg.norm(dg - dc) / max(np.linalg.norm(dc), 1e-30))
    worst = max(ratios, key=ratios.get)
    if rel[0] > LOSS_REL or max(rel) > 1e-3 or ratios[worst] > UPDATE_NORM:
        raise AssertionError(f"{what}: losses card {lg} vs CPU {lc} (rel {rel}); first update of {worst} "
                             f"{ratios[worst]:.3e} off the CPU's in norm (bound {UPDATE_NORM})")
    return (f"losses rel to the CPU {', '.join(f'{r:.2e}' for r in rel)}; the first step's updates off the "
            f"CPU's by {ratios[worst]:.2e} in norm at most ({worst}), median "
            f"{float(np.median(list(ratios.values()))):.2e}")


def tree_region_training(net, card: str, batch: int = 8, steps: int = 3, device="cuda") -> None:
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    rng = np.random.default_rng(12)
    batches = [synthetic_batch(rng, batch, net.height, net.specs[-1].classes) for _ in range(steps)]
    cfg = TrainConfig(burn_in=0, quant_start_step=0, batch_size=batch)
    _, _, lg, lc, times, _ = _trainer_pair(lambda dev: Trainer(net, cfg, seed=0, device=dev), steps, batches,
                                           device)
    rel = [abs(a - b) / abs(b) for a, b in zip(lg, lc)]
    if not np.isfinite(lg + lc).all() or rel[0] > 1e-3 or max(rel) > 1e-2:
        raise AssertionError(f"tree region EMA-QAT: losses card {lg} vs CPU {lc} (rel {rel})")
    log(f"  {steps} EMA-QAT steps of the tree region loss at batch {batch}: losses card {lg}, CPU {lc} "
        f"(rel {', '.join(f'{r:.2e}' for r in rel)}); card {1e3 * np.mean(times[1:]):.1f} ms/step after "
        f"the first [{card}]")


def _class_images(root: str, names: list[str], n: int, size: int) -> str:
    from PIL import Image

    rng = np.random.default_rng(13)
    paths = []
    for j in range(n):
        p = os.path.join(root, f"{names[int(rng.integers(0, len(names)))]}.{j}.png")
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return os.path.join(root, "list.txt")


def classifier(card: str, size: int = 224, classes: int = 1000, batch: int = 16, steps: int = 3,
               device="cuda") -> dict:
    import dataclasses

    from yolo_quantization_tpu_torch.core.tree import parse_tree
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.models.presets import synthetic_tree_lines
    from yolo_quantization_tpu_torch.nn.graph import SoftmaxSpec
    from yolo_quantization_tpu_torch.train.classify import ClassificationDataset, ClassifierTrainer, evaluate_top_k

    tree = parse_tree(synthetic_tree_lines(leaves=classes, max_depth=4, seed=1))
    rng = np.random.default_rng(14)
    out = {}
    for kind in ("flat", "tree"):
        if kind == "flat":
            net = zoo.darknet19(classes=classes, width=size, height=size)
            labels_from, names = np.arange(classes), [f"c{j:04d}" for j in range(classes)]
        else:
            base = zoo.darknet19(classes=tree.n, width=size, height=size)
            net = dataclasses.replace(base, specs=base.specs[:-1] + (SoftmaxSpec(tree=tree),))
            labels_from, names = np.nonzero(tree.leaf)[0], list(tree.names)
        batches = [(rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32),
                    labels_from[rng.integers(0, len(labels_from), batch)]) for _ in range(steps)]
        tg, tc, lg, lc, times, snaps = _trainer_pair(lambda dev: ClassifierTrainer(net, lr=0.01, device=dev),
                                                     steps, batches, device)
        summary = _check_float_pair(f"darknet19 {kind}", lg, lc, snaps)
        with tempfile.TemporaryDirectory() as d:
            ds = ClassificationDataset(_class_images(d, names, batch, size), names, size, size)
            eg, ec = evaluate_top_k(net, tg.params, ds), evaluate_top_k(net, tc.params, ds)
        if eg != ec:
            raise AssertionError(f"darknet19 {kind}: evaluate_top_k {eg} on the card, {ec} on the CPU")
        out[kind] = 1e3 * float(np.mean(times[1:]))
        log(f"  darknet19 {size} {kind}{f' ({tree!r})' if kind == 'tree' else ''}, batch {batch}: {steps} "
            f"steps, {summary}; evaluate_top_k {eg} on both; {out[kind]:.3f} ms/step on the card after the "
            f"first [{card}]")
    return out


def segmenter(card: str, size: int = 416, classes: int = 21, batch: int = 4, steps: int = 3,
              device="cuda") -> None:
    from yolo_quantization_tpu_torch.nn.graph import ConvSpec, MaxPoolSpec, NetworkDef, UpsampleSpec
    from yolo_quantization_tpu_torch.train.segment import SegmenterTrainer

    net = NetworkDef(specs=(ConvSpec(16, quantized=False), MaxPoolSpec(2, 2, quantized=False),
                            ConvSpec(32, quantized=False), MaxPoolSpec(2, 2, quantized=False),
                            ConvSpec(64, quantized=False), UpsampleSpec(4, quantized=False),
                            ConvSpec(classes, size=1, pad=0, activation="linear", batch_normalize=False,
                                     quantized=False)), width=size, height=size)
    rng = np.random.default_rng(15)
    batches = [(rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32),
                rng.integers(0, classes, (batch, size, size))) for _ in range(steps)]
    tg, tc, lg, lc, times, snaps = _trainer_pair(
        lambda dev: SegmenterTrainer(net, classes, lr=0.01, device=dev), steps, batches, device)
    summary = _check_float_pair("segmenter", lg, lc, snaps)
    same = float(np.mean(tg.predict(batches[0][0][0]) == tc.predict(batches[0][0][0])))
    if same < 0.9999:
        raise AssertionError(f"segmenter predict: {same:.6f} of the pixels equal")
    log(f"  segmenter {size}, {classes} classes, batch {batch}: {steps} steps, {summary}; predict equal on "
        f"{same:.6f} of the pixels; {1e3 * np.mean(times[1:]):.3f} ms/step on the card after the first [{card}]")


def run(card: str) -> dict:
    """Phase 17; returns the WordTree detector's predict K1 launches and
    the classifier's step times."""
    t0 = time.perf_counter()
    _, net, launches = wordtree_detector(card)
    log(f"  WordTree detector: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tree_region_training(net, card)
    log(f"  tree region training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = classifier(card)
    log(f"  classifier: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    segmenter(card)
    log(f"  segmenter: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "classifier_ms": times}


def main() -> int:
    from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity

    if not torch.cuda.is_available():
        raise SystemExit("wordtree_check: torch.cuda.is_available() is false; this needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    log(json.dumps(run(card_identity())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
