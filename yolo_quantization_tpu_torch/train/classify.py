"""Image classification training and evaluation (darknet's classifier).

The counterpart of ``yolo_quantization_tpu/train/classify.py``: a dataset
labelled by substring of the image path (src/data.c fill_truth), softmax
cross-entropy training of any ``NetworkDef`` that ends in a [softmax] (or
its logits), the hierarchical cross entropy where that softmax carries a
WordTree, and top-1 / top-k evaluation.  The trainer runs on the GPU
unless given ``device="cpu"``; with a device ``mesh`` it is data-parallel
through ``parallel/mesh.py::data_parallel``, as the detector's ``Trainer``.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_quantization_tpu_torch.core.tree import (
    hierarchy_cross_entropy,
    hierarchy_predictions,
    hierarchy_top_prediction,
    softmax_tree,
)
from yolo_quantization_tpu_torch.data.image import letterbox, load_image_rgb
from yolo_quantization_tpu_torch.data.voc import read_image_list
from yolo_quantization_tpu_torch.infer.float_engine import resolve_device
from yolo_quantization_tpu_torch.nn.graph import (
    ForwardMode,
    NetParams,
    NetworkDef,
    SoftmaxSpec,
    init_params_numpy,
    params_to_torch,
)
from yolo_quantization_tpu_torch.parallel import mesh as pmesh
from yolo_quantization_tpu_torch.train.qat import (
    TrainConfig,
    TrainState,
    make_optimizer,
    roll_bn_stats,
    run_forward,
    to_device,
)


def label_from_path(path: str, names: list[str]) -> int:
    """darknet's substring label matching (src/data.c fill_truth)."""
    for i, n in enumerate(names):
        if n in path:
            return i
    raise ValueError(f"no class name of {names[:3]}... found in {path}")


class ClassificationDataset:
    def __init__(self, list_file: str, names: list[str], net_w: int, net_h: int):
        self.paths = read_image_list(list_file)
        self.names = names
        self.net_w, self.net_h = net_w, net_h

    def __len__(self):
        return len(self.paths)

    def sample(self, idx: int) -> tuple[np.ndarray, int]:
        p = self.paths[idx % len(self.paths)]
        return letterbox(load_image_rgb(p), self.net_w, self.net_h), label_from_path(p, self.names)


def _forward_all(net: NetworkDef, state: TrainState, x: torch.Tensor, mode: ForwardMode):
    """(every layer's output, BN batch statistics) of the graph, for nets
    without detection heads."""
    _, aux = run_forward(net, state, x, mode, return_outputs=True)
    return aux["outputs"], aux["bn_stats"]


def _logits_forward(net: NetworkDef, state: TrainState, x: torch.Tensor, mode: ForwardMode):
    """(logits (N, classes), BN statistics): the output before a trailing
    [softmax], so the loss takes the log-softmax itself."""
    outputs, bn_stats = _forward_all(net, state, x, mode)
    logits = outputs[-2] if isinstance(net.specs[-1], SoftmaxSpec) else outputs[-1]
    return logits.reshape(x.shape[0], -1), bn_stats


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy with integer labels over the last axis,
    logsumexp(z) - z[label], per example; the label is picked by a one-hot
    product, so the gradient adds through no scatter."""
    onehot = torch.nn.functional.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    return -torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1)


def _net_tree(net: NetworkDef):
    """The WordTree of a trailing [softmax], if any (darknet's
    net->hierarchy, src/parser.c:739)."""
    if net.specs and isinstance(net.specs[-1], SoftmaxSpec):
        return net.specs[-1].tree
    return None


def _sgd_state(net: NetworkDef, seed: int, device, lr: float, momentum: float, weight_decay: float):
    """Params from ``init_params_numpy(seed)`` in a ``NetParams`` module and
    SGD with momentum at a constant rate, the decay on the kernels only."""
    params = NetParams(net, params_to_torch(init_params_numpy(seed, net), device))
    opt = make_optimizer(TrainConfig(momentum=momentum, weight_decay=weight_decay), params)
    for pg in opt.param_groups:
        pg["lr"] = lr
    return TrainState(params, opt, None, 0, 0)


class ClassifierTrainer:
    """SGD with momentum and softmax cross entropy (darknet's classifier
    defaults), BN rolling statistics at .99/.01 after each update.

    Nets whose trailing [softmax] carries a WordTree train with the
    hierarchical loss (grouped softmax, cross entropy summed over the
    label's ancestor path).  ``step`` takes (images (N, H, W, 3), integer
    labels (N,)): with a ``mesh``, this rank's rows of the global batch.
    """

    def __init__(self, net: NetworkDef, lr: float = 0.01, momentum: float = 0.9,
                 weight_decay: float = 5e-4, seed: int = 0, device=None, mesh=None, fsdp: bool = False):
        self.net = net
        self.tree = _net_tree(net)
        self.device = resolve_device(device, "ClassifierTrainer")
        self.state, self.group = pmesh.data_parallel(
            _sgd_state(net, seed, self.device, lr, momentum, weight_decay), mesh, fsdp)
        self.mode = ForwardMode(train=True, group=self.group)

    @property
    def params(self):
        return self.state.params

    def step(self, images, labels) -> dict:
        x = to_device(images, self.device)
        y = to_device(labels, self.device, torch.int64)
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        logits, bn_stats = _logits_forward(self.net, self.state, x, self.mode)
        if self.tree is not None:
            loss = torch.mean(hierarchy_cross_entropy(logits, y, self.tree))
        else:
            loss = torch.mean(cross_entropy(logits, y))
        loss.backward()
        opt.step()
        roll_bn_stats(self.state.params, bn_stats)
        n = x.shape[0] * pmesh.rank_world(self.group)[1]
        self.state = self.state._replace(step=self.state.step + 1, seen=self.state.seen + n)
        acc = torch.mean((torch.argmax(logits.detach(), -1) == y).to(torch.float32))
        return {"loss": pmesh.global_mean(loss.detach(), self.group), "acc": pmesh.global_mean(acc, self.group)}


@torch.no_grad()
def evaluate_top_k(net: NetworkDef, params, dataset: ClassificationDataset, k: int = 5,
                   max_images: int | None = None, tree_thresh: float = 0.5) -> dict:
    """Top-1 / top-k accuracy (darknet's validate_classifier) of ``params``
    (a ``NetParams`` module, as ``ClassifierTrainer.params`` holds it) on
    their device.  With a WordTree trailing softmax, top-1 is the greedy
    hierarchy descent and top-k ranks by joint path probability (darknet's
    predict_classifier)."""
    tree = _net_tree(net)
    state = TrainState(params, None, None, 0)
    device = next(iter(params.parameters())).device
    correct1 = correctk = total = 0
    for i in range(min(len(dataset), max_images or len(dataset))):
        im, label = dataset.sample(i)
        logits, _ = _logits_forward(net, state, to_device(im[None], device), ForwardMode())
        if tree is not None:
            scores = softmax_tree(logits, tree)
            top1 = hierarchy_top_prediction(scores[0].cpu().numpy(), tree, tree_thresh)
            order = np.argsort(-hierarchy_predictions(scores, tree)[0].cpu().numpy())
        else:
            order = np.argsort(-logits[0].cpu().numpy())
            top1 = int(order[0])
        correct1 += int(top1 == label)
        correctk += int(label in order[:k])
        total += 1
    return {"top1": correct1 / max(total, 1), f"top{k}": correctk / max(total, 1)}
