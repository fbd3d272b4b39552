"""Device-time breakdown of QAT train steps on one GPU (torch.profiler).

    python -m yolo_quantization_tpu_torch.tools.profile_train [batch] [--v3]

Runs EMA-QAT steps of yolov3-tiny (416x416, 5 classes; with ``--v3``
yolov3, 80 classes) at the batch given (16 by default) on seeded synthetic
images and truths, and reports the wall time per step, the device's busy
share (kernel time over the wall time of the profiled window) and the share
of the device time in each part of the step.  A kernel belongs to the first
match along its launching operator's chain of enclosing ranges:

  optimizer        torch.optim's step (and pruning), BN rolling stats
  conv backward    the convolutions' data and weight gradients (cuDNN and
                   ``nn/layers.py::weight_grad``)
  conv forward     the convolutions (the BN stats conv included)
  fake-quant/EMA   the fake-quant forwards and backwards, the batch range
                   statistics and the EMA updates
  loss             the yolo loss's forward (its backward is in "other")
  other backward   every other gradient kernel
  other forward    BN statistics and fold, activations, pools, routes...

Prints one JSON line.  It measures and changes nothing.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_quantization_tpu_torch.models import zoo
from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity
from yolo_quantization_tpu_torch.train.loss import MAX_BOXES
from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

ITERS = 3
CATEGORIES = ("optimizer", "conv backward", "conv forward", "fake-quant/EMA", "loss",
              "other backward", "other forward")


def categorize(chain: list[str]) -> str:
    """The category of a kernel from its launching operator's chain of
    names, innermost first."""
    joined = " | ".join(chain)
    if "Optimizer.step" in joined or "train_state_update" in joined:
        return "optimizer"
    if "convolution_backward" in joined or "_Conv2dBackward" in joined:
        return "conv backward"
    if "_FakeQuant" in joined or any(n in ("fake_quant", "range_stats", "ema_update") for n in chain):
        return "fake-quant/EMA"
    if "aten::convolution" in joined or "cudnn_convolution" in joined:
        return "conv forward"
    if "yolo_loss" in chain:
        return "loss"
    if "autograd::engine::evaluate_function" in joined or "Backward" in joined:
        return "other backward"
    return "other forward"


def synthetic_batch(rng, batch: int, size: int, classes: int):
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    truths = np.zeros((batch, MAX_BOXES, 5), np.float32)
    for b in range(batch):
        n = int(rng.integers(1, 8))
        truths[b, :n, 0:2] = rng.uniform(0.1, 0.9, (n, 2))
        truths[b, :n, 2:4] = rng.uniform(0.05, 0.5, (n, 2))
        truths[b, :n, 4] = rng.integers(0, classes, n)
    return images, truths


def breakdown(net, batch: int, classes: int) -> dict:
    cfg = TrainConfig(burn_in=0, quant_start_step=0, batch_size=batch)
    trainer = Trainer(net, cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    images, truths = synthetic_batch(rng, batch, net.height, classes)
    x = torch.from_numpy(images).cuda()
    t = torch.from_numpy(truths).cuda()
    for _ in range(2):  # warms cuDNN's algorithm choice and the allocator
        trainer.step(x, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            trainer.step(x, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    shares = dict.fromkeys(CATEGORIES, 0.0)
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        shares[categorize(chain)] += sum(k.duration for k in e.kernels)
    device_us = sum(shares.values())
    device_ms = device_us / 1e3 / ITERS
    return {
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / wall_ms,
        "shares": {k: v / device_us if device_us else 0.0 for k, v in shares.items()},
    }


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA GPU")
    v3 = "--v3" in argv
    batch = next((int(a) for a in argv if a != "--v3"), 16)
    classes = 80 if v3 else 5
    net = zoo.yolov3(classes=classes) if v3 else zoo.yolov3_tiny(classes=classes)
    row = {"model": "yolov3" if v3 else "yolov3-tiny", "size": 416, "batch": batch,
           "phase": "ema-qat", "card": card_identity(), **breakdown(net, batch, classes)}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
