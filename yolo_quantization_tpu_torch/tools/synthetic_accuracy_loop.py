"""End-to-end accuracy validation on a synthetic dataset.

The counterpart of ``examples/synthetic_accuracy_loop.py``, through the
port's public API.  It generates a small learnable detection task (bright
rectangles), runs the full pipeline — float warm-up -> QAT -> conversion ->
integer inference (K1 on the card) -> F1 harness — and checks that the
integer engine's F1 lies within 0.5 of the float engine's.  That is the
framework's core claim (QAT accuracy transfers to uint8 inference, Jacob et
al. §3), shown with no external data.

    python -m yolo_quantization_tpu_torch.tools.synthetic_accuracy_loop [--steps 400] [--device cuda|cpu]

The JAX example runs on the CPU unless given ``--tpu``.  The port runs on
the card unless given ``--device cpu``, as its other entry points do, and
raises where there is no card.  The dataset is the example's byte for byte
(the same ``default_rng(7)`` draws, JPEGs and label lines); the trainer's
initial weights come from ``init_params_numpy(0)``, the loader's batches from
its seed 0.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def make_dataset(root: str, n: int = 16, size: int = 96) -> str:
    """The example's 16 seeded 96x96 JPEGs (quality 97), one box of class 1
    each, darknet label files and a list file; returns the list file."""
    from PIL import Image

    rng = np.random.default_rng(7)
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(n):
        im = (rng.uniform(0, 0.25, (size, size, 3)) * 255).astype(np.uint8)
        w, h = rng.uniform(0.25, 0.5), rng.uniform(0.3, 0.55)
        x, y = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        x0, y0 = int((x - w / 2) * size), int((y - h / 2) * size)
        x1, y1 = int((x + w / 2) * size), int((y + h / 2) * size)
        im[y0:y1, x0:x1] = [245, 80, 50]
        p = f"{root}/images/img_{i}.jpg"
        Image.fromarray(im).save(p, quality=97)
        with open(f"{root}/labels/img_{i}.txt", "w") as f:
            f.write(f"1 {x:.4f} {y:.4f} {w:.4f} {h:.4f}\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def train(list_file: str, steps: int, device):
    """The example's training: yolov3-tiny (5 classes, 96x96), float to
    ``steps // 2``, then EMA-QAT, batches of 4 from an augmenting
    ``BatchLoader`` with 2 workers; prints the loss every 50 steps.  Returns
    the trainer."""
    from yolo_quantization_tpu_torch.data.loader import BatchLoader
    from yolo_quantization_tpu_torch.data.voc import AugmentConfig, DetectionDataset
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    net = zoo.yolov3_tiny(classes=5, width=96, height=96)
    cfg = TrainConfig(
        learning_rate=1e-3, burn_in=20, quant_start_step=steps // 2,
        max_batches=steps, batch_size=4, lr_steps=(), lr_scales=(),
    )
    trainer = Trainer(net, cfg, device=device)
    ds = DetectionDataset(
        list_file, 96, 96, augment=True,
        aug_cfg=AugmentConfig(jitter=0.1, hue=0.02, saturation=1.1, exposure=1.1),
    )
    loader = BatchLoader(ds, cfg.batch_size, workers=2, pin_memory=trainer.device.type == "cuda")
    t0 = time.time()
    try:
        for step in range(steps):
            images, truths = loader.next()
            m = trainer.step(images, truths)
            if step % 50 == 0:
                print(f"step {step}: loss {float(m['loss']):.3f} ({time.time() - t0:.0f}s)", flush=True)
    finally:
        loader.close()
    return trainer


def evaluate(trainer, list_file: str):
    """convert -> the integer ``Engine`` and the ``FloatEngine`` (max_det 64),
    each through ``f1_sweep``; prints both best rows and returns them
    (integer, float)."""
    from yolo_quantization_tpu_torch.eval.f1 import f1_sweep
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy

    net, state, device = trainer.net, trainer.state, trainer.device
    program = convert(net, params_to_numpy(state.params), quant_state_to_numpy(state.quant_state))
    int_engine = Engine(program, max_det=64, device=device)
    int_best = max(f1_sweep(int_engine, list_file), key=lambda r: r.f1)
    float_engine = FloatEngine(net, state.params, max_det=64, device=device)
    float_best = max(f1_sweep(float_engine, list_file), key=lambda r: r.f1)
    print(f"integer engine: recall {int_best.recall:.1f} precision {int_best.precision:.1f} F1 {int_best.f1:.1f}")
    print(f"float engine:   recall {float_best.recall:.1f} precision {float_best.precision:.1f} F1 {float_best.f1:.1f}")
    return int_best, float_best


def quantization_cost(int_best, float_best) -> float:
    """|integer F1 - float F1|, printed as the example prints it."""
    gap = abs(int_best.f1 - float_best.f1)
    print(f"quantization F1 cost: {gap:.2f} (target: <= 0.5, BASELINE.md)", flush=True)
    return gap


def main(steps: int = 400, device: str = "cuda"):
    """The whole loop; raises when the integer engine lost more than 0.5 F1
    against the float engine.  Returns the (integer, float) best rows."""
    with tempfile.TemporaryDirectory(prefix="yoloq_demo_") as root:
        list_file = make_dataset(root)
        int_best, float_best = evaluate(train(list_file, steps, device), list_file)
    if quantization_cost(int_best, float_best) > 0.5:
        raise AssertionError("integer engine lost more than 0.5 F1 vs float")
    return int_best, float_best


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.steps, args.device)
