"""Flagship-resolution accuracy capstone.

The counterpart of ``scripts/accuracy_capstone.py``.  The reference's
headline is F1 from QAT at 416x416 on a 5-class set; its dataset and
pretrained weights are not in the repository, so this runs the reference's
PROTOCOL at the flagship configuration on synthetic data:

  - 416x416, 5 classes, several boxes an image (2 large -> coarse head,
    2 small -> fine head through the route+upsample path; ``--v3`` adds a
    mid pair so all three yolov3 scales get targets);
  - the full QAT schedule: float burn-in -> ``quant_start_step`` (2/5 of
    the steps) -> EMA ranges (or learned ranges after the warm-up);
  - multiscale sizes {base - 96, base, base + 96} every 10 steps;
  - float, QAT-simulation and integer rows: ``FloatEngine``,
    ``QatSimEngine`` with the trained ranges, and ``Engine`` over
    ``convert``'s program (K1 on the card; ``--v3`` adds the integer
    shortcut); each an F1 sweep 0.1-0.7, NMS 0.1, IoU 0.1;
  - the contract: integer F1 >= float F1 - 0.5 (``within_half_point``) and
    >= QAT-sim F1 - 0.5 (``int_within_half_of_qat_sim``).  Read the second
    apart from the first: it says whether the engine is faithful to what
    training optimized, the first what quantization cost.

    python -m yolo_quantization_tpu_torch.tools.accuracy_capstone [steps=3000] [batch=32]
        [--v2] [--v3] [--leaky] [--bf16] [--percentile[=p]] [--learned]
        [--float-baseline] [--no-multiscale] [--base-size=N] [--eval-images=N]
        [--lr=X] [--tag=r11] [--device=cuda|cpu] [--out-dir=DIR]

Runs on the card unless given ``--device cpu``.  Everything bulk stays on
the device: each batch is drawn and painted there (``draw_slots``,
``paint_batch``) and evaluation fetches only the engines' top-64.  The
draws come from a seeded ``torch.Generator`` (seed 101 and the step for
training, 777 and the batch index for evaluation), so the images are not
the JAX script's ``jax.random`` ones; ``paint_batch`` is its ``render_batch``
arithmetic, bit for bit on the same draws.  The initial weights come from
``init_params_numpy(3)``, not from ``jax.random.PRNGKey(3)``.

Writes ``ACCURACY_TORCH[_V3|_V2]_<tag>[_leaky][_percentile...][_learned][_bf16].json``
(``FLOATBASE_TORCH[_V3]_<tag>[_lr<x>].json`` with ``--float-baseline``)
into ``--out-dir`` (the repository root by default), with the JAX
script's field and metric names, and prints it as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device
from yolo_quantization_tpu_torch.tools.crossf1 import STD_TINY_ANCHORS

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASSES = 5
PALETTE = (
    (0.95, 0.30, 0.20),
    (0.25, 0.85, 0.35),
    (0.25, 0.40, 0.95),
    (0.92, 0.85, 0.25),
    (0.80, 0.30, 0.90),
)
MAX_BOXES = 90
# slot size ranges (relative): tiny exercises both tiny-yolo heads; the v3
# variant adds a mid pair so all THREE v3 scales get targets
SLOT_RANGES = {
    "tiny": ((0.45, 0.72), (0.45, 0.72), (0.09, 0.20), (0.09, 0.20)),
    "v3": (
        (0.45, 0.72), (0.45, 0.72),   # coarse head (116-373 px anchors)
        (0.12, 0.25), (0.12, 0.25),   # mid head (30-119 px anchors)
        (0.035, 0.075), (0.035, 0.075),  # fine head (10-33 px anchors)
    ),
}
TRAIN_SEED, EVAL_SEED = 101, 777
PROTOCOL = ("detector f1 sweep 0.1-0.7, NMS 0.1, IoU 0.1 (examples/detector.c:760-876); "
            "images drawn from a seeded torch.Generator, not jax.random")


def seeded_generator(device, base: int, index: int) -> torch.Generator:
    """The generator of one batch on ``device``, seeded from ``base`` and
    ``index`` (the step, or the evaluation batch) through a numpy
    ``SeedSequence``: a 32-bit seed, since the CPU generator keeps only the
    low 32 bits of its seed."""
    seed = int(np.random.SeedSequence((base, index)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def draw_slots(generator: torch.Generator, batch: int, size: int, slots: str = "tiny") -> dict:
    """The random tensors of one batch, on the generator's device: the noise
    background (B, S, S, 3) in [0, 0.22), the uniforms behind each slot's
    size and centre (B, n, 2), its class (B, n), whether it is present
    (B, n; even slots always, odd ones with probability 0.7) and its colour
    jitter (B, n, 3) in [-0.06, 0.06)."""
    n = len(SLOT_RANGES[slots])
    kw = dict(generator=generator, device=generator.device)
    background = torch.rand((batch, size, size, 3), **kw) * 0.22
    u_wh = torch.rand((batch, n, 2), **kw)
    u_xy = torch.rand((batch, n, 2), **kw)
    cls = torch.randint(0, CLASSES, (batch, n), **kw)
    present = (torch.rand((batch, n), **kw) < 0.7) | (torch.arange(n, device=generator.device) % 2 == 0)
    jitter = torch.rand((batch, n, 3), **kw) * 0.12 - 0.06
    return dict(background=background, u_wh=u_wh, u_xy=u_xy, cls=cls, present=present, jitter=jitter)


def paint_batch(draws: dict, size: int, slots: str = "tiny"):
    """Coloured class rectangles over the background, larges painted first
    so smalls stay visible: the JAX script's ``render_batch`` arithmetic in
    its order, a pure function of ``draws``.  Returns (images (B, S, S, 3)
    float32, truths (B, MAX_BOXES, 5) [x, y, w, h, cls], absent slots with
    zero w and h)."""
    ranges = SLOT_RANGES[slots]
    img = draws["background"]
    f32, dev = torch.float32, img.device
    lo = torch.tensor([r[0] for r in ranges], dtype=f32, device=dev)
    hi = torch.tensor([r[1] for r in ranges], dtype=f32, device=dev)
    wh = draws["u_wh"] * (hi - lo)[None, :, None] + lo[None, :, None]
    xy = draws["u_xy"] * (1.0 - wh) + wh / 2
    cls, present, jitter = draws["cls"], draws["present"], draws["jitter"]
    # a divisor on the device: CUDA multiplies by a host scalar's reciprocal
    axis = torch.arange(size, dtype=f32, device=dev) / torch.full((), float(size), dtype=f32, device=dev)
    yy, xx = axis[None, :, None], axis[None, None, :]
    palette = torch.tensor(PALETTE, dtype=f32, device=dev)
    for s in range(len(ranges)):
        x0 = (xy[:, s, 0] - wh[:, s, 0] / 2)[:, None, None]
        x1 = (xy[:, s, 0] + wh[:, s, 0] / 2)[:, None, None]
        y0 = (xy[:, s, 1] - wh[:, s, 1] / 2)[:, None, None]
        y1 = (xy[:, s, 1] + wh[:, s, 1] / 2)[:, None, None]
        mask = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1) & present[:, s, None, None]
        color = torch.clamp(palette[cls[:, s]][:, None, None, :] + jitter[:, s, None, None, :], 0, 1)
        img = torch.where(mask[..., None], color, img)
    truth_rows = torch.cat([xy, torch.where(present[..., None], wh, 0.0), cls[..., None].to(f32)], dim=-1)
    return img, F.pad(truth_rows, (0, 0, 0, MAX_BOXES - len(ranges)))


def render_batch(generator: torch.Generator, batch: int, size: int, slots: str = "tiny"):
    return paint_batch(draw_slots(generator, batch, size, slots), size, slots)


def build_net(activation: str = "relu6", v3: bool = False, size: int = 416, v2: bool = False):
    from yolo_quantization_tpu_torch.models import zoo

    if v2:
        # yolov2-tiny, [region] head: anchors in GRID units for the 13x13
        # grid at 416, one per synthetic slot band (larges 0.45-0.72 rel ≈
        # 5.8-9.4 cells, smalls 0.09-0.20 ≈ 1.2-2.6)
        return zoo.yolov2_tiny(classes=CLASSES, width=size, height=size, activation=activation,
                               anchors=((1.8, 1.8), (4.2, 4.2), (7.6, 7.6)))
    if v3:
        # full yolov3: darknet53 residual ladder, 23 quantized shortcuts,
        # 3-scale heads
        return zoo.yolov3(classes=CLASSES, width=size, height=size, activation=activation)
    # standard darknet-tiny anchors (the zoo's default, the reference cfg's
    # elongated anchors, match no square synthetic box)
    return zoo.yolov3_tiny(classes=CLASSES, width=size, height=size, activation=activation,
                           anchors=STD_TINY_ANCHORS)


def train(net, steps: int, batch: int, multiscale: bool, quant_start: int, slots: str = "tiny",
          base_size: int = 416, range_stat: str = "minmax", compute_dtype: str = "float32",
          learned_ranges: bool = False, lr: float = 1e-3, device=None, log=print):
    """The script's schedule through the ``Trainer`` (burn-in 50; float
    before ``quant_start``, EMA-QAT, then learned ranges after the warm-up
    when asked), each step's batch drawn on the device; the loss is fetched
    every 100 steps and at the last.  Returns (trainer, [(step, loss)])."""
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    cfg = TrainConfig(
        learning_rate=lr, burn_in=50, batch_size=batch, quant_start_step=quant_start,
        max_batches=steps, range_stat=range_stat, compute_dtype=compute_dtype,
        learned_ranges=learned_ranges,
    )
    trainer = Trainer(net, cfg, seed=3, device=device)
    sizes = (base_size - 96, base_size, base_size + 96) if multiscale else (base_size,)
    t0 = time.time()
    losses = []
    for step in range(steps):
        size = sizes[(step // 10) % len(sizes)]
        images, truths = render_batch(seeded_generator(trainer.device, TRAIN_SEED, step), batch, size, slots)
        metrics = trainer.step(images, truths)
        if (step + 1) % 100 == 0 or step + 1 == steps:
            loss = float(metrics["loss"])  # waits for the queued steps
            losses.append((step + 1, loss))
            log(f"step {step + 1}/{steps} size {size} loss {loss:.4f} ({time.time() - t0:.0f}s)")
    return trainer, losses


def eval_batches(n_images: int, batch: int = 25, slots: str = "tiny", size: int = 416, device=None):
    """The fixed seeded evaluation images, drawn on the device: a list of
    (images, truths) batches."""
    return [render_batch(seeded_generator(device, EVAL_SEED, bi), batch, size, slots)
            for bi in range(n_images // batch)]


def eval_engine(engine, batches) -> list:
    """Each batch through ``engine.predict`` (decode and top-k on the device,
    only the top-k copied back); per image (boxes, obj, truths [cls, x, y,
    w, h]) for ``f1_rows``."""
    cache = []
    for images, truths in batches:
        boxes, obj, _ = engine.predict(images)
        tr = truths.cpu().numpy()
        for k in range(len(tr)):
            rows = tr[k][tr[k, :, 2] > 0]
            cache.append((boxes[k], obj[k], np.concatenate([rows[:, 4:5], rows[:, 0:4]], axis=1)))
    return cache


def best_row(cache, verbose: bool):
    from yolo_quantization_tpu_torch.eval.f1 import f1_rows

    return max(f1_rows(cache, verbose=verbose), key=lambda r: r.f1)


def row_json(r) -> dict:
    return {"thresh": r.thresh, "recall": round(r.recall, 2), "precision": round(r.precision, 2),
            "f1": round(r.f1, 2)}


def device_name(device: torch.device) -> str:
    """The torch device's name and, on a card, nvidia-smi's name and power
    limit."""
    if device.type != "cuda":
        return str(device)
    from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity

    return f"{torch.cuda.get_device_name(device)} ({device}); nvidia-smi: {card_identity()}"


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=3000)
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("--v2", action="store_true", help="yolov2-tiny, region head")
    ap.add_argument("--v3", action="store_true", help="full yolov3, 23 quantized shortcuts")
    ap.add_argument("--leaky", action="store_true", help="leaky activations instead of relu6")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 conv operands in training")
    ap.add_argument("--percentile", nargs="?", const="", default=None, metavar="P",
                    help="percentile ranges (--percentile=P for the tail)")
    ap.add_argument("--learned", action="store_true", help="learned ranges after the EMA warm-up")
    ap.add_argument("--float-baseline", action="store_true", help="float training only, float row only")
    ap.add_argument("--no-multiscale", action="store_true")
    ap.add_argument("--base-size", type=int, default=416)
    ap.add_argument("--eval-images", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tag", default="r11")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=REPO)
    return ap.parse_args(argv)


def settings(a) -> tuple[str, str, str]:
    """(activation, range_stat, compute_dtype) as the flags set them."""
    range_stat = ("minmax" if a.percentile is None else
                  "percentile" if a.percentile == "" else f"percentile:{a.percentile}")
    return "leaky" if a.leaky else "relu6", range_stat, "bfloat16" if a.bf16 else "float32"


def file_name(a) -> str:
    """The JAX script's record name with ``TORCH`` after its first part."""
    activation, range_stat, compute_dtype = settings(a)
    if a.float_baseline:
        lr_part = "" if a.lr == 1e-3 else f"_lr{a.lr:g}"
        return f"FLOATBASE_TORCH{'_V3' if a.v3 else ''}_{a.tag}{lr_part}.json"
    parts = ["ACCURACY", "TORCH"]
    if a.v3:
        parts.append("V3")
    if a.v2:
        parts.append("V2")
    parts.append(a.tag)
    if activation != "relu6":
        parts.append(activation)
    if range_stat != "minmax":
        parts.append(range_stat.replace(":", "-"))
    if a.learned:
        parts.append("learned")
    if compute_dtype != "float32":
        parts.append("bf16")
    return "_".join(parts) + ".json"


def main(argv=None, log=print):
    """Train, evaluate, write and print the record.  Returns (record, info):
    info holds the printed losses, the training's peak device memory (MiB,
    on a card) and the record's path."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine, QatSimEngine
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy

    a = parse_args(argv)
    device = resolve_device(a.device, "accuracy_capstone")
    multiscale = not a.no_multiscale
    activation, range_stat, compute_dtype = settings(a)
    size = a.base_size
    slots = "v3" if a.v3 else "tiny"
    quant_start = a.steps + 1 if a.float_baseline else a.steps * 2 // 5
    model = "yolov2-tiny" if a.v2 else "yolov3" if a.v3 else "yolov3-tiny"

    net = build_net(activation, v3=a.v3, size=size, v2=a.v2)
    log(f"capstone: {'yolov3-full' if model == 'yolov3' else model} {size}x{size} {CLASSES}-class "
        f"{activation} QAT, {a.steps} steps batch {a.batch}, multiscale={multiscale}, "
        f"quant_start={quant_start}, range_stat={range_stat}, compute_dtype={compute_dtype}, "
        f"device={device_name(device)}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    trainer, losses = train(net, a.steps, a.batch, multiscale, quant_start, slots=slots, base_size=size,
                            range_stat=range_stat, compute_dtype=compute_dtype,
                            learned_ranges=a.learned, lr=a.lr, device=device, log=log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0
    info = {"losses": losses,
            "peak_mib": (torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None)}
    if info["peak_mib"] is not None:
        log(f"training: {train_s:.1f} s, {1e3 * train_s / a.steps:.3f} ms a step, peak memory "
            f"{info['peak_mib']:.1f} MiB (sizes up to {size + 96 if multiscale else size})")
    state = trainer.state
    batches = eval_batches(a.eval_images, slots=slots, size=size, device=device)

    if a.float_baseline:
        # pure float training (QAT never activates): the honest comparator
        # for the QAT capstones' int rows — their "float" row is QAT weights
        # stripped of the clamps they trained against, not a float model
        best = best_row(eval_engine(FloatEngine(net, state.params, max_det=64, device=device), batches), True)
        log(f"float-baseline best: thresh {best.thresh} R {best.recall:.2f} "
            f"P {best.precision:.2f} F1 {best.f1:.2f}")
        out = {
            "metric": f"float_baseline_{'v3_' if a.v3 else ''}{size}",
            "config": {
                "model": model, "size": size, "classes": CLASSES, "steps": a.steps, "batch": a.batch,
                "activation": activation, "multiscale": multiscale, "learning_rate": a.lr,
                "eval_images": a.eval_images,
            },
            "train_seconds": round(train_s, 1),
            "float": row_json(best),
            "device": device_name(device),
        }
    else:
        # the QAT-simulated eval: the fake-quant graph training optimized.
        # If it matches the integer engine, the engine is faithful and any
        # gap to float is the quantization itself
        qbest = best_row(eval_engine(QatSimEngine(net, state.params, state.quant_state, max_det=64,
                                                  device=device), batches), False)
        log(f"qat-sim best: thresh {qbest.thresh} R {qbest.recall:.2f} P {qbest.precision:.2f} F1 {qbest.f1:.2f}")
        fbest = best_row(eval_engine(FloatEngine(net, state.params, max_det=64, device=device), batches), True)
        log(f"float best: thresh {fbest.thresh} R {fbest.recall:.2f} P {fbest.precision:.2f} F1 {fbest.f1:.2f}")
        program = convert(net, params_to_numpy(state.params), quant_state_to_numpy(state.quant_state))
        ibest = best_row(eval_engine(Engine(program, max_det=64, device=device), batches), True)
        log(f"int best: thresh {ibest.thresh} R {ibest.recall:.2f} P {ibest.precision:.2f} F1 {ibest.f1:.2f}")
        out = {
            "metric": f"accuracy_capstone_{'v2_' if a.v2 else 'v3_' if a.v3 else ''}{size}",
            "config": {
                "model": model, "size": size, "classes": CLASSES, "steps": a.steps, "batch": a.batch,
                "activation": activation, "multiscale": multiscale, "quant_start_step": quant_start,
                "range_stat": range_stat, "compute_dtype": compute_dtype, "learned_ranges": a.learned,
                "quantized_shortcuts": 23 if model == "yolov3" else 0,
                "eval_images": a.eval_images, "protocol": PROTOCOL,
            },
            "train_seconds": round(train_s, 1),
            "float": row_json(fbest),
            "int": row_json(ibest),
            "qat_sim": row_json(qbest),
            "f1_gap": round(fbest.f1 - ibest.f1, 3),
            "f1_gap_vs_qat_sim": round(qbest.f1 - ibest.f1, 3),
            "within_half_point": bool(ibest.f1 >= fbest.f1 - 0.5),
            "int_within_half_of_qat_sim": bool(ibest.f1 >= qbest.f1 - 0.5),
            "device": device_name(device),
        }
    os.makedirs(a.out_dir, exist_ok=True)
    info["path"] = os.path.join(a.out_dir, file_name(a))
    with open(info["path"], "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    return out, info


if __name__ == "__main__":
    main()
