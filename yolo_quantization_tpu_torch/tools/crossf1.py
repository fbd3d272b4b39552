"""Cross-binary F1: the C-exact twin and the compiled reference score the
port's QAT-trained checkpoint.

The counterpart of ``scripts/crossf1.py``:

    python -m yolo_quantization_tpu_torch.tools.crossf1 [--steps 1500] [--train-size 160]
        [--batch 8] [--n-train 48] [--n-eval 24] [--tag r10] [--device cuda|cpu]

1. renders a lossless synthetic train and eval set (PNG bytes under .jpg
   names, so the reference's .jpg -> .txt label lookup works; 5 classes, two
   large and two small boxes per image), 416x416;
2. builds the flagship topology (yolov3-tiny, relu6, 5 classes) with the
   standard tiny anchors (the reference cfg's elongated 405-420 px anchors
   cannot match square synthetic boxes);
3. trains it with QAT on the device (``Trainer``, ``BatchLoader``,
   ``DetectionDataset``, augmentation on) at ``--train-size`` and writes it
   with ``save_darknet_weights``, its quant blocks holding the asymmetric
   per-channel weight codes of the parity engine (``scripts/crossf1.py``
   writes symmetric codes, so there the twin and the C binary run other
   integer weights than the parity engine);
4. counts the detector-f1 protocol (``eval/f1.py``) over the eval set from
   the C-exact twin (``parity/ctwin.py``), the integer ``Engine`` in parity
   mode (asymmetric weights, raw-byte routes, per-image dynamic input
   quantization, darknet's leaky; K1 on the card), the ``Engine`` in
   production mode and the ``QatSimEngine``.

Contract 2 (``tests/test_crossf1.py``'s): the production engine's best F1
is at least the QAT simulation's minus 0.5.  Contract 1, the twin's counts
equal to the compiled reference binary's at every threshold, runs only
where the reference sources (``REF``) and gcc exist (the binary and
``native/parity_shim.c`` are built under ``build/torch_ref``); elsewhere
the verdict says it was not run.  Writes ``CROSSF1_<tag>.json`` into the
work directory, prints a JSON summary last, and exits 0 only when every
contract that ran holds.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STD_TINY_ANCHORS = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319))
CLASS_COLORS = [
    (245, 80, 50), (60, 220, 90), (70, 110, 245), (240, 200, 60),
    (180, 70, 230),
]


def render_dataset(root: str, n: int, seed: int, canvas: int = 416) -> str:
    """Synthetic coloured-box detection set, lossless on disk: one or two
    large boxes (the 344x319-class anchors at 416) and one or two small
    (81x82-class, through the route + upsample fine head) per image, 5
    classes.  Returns the image list file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(n):
        im = (rng.uniform(0, 0.22, (canvas, canvas, 3)) * 255).astype(np.uint8)
        labels = []

        def put_box(w, h, cls):
            x = rng.uniform(w / 2, 1 - w / 2)
            y = rng.uniform(h / 2, 1 - h / 2)
            x0, y0 = int((x - w / 2) * canvas), int((y - h / 2) * canvas)
            x1, y1 = int((x + w / 2) * canvas), int((y + h / 2) * canvas)
            im[y0:y1, x0:x1] = CLASS_COLORS[cls]
            labels.append(f"{cls} {x:.6f} {y:.6f} {w:.6f} {h:.6f}")

        # two large (the second present with p=.7), two small (the same)
        put_box(rng.uniform(0.45, 0.72), rng.uniform(0.45, 0.72), int(rng.integers(5)))
        if rng.uniform() < 0.7:
            put_box(rng.uniform(0.45, 0.72), rng.uniform(0.45, 0.72), int(rng.integers(5)))
        put_box(rng.uniform(0.09, 0.20), rng.uniform(0.09, 0.20), int(rng.integers(5)))
        if rng.uniform() < 0.7:
            put_box(rng.uniform(0.09, 0.20), rng.uniform(0.09, 0.20), int(rng.integers(5)))
        # PNG bytes under a .jpg name: lossless for both decoders (they
        # sniff magic bytes); .jpg for the reference's label lookup
        p = f"{root}/images/img_{i:03d}.jpg"
        Image.fromarray(im).save(p, format="PNG")
        with open(f"{root}/labels/img_{i:03d}.txt", "w") as f:
            f.write("\n".join(labels) + "\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def flagship_net(size: int = 416):
    """The flagship topology (yolov3-tiny, relu6, 5 classes) with the
    standard tiny anchors."""
    from yolo_quantization_tpu_torch.models import zoo

    return zoo.yolov3_tiny(classes=5, anchors=STD_TINY_ANCHORS, width=size, height=size)


def reference_dir() -> str | None:
    """The reference darknet sources (``REF``), where they and gcc exist."""
    import shutil

    ref = os.environ.get("REF")
    if not ref or not os.path.isdir(ref) or shutil.which("gcc") is None:
        return None
    return ref


def build_reference(ref: str) -> str:
    """Build the reference binary and the parity shim into build/torch_ref;
    returns the shim's path."""
    out = os.path.join(REPO, "build", "torch_ref")
    subprocess.run(["bash", os.path.join(REPO, "scripts", "build_reference.sh")], check=True,
                   capture_output=True, text=True, env={**os.environ, "REF": ref, "OUT": out})
    return os.path.join(out, "parity_shim")


def write_cfg(workdir: str, ref: str) -> str:
    """The reference cfg with only its anchors replaced by the standard tiny
    set, for the compiled binary."""
    with open(os.path.join(ref, "cfg", "yolov3_tiny_quant_channelwise.cfg")) as f:
        text = f.read()
    anchors = ",  ".join(f"{w},{h}" for w, h in STD_TINY_ANCHORS)
    text = re.sub(r"anchors *=.*", f"anchors = {anchors}", text)
    out = os.path.join(workdir, "crossf1.cfg")
    with open(out, "w") as f:
        f.write(text)
    return out


def train(net, list_file: str, train_size: int, steps: int, batch: int, device, seed: int = 7,
          log=print):
    """QAT training on ``device``: float for the first 40% of the steps,
    EMA-QAT after.  Returns (params, ranges, seen) as numpy."""
    from yolo_quantization_tpu_torch.data.loader import BatchLoader
    from yolo_quantization_tpu_torch.data.voc import AugmentConfig, DetectionDataset
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    cfg = TrainConfig(learning_rate=1e-3, burn_in=50, quant_start_step=steps * 2 // 5,
                      max_batches=steps, batch_size=batch)
    trainer = Trainer(net, cfg, seed=seed, device=device)
    ds = DetectionDataset(list_file, train_size, train_size, augment=True,
                          aug_cfg=AugmentConfig(jitter=0.08, hue=0.02, saturation=1.1, exposure=1.1))
    loader = BatchLoader(ds, batch, workers=4)
    t0 = time.time()
    try:
        for i in range(steps):
            images, truths = loader.next()
            m = trainer.step(images, truths)
            if i % 100 == 0 or i == steps - 1:
                log(f"step {i}: loss {float(m['loss']):.4f} ({time.time() - t0:.0f}s)")
    finally:
        loader.close()
    st = trainer.state
    return params_to_numpy(st.params), quant_state_to_numpy(st.quant_state), int(st.seen)


def _rows(rows) -> list[dict]:
    return [{"thresh": r.thresh, "tp": r.tp, "tp_fp": r.tp_fp, "tp_fn": r.tp_fn,
             "recall": r.recall, "precision": r.precision, "f1": r.f1} for r in rows]


def engine_rows(engine, list_file: str) -> list[dict]:
    from yolo_quantization_tpu_torch.eval.f1 import f1_sweep

    return _rows(f1_sweep(engine, list_file))


def twin_rows(net, weights_path: str, list_file: str) -> list[dict]:
    """F1 rows from the C-exact twin: byte-identical to the compiled
    reference, so these counts equal the C binary's; an engine-vs-C gap is
    then the engine's rounding epilogue against the reference's truncation
    through doubles."""
    from yolo_quantization_tpu_torch.data.image import letterbox, load_image_rgb
    from yolo_quantization_tpu_torch.data.voc import label_path_for, read_boxes, read_image_list
    from yolo_quantization_tpu_torch.eval.f1 import f1_rows
    from yolo_quantization_tpu_torch.models.darknet_weights import load_darknet_weights
    from yolo_quantization_tpu_torch.nn.graph import YoloSpec
    from yolo_quantization_tpu_torch.parity.ctwin import CTwin, yolo_detections_c

    twin = CTwin(net, load_darknet_weights(weights_path, net))
    cache = []
    for p in read_image_list(list_file):
        im = load_image_rgb(p)
        h, w, _ = im.shape
        chw = np.ascontiguousarray(letterbox(im, net.width, net.height).transpose(2, 0, 1))
        res = twin.forward(chw)
        yolo_outs = [tl.f32 for tl, s in zip(res.layers, net.specs) if isinstance(s, YoloSpec)]
        dets = yolo_detections_c(net, yolo_outs, w, h, 0.05)
        cache.append((dets[:, :4], dets[:, 4], read_boxes(label_path_for(p))))
    return _rows(f1_rows(cache))


def run_c_f1(shim: str, cfg: str, weights: str, list_file: str, outdir: str) -> list[dict]:
    """The shim's f1 list mode (the reference's validate_detector_f1)."""
    r = subprocess.run([shim, cfg, weights, list_file, outdir], capture_output=True, text=True,
                       timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"parity_shim f1 mode failed:\n{r.stderr[-2000:]}")
    rows = []
    with open(os.path.join(outdir, "crossf1.txt")) as f:
        for line in f:
            p = line.split()
            tp, tp_fp, tp_fn = int(p[1]), int(p[2]), int(p[3])
            rows.append({"thresh": float(p[0]), "tp": tp, "tp_fp": tp_fp, "tp_fn": tp_fn,
                         "proposals": int(p[4]), "recall": 100.0 * tp / max(tp_fn, 1),
                         "precision": 100.0 * tp / max(tp_fp, 1),
                         "f1": 100.0 * 2 * tp / max(tp_fp + tp_fn, 1)})
    return rows


def best(rows: list[dict]) -> dict:
    return max(rows, key=lambda r: r["f1"])


def run(workdir: str, steps: int = 1500, train_size: int = 160, batch: int = 8, n_train: int = 48,
        n_eval: int = 24, device="cuda", phase: str = "all", tag: str = "r10", log=print) -> dict:
    """The whole loop; returns the verdict (``ok`` when every contract that
    ran holds).  ``phase="train"`` stops after the export; ``"eval"``
    reuses the work directory's ``crossf1.weights``."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.float_engine import QatSimEngine
    from yolo_quantization_tpu_torch.models.darknet_weights import (
        load_darknet_weights,
        save_darknet_weights,
    )

    dev = resolve_device(device, "crossf1")
    os.makedirs(workdir, exist_ok=True)
    ref = reference_dir()
    net = flagship_net()
    weights_path = os.path.join(workdir, "crossf1.weights")
    meta_path = os.path.join(workdir, "train_meta.json")
    eval_list = render_dataset(os.path.join(workdir, "eval"), n_eval, seed=99)
    if phase in ("all", "train"):
        train_list = render_dataset(os.path.join(workdir, "train"), n_train, seed=11)
        log(f"training on {dev}: {len(net.specs)}-spec net at {train_size}^2 for {steps} steps, "
            f"batch {batch}")
        t0 = time.perf_counter()
        params, qs, seen = train(net, train_list, train_size, steps, batch, dev, log=log)
        train_s = time.perf_counter() - t0
        # the parity engine's asymmetric per-channel codes, so the twin and
        # the engine it is compared with run the same integer weights
        save_darknet_weights(weights_path, net, params, qs, seen=seen, symmetric_weights=False)
        with open(meta_path, "w") as f:
            json.dump({"steps": steps, "batch": batch, "device": str(dev), "train_size": train_size,
                       "quant_start_step": steps * 2 // 5, "seconds": train_s}, f)
        if phase == "train":
            return {"ok": True, "weights": weights_path, "train_seconds": train_s}
    ckpt = load_darknet_weights(weights_path, net)
    params, qs = ckpt.params, ckpt.quant_state

    prog_parity = convert(net, params, qs, symmetric_weights=False, route_rescale=False)
    e_rows = engine_rows(Engine(prog_parity, max_det=256, device=dev, dynamic_input=True,
                                exact_leaky=True), eval_list)
    p_rows = engine_rows(Engine(convert(net, params, qs), max_det=256, device=dev), eval_list)
    q_rows = engine_rows(QatSimEngine(net, params, qs, max_det=256, device=dev), eval_list)
    t0 = time.perf_counter()
    t_rows = twin_rows(net, weights_path, eval_list)
    twin_s = time.perf_counter() - t0

    eb, pb, qb, tb = best(e_rows), best(p_rows), best(q_rows), best(t_rows)
    with open(meta_path) as f:
        train_meta = json.load(f)
    out = {
        "protocol": "the detector-f1 protocol (eval/f1.py: thresholds 0.1-0.6, class-agnostic "
                    "NMS 0.1) over lossless synthetic images at 416",
        "net": "yolov3-tiny, relu6, 5 classes, standard tiny anchors, 416x416 eval",
        "train": train_meta,
        "eval_images": n_eval,
        "engine_parity_mode": {"rows": e_rows, "best": eb},
        "engine_production": {"rows": p_rows, "best": pb},
        "qat_sim": {"rows": q_rows, "best": qb},
        "twin_c_exact": {"rows": t_rows, "best": tb, "seconds": twin_s},
        "contract2_engine_within_half_point_of_qat_sim": bool(pb["f1"] >= qb["f1"] - 0.5),
        "f1_delta_twin_vs_engine_parity": round(abs(tb["f1"] - eb["f1"]), 3),
        "device": str(dev),
    }
    if ref is not None:
        shim = build_reference(ref)
        c_rows = run_c_f1(shim, write_cfg(workdir, ref), weights_path, eval_list, workdir)
        out["c_binary"] = {"rows": c_rows, "best": best(c_rows)}
        out["contract1_twin_counts_equal_c_binary"] = all(
            (tr["tp"], tr["tp_fp"], tr["tp_fn"]) == (cr["tp"], cr["tp_fp"], cr["tp_fn"])
            for tr, cr in zip(t_rows, c_rows))
        out["f1_delta_c_vs_engine_parity"] = round(abs(best(c_rows)["f1"] - eb["f1"]), 3)
    else:
        out["contract1_twin_counts_equal_c_binary"] = "not run: reference sources absent"
    out["ok"] = bool(out["contract2_engine_within_half_point_of_qat_sim"]
                     and out["contract1_twin_counts_equal_c_binary"] is not False)
    with open(os.path.join(workdir, f"CROSSF1_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def summary(out: dict) -> dict:
    """The verdict without the per-threshold rows."""
    rows = ("engine_parity_mode", "engine_production", "qat_sim", "twin_c_exact", "c_binary")
    return {k: v for k, v in out.items() if k not in rows} | {
        f"{k}_best": out[k]["best"] for k in rows if k in out}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=("all", "train", "eval"), default="all",
                    help="train: train and export only; eval: reuse the work directory's .weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--train-size", type=int, default=160)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-eval", type=int, default=24)
    ap.add_argument("--tag", default="r10")
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "torch_crossf1"))
    args = ap.parse_args(argv)
    out = run(args.workdir, args.steps, args.train_size, args.batch, args.n_train, args.n_eval,
              args.device, args.phase, args.tag, log=lambda m: print(m, flush=True))
    print(json.dumps(summary(out) if args.phase != "train" else out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
