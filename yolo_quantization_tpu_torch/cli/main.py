"""Command-line entry points: the counterpart of
``yolo_quantization_tpu/cli/main.py`` (darknet's ``detector`` CLI):

  python -m yolo_quantization_tpu_torch.cli train  --model yolov3-tiny --train-list L [...]
  python -m yolo_quantization_tpu_torch.cli detect --weights W --image IMG [--out OUT.png]
  python -m yolo_quantization_tpu_torch.cli valid  --weights W --test-list L --map
  python -m yolo_quantization_tpu_torch.cli f1     --program P.npz --test-list L
  python -m yolo_quantization_tpu_torch.cli export --ckpt DIR --out W
  python -m yolo_quantization_tpu_torch.cli bench  [--v3] [--batches 128,256]

Models come from darknet cfg files (``models/cfg.py``) or the built-in zoo
(``--model yolov3-tiny|yolov3|yolov2-tiny|yolov2``); weights from darknet
``.weights`` files (``models/darknet_weights.py``), integer programs
(``.npz``) or the port's checkpoint directories (``train/checkpoint.py``).
Every subcommand runs on the GPU unless ``--device cpu`` is given, and
fails where there is no GPU.  ``train --data-parallel`` (or ``--fsdp``)
trains over every rank of a process group, one rank per device, started
by torchrun (``torchrun --nproc-per-node N -m yolo_quantization_tpu_torch.cli
train --data-parallel ...``): NCCL on the cards, gloo with ``--device
cpu``; without torchrun the group is this one process.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from yolo_quantization_tpu_torch.tools import bench as bench_tool


def _device(args) -> str:
    """``--device``; a CUDA device where there is none fails, as Engine does."""
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{args.command} runs on the GPU unless --device cpu is given, and "
                         "torch.cuda.is_available() is false")
    return args.device


def _read_names(path):
    if not path:
        return None
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load_model(args):
    from yolo_quantization_tpu_torch.models import cfg as cfgmod
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.train.qat import TrainConfig

    if args.cfg:
        return cfgmod.load_cfg(args.cfg)
    builders = {
        "yolov3-tiny": zoo.yolov3_tiny,
        "yolov3": zoo.yolov3,
        "yolov2-tiny": zoo.yolov2_tiny,
        "yolov2": zoo.yolov2,
    }
    if args.model in builders:
        net = builders[args.model](classes=args.classes, width=args.size, height=args.size)
        return net, TrainConfig()
    raise SystemExit(f"unknown model {args.model!r}; pass --cfg or one of {sorted(builders)}")


def _restore(args, net):
    """(numpy params, numpy quant state, state) from the ``--ckpt`` directory."""
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy
    from yolo_quantization_tpu_torch.train.checkpoint import restore_checkpoint
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, init_train_state

    template = init_train_state(net, TrainConfig(), device="cpu")
    state = restore_checkpoint(args.ckpt, template)
    return params_to_numpy(state.params), quant_state_to_numpy(state.quant_state), state


def _engine_from(args, net):
    """Integer engine when quant ranges exist; float engine otherwise
    (darknet's close_quantization fallback)."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine

    device = _device(args)
    options = dict(device=device, carrier="int16" if args.int16 else "int8",
                   dynamic_input=args.dynamic_input, exact_leaky=args.exact_leaky)

    def build(params, qs):
        has_ranges = qs is not None and any(
            k.startswith("act_") and float(st["max"]) != float(st["min"]) for k, st in qs.items())
        if args.float or not has_ranges:
            print("running FLOAT inference (no quant ranges or --float given)")
            return FloatEngine(net, params, device=device)
        return Engine(convert(net, params, qs), **options)

    if args.program:
        from yolo_quantization_tpu_torch.infer.serialize import load_program

        return Engine(load_program(args.program), **options)
    if args.weights:
        from yolo_quantization_tpu_torch.models.darknet_weights import load_darknet_weights

        ckpt = load_darknet_weights(args.weights, net)
        return build(ckpt.params, ckpt.quant_state)
    if args.ckpt:
        params, qs, _ = _restore(args, net)
        return build(params, qs)
    raise SystemExit("need --weights (darknet), --program (.npz) or --ckpt (checkpoint directory)")


def cmd_train(args):
    import torch.distributed as dist

    from yolo_quantization_tpu_torch.parallel import distributed
    from yolo_quantization_tpu_torch.parallel import mesh as pmesh

    device = _device(args)
    mesh, owns_group = None, False
    if args.data_parallel or args.fsdp:
        owns_group = not dist.is_initialized()
        distributed.initialize(device=device)
        device = pmesh.rank_device(device)
        mesh = distributed.global_mesh(device=device)
    try:
        _train(args, device, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args, device, mesh):
    """The training loop of ``cmd_train``; with a mesh every rank runs it on
    its rows of each global batch, and rank 0 alone prints and writes."""
    import dataclasses
    import random

    from yolo_quantization_tpu_torch.data.loader import BatchLoader
    from yolo_quantization_tpu_torch.data.voc import DetectionDataset
    from yolo_quantization_tpu_torch.parallel import mesh as pmesh
    from yolo_quantization_tpu_torch.train import checkpoint as ckpt
    from yolo_quantization_tpu_torch.train.qat import Trainer, multiscale_resolutions

    net, tcfg = _load_model(args)
    overrides = {"batch_size": args.batch_size, "max_batches": args.max_batches,
                 "quant_start_step": args.quant_start,
                 "freeze_ranges_after": args.freeze_ranges_after}
    tcfg = dataclasses.replace(tcfg, **{k: v for k, v in overrides.items() if v is not None})
    if args.prune:
        tcfg = dataclasses.replace(tcfg, prune=True, prune_threshold=args.prune_threshold)

    trainer = Trainer(net, tcfg, device=device, mesh=mesh, fsdp=args.fsdp)
    rank, world = pmesh.rank_world(trainer.group)
    say = print if rank == 0 else (lambda *a, **k: None)
    start = 0
    if args.resume and ckpt.latest_step(args.backup_dir) is not None:
        trainer.state = ckpt.restore_checkpoint(args.backup_dir, trainer.state)
        start = int(trainer.state.step)
        say(f"resumed from step {start}")

    ds = DetectionDataset(args.train_list, net.width, net.height, augment=True)
    # every rank loads the same global batches (one seed) and takes its rows
    loader = BatchLoader(ds, tcfg.batch_size, workers=args.workers,
                         pin_memory=trainer.device.type == "cuda")
    where = f"DP over {world} devices ({trainer.device.type})" if mesh else f"single device ({trainer.device})"
    say(f"training {len(net.specs)}-layer net at {net.width}x{net.height}, "
        f"batch {tcfg.batch_size}, {len(ds)} images, {where}")
    if args.fsdp:
        from yolo_quantization_tpu_torch.parallel import fsdp

        rep = fsdp.shard_report(trainer.state.params, world)
        say(f"FSDP over {world} devices: {rep['sharded_fraction'] * 100:.1f}% of param bytes sharded "
            f"({rep['sharded_bytes']} sharded / {rep['replicated_bytes']} replicated)")
    resolutions = multiscale_resolutions() if args.multiscale else None
    # one seed on every rank: the ranks switch to the same resolution
    scale_rng = random.Random(0)
    avg_loss = None
    try:
        for step in range(start, tcfg.max_batches):
            if resolutions and step % 10 == 0:
                dim = scale_rng.choice(resolutions)
                ds.set_size(dim, dim)
                if step % 100 == 0:
                    say(f"resolution -> {dim}")
            images, truths = pmesh.shard_batch(trainer.group, *loader.next())
            t0 = time.time()
            metrics = trainer.step(images, truths)
            loss = float(metrics["loss"])  # waits for the step
            avg_loss = loss if avg_loss is None else 0.9 * avg_loss + 0.1 * loss
            prune_info = (f", sparsity {float(metrics['sparsity']):.3f}"
                          if "sparsity" in metrics else "")
            say(f"{step + 1}: loss {loss:.4f}, avg {avg_loss:.4f}, "
                f"lr {float(metrics['lr']):.6f}, {time.time() - t0:.2f}s, "
                f"{(step + 1) * tcfg.batch_size} images{prune_info}")
            if ckpt.checkpoint_cadence(step + 1):
                ckpt.save_checkpoint(args.backup_dir, trainer.state)
                say(f"checkpointed step {step + 1} -> {args.backup_dir}")
    finally:
        loader.close()
    ckpt.save_checkpoint(args.backup_dir, trainer.state)
    say("training done")


def cmd_detect(args):
    from yolo_quantization_tpu_torch.data.image import letterbox, load_image_rgb
    from yolo_quantization_tpu_torch.eval import detect as D

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    im = load_image_rgb(args.image)
    h, w, _ = im.shape
    t0 = time.time()
    x = letterbox(im, net.width, net.height)
    boxes, obj, cls = engine.predict(x[None])
    boxes = D.correct_boxes(boxes[0], w, h, net.width, net.height)
    obj, cls = obj[0], cls[0]
    keep = obj > args.thresh
    b, o, c = D.nms_obj(boxes[keep], obj[keep], cls[keep], args.nms)
    print(f"{args.image}: predicted in {time.time() - t0:.3f}s")
    names = _read_names(args.names)
    for i in range(len(o)):
        if o[i] <= args.thresh:
            continue
        probs = o[i] * c[i]
        ci = int(np.argmax(probs))
        label = names[ci] if names and ci < len(names) else f"class{ci}"
        print(f"  {label}: {100 * probs[ci]:.0f}%  "
              f"box(x={b[i, 0]:.3f} y={b[i, 1]:.3f} w={b[i, 2]:.3f} h={b[i, 3]:.3f})")
    if args.out:
        _draw(im, b, o, args.thresh, args.out, cls=c, names=names)
        print(f"  wrote {args.out}")


def _class_color(ci: int, classes: int):
    """darknet's per-class colour wheel (get_color with offset
    class*123457 % classes; red/green/blue from columns 2/1/0 of a
    6-colour table)."""
    table = [(1, 0, 1), (0, 0, 1), (0, 1, 1), (0, 1, 0), (1, 1, 0), (1, 0, 0)]
    classes = max(classes, 1)
    offset = (ci * 123457) % classes
    ratio = offset / classes * 5
    i, j = int(ratio), min(int(ratio) + 1, 5)
    r = ratio - i
    rgb = [(1 - r) * table[i][c] + r * table[j][c] for c in (2, 1, 0)]
    return tuple(int(255 * v) for v in rgb)


def _annotate(im, boxes, obj, thresh, cls=None, names=None):
    """Draw class-coloured boxes with "name prob%" labels (darknet's
    draw_detections, text through PIL); returns float32 RGB [0, 1]."""
    from PIL import Image, ImageDraw

    img = Image.fromarray((im * 255).astype(np.uint8))
    d = ImageDraw.Draw(img)
    h, w = im.shape[:2]
    for i in range(len(obj)):
        if obj[i] <= thresh:
            continue
        x, y, bw, bh = boxes[i]
        left, top = (x - bw / 2) * w, (y - bh / 2) * h
        right, bot = (x + bw / 2) * w, (y + bh / 2) * h
        color = (255, 60, 40)
        label = None
        if cls is not None and np.size(cls[i]):
            probs = obj[i] * np.asarray(cls[i])
            ci = int(np.argmax(probs))
            if probs[ci] > thresh:
                name = names[ci] if names and ci < len(names) else f"class{ci}"
                label = f"{name} {100 * probs[ci]:.0f}%"
            color = _class_color(ci, len(cls[i]))
        d.rectangle([left, top, right, bot], outline=color, width=max(2, round(0.006 * min(h, w))))
        if label:
            tb = d.textbbox((0, 0), label)
            tw, th = tb[2] - tb[0], tb[3] - tb[1]
            y0 = top - th - 4 if top - th - 4 >= 0 else top
            d.rectangle([left, y0, left + tw + 4, y0 + th + 4], fill=color)
            lum = 0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]
            d.text((left + 2, y0 + 2), label, fill=(0, 0, 0) if lum > 128 else (255, 255, 255))
    return np.asarray(img).astype(np.float32) / 255.0


def _draw(im, boxes, obj, thresh, out_path, cls=None, names=None):
    from PIL import Image

    out = _annotate(im, boxes, obj, thresh, cls=cls, names=names)
    Image.fromarray((out * 255).astype(np.uint8)).save(out_path)


def cmd_f1(args):
    from yolo_quantization_tpu_torch.eval.f1 import f1_sweep

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    if args.eval_size:
        engine = engine.at_size(args.eval_size)  # darknet's resize_network before eval
    rows = f1_sweep(engine, args.test_list, max_images=args.max_images, verbose=True)
    best = max(rows, key=lambda r: r.f1)
    print(f"best: thresh {best.thresh:.1f} recall {best.recall:.2f} "
          f"precision {best.precision:.2f} F1 {best.f1:.2f}")
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(f"thresh = {r.thresh:.6f}, recall = {r.recall:.6f}, "
                        f"precison = {r.precision:.6f}, f1 score = {r.f1:.6f}\n")


def cmd_export_program(args):
    """Weights or checkpoint -> self-contained integer program (.npz)."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.serialize import save_program

    net, _ = _load_model(args)
    if args.weights:
        from yolo_quantization_tpu_torch.models.darknet_weights import load_darknet_weights

        ckpt = load_darknet_weights(args.weights, net)
        params, qs = ckpt.params, ckpt.quant_state
    elif args.ckpt:
        params, qs, _ = _restore(args, net)
    else:
        raise SystemExit("export-program needs --weights (darknet) or --ckpt (checkpoint directory)")
    save_program(args.out, convert(net, params, qs))
    print(f"wrote integer program {args.out}")


def cmd_export(args):
    """Checkpoint directory -> darknet .weights (with the quantization
    extension once the ranges have been seen)."""
    from yolo_quantization_tpu_torch.models.darknet_weights import save_darknet_weights

    net, _ = _load_model(args)
    params, qs, state = _restore(args, net)
    qs = qs if float(qs["input"]["max"]) != 0 else None
    seen = int(state.seen)  # images consumed (darknet's net.seen)
    save_darknet_weights(args.out, net, params, qs, seen=seen)
    print(f"wrote {args.out} (quantized={qs is not None}, seen={seen})")


def cmd_recall(args):
    """Recall and IoU (darknet's validate_detector_recall)."""
    from yolo_quantization_tpu_torch.eval.f1 import recall_eval

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    out = recall_eval(engine, args.test_list, thresh=args.thresh, iou_thresh=args.iou,
                      max_images=args.max_images)
    print(f"recall {out['recall']:.2f}%  avg IoU {out['avg_iou']:.2f}%  "
          f"RPs/img {out['proposals_per_image']:.2f}  truths {out['total_truths']}")


def cmd_valid(args):
    """VOC/COCO/ImageNet result writers and mAP (darknet's detector valid)."""
    from yolo_quantization_tpu_torch.eval.valid import (
        read_map,
        voc_map,
        write_coco_results,
        write_imagenet_results,
        write_voc_results,
    )

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    if args.eval_size:
        engine = engine.at_size(args.eval_size)
    class_map = read_map(args.class_map) if args.class_map else None
    names = _read_names(args.names) or [f"class{i}" for i in range(args.classes)]
    common = dict(max_images=args.max_images, flip=args.flip, class_map=class_map)
    if args.format == "voc":
        files = write_voc_results(engine, args.test_list, args.out_dir, names, **common)
        print(f"wrote {len(files)} VOC result files to {args.out_dir}")
    elif args.format == "coco":
        os.makedirs(args.out_dir, exist_ok=True)
        out = write_coco_results(engine, args.test_list,
                                 os.path.join(args.out_dir, "coco_results.json"), **common)
        print(f"wrote {out}")
    elif args.format == "imagenet":
        out = write_imagenet_results(engine, args.test_list,
                                     os.path.join(args.out_dir, "imagenet-detection.txt"), **common)
        print(f"wrote {out}")
    if args.map:
        res = voc_map(engine, args.test_list, len(names), max_images=args.max_images,
                      flip=args.flip)
        for c, ap in zip(names, res["ap"]):
            print(f"  AP {c}: {100 * ap:.2f}" if ap == ap else f"  AP {c}: n/a (no truths)")
        print(f"mAP@0.5 = {100 * res['map']:.2f}")


def cmd_weights_tool(args):
    """Weight surgery (darknet's partial/rgbgr/rescale/... utilities)."""
    from yolo_quantization_tpu_torch.models import weights_tools as wt
    from yolo_quantization_tpu_torch.models.darknet_weights import (
        load_darknet_weights,
        save_darknet_weights,
    )

    net, _ = _load_model(args)
    ckpt = load_darknet_weights(args.weights, net)
    params = ckpt.params
    if args.op == "print":
        print(wt.print_weights(net, params, args.layer))
        return
    if args.op == "stats":
        print(wt.statistics_net(net, params))
        return
    if args.op == "visualize":
        from PIL import Image

        mosaic = wt.filter_mosaic(net, params, args.layer if args.layer >= 0 else None)
        out = args.out or "filters.png"
        Image.fromarray(mosaic).save(out)
        print(f"wrote filter mosaic {mosaic.shape} to {out}")
        return
    if args.op == "mkimg":
        from PIL import Image

        out_dir = args.out or "mkimg_out"
        os.makedirs(out_dir, exist_ok=True)
        for z, im in enumerate(wt.mkimg(net, params, args.canvas, args.canvas, args.num)):
            Image.fromarray((im * 255 + 0.5).astype("uint8")).save(os.path.join(out_dir, f"gen_{z}.png"))
        print(f"wrote {args.num} generated images to {out_dir}/")
        return
    if args.op == "rgbgr":
        wt.rgbgr_net(net, params)
    elif args.op == "rescale":
        wt.rescale_net(net, params, args.scale)
    elif args.op == "denormalize":
        wt.denormalize_net(net, params)
    elif args.op == "normalize":
        net = wt.normalize_net(net, params)
        print("note: layers gained batch_normalize=1 — load the result with a BN-enabled model "
              "definition (as with darknet's normalize_net)")
    out = args.out or args.weights
    save_darknet_weights(out, net, params, seen=ckpt.seen)
    print(f"applied {args.op}, wrote {out}")


def _dets_arrays(dets):
    boxes = np.array([d.box for d in dets]) if dets else np.zeros((0, 4))
    objs = np.array([d.objectness for d in dets]) if dets else np.zeros(0)
    cls = np.array([d.class_probs for d in dets]) if dets else np.zeros((0, 0))
    return boxes, objs, cls


def cmd_demo(args):
    """Streaming demo (darknet's OpenCV video demo, without a display):
    continuous batching through the Server.  ``--frames`` is a directory of
    images (annotated frames written to --out-dir) or a video file
    (annotated video written to --out-video)."""
    import glob

    from yolo_quantization_tpu_torch.data.image import load_image_rgb
    from yolo_quantization_tpu_torch.infer.serving import Server

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    server = Server(engine, batch_size=args.batch_size, max_delay_ms=10)
    names = _read_names(args.names)
    t0 = time.time()
    try:
        if os.path.isfile(args.frames):
            from yolo_quantization_tpu_torch.data.video import VideoWriter, read_video

            frames_it, fps, size_wh = read_video(args.frames)
            out_path = args.out_video or os.path.splitext(args.frames)[0] + "_det.mp4"
            writer = VideoWriter(out_path, fps, size_wh)
            pending = []  # (frame, future), drained in order to keep the frame order
            n = 0
            for im in frames_it:
                pending.append((im, server.submit(im, thresh=args.thresh)))
                if len(pending) >= 4 * args.batch_size:
                    im0, fut = pending.pop(0)
                    bb, oo, cc = _dets_arrays(fut.result(timeout=600))
                    writer.write(_annotate(im0, bb, oo, 0.0, cls=cc, names=names))
                    n += 1
            for im0, fut in pending:
                bb, oo, cc = _dets_arrays(fut.result(timeout=600))
                writer.write(_annotate(im0, bb, oo, 0.0, cls=cc, names=names))
                n += 1
            writer.close()
            where = f"annotated video {out_path}"
        else:
            frames = sorted(f for pat in ("*.jpg", "*.jpeg", "*.png")
                            for f in glob.glob(os.path.join(args.frames, pat)))
            if not frames:
                raise SystemExit(f"no frames found in {args.frames}")
            os.makedirs(args.out_dir, exist_ok=True)
            images = [load_image_rgb(f) for f in frames]
            futures = [server.submit(im, thresh=args.thresh) for im in images]
            for f, im, fut in zip(frames, images, futures):
                boxes, objs, cc = _dets_arrays(fut.result(timeout=600))
                _draw(im, boxes, objs, 0.0, os.path.join(args.out_dir, os.path.basename(f)),
                      cls=cc, names=names)
            n = len(frames)
            where = f"annotated frames in {args.out_dir}"
    finally:
        server.close()
    dt = time.time() - t0
    stats = server.stats
    print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps), {stats['batches']} batches, avg fill "
          f"{stats['batch_fill_sum'] / max(stats['batches'], 1):.2f}; {where}")


def cmd_bench(args):
    bench_tool.run_args(args)


def build_parser():
    p = argparse.ArgumentParser(prog="yolo_quantization_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, weights=True):
        sp.add_argument("--cfg", help="darknet cfg file")
        sp.add_argument("--model", default="yolov3-tiny", help="zoo model name")
        sp.add_argument("--size", type=int, default=416)
        sp.add_argument("--classes", type=int, default=5)
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the default; fails without a GPU) or cpu")
        if weights:
            sp.add_argument("--weights", help="darknet .weights file")
            sp.add_argument("--ckpt", help="checkpoint directory (train/checkpoint.py)")
            sp.add_argument("--float", action="store_true",
                            help="force float inference (close_quantization)")
            sp.add_argument("--program", help="pre-converted integer program (.npz)")
            sp.add_argument("--int16", action="store_true",
                            help="run conv contractions with 16-bit operands "
                                 "(bit-identical outputs)")
            sp.add_argument("--exact-leaky", action="store_true",
                            help="C byte-parity mode: double-rounded quantized leaky "
                                 "instead of the QAT-matched single round")
            sp.add_argument("--dynamic-input", action="store_true",
                            help="re-quantize the input per image at runtime "
                                 "(darknet's per-image preprocessing)")

    sp = sub.add_parser("train", help="QAT training")
    common(sp, weights=False)
    sp.add_argument("--train-list", required=True)
    sp.add_argument("--backup-dir", default="backup", help="checkpoint directory")
    sp.add_argument("--batch-size", type=int)
    sp.add_argument("--max-batches", type=int)
    sp.add_argument("--workers", type=int, default=8)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--quant-start", type=int, help="override start_quantization_step")
    sp.add_argument("--multiscale", action="store_true",
                    help="random input resolution in {320..608} every 10 batches")
    sp.add_argument("--data-parallel", action="store_true",
                    help="data-parallel training (DDP) over the ranks torchrun starts, one per "
                         "device")
    sp.add_argument("--fsdp", action="store_true",
                    help="data-parallel training with params and optimizer state sharded (FSDP2)")
    sp.add_argument("--freeze-ranges-after", type=int, default=None,
                    help="freeze the EMA activation ranges N QAT steps after quant_start")
    sp.add_argument("--prune", action="store_true",
                    help="magnitude pruning each update (darknet's PRUNE build flag)")
    sp.add_argument("--prune-threshold", type=float, default=0.001)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("detect", help="single-image quantized inference")
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--thresh", type=float, default=0.5)
    sp.add_argument("--nms", type=float, default=0.45)
    sp.add_argument("--names", help="class names file")
    sp.add_argument("--out", help="write annotated image here")
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("f1", help="F1 sweep eval (darknet's detector f1)")
    common(sp)
    sp.add_argument("--test-list", required=True)
    sp.add_argument("--max-images", type=int)
    sp.add_argument("--out", help="append results file (test_quant.txt style)")
    sp.add_argument("--eval-size", type=int,
                    help="evaluate at a non-native resolution (multiple of 32; "
                         "darknet's resize_network)")
    sp.set_defaults(fn=cmd_f1)

    sp = sub.add_parser("export", help="checkpoint directory -> darknet .weights")
    common(sp, weights=False)
    sp.add_argument("--ckpt", required=True, help="checkpoint directory (train/checkpoint.py)")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("export-program", help="build a deployable integer program (.npz)")
    common(sp)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export_program)

    sp = sub.add_parser("recall", help="recall/IoU eval (darknet's detector recall)")
    common(sp)
    sp.add_argument("--test-list", required=True)
    sp.add_argument("--thresh", type=float, default=0.25)
    sp.add_argument("--iou", type=float, default=0.5)
    sp.add_argument("--max-images", type=int)
    sp.set_defaults(fn=cmd_recall)

    sp = sub.add_parser("valid", help="VOC/COCO/ImageNet result writers + mAP")
    common(sp)
    sp.add_argument("--test-list", required=True)
    sp.add_argument("--out-dir", default="results")
    sp.add_argument("--format", choices=("voc", "coco", "imagenet", "none"), default="voc")
    sp.add_argument("--names", help="class names file")
    sp.add_argument("--map", action="store_true", help="also compute mAP@0.5")
    sp.add_argument("--flip", action="store_true",
                    help="horizontal-flip TTA (darknet's `detector valid2`)")
    sp.add_argument("--class-map", help="class index map file (darknet .data `map=`)")
    sp.add_argument("--max-images", type=int)
    sp.add_argument("--eval-size", type=int,
                    help="evaluate at a non-native resolution (multiple of 32)")
    sp.set_defaults(fn=cmd_valid)

    sp = sub.add_parser(
        "weights-tool",
        help="weight surgery (print/stats/rgbgr/rescale/normalize/denormalize/visualize/mkimg)")
    common(sp, weights=False)
    sp.add_argument("--weights", required=True)
    sp.add_argument("--op", required=True,
                    choices=("print", "stats", "rgbgr", "rescale", "normalize", "denormalize",
                             "visualize", "mkimg"))
    sp.add_argument("--layer", type=int, default=0,
                    help="conv layer index (visualize: -1 = first conv)")
    sp.add_argument("--scale", type=float, default=1.0)
    sp.add_argument("--num", type=int, default=4, help="mkimg: images to generate")
    sp.add_argument("--canvas", type=int, default=256, help="mkimg: canvas size")
    sp.add_argument("--out", help="output path (weights file / png / mkimg dir)")
    sp.set_defaults(fn=cmd_weights_tool)

    sp = sub.add_parser("demo", help="streaming demo over a frames directory or a video file")
    common(sp)
    sp.add_argument("--frames", required=True,
                    help="directory of jpg/png frames, or a video file (mp4/avi)")
    sp.add_argument("--out-dir", default="demo_out")
    sp.add_argument("--out-video", default=None,
                    help="output path for video mode (default <input>_det.mp4)")
    sp.add_argument("--thresh", type=float, default=0.5)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--names", help="class names file for box labels")
    sp.set_defaults(fn=cmd_demo)

    sp = sub.add_parser("bench", help="the GPU benchmark: images/s, int8 utilization, batch-1 latency "
                                      "(tools/bench.py)")
    bench_tool.add_arguments(sp)
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
