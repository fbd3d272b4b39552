"""Training throughput: the QAT step's time on one GPU, and a data-parallel
scaling curve.

The counterpart of ``scripts/bench_train.py``:

    python -m yolo_quantization_tpu_torch.tools.bench_train chip [batch] [steps]
        [--device cuda|cpu]
    torchrun --nproc-per-node N -m yolo_quantization_tpu_torch.tools.bench_train scaling
        [--device cuda|cpu]

- ``chip``: the flagship (yolov3-tiny, 5 classes) trained at 416 on a
  seeded synthetic batch already on the device (``Trainer``): EMA-QAT from
  the first step, float32.  The first step's time (the
  kernels' first launches, cuDNN's algorithm search, allocations) apart from
  the steady state's, each ended by a device synchronize; peak device
  memory.
- ``scaling``: weak scaling (8 images a rank at 160) over
  ``parallel/distributed.py::scaling_efficiency`` on the process group
  (torchrun's, or this one process): the EMA-QAT step of the first n ranks,
  DDP over them, at n = 1, 2, 4, 8; counts above the ranks present are
  skipped and reported so.

Prints one JSON line per result.  Runs on the GPU unless ``--device cpu``
is given, and raises where there is no GPU.
"""

from __future__ import annotations

import json
import sys
import time
import warnings

import numpy as np
import torch

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device
from yolo_quantization_tpu_torch.tools.bench import card_name


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_chip(batch: int = 64, steps: int = 10, size: int = 416, device="cuda") -> dict:
    from yolo_quantization_tpu_torch.models.presets import flagship_network
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer, to_device

    dev = resolve_device(device, "bench_train")
    net = flagship_network(size=size)
    cfg = TrainConfig(batch_size=batch, quant_start_step=0)
    images, truths = synthetic_batch(np.random.default_rng(1), batch, size, classes=5)
    x, t = to_device(images, dev), to_device(truths, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(net, cfg, seed=0, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    trainer.step(x, t)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = trainer.step(x, t)
    _sync(dev)
    dt = time.perf_counter() - t0
    out = {
        "metric": "qat_train_step",
        "size": size,
        "batch": batch,
        "steps": steps,
        "step_ms": round(1e3 * dt / steps, 3),
        "images_per_sec": round(steps * batch / dt, 1),
        "first_step_s": round(first_s, 3),
        "peak_mib": (round(torch.cuda.max_memory_allocated(dev) / 2**20, 1) if dev.type == "cuda"
                     else None),
        "loss": round(float(metrics["loss"]), 4),
        "device": card_name(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def bench_scaling(size: int = 160, per_device_batch: int = 8, iters: int = 8, device="cuda",
                  counts=(1, 2, 4, 8)) -> dict:
    """Weak scaling of the EMA-QAT step over the first n ranks of the
    process group (torchrun's variables, or a group of this process)."""
    import types

    import torch.distributed as dist

    from yolo_quantization_tpu_torch.models.presets import flagship_network
    from yolo_quantization_tpu_torch.parallel import distributed
    from yolo_quantization_tpu_torch.parallel import mesh as pmesh
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, init_train_state, make_train_step, to_device

    dev = resolve_device(device, "bench_train")
    distributed.initialize(device=dev.type)
    dev = pmesh.rank_device(dev.type)
    net = flagship_network(size=size)
    cfg = TrainConfig(batch_size=per_device_batch, quant_start_step=0)
    holder: dict = {}

    def step_fn(group, batch):
        if holder.get("group") is not group:
            # the first n ranks' DDP trainer, from the same seed on each
            state = init_train_state(net, cfg, 0, dev)
            state = pmesh.replicate(types.SimpleNamespace(get_group=lambda _name: group), state)
            holder.update(group=group, state=state, step=make_train_step(net, cfg, qat=True, group=group),
                          generator=torch.Generator(device=dev).manual_seed(0))
        images, truths = pmesh.shard_batch(group, *batch)
        holder["state"], metrics = holder["step"](holder["state"], to_device(images, dev),
                                                  to_device(truths, dev), holder["generator"])
        float(metrics["loss"])

    def make_batch(n):
        return synthetic_batch(np.random.default_rng(2), n * per_device_batch, size, classes=5)

    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results = distributed.scaling_efficiency(step_fn, make_batch, list(counts), iters=iters)
        base = results.get(1)
        out = {
            "metric": "qat_train_scaling",
            "size": size,
            "per_device_batch": per_device_batch,
            "world": dist.get_world_size(),
            "images_per_sec": {str(k): round(v, 2) for k, v in results.items()},
            "weak_scaling_vs_1dev": {str(k): round(v / base, 3) for k, v in results.items()} if base else {},
            "skipped": [str(w.message) for w in caught if "skipped" in str(w.message)],
            "device": card_name(dev),
        }
        rank = dist.get_rank()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k : k + 2]
    mode = argv[0] if argv else "chip"
    if mode == "chip":
        bench_chip(int(argv[1]) if len(argv) > 1 else 64, int(argv[2]) if len(argv) > 2 else 10,
                   device=device)
    elif mode == "scaling":
        bench_scaling(device=device)
    else:
        raise SystemExit(f"bench_train: unknown mode {mode!r} (chip or scaling)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
