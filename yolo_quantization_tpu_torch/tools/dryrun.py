"""A one-GPU forward check and a multi-rank correctness dry run.

The counterpart of ``__graft_entry__.py``:

    python -m yolo_quantization_tpu_torch.tools.dryrun [n] [--backend nccl|gloo]

``entry(device="cuda")`` returns (fn, args): fn(*args) is the flagship's
integer forward (yolov3-tiny uint8, 416x416, batch 1, K1 on every conv on
the card) and returns the tuple of its heads.

``dryrun_multichip(n, backend)`` runs n ranks (a process each; a single
rank runs in this process) and holds, as the JAX dry run does:

1. a QAT train step on the global batch, one process against the n-rank
   DDP ``Trainer``: loss within 5e-3 relative, the post-step parameter
   checksum (the sum of |param|) within 1e-5 relative;
2. the same under FSDP2, with ``parallel/fsdp.py::shard_report``'s sharded
   fraction;
3. tensor-parallel integer inference (``parallel/tp.py::run_tp``, conv
   channels over min(n, 4) model ranks) bit-equal to ``Engine``'s heads.

NCCL (the default) takes one card per rank, and too few cards is an error;
gloo runs the ranks on the CPU, and only when asked for.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device

LOSS_REL = 5e-3
CHECKSUM_REL = 1e-5


def entry(device="cuda"):
    from yolo_quantization_tpu_torch.infer.engine import build_forward, device_arrays
    from yolo_quantization_tpu_torch.models.presets import flagship_program

    dev = resolve_device(device, "entry")
    program = flagship_program()
    fwd = build_forward(program)
    arrays = device_arrays(program, dev)
    x = torch.zeros((1, 416, 416, 3), dtype=torch.float32, device=dev)

    def fn(arrays, x):
        with torch.inference_mode():
            return tuple(fwd(arrays, x))

    return fn, (arrays, x)


def checksum(params) -> float:
    """Sum of |param| over every tensor (numpy), as the JAX dry run sums."""
    return float(sum(float(np.abs(v).sum(dtype=np.float64)) for p in params.values() for v in p.values()))


def _body(n: int, device) -> dict:
    """One rank's checks on the current process group; returns the numbers."""
    import torch.distributed as dist

    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.models.presets import flagship_program
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy
    from yolo_quantization_tpu_torch.parallel import distributed, fsdp
    from yolo_quantization_tpu_torch.parallel import mesh as pmesh
    from yolo_quantization_tpu_torch.parallel.tp import run_tp
    from yolo_quantization_tpu_torch.train.loss import MAX_BOXES
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    net = zoo.yolov3_tiny(classes=5, width=64, height=64)
    cfg = TrainConfig(burn_in=0, quant_start_step=0, batch_size=n)
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)
    truths = np.zeros((n, MAX_BOXES, 5), np.float32)
    truths[:, 0] = (0.5, 0.5, 0.4, 0.4, 1.0)

    # one process, the whole global batch
    one = Trainer(net, cfg, seed=0, device=device)
    loss1 = float(one.step(images, truths)["loss"])
    sum1 = checksum(params_to_numpy(one.state.params))
    if not np.isfinite(loss1):
        raise AssertionError(f"non-finite one-process loss {loss1}")

    mesh = distributed.global_mesh(device=device.type)
    rows = pmesh.shard_batch(mesh.get_group("data"), images, truths)
    out = {"loss_1": loss1, "checksum_1": sum1}
    for kind in ("dp", "fsdp"):
        tr = Trainer(net, cfg, seed=0, device=device, mesh=mesh, fsdp=kind == "fsdp")
        loss = float(tr.step(*rows)["loss"])
        total = checksum(params_to_numpy(tr.state.params))
        if abs(loss - loss1) > LOSS_REL * max(abs(loss1), 1.0):
            raise AssertionError(f"{kind} loss {loss} != one process's {loss1}")
        if abs(total - sum1) > CHECKSUM_REL * max(abs(sum1), 1.0):
            raise AssertionError(f"{kind} param checksum {total} != one process's {sum1}")
        out[f"loss_{kind}"], out[f"checksum_{kind}"] = loss, total
    out["fsdp_sharded_fraction"] = fsdp.shard_report(one.state.params, mesh["data"].size())["sharded_fraction"]

    prog = flagship_program(classes=5, size=64)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref_heads = Engine(prog, device=device).raw_heads(x)
    tp_heads, tp_mesh = run_tp(prog, x, n_model=min(n, 4), device=device.type)
    out["tp_max_abs_diff"] = max(int(np.max(np.abs(a.astype(np.int64) - b.astype(np.int64))))
                                 for a, b in zip(ref_heads, tp_heads))
    out["tp_model_ranks"] = tp_mesh["model"].size()
    if out["tp_max_abs_diff"] != 0:
        raise AssertionError(f"TP heads differ from the single-device engine by {out['tp_max_abs_diff']}")
    out["world"] = dist.get_world_size()
    return out


def _run_rank(n: int, rank: int, port: int | None, backend: str) -> dict:
    import torch.distributed as dist

    from yolo_quantization_tpu_torch.parallel import distributed
    from yolo_quantization_tpu_torch.parallel import mesh as pmesh

    kind = "cuda" if backend == "nccl" else "cpu"
    distributed.initialize(None if port is None else f"localhost:{port}", n, rank, device=kind)
    try:
        return _body(n, pmesh.rank_device(kind))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, backend: str = "nccl", timeout: float = 900.0) -> dict:
    """The three checks over ``n_devices`` ranks (module docstring); prints
    one line and returns rank 0's numbers.  Raises on any disagreement."""
    from yolo_quantization_tpu_torch.tools.parallel_check import launch_ranks

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl":
        resolve_device("cuda", "dryrun_multichip over NCCL")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) over NCCL needs {n_devices} CUDA devices, "
                               f"and {torch.cuda.device_count()} are present (gloo on the CPU runs "
                               "only when asked for: backend='gloo')")
    if n_devices == 1:
        out = _run_rank(1, 0, None, backend)
    else:
        with tempfile.TemporaryDirectory() as d:
            code, tail = launch_ranks("yolo_quantization_tpu_torch.tools.dryrun", n_devices,
                                      lambda port, r: ["--worker", str(n_devices), str(r), str(port), backend, d],
                                      timeout)
            if code:
                raise AssertionError(f"dryrun_multichip ranks failed:\n{tail}")
            with open(os.path.join(d, "rank0.json")) as f:
                out = json.load(f)
    print(f"dryrun_multichip({n_devices}) over {backend}: ok, loss 1dev={out['loss_1']:.4f} "
          f"dp={out['loss_dp']:.4f} fsdp={out['loss_fsdp']:.4f}, param_checksum "
          f"1dev={out['checksum_1']:.2f} dp={out['checksum_dp']:.2f} fsdp={out['checksum_fsdp']:.2f}, "
          f"fsdp_sharded_fraction={out['fsdp_sharded_fraction']:.3f}, tp_max_abs_diff="
          f"{out['tp_max_abs_diff']} (model axis {out['tp_model_ranks']})", flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--worker":
        n, rank, port, backend, outdir = argv[1:]
        os.environ["LOCAL_RANK"] = rank  # this rank's card under NCCL
        out = _run_rank(int(n), int(rank), int(port), backend)
        if int(rank) == 0:
            with open(os.path.join(outdir, "rank0.json"), "w") as f:
                json.dump(out, f)
        return 0
    backend = "nccl"
    if "--backend" in argv:
        k = argv.index("--backend")
        backend = argv[k + 1]
        del argv[k : k + 2]
    n = int(argv[0]) if argv else 2
    if backend == "nccl":
        fn, args = entry()
        print("entry ok:", [tuple(h.shape) for h in fn(*args)], flush=True)
    dryrun_multichip(n, backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
