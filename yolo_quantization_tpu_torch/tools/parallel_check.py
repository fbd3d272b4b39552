"""The parallel package on one card: data parallelism and tensor
parallelism held against the single-device trainer and engine.

    python -m yolo_quantization_tpu_torch.tools.parallel_check

- ``data_parallel_world1``: a process group of one rank (NCCL on the card):
  the ``Trainer`` with DDP and with FSDP2 against the plain ``Trainer``,
  yolov3-tiny at 416, batch 16, two float and four EMA-QAT steps, params
  and ranges bit for bit; ms per step of each; an FSDP2 checkpoint written
  whole and read back through the command line's ``export``.
- ``data_parallel_two_ranks``: two processes on the one card over gloo
  (NCCL takes one rank per device), 8 rows each, against the single
  process on the 16: two float steps and one EMA-QAT step from the same
  params: the float steps' losses within rel 2e-4 (``tests/test_fsdp.py``'s
  bound) and each param tensor within 1e-3 of its update or twice what one
  process moves it by on its rows in reverse order, whichever is larger
  (gradients summed in another order; a BN shift's gradient is a sum that
  cancels, so its relative error is large).  The QAT step's loss moves with the order the global
  batch's statistics add in, which one process shows by itself: on its
  rows in reverse order.  So the step is held to rel 2e-4 or twice that
  reversed-order difference, whichever is larger, and at most twice as
  many params and ranges beyond rtol 2e-3, atol 5e-4 as the reversed
  order gives.  DDP, then FSDP2 where gloo carries its collectives on CUDA
  tensors.  A correctness run: its step times are not
  speed figures.
- ``tensor_parallel``: K1 on 2 and 4 channel slices of yolov3-tiny (416, 5
  classes) and yolov3 (416, 80 classes), the slices concatenated, against
  ``Engine`` at every layer, bit for bit; K1's time on one slice against
  the whole conv; ``make_tp_engine`` on the one-rank group against
  ``Engine.predict``, its K1 launches counted.

Run alone it makes its own one-rank group; ``chip_smoke.py`` runs it as
phase 16.  The two-rank workers are this module run with ``--worker``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# float steps: each tensor's difference within 1e-3 of its update (the
# change from the initial params), gradients summing in another order
UPDATE_RTOL = 1e-3
QAT_TOL = dict(rtol=2e-3, atol=5e-4)
LOSS_REL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def _batch(size: int, batch: int, classes: int = 5, seed: int = 6):
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch

    return synthetic_batch(np.random.default_rng(seed), batch, size, classes)


def _snapshot(state):
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy

    return params_to_numpy(state.params), quant_state_to_numpy(state.quant_state)


def _differ(a, b, tol=None, init=None, own=None) -> list[str]:
    """Names of the params and ranges of two snapshots that differ: bit for
    bit, or beyond ``tol``; or, with ``init`` (the snapshot both started
    from) and ``own`` (``b``'s process on its rows in reverse order), by
    more than ``UPDATE_RTOL`` of the tensor's largest update in ``b`` and
    more than twice ``own``'s largest difference from ``b``."""
    out = []
    for j, (part_a, part_b) in enumerate(zip(a, b)):
        for i, p in part_a.items():
            for k, v in p.items():
                w = part_b[i][k]
                if init is not None:
                    step = np.max(np.abs(w - init[j][i][k]), initial=0.0)
                    noise = np.max(np.abs(own[j][i][k] - w), initial=0.0)
                    same = np.max(np.abs(v - w), initial=0.0) <= max(UPDATE_RTOL * step, 2 * noise) + 1e-7
                else:
                    same = np.array_equal(v, w) if tol is None else np.allclose(v, w, **tol)
                if not same:
                    out.append(f"{i}/{k}")
    return out


def _steps(trainer, x, t, n: int) -> tuple[list[float], float]:
    """n steps: (losses, ms per step)."""
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = [trainer.step(x, t)["loss"] for _ in range(n)]
    sync()
    return [float(v) for v in losses], (time.perf_counter() - t0) * 1e3 / n


def data_parallel_world1(mesh, card: str, size: int = 416, batch: int = 16, device="cuda") -> dict:
    from yolo_quantization_tpu_torch.cli.main import main as cli
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.models.darknet_weights import load_darknet_weights
    from yolo_quantization_tpu_torch.train import checkpoint as ck
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    net = zoo.yolov3_tiny(classes=5, width=size, height=size)
    images, truths = _batch(size, batch)
    x, t = torch.from_numpy(images).to(device), torch.from_numpy(truths).to(device)
    cfg = TrainConfig(burn_in=0, quant_start_step=2, batch_size=batch)
    runs, snaps = {}, {}
    for kind in ("plain", "ddp", "fsdp"):
        tr = Trainer(net, cfg, seed=0, device=device, mesh=None if kind == "plain" else mesh,
                     fsdp=kind == "fsdp")
        runs[kind] = (tr, _steps(tr, x, t, 6)[0])
        snaps[kind] = _snapshot(tr.state)
    for kind in ("ddp", "fsdp"):
        bad = _differ(snaps[kind], snaps["plain"])
        if runs[kind][1] != runs["plain"][1] or bad:
            raise AssertionError(f"{kind} on one rank: losses {runs[kind][1]} vs {runs['plain'][1]}, "
                                 f"params or ranges differing at {bad[:6]}")
    log(f"  DDP and FSDP2 on a one-rank {torch.distributed.get_backend(mesh.get_group('data'))} group: "
        f"2 float + 4 EMA-QAT steps of yolov3-tiny {size} batch {batch} equal to the plain Trainer bit "
        f"for bit (losses {runs['plain'][1]})")
    with tempfile.TemporaryDirectory() as d:
        fs = runs["fsdp"][0]
        ck.save_checkpoint(os.path.join(d, "ckpt"), fs.state)
        cli(["export", "--model", "yolov3-tiny", "--classes", "5", "--size", str(size), "--device",
             str(device), "--ckpt", os.path.join(d, "ckpt"), "--out", os.path.join(d, "w.weights")])
        loaded = load_darknet_weights(os.path.join(d, "w.weights"), net)
        bad = [f"{i}/{k}" for i, p in snaps["fsdp"][0].items() for k, v in p.items()
               if not np.array_equal(loaded.params[i][k], v)]
        if bad or loaded.seen != fs.state.seen:
            raise AssertionError(f"FSDP checkpoint -> export: params differ at {bad[:6]}")
    log("  the FSDP2 checkpoint (written whole by rank 0) exports to .weights holding the same params")
    times = {}
    for kind in ("plain", "ddp", "fsdp", "plain"):
        tr = Trainer(net, TrainConfig(burn_in=0, quant_start_step=0, batch_size=batch), seed=0,
                     device=device, mesh=None if kind == "plain" else mesh, fsdp=kind == "fsdp")
        _steps(tr, x, t, 2)
        times.setdefault(kind, []).append(_steps(tr, x, t, 5)[1])
    for kind, ms in times.items():
        log(f"  EMA-QAT step, yolov3-tiny {size} batch {batch}, {kind} (one rank): "
            f"{', '.join(f'{v:.3f}' for v in ms)} ms/step [{card}]")
    return {k: float(np.mean(v)) for k, v in times.items()}


RUNS = (("float", 100, 2), ("qat", 0, 1))  # (name, quant_start_step, steps)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(module: str, n: int, argv, timeout: float) -> tuple[int, str]:
    """``n`` worker processes ``python -m module *argv(port, rank)``, the
    repo on their path and ``port`` a free localhost port for their group:
    (the exit code of largest magnitude, the last of each worker's output)."""
    port = _free_port()
    env = {**os.environ, "PYTHONFAULTHANDLER": "1", "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
         os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv(port, r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    return max(codes, key=abs), "\n".join(f"rank {r} (exit {c}): {log[-1500:]}" for r, (c, log) in
                                           enumerate(zip(codes, logs)))


def data_parallel_two_ranks(card: str, size: int = 416, batch: int = 16, device="cuda:0",
                            timeout: float = 600.0) -> dict:
    """Two gloo ranks on ``device``, batch // 2 rows each, against one
    process on the whole batch: DDP, then FSDP2 in a pair of its own (gloo
    may not carry its collectives on CUDA tensors; then it is reported and
    ``tests/test_torch_distributed.py`` holds FSDP2 on two CPU ranks).
    Returns {run: {"ms": rank 0's ms per step} or {"error": ...}}."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    net = zoo.yolov3_tiny(classes=5, width=size, height=size)
    images, truths = _batch(size, batch)
    report = {}
    with tempfile.TemporaryDirectory() as d:
        for kind in ("ddp", "fsdp"):
            code, tail = launch_ranks(
                "yolo_quantization_tpu_torch.tools.parallel_check", 2,
                lambda port, r: ["--worker", kind, str(port), str(r), d, str(size), str(batch), str(device)],
                timeout)
            if code != 0:
                if kind == "ddp":
                    raise AssertionError(f"two-rank DDP workers failed:\n{tail}")
                why = [ln.strip() for ln in tail.splitlines() if "Fatal Python error" in ln or "Error" in ln]
                why = (why or tail.strip().splitlines()[-1:])[0][:300]
                report.update({f"fsdp-{name}": {"error": f"workers exited {code}: {why}"} for name, _, _ in RUNS})
                continue
            with open(os.path.join(d, f"{kind}.json")) as f:
                report.update(json.load(f))

        def single(order):
            tr = Trainer(net, TrainConfig(burn_in=0, quant_start_step=qs, batch_size=batch), seed=0,
                         device=device)
            init = _snapshot(tr.state)
            losses = _steps(tr, torch.from_numpy(images[order]).to(device),
                            torch.from_numpy(truths[order]).to(device), steps)[0]
            return losses, _snapshot(tr.state), init

        for name, qs, steps in RUNS:
            want_losses, want, init = single(np.arange(batch))
            loss_rel = LOSS_REL
            tol = (f"{UPDATE_RTOL} of each tensor's update or twice the reversed rows' difference"
                   if name == "float" else QAT_TOL)
            # one process on the same rows in reverse order: the BN
            # statistics and gradients add in another order, as they do over
            # two ranks.  A QAT step's loss moves with that order (an ulp
            # moves a fake-quant code); the ranks may move it as far again
            rev_losses, rev, _ = single(np.arange(batch)[::-1].copy())
            own = max(abs(a - b) / abs(b) for a, b in zip(rev_losses, want_losses))
            if name == "qat":
                loss_rel = max(LOSS_REL, 2 * own)
                bad_rev = _differ(rev, want, tol)
                log(f"  one process, its rows reversed, one EMA-QAT step: loss rel {own:.2e}; params or "
                    f"ranges beyond {tol}: {len(bad_rev)} tensors")
            for kind in ("ddp", "fsdp"):
                key = f"{kind}-{name}"
                if "error" in report[key]:
                    log(f"  two gloo ranks on one card, {key}: not run: {report[key]['error']}")
                    continue
                z = np.load(os.path.join(d, f"{key}.npz"))
                got = ({int(k[1:].split(".")[0]): {} for k in z.files if k.startswith("p")}, {})
                for k in z.files:
                    if k.startswith("p"):
                        i, n = k[1:].split(".")
                        got[0][int(i)][n] = z[k]
                    elif k.startswith("q"):
                        i, n = k[1:].split(".")
                        got[1].setdefault(i, {})[n] = z[k]
                rel = max(abs(a - b) / abs(b) for a, b in zip(z["losses"], want_losses))
                bad = _differ(got, want, init=init, own=rev) if name == "float" else _differ(got, want, tol)
                if rel > loss_rel or (name == "float" and bad) or (name == "qat" and len(bad) > 2 * len(bad_rev)):
                    raise AssertionError(f"two gloo ranks, {key}: loss rel {rel:.3e} (bound {loss_rel:.3e}), "
                                         f"params or ranges beyond {tol} at {bad[:6]} ({len(bad)} tensors)")
                log(f"  two gloo ranks on one card, {key} ({steps} step{'s' * (steps > 1)}, 2 x {batch // 2} "
                    f"rows): loss rel {rel:.2e} of one process on {batch} (bound {loss_rel:.2e}); params or "
                    f"ranges beyond {tol}: {len(bad)} tensors; {report[key]['ms']:.3f} ms/step (correctness "
                    f"run, not a speed figure) [{card}]")
    return report


def worker(kind: str, port: int, rank: int, outdir: str, size: int, batch: int, device: str) -> None:
    """One of the two gloo ranks of ``data_parallel_two_ranks``, training
    with ``kind`` (ddp or fsdp)."""
    import torch.distributed as dist

    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.parallel import distributed, mesh as pmesh
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    mesh = distributed.global_mesh(device=device)
    net = zoo.yolov3_tiny(classes=5, width=size, height=size)
    images, truths = _batch(size, batch)
    x, t = pmesh.shard_batch(mesh.get_group("data"), torch.from_numpy(images).to(device),
                             torch.from_numpy(truths).to(device))
    report = {}
    for name, qs, steps in RUNS:
        cfg = TrainConfig(burn_in=0, quant_start_step=qs, batch_size=batch)
        tr = Trainer(net, cfg, seed=0, device=device, mesh=mesh, fsdp=kind == "fsdp")
        losses, ms = _steps(tr, x, t, steps)
        params, ranges = _snapshot(tr.state)
        report[f"{kind}-{name}"] = {"ms": ms}
        if rank == 0:
            np.savez(os.path.join(outdir, f"{kind}-{name}.npz"), losses=np.asarray(losses),
                     **{f"p{i}.{k}": v for i, p in params.items() for k, v in p.items()},
                     **{f"q{k}.{n}": v for k, st in ranges.items() for n, v in st.items()})
    if rank == 0:
        with open(os.path.join(outdir, f"{kind}.json"), "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


def _slice_times(card: str, device="cuda") -> dict:
    """K1 on one channel slice of each of yolov3-tiny's 13 convs at batch
    16 (graph-timed), 2 and 4 ways, against the whole conv."""
    from yolo_quantization_tpu_torch.ops import cuda_qconv
    from yolo_quantization_tpu_torch.tools.kernel_timings import flagship_layers, graph_time_ms, random_layer

    rng = np.random.default_rng(9)
    totals = {1: 0.0, 2: 0.0, 4: 0.0}
    for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
        x, wt, bias, m = random_layer(rng, 16, h, w, ci, co, k)
        xt = torch.from_numpy(x).to(device)
        row = []
        for ways in (1, 2, 4):
            if co % ways:  # the 30-channel heads run whole under TP
                ways_co = co
            else:
                ways_co = co // ways
            wt_t = torch.from_numpy(np.ascontiguousarray(wt[..., :ways_co])).to(device)
            b_t = torch.from_numpy(bias[:ways_co]).to(device)
            m_t = torch.from_numpy(m[:ways_co]).to(device)
            wp = cuda_qconv.pack_weights(wt_t)
            ms = graph_time_ms(lambda: cuda_qconv.quantized_conv2d_cuda(
                xt, wt_t, b_t, m_t, 3, pad=pad, act=act, out_zp_static=0, fuse_pool=fused, out_i8=True,
                w_packed=wp))
            totals[ways] += ms
            row.append(f"{ways_co} ch {ms:.4f} ms")
        log(f"    layer {i:2d} {h}x{w}x{ci}->{co}: " + ", ".join(row))
    log(f"  K1 per slice over the 13 convs at batch 16: whole {totals[1]:.4f} ms, 1/2 {totals[2]:.4f} ms, "
        f"1/4 {totals[4]:.4f} ms (graph-timed; the 30-channel heads whole in each) [{card}]")
    return totals


def tensor_parallel(card: str, size: int = 416, batch: int = 2, device="cuda") -> int:
    """The TP checks; returns the K1 launches of ``make_tp_engine``'s
    predict, the phase's main path (every K1 launch elsewhere here is a
    comparison)."""
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.presets import flagship_program, v3_program
    from yolo_quantization_tpu_torch.ops import cuda_qconv
    from yolo_quantization_tpu_torch.parallel import tp

    x = np.random.default_rng(4).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    flagship = flagship_program(classes=5, size=size)
    for name, program in (("yolov3-tiny", flagship), ("yolov3", v3_program(classes=80, size=size))):
        _, outs = Engine(program, device=device).raw_heads(x, return_outputs=True)
        for ways in (2, 4):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fwd = tp.tp_forward(program, ways, device, return_outputs=True)
            with torch.inference_mode():
                _, touts = fwd(xt)
            bad = [i for i, (a, b) in enumerate(zip(outs, touts)) if not np.array_equal(b.cpu().numpy(), a)]
            if bad:
                raise AssertionError(f"TP {name} {ways} ways: layers {bad[:6]} differ from Engine")
            whole = [str(w.message).split("[")[1].split("]")[0] for w in caught]
            log(f"  TP {name} {size}, {ways} slices: all {len(outs)} layer outputs equal to Engine's "
                f"(K1 on each slice{'; whole: convs ' + whole[0] if whole else ''})")
    if torch.device(device).type == "cuda":
        _slice_times(card, device)
    predict, mesh = tp.make_tp_engine(flagship, max_det=64, device=device)
    want = Engine(flagship, max_det=64, device=device).predict(x)
    cuda_qconv.launches = 0
    got = predict(x)
    launches = cuda_qconv.launches
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("make_tp_engine's predict differs from Engine.predict")
    log(f"  make_tp_engine on the {tuple(mesh.shape)} mesh: predict equal to Engine.predict; "
        f"{launches} K1 launches")
    return launches


def run(card: str, size: int = 416, device="cuda") -> dict:
    """Phase 16: one-rank DP, two gloo ranks, TP.  Returns the timings and
    the main path's K1 launches."""
    import torch.distributed as dist

    from yolo_quantization_tpu_torch.parallel import distributed

    distributed.initialize(device=device)
    try:
        mesh = distributed.global_mesh(device=device)
        t0 = time.perf_counter()
        times = data_parallel_world1(mesh, card, size, device=device)
        log(f"  one-rank DDP/FSDP2: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        two = data_parallel_two_ranks(card, size, device=f"{torch.device(device).type}:0"
                                      if torch.device(device).type == "cuda" else "cpu")
        log(f"  two gloo ranks: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = tensor_parallel(card, size, device=device)
        log(f"  TP: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    return {"times": times, "two_ranks": two, "launches": launches}


def main(argv: list[str]) -> int:
    if argv and argv[0] == "--worker":
        kind, port, rank, outdir, size, batch, device = argv[1:]
        worker(kind, int(port), int(rank), outdir, int(size), int(batch), device)
        return 0
    from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity

    if not torch.cuda.is_available():
        raise SystemExit("parallel_check: torch.cuda.is_available() is false; this needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    log(json.dumps(run(card)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
