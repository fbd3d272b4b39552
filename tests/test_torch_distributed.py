"""The port's parallel package over a real process group: 2 gloo ranks on
the CPU, started once for the module, against one process and the JAX
package.

- DDP and FSDP2 (``Trainer(mesh=..., fsdp=...)``): yolov3-tiny at 64x64, a
  global batch of 8 split 4 + 4, against the single-process ``Trainer`` on
  the whole batch: two float steps (loss within rel 2e-4, the bound of
  ``tests/test_fsdp.py``; params within rtol 1e-3, atol 1e-5), and one
  EMA-QAT step from the same params, as ``tests/test_fsdp.py`` takes it
  (loss rel 2e-4; params and ranges within its rtol 2e-3, atol 5e-4: the
  global batch statistics add in another order, which moves a fake-quant
  code now and then).  Later QAT steps are not compared: an ulp in one
  step's params moves the next QAT loss by 1e-3 and more, in one process
  as well.  DDP also with percentile ranges and pruning, and with learned
  ranges; FSDP2 with pruning (in place on the shards); the classifier
  trainer over DDP.  The first float step against the un-jitted JAX step on the same
  global batch (loss rel 1e-4, params rtol 1e-3 atol 1e-6, as
  ``tests/test_torch_train.py``).
- The global-batch statistics: BN mean and variance (rtol 1e-5 against
  ``batch_stats`` of the whole batch), minmax ranges and the percentile
  subsample bit for bit, dropout masks as rows of the whole batch's mask.
- An FSDP2 checkpoint written whole by rank 0 and read back by
  ``restore_checkpoint`` and ``export``.
- TP: ``run_tp`` and ``make_tp_engine`` over 2 model ranks, and over 2 data
  ranks, bit-equal to ``Engine`` and to JAX's ``make_tp_engine``.
- One ``Server`` per process, equal to a single process's.
- ``scaling_efficiency`` skips device counts above the world, saying so.
- An explicit coordinator that cannot be reached raises.

The worker is this file run as a script: ``python test_torch_distributed.py
<port> <world> <rank> <outdir>``.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
SIZE, BATCH, CLASSES = 64, 8, 2
CFG = dict(burn_in=0, learning_rate=1e-3)
FLOAT_TOL = dict(rtol=1e-3, atol=1e-5)  # gradients summed in another order: 8.4e-6 at 64x64 on the CPU
QAT_TOL = dict(rtol=2e-3, atol=5e-4)
RUNS = {  # name -> (TrainConfig overrides, steps, loss rtol, params and ranges tolerance)
    "ddp-float": (dict(quant_start_step=100), 2, 2e-4, FLOAT_TOL),
    "fsdp-float": (dict(quant_start_step=100), 2, 2e-4, FLOAT_TOL),
    "ddp": (dict(quant_start_step=0), 1, 2e-4, QAT_TOL),
    "fsdp": (dict(quant_start_step=0, prune=True), 1, 2e-4, QAT_TOL),
    # percentile ranges are order statistics of a subsample: a change in the
    # BN statistics' reduction order alone moves this step's loss by 7.1e-4
    # in one process (the mean and variance as two sums in place of
    # torch.mean / torch.var), and the head ranges downstream by 0.4%
    "ddp-percentile": (dict(quant_start_step=0, range_stat="percentile", prune=True), 1, 2e-3,
                       dict(rtol=1e-2, atol=5e-4)),
    "ddp-learned": (dict(quant_start_step=0, learned_ranges=True, range_warmup=0), 1, 2e-4, QAT_TOL),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def global_batch():
    from yolo_quantization_tpu_torch.train.loss import MAX_BOXES

    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    truths = np.zeros((BATCH, MAX_BOXES, 5), np.float32)
    truths[:, 0] = (0.5, 0.5, 0.4, 0.4, 0.0)
    truths[::2, 1] = (0.2, 0.3, 0.1, 0.15, 1.0)
    return images, truths


def train_config(name):
    from yolo_quantization_tpu_torch.train.qat import TrainConfig

    return TrainConfig(**CFG, **RUNS[name][0])


def net():
    from yolo_quantization_tpu_torch.models import zoo

    return zoo.yolov3_tiny(classes=CLASSES, width=SIZE, height=SIZE)


def serve_frames(frames):
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.serving import Server
    from yolo_quantization_tpu_torch.models.presets import flagship_program

    server = Server(Engine(flagship_program(classes=3, size=96), max_det=32, device="cpu"),
                    batch_size=(1, 4), max_delay_ms=5.0)
    try:
        futs = [server.submit(im, thresh=0.05) for im in frames]
        return [[[*map(float, d.box), float(d.objectness), int(d.class_probs.argmax())]
                 for d in f.result(timeout=300)] for f in futs]
    finally:
        server.close()


def frames():
    rng = np.random.default_rng(99)
    return [rng.uniform(0, 1, (128, 160, 3)).astype(np.float32) for _ in range(6)]


def classifier_net():
    from yolo_quantization_tpu_torch.nn import graph as G

    return G.NetworkDef(specs=(G.ConvSpec(filters=8, quantized=False), G.MaxPoolSpec(2, 2),
                               G.ConvSpec(filters=16, quantized=False), G.AvgPoolSpec(),
                               G.ConnectedSpec(outputs=3, activation="linear"), G.SoftmaxSpec()),
                        width=32, height=32)


def classifier_batch():
    rng = np.random.default_rng(9)
    return rng.uniform(0, 1, (BATCH, 32, 32, 3)).astype(np.float32), rng.integers(0, 3, BATCH)


def tp_images():
    return np.random.default_rng(5).uniform(0, 1, (4, 96, 96, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# The worker (one per rank)
# ---------------------------------------------------------------------------


def worker(port: int, world: int, rank: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from yolo_quantization_tpu_torch.models.presets import flagship_program
    from yolo_quantization_tpu_torch.nn import layers as L
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy
    from yolo_quantization_tpu_torch.parallel import distributed, mesh as pmesh, tp
    from yolo_quantization_tpu_torch.train import checkpoint
    from yolo_quantization_tpu_torch.train.qat import Trainer

    torch.set_num_threads(2)
    distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    mesh = distributed.global_mesh(device="cpu")
    group = mesh.get_group("data")
    out = {}
    images, truths = global_batch()

    # the global-batch statistics
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((BATCH, 5, 7, 6)).astype(np.float32))
    xl = pmesh.shard_batch(group, x)
    mean, var = pmesh.batch_stats(xl, group)
    gmean, gvar = L.batch_stats(x)
    lo, hi = pmesh.batch_minmax(xl, group)
    big = torch.from_numpy(rng.standard_normal(world * 3 * 50_000).astype(np.float32))
    sample = pmesh.strided_sample(pmesh.shard_batch(group, big), group)
    uneven = pmesh.strided_sample(big[: 70_001] if rank == 0 else big[70_001: 140_000], group)
    gen = torch.Generator().manual_seed(11)
    drop = L.dropout(torch.ones(BATCH // world, 3, 3, 2), 0.5, gen, pmesh.rank_world(group))
    out["stats"] = dict(
        mean=bool(np.allclose(mean.numpy(), gmean.numpy(), rtol=1e-5, atol=1e-7)),
        var=bool(np.allclose(var.numpy(), gvar.numpy(), rtol=1e-5, atol=1e-7)),
        minmax=bool(float(lo) == float(x.min()) and float(hi) == float(x.max())),
        percentile=bool(torch.equal(sample, big[:: len(big) // 65536])),
        uneven=bool(torch.equal(uneven, big[:140_000][:: 140_000 // 65536])),
        dropout=bool(torch.equal(drop, L.dropout(torch.ones(BATCH, 3, 3, 2), 0.5,
                                                 torch.Generator().manual_seed(11))
                                 [pmesh.shard_batch(group, torch.arange(BATCH))])))

    # DDP and FSDP2 training
    for name, (_, steps, _, _) in RUNS.items():
        trainer = Trainer(net(), train_config(name), seed=0, device="cpu", mesh=mesh,
                          fsdp=name.startswith("fsdp"))
        losses = []
        for s in range(steps):
            im, tr = pmesh.shard_batch(group, images, truths)
            losses.append(float(trainer.step(im, tr)["loss"]))
            if s == 0 and name == "ddp-float":
                first = params_to_numpy(trainer.state.params)
        params = params_to_numpy(trainer.state.params)
        if name == "fsdp":
            w = trainer.state.params[10]["w"]
            out["fsdp_shard"] = [list(w.to_local().shape), list(w.shape), str(w.placements)]
            checkpoint.save_checkpoint(os.path.join(outdir, "ckpt"), trainer.state)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{name}.npz"), losses=np.asarray(losses),
                     **{f"p{i}.{k}": v for i, p in params.items() for k, v in p.items()},
                     **{f"q{k}.{n}": v for k, st in quant_state_to_numpy(trainer.state.quant_state).items()
                        for n, v in st.items()},
                     **({f"f{i}.{k}": v for i, p in first.items() for k, v in p.items()}
                        if name == "ddp-float" else {}))
        out[f"{name}_seen"] = int(trainer.state.seen)

    # the classifier trainer takes the same mesh (DDP)
    from yolo_quantization_tpu_torch.train.classify import ClassifierTrainer

    cimages, clabels = classifier_batch()
    ct = ClassifierTrainer(classifier_net(), lr=0.05, device="cpu", mesh=mesh)
    closses = [float(ct.step(*pmesh.shard_batch(group, cimages, clabels))["loss"]) for _ in range(2)]
    if rank == 0:
        np.savez(os.path.join(outdir, "classifier.npz"), losses=np.asarray(closses),
                 **{f"p{i}.{k}": v for i, p in params_to_numpy(ct.params).items() for k, v in p.items()})

    # tensor parallelism: 2 model ranks, then 2 data ranks
    program = flagship_program(classes=3, size=96)
    heads, tp_mesh = tp.run_tp(program, tp_images(), n_model=world, device="cpu")
    predict, _ = tp.make_tp_engine(program, n_model=world, n_data=1, max_det=64, device="cpu")
    dp_predict, dp_mesh = tp.make_tp_engine(program, n_model=1, n_data=world, max_det=64, device="cpu")
    dets, dp_dets = predict(tp_images()), dp_predict(tp_images())
    if rank == 0:
        np.savez(os.path.join(outdir, "tp.npz"), **{f"h{i}": h for i, h in enumerate(heads)},
                 **{f"m{i}": v for i, v in enumerate(dets)}, **{f"d{i}": v for i, v in enumerate(dp_dets)})
    out["tp_mesh"] = [list(tp_mesh.shape), list(dp_mesh.shape)]
    out["served"] = serve_frames(frames())
    out["world"] = dist.get_world_size()

    def step_fn(g, batch):
        dist.all_reduce(batch[0].clone(), group=g)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scaling = distributed.scaling_efficiency(step_fn, lambda n: (torch.ones(4 * n, 3),), [1, 2, 4], iters=2)
    out["scaling"] = [sorted(scaling), [str(w.message) for w in caught if "scaling" in str(w.message)]]
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(WORLD), str(r), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    results = [json.load(open(out / f"rank{r}.json")) for r in range(WORLD)]
    return out, results


def load(path, prefix):
    z = np.load(path)
    out = {}
    for key in z.files:
        if key.startswith(prefix) and key != "losses":
            i, k = key[len(prefix):].split(".")
            out.setdefault(int(i) if prefix != "q" else i, {})[k] = z[key]
    return out


@pytest.fixture(scope="module")
def single():
    """The single-process Trainer on the whole global batch, per run."""
    import torch

    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy
    from yolo_quantization_tpu_torch.train.qat import Trainer

    torch.set_num_threads(2)
    images, truths = global_batch()
    out = {}
    for name, (_, steps, _, _) in RUNS.items():
        if name == "fsdp-float":
            continue
        trainer = Trainer(net(), train_config(name), seed=0, device="cpu")
        losses = [float(trainer.step(images, truths)["loss"]) for _ in range(steps)]
        out[name] = (losses, params_to_numpy(trainer.state.params),
                     quant_state_to_numpy(trainer.state.quant_state))
    out["fsdp-float"] = out["ddp-float"]
    return out


def test_global_batch_statistics(ranks):
    for r in ranks[1]:
        assert r["world"] == WORLD
        assert r["stats"] == dict(mean=True, var=True, minmax=True, percentile=True, uneven=True,
                                  dropout=True), r["stats"]


@pytest.mark.parametrize("name", list(RUNS))
def test_data_parallel_matches_one_process(ranks, single, name):
    out, results = ranks
    z = np.load(out / f"{name}.npz")
    losses, params, qs = single[name]
    _, steps, loss_rel, tol = RUNS[name]
    np.testing.assert_allclose(z["losses"], losses, rtol=loss_rel)
    got = load(out / f"{name}.npz", "p")
    for i, p in params.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[i][k], v, **tol, err_msg=f"{name} params[{i}][{k}]")
    gq = load(out / f"{name}.npz", "q")
    for k, st in qs.items():
        for n, v in st.items():
            np.testing.assert_allclose(gq[k][n], v, **tol, err_msg=f"{name} {k}.{n}")
    assert all(r[f"{name}_seen"] == BATCH * steps for r in results)


def test_classifier_trainer_is_data_parallel(ranks):
    """``ClassifierTrainer(mesh=...)`` reuses the detector's DDP path: two
    steps over 2 ranks equal one process on the whole batch (loss rel 2e-4,
    params as the float runs)."""
    import torch

    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy
    from yolo_quantization_tpu_torch.train.classify import ClassifierTrainer

    torch.set_num_threads(2)
    out, _ = ranks
    z = np.load(out / "classifier.npz")
    ct = ClassifierTrainer(classifier_net(), lr=0.05, device="cpu")
    losses = [float(ct.step(*classifier_batch())["loss"]) for _ in range(2)]
    np.testing.assert_allclose(z["losses"], losses, rtol=2e-4)
    got = load(out / "classifier.npz", "p")
    for i, p in params_to_numpy(ct.params).items():
        for k, v in p.items():
            np.testing.assert_allclose(got[i][k], v, **FLOAT_TOL, err_msg=f"params[{i}][{k}]")


def test_fsdp_shards_and_checkpoint_reads_whole(ranks, tmp_path):
    """The 256 -> 512 conv's kernel stays sharded on its output channels
    after the steps; rank 0's checkpoint holds the whole params, and
    ``restore_checkpoint`` and ``export`` read it as any other."""
    from yolo_quantization_tpu_torch.cli.main import main
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy
    from yolo_quantization_tpu_torch.train.checkpoint import restore_checkpoint
    from yolo_quantization_tpu_torch.train.qat import init_train_state

    out, results = ranks
    local, whole, placements = results[0]["fsdp_shard"]
    assert local == whole[:3] + [whole[3] // WORLD] and "Shard(dim=3)" in placements
    state = restore_checkpoint(str(out / "ckpt"), init_train_state(net(), train_config("fsdp"), device="cpu"))
    assert state.step == 1 and state.seen == BATCH
    got = load(out / "fsdp.npz", "p")
    for i, p in params_to_numpy(state.params).items():
        for k, v in p.items():
            np.testing.assert_array_equal(v, got[i][k], err_msg=f"params[{i}][{k}]")
    assert len(state.opt_state.state) == len(list(state.params.parameters()))
    weights = str(tmp_path / "fsdp.weights")
    main(["export", "--model", "yolov3-tiny", "--classes", str(CLASSES), "--size", str(SIZE),
          "--device", "cpu", "--ckpt", str(out / "ckpt"), "--out", weights])
    assert os.path.getsize(weights) > 0


def test_first_step_matches_jax(ranks):
    """DDP's first (float) step over 2 ranks against the un-jitted JAX step
    on the whole global batch."""
    import jax
    import jax.numpy as jnp

    from yolo_quantization_tpu.models import zoo as jzoo
    from yolo_quantization_tpu.nn import graph as JG
    from yolo_quantization_tpu.train import qat as jqat
    from yolo_quantization_tpu_torch.nn.graph import init_params_numpy

    out, _ = ranks
    jnet = jzoo.yolov3_tiny(classes=CLASSES, width=SIZE, height=SIZE)
    jcfg = jqat.TrainConfig(donate_state=False, **CFG, **RUNS["ddp-float"][0])
    jp = jax.tree.map(jnp.asarray, init_params_numpy(0, net()))
    qs = jax.tree.map(jnp.asarray, JG.init_quant_state(jnet))
    state = jqat.TrainState(jp, jqat.make_optimizer(jcfg).init(jp), qs, jnp.int32(0), jnp.int32(0))
    images, truths = global_batch()
    state, metrics = jqat.make_train_step(jnet, jcfg, qat=False).__wrapped__(
        state, jnp.asarray(images), jnp.asarray(truths))
    assert float(np.load(out / "ddp-float.npz")["losses"][0]) == pytest.approx(float(metrics["loss"]), rel=1e-4)
    got = load(out / "ddp-float.npz", "f")
    for i, p in state.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[i][k], np.asarray(v), rtol=1e-3, atol=1e-6, err_msg=f"{i}/{k}")


def test_tensor_parallel_matches_engine_and_jax(ranks):
    import jax  # noqa: F401  (the JAX engine below runs on the conftest's 8 CPU devices)

    from yolo_quantization_tpu.models.presets import flagship_program as jflagship
    from yolo_quantization_tpu.parallel.tp import make_tp_engine as jmake
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.presets import flagship_program

    out, results = ranks
    z = np.load(out / "tp.npz")
    assert results[0]["tp_mesh"] == [[1, WORLD], [WORLD, 1]]
    eng = Engine(flagship_program(classes=3, size=96), max_det=64, device="cpu")
    for i, h in enumerate(eng.raw_heads(tp_images())):
        np.testing.assert_array_equal(z[f"h{i}"], h)
    want = eng.predict(tp_images())
    jpredict, _ = jmake(jflagship(classes=3, size=96), n_model=4, n_data=2, max_det=64)
    for i, (w, j) in enumerate(zip(want, jpredict(tp_images()))):
        np.testing.assert_array_equal(z[f"m{i}"], w)
        np.testing.assert_array_equal(z[f"d{i}"], w)
        # decoded floats: XLA's and torch's sigmoid and exp differ by ulps
        np.testing.assert_allclose(z[f"m{i}"], np.asarray(j), rtol=1e-6, atol=1e-7)


def test_one_server_per_process(ranks):
    """Serving has no state across processes: each rank's Server answers as
    one process does."""
    _, results = ranks
    single = json.loads(json.dumps(serve_frames(frames())))
    assert results[0]["served"] == results[1]["served"] == single
    assert sum(len(d) for d in single) > 0


def test_cli_trains_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m yolo_quantization_tpu_torch.cli train
    --fsdp --device cpu``: rank 0 alone prints the JAX CLI's lines and the
    FSDP report, and writes the whole checkpoint, which ``export`` reads."""
    from test_torch_valid import make_dataset
    from yolo_quantization_tpu_torch.cli.main import main

    lst = make_dataset(str(tmp_path), n=4)
    model = ["--model", "yolov3-tiny", "--size", "64", "--classes", "5", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(HERE), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(WORLD),
         "--master-port", str(free_port()), "-m", "yolo_quantization_tpu_torch.cli", "train", *model,
         "--fsdp", "--train-list", lst, "--backup-dir", str(tmp_path / "backup"), "--batch-size", "4",
         "--max-batches", "2", "--workers", "2", "--quant-start", "1"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum("DP over 2 devices (cpu)" in ln for ln in lines) == 1
    assert sum(ln.startswith("FSDP over 2 devices: ") for ln in lines) == 1
    assert sum(ln.startswith("2: loss") for ln in lines) == 1 and lines[-1] == "training done"
    assert os.listdir(tmp_path / "backup") == ["2"]
    main(["export", *model, "--ckpt", str(tmp_path / "backup"), "--out", str(tmp_path / "m.weights")])
    assert os.path.getsize(tmp_path / "m.weights") > 1000


def test_scaling_efficiency_skips_counts_above_the_world(ranks):
    """Counts above the world's 2 ranks are skipped with a warning; each
    rank measures the counts whose group holds it."""
    _, results = ranks
    assert [r["scaling"][0] for r in results] == [[1, 2], [2]]
    assert all(r["scaling"][1] == ["scaling_efficiency: 4 devices skipped; the world has 2"] for r in results)


def test_unreachable_coordinator_raises():
    """``initialize`` with an explicit coordinator that cannot be reached
    raises; it never runs on alone."""
    code = ("import sys\n"
            "from yolo_quantization_tpu_torch.parallel import distributed\n"
            "try:\n"
            f"    distributed.initialize('localhost:{free_port()}', 2, 1, initialization_timeout=3, device='cpu')\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__); sys.exit(3)\n"
            "print('SILENT'); sys.exit(0)\n")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(HERE)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
