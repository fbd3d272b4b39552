"""The port's accuracy capstone (``tools/accuracy_capstone.py``) against
``scripts/accuracy_capstone.py``, on the CPU.

- ``paint_batch`` on draws taken from a ``jax.random`` key in the script's
  split order equals the script's ``render_batch`` bit for bit (images and
  truth rows), for both slot sets at 64x64 and at 416x416.  Under
  ``jax.jit`` XLA contracts ``u * (1 - wh) + wh / 2`` into an FMA, so the
  jitted script's truth centres may sit one ulp away; its images are equal.
- ``draw_slots`` is a fixed function of its generator's seed, with the
  script's slot rules.
- The evaluation of the three rows against the script's ``eval_engine``
  on the same 25 rendered 64x64 images and the same seeded parameters and
  calibrated ranges (``tools/qat_check.py::calibrated_ranges``): the
  integer top-k within the decode tolerance and its F1 counts equal at
  every threshold; the float top-k within ``FLOAT_TOL`` (a float forward
  sums its convs in another order than XLA's: 4.1e-5 of a box here, past
  the decode tolerance) and its counts equal except at an image with a
  score within that tolerance of a threshold (named).  A whole fake-quant
  forward is not reproducible across implementations (an ulp of a conv
  output moves a code; here the heads of about half the images differ),
  so the QAT-sim engine is held layer by layer on the same images, each
  JAX layer from the port's inputs, by ``tools/qat_check.py``'s value rule.
- ``main`` end to end at 64x64 (plain, ``--float-baseline``): the records'
  key sets equal the script's (``ACCURACY_V2_r05.json``,
  ``FLOATBASE_V3_r05.json``), under the ``TORCH`` names; two ``--bf16``
  steps give finite losses; multiscale switches size every 10 steps.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_native import jax_binding_whole
from test_torch_qat import jax_layer, jax_mode
from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.eval.f1 import f1_rows as jf1_rows
from yolo_quantization_tpu.infer.convert import convert as jconvert
from yolo_quantization_tpu.infer.engine import Engine as JEngine
from yolo_quantization_tpu.infer.engine import build_forward as jbuild_forward
from yolo_quantization_tpu.infer.float_engine import FloatEngine as JFloatEngine
from yolo_quantization_tpu_torch.eval.f1 import f1_rows
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.infer.engine import Engine
from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine, QatSimEngine
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.tools import accuracy_capstone as C
from yolo_quantization_tpu_torch.tools import qat_check as Q

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    """The JAX binding holds the whole native library (``test_torch_native``)."""
    with jax_binding_whole():
        yield
DECODE_TOL = dict(rtol=1e-6, atol=1e-7)
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_v2.py's FloatEngine-vs-JAX tolerance


@pytest.fixture(scope="module")
def jcap():
    """scripts/accuracy_capstone.py as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location("jax_accuracy_capstone", ROOT / "scripts" / "accuracy_capstone.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_draws(jcap, key, batch: int, size: int, slots: str) -> dict:
    """``render_batch``'s random tensors from ``key``, in its split order, as
    the port's draws."""
    n = len(jcap.SLOT_RANGES[slots])
    kb, kc, kw, kx, kj, kp = jax.random.split(key, 6)
    present = jnp.concatenate(
        [jnp.ones((batch, 1), bool) if s % 2 == 0
         else jax.random.uniform(jax.random.fold_in(kp, s), (batch, 1)) < 0.7 for s in range(n)], axis=1)
    draws = dict(
        background=jax.random.uniform(kb, (batch, size, size, 3), jnp.float32, 0.0, 0.22),
        u_wh=jax.random.uniform(kw, (batch, n, 2), jnp.float32),
        u_xy=jax.random.uniform(kx, (batch, n, 2), jnp.float32),
        cls=jax.random.randint(kc, (batch, n), 0, jcap.CLASSES),
        present=present,
        jitter=jax.random.uniform(kj, (batch, n, 1, 1, 3), jnp.float32, -0.06, 0.06).reshape(batch, n, 3),
    )
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    out["cls"] = out["cls"].long()
    return out


def test_constants_are_the_scripts(jcap):
    assert C.CLASSES == jcap.CLASSES and C.MAX_BOXES == jcap.MAX_BOXES
    assert C.SLOT_RANGES == jcap.SLOT_RANGES
    np.testing.assert_array_equal(np.asarray(C.PALETTE, np.float32), np.asarray(jcap.PALETTE))
    for kw in (dict(), dict(v3=True), dict(v2=True), dict(activation="leaky")):
        t, j = C.build_net(size=64, **kw), jcap.build_net(size=64, **kw)
        assert repr(t.specs) == repr(j.specs) and (t.width, t.height) == (j.width, j.height)


@pytest.mark.parametrize("slots,batch,size", [("tiny", 4, 64), ("v3", 4, 64), ("tiny", 1, 416), ("v3", 1, 416)])
def test_paint_batch_equals_render_batch(jcap, slots, batch, size):
    key = jax.random.fold_in(jax.random.PRNGKey(101), 7)
    images, truths = C.paint_batch(jax_draws(jcap, key, batch, size, slots), size, slots)
    want_images, want_truths = jcap.render_batch(key, batch, size, slots)
    assert images.dtype == truths.dtype == torch.float32
    np.testing.assert_array_equal(images.numpy(), np.asarray(want_images))
    np.testing.assert_array_equal(truths.numpy(), np.asarray(want_truths))
    if size == 64:
        jit_images, jit_truths = jax.jit(jcap.render_batch, static_argnames=("batch", "size", "slots"))(
            key, batch=batch, size=size, slots=slots)
        np.testing.assert_array_equal(images.numpy(), np.asarray(jit_images))
        np.testing.assert_array_max_ulp(truths.numpy(), np.asarray(jit_truths), maxulp=1)


@pytest.mark.parametrize("slots", ["tiny", "v3"])
def test_draw_slots_follow_the_scripts_rules(slots):
    ranges = np.asarray(C.SLOT_RANGES[slots], np.float32)
    n = len(ranges)
    draw = lambda seed: C.draw_slots(C.seeded_generator("cpu", seed, 3), 64, 8, slots)  # noqa: E731
    a, b, c = draw(101), draw(101), draw(777)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["u_wh"], c["u_wh"])
    assert a["background"].shape == (64, 8, 8, 3) and a["cls"].shape == a["present"].shape == (64, n)
    assert 0 <= a["background"].min() and a["background"].max() <= 0.22
    assert 0 <= a["cls"].min() and a["cls"].max() < C.CLASSES
    assert a["jitter"].abs().max() <= 0.06 and a["jitter"].shape == (64, n, 3)
    present = a["present"].numpy()
    assert present[:, 0::2].all() and not present[:, 1::2].all() and present[:, 1::2].any()
    _, truths = C.paint_batch(a, 8, slots)
    t = truths.numpy()
    assert t.shape == (64, C.MAX_BOXES, 5)
    assert not t[:, n:].any()
    wh = t[:, :n, 2:4]
    assert not wh[~present].any()
    live = wh[present]
    lo, hi = (np.broadcast_to(ranges[None, :, i, None], wh.shape)[present] for i in (0, 1))
    assert (live >= lo).all() and (live <= hi * (1 + 1e-6)).all()
    assert (t[:, :n, :4] >= 0).all() and (t[:, :n, :4] <= 1).all()
    np.testing.assert_array_equal(t[:, :n, 4], a["cls"].numpy())
    # a centre keeps its box inside the image
    xy = t[:, :n, 0:2][present]
    assert (xy - live / 2 >= -1e-6).all() and (xy + live / 2 <= 1 + 1e-6).all()


@pytest.fixture(scope="module")
def rows_setup(jcap):
    """The flagship topology at 64x64, seeded weights, ranges calibrated on
    the first 8 of 25 images the script renders for evaluation, and each
    row's per-image cache from the script's ``eval_engine`` and the port's."""
    size = 64
    tnet, jnet = C.build_net(size=size), jcap.build_net(size=size)
    params = TG.init_params_numpy(5, tnet)
    render = jax.jit(jcap.render_batch, static_argnames=("batch", "size", "slots"))
    images, truths = render(jax.random.fold_in(jax.random.PRNGKey(777), 0), batch=25, size=size, slots="tiny")
    x = torch.from_numpy(np.array(images))
    qs = TG.quant_state_to_numpy(Q.calibrated_ranges(tnet, TG.params_to_torch(params, "cpu"), x[:8]))

    program = jconvert(jnet, params, qs)
    engine = JEngine(program, max_det=64)

    @jax.jit
    def int_run(arrays, x):
        heads = jbuild_forward(program)(arrays, x)
        b, o, c = jdetect.decode_all_heads(heads, jnet)
        return jdetect.top_k_detections(b, o, c, 64)

    fe = JFloatEngine(jnet, params, max_det=64)
    want = {"int": jcap.eval_engine(int_run, engine.arrays, 25, slots="tiny", size=size),
            "float": jcap.eval_engine(fe._run, fe.params, 25, slots="tiny", size=size)}
    batches = [(x, torch.from_numpy(np.array(truths)))]
    got = {"int": C.eval_engine(Engine(convert(tnet, params, qs), max_det=64, device="cpu"), batches),
           "float": C.eval_engine(FloatEngine(tnet, params, max_det=64, device="cpu"), batches),
           "qat": C.eval_engine(QatSimEngine(tnet, params, qs, max_det=64, device="cpu"), batches)}
    return dict(tnet=tnet, jnet=jnet, params=params, qs=qs, x=x, want=want, got=got)


def counts(rows):
    return [(r.thresh, r.tp, r.tp_fp, r.tp_fn) for r in rows]


def test_integer_rows_equal_the_scripts(rows_setup):
    want, got = rows_setup["want"]["int"], rows_setup["got"]["int"]
    assert len(want) == len(got) == 25
    for k, ((wb, wo, wt), (gb, go, gt)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gt, wt, err_msg=f"image {k} truths")
        np.testing.assert_allclose(gb, wb, **DECODE_TOL, err_msg=f"image {k} boxes")
        np.testing.assert_allclose(go, wo, **DECODE_TOL, err_msg=f"image {k} objectness")
    assert counts(f1_rows(got)) == counts(jf1_rows(want))
    assert sum(len(t) for _, _, t in got) > 25  # the odd slots are there too


def test_float_rows_equal_the_scripts(rows_setup):
    want, got = rows_setup["want"]["float"], rows_setup["got"]["float"]
    near = set()  # images with a score within the tolerance of a threshold
    for k, ((wb, wo, _), (gb, go, _)) in enumerate(zip(want, got)):
        np.testing.assert_allclose(gb, wb, **FLOAT_TOL, err_msg=f"image {k} boxes")
        np.testing.assert_allclose(go, wo, **FLOAT_TOL, err_msg=f"image {k} objectness")
        tol = FLOAT_TOL["atol"] + FLOAT_TOL["rtol"] * np.abs(wo)
        if any((np.abs(wo - t) <= tol).any() for t in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)):
            near.add(k)
    far = [k for k in range(len(want)) if k not in near]
    assert counts(f1_rows([got[k] for k in far])) == counts(jf1_rows([want[k] for k in far])), \
        f"counts differ away from the thresholds; images near one: {sorted(near)}"
    if not near:
        assert counts(f1_rows(got)) == counts(jf1_rows(want))


def test_qat_sim_row_holds_layer_by_layer(rows_setup):
    """The QAT-sim row's forward on the evaluation images: every layer of
    the script's fake-quant eval forward from the port's inputs, held by
    the value rule (within one grid step where fake-quantized); its heads
    are the engine's."""
    tnet, jnet, x = rows_setup["tnet"], rows_setup["jnet"], rows_setup["x"]
    qs_np = rows_setup["qs"]
    mode = Q.MODES["qat-eval"]
    params = TG.params_to_torch(rows_setup["params"], "cpu")
    qs = TG.quant_state_to_torch(qs_np, "cpu")
    with torch.no_grad():
        heads, aux = TG.forward(tnet, params, x, mode, qs, return_outputs=True)
    x0, outputs = aux["input"], aux["outputs"]
    engine = QatSimEngine(tnet, rows_setup["params"], qs_np, max_det=64, device="cpu")
    for a, b in zip(engine.raw_heads(x.numpy()), heads):
        np.testing.assert_array_equal(a, b.numpy())
    n = len(tnet.specs)
    reads = [Q.layer_inputs(tnet, i) for i in range(n)]
    as_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731

    @jax.jit
    def layers(p, qs_j, xs, rd):
        """Every JAX layer side by side, each from the port's inputs."""
        ys = []
        for i in range(n):
            outs = [None] * i
            for j, o in zip(reads[i], rd[i]):
                outs[j] = o
            ys.append(jax_layer(jnet, i, p.get(i, {}), xs[i], outs, jax_mode(mode), qs_j)[0])
        return ys

    ys = layers(jax.tree.map(jnp.asarray, rows_setup["params"]), jax.tree.map(jnp.asarray, qs_np),
                [as_j(x0 if i == 0 else outputs[i - 1]) for i in range(n)],
                [[as_j(outputs[j]) for j in reads[i]] for i in range(n)])
    for i, y in enumerate(ys):
        key = Q.output_range_key(tnet, i, qs_np)
        step = Q.grid_step(qs_np[key]) if key else None
        Q.check_share(f"layer {i}", outputs[i], np.asarray(y), **Q.VALUE_TOL, step=step)
    got = rows_setup["got"]["qat"]
    assert len(got) == 25 and all(np.isfinite(b).all() and ((o >= 0) & (o <= 1)).all() for b, o, _ in got)


def test_tensor_input_equals_numpy_input(rows_setup):
    """The evaluation hands the engines its images as tensors (on the card,
    no host round trip); predict gives what it gives on numpy."""
    x = rows_setup["x"][:3]
    tnet, params, qs = rows_setup["tnet"], rows_setup["params"], rows_setup["qs"]
    for engine in (Engine(convert(tnet, params, qs), max_det=16, device="cpu"),
                   FloatEngine(tnet, params, max_det=16, device="cpu")):
        for a, b in zip(engine.predict(x), engine.predict(x.numpy())):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="float32 or uint8"):
        Engine(convert(tnet, params, qs), device="cpu").predict(x.double())


def record_keys(path):
    rec = json.loads(Path(path).read_text())
    return set(rec), set(rec["config"]), rec


def test_capstone_end_to_end_writes_the_scripts_records(tmp_path, capsys):
    common = ["4", "2", "--base-size=64", "--no-multiscale", "--eval-images=25", "--device=cpu",
              f"--out-dir={tmp_path}"]
    out, info = C.main(common)
    assert Path(info["path"]).name == "ACCURACY_TORCH_r11.json"
    keys, config_keys, rec = record_keys(info["path"])
    want_keys, want_config, _ = record_keys(ROOT / "ACCURACY_V2_r05.json")
    assert keys == want_keys and config_keys == want_config
    assert rec == json.loads(json.dumps(out))
    assert rec["metric"] == "accuracy_capstone_64" and rec["device"] == "cpu"
    assert "torch.Generator" in rec["config"]["protocol"]
    assert rec["config"]["quant_start_step"] == 1 and rec["config"]["steps"] == 4
    assert rec["within_half_point"] == (rec["int"]["f1"] >= rec["float"]["f1"] - 0.5)
    assert [s for s, _ in info["losses"]] == [4] and np.isfinite([v for _, v in info["losses"]]).all()
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == rec
    assert any(line.startswith("int best: thresh") for line in printed)

    out, info = C.main(common + ["--float-baseline"])
    assert Path(info["path"]).name == "FLOATBASE_TORCH_r11.json"
    keys, config_keys, rec = record_keys(info["path"])
    want_keys, want_config, _ = record_keys(ROOT / "FLOATBASE_V3_r05.json")
    assert keys == want_keys and config_keys == want_config
    assert rec["metric"] == "float_baseline_64" and rec["config"]["model"] == "yolov3-tiny"


def test_record_names_follow_the_scripts_with_torch():
    def name(*flags):
        return C.file_name(C.parse_args(list(flags)))

    assert name() == "ACCURACY_TORCH_r11.json"
    assert name("--v3", "--bf16") == "ACCURACY_TORCH_V3_r11_bf16.json"
    assert name("--v2", "--tag=x") == "ACCURACY_TORCH_V2_x.json"
    assert name("--leaky", "--percentile=0.01", "--learned") == "ACCURACY_TORCH_r11_leaky_percentile-0.01_learned.json"
    assert name("--percentile") == "ACCURACY_TORCH_r11_percentile.json"
    assert name("--float-baseline", "--v3", "--lr=5e-4") == "FLOATBASE_TORCH_V3_r11_lr0.0005.json"
    a = C.parse_args(["1500", "16"])
    assert (a.steps, a.batch, a.device, a.eval_images) == (1500, 16, "cuda", 200)
    assert C.settings(a) == ("relu6", "minmax", "float32")
    assert C.settings(C.parse_args(["--leaky", "--percentile=0.01", "--bf16"])) == (
        "leaky", "percentile:0.01", "bfloat16")


def test_bf16_steps_are_finite_and_multiscale_switches_every_10_steps(capsys):
    net = C.build_net(size=64)
    trainer, losses = C.train(net, 2, 2, False, 1, base_size=64, compute_dtype="bfloat16", device="cpu")
    assert trainer.cfg.compute_dtype == "bfloat16"
    assert [s for s, _ in losses] == [2] and np.isfinite(losses[0][1])
    # sizes 64, 160, 256 (at 32 a batch of one holds 1x1 maps, whose batch
    # variance is degenerate)
    net = C.build_net(size=160)
    _, losses = C.train(net, 11, 1, True, 100, base_size=160, device="cpu")
    assert np.isfinite([v for _, v in losses]).all()
    assert "step 11/11 size 160 loss" in capsys.readouterr().out


def test_the_capstone_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.main(["2", "2"])
