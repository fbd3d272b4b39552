"""The port's yolo loss, train step and Trainer against the JAX package's, on
the CPU.

The loss and its gradient against ``yolo_head_loss`` (a batch with two
truths in one cell and anchor among the cases).  ``make_train_step`` steps
from the same params, ranges and batch against JAX's in every phase
(float, EMA-QAT, learned ranges, frozen ranges), with SGD and Adam, prune on
and off: the loss within rtol=1e-4, the updated params, BN rolling
statistics and ranges within rtol=1e-3, atol=1e-6, against the un-jitted
JAX step (jit moves its own QAT gradients by about 1%).  The QAT phases run on a
small net at 32x32, where a fake-quant code flip (an ulp of a conv output
on the other side of a rounding boundary, see ``test_torch_qat.py``) is
rare enough not to move the loss; the float phase also runs on
yolov3-tiny at 96x96.  Then the Trainer's phase plan, the checkpoint round
trip and the device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.train import loss as jloss
from yolo_quantization_tpu.train import qat as jqat
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.tools import qat_check as Q
from yolo_quantization_tpu_torch.train import checkpoint as ck
from yolo_quantization_tpu_torch.train import loss as tloss
from yolo_quantization_tpu_torch.train import qat as tqat

torch.set_num_threads(2)

MAX_BOXES = tloss.MAX_BOXES
ANCHORS = ((10, 14), (23, 27), (37, 58))


def make_truths(batch, boxes):
    t = np.zeros((batch, MAX_BOXES, 5), np.float32)
    for b in range(batch):
        for i, bx in enumerate(boxes):
            t[b, i] = bx
    return t


# two truths of one image in one cell of one anchor (different classes and
# sizes: the later one's box target stays, both classes get target 1), and
# a third elsewhere
COLLIDING = [(0.51, 0.52, 0.90, 0.70, 1.0), (0.53, 0.50, 0.90, 0.70, 3.0), (0.2, 0.7, 0.1, 0.12, 0.0)]


@pytest.mark.parametrize("boxes", [[], [(0.5, 0.5, 0.9, 0.7, 2.0)], COLLIDING,
                                   [(0.3, 0.4, 0.2, 0.3, 1.0), (0.8, 0.1, 0.05, 0.06, 4.0)]],
                         ids=["empty", "one", "colliding", "two"])
def test_yolo_head_loss_and_gradient_match_jax(boxes):
    rng = np.random.default_rng(0)
    raw = (rng.standard_normal((2, 5, 5, 30)) * 0.5).astype(np.float32)
    raw[0, 2, 2] = 0.0  # logits at the max(z, 0) kink, as fake-quantized heads give
    truths = make_truths(2, boxes)

    def jf(r):
        return jloss.yolo_head_loss(r, jnp.asarray(truths), (3, 4, 5), jzoo.NOK_TINY_ANCHORS, 5, 160, 160)

    (jl, jst), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(raw))
    rt = torch.from_numpy(raw).requires_grad_(True)
    tl, tst = tloss.yolo_head_loss(rt, torch.from_numpy(truths), (3, 4, 5), tzoo.NOK_TINY_ANCHORS, 5, 160, 160)
    tl.backward()
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    assert int(tst["obj_count"]) == int(jst["obj_count"])
    assert float(tst["avg_obj"]) == pytest.approx(float(jst["avg_obj"]), rel=1e-5)
    if boxes is COLLIDING:
        assert int(tst["obj_count"]) == 2  # two truths, one slot, in each of 2 images


def test_last_writer_keeps_the_later_truth():
    """The scatter keeps, of the assigned truths that share a slot, the last
    one in (image, truth) order, as the reference's in-order scatter does
    (a slot number holds the image index, so two images never share one)."""
    slot = torch.tensor([[3, 5, 3, 7], [11, 11, 8, 8]])
    assign = torch.tensor([[True, True, True, False], [True, False, True, True]])
    win = tloss._last_writer(slot, assign, 12)
    assert win.tolist() == [[False, True, True, False], [True, False, False, True]]


def test_total_loss_over_tiny_heads_matches_jax():
    net_j = jzoo.yolov3_tiny(classes=5, width=160, height=160)
    net_t = tzoo.yolov3_tiny(classes=5, width=160, height=160)
    rng = np.random.default_rng(2)
    heads = [(rng.standard_normal((2, 5, 5, 30)) * 0.3).astype(np.float32),
             (rng.standard_normal((2, 10, 10, 30)) * 0.3).astype(np.float32)]
    truths = make_truths(2, COLLIDING)
    jl, _ = jloss.total_loss([jnp.asarray(h) for h in heads], jnp.asarray(truths), net_j)
    tl, _ = tloss.total_loss([torch.from_numpy(h) for h in heads], torch.from_numpy(truths), net_t)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    jl2, _ = jloss.total_loss([jnp.asarray(h) for h in heads], jnp.asarray(truths), net_j, input_hw=(192, 192))
    tl2, _ = tloss.total_loss([torch.from_numpy(h) for h in heads], torch.from_numpy(truths), net_t,
                              input_hw=(192, 192))
    assert float(tl2) == pytest.approx(float(jl2), rel=1e-5)


def test_region_and_detection_losses_raise_naming_the_roadmap():
    """The region and detection losses run through ``total_loss`` since the
    yolov2/yolov1 slice and equal the reference's (the full cases are in
    ``test_torch_v2.py``); a WordTree region head's loss too (its cases are
    in ``test_torch_tree.py``)."""
    rng = np.random.default_rng(0)
    truths = make_truths(2, COLLIDING)
    heads = [rng.uniform(0.05, 0.95, (2, 3, 3, 2 * 9)).astype(np.float32),
             rng.uniform(-0.5, 0.9, (2, 2 * 2 * (3 + 2 * 5))).astype(np.float32)]
    for G, lib, cast in ((JG, jloss, jnp.asarray), (TG, tloss, torch.from_numpy)):
        net = G.NetworkDef(specs=(G.RegionSpec(anchors=((1, 1), (2, 2)), classes=4, num=2),
                                  G.DetectionSpec(classes=3, num=2, side=2, sqrt=True, rescore=True)),
                           width=32, height=32)
        got = float(lib.total_loss([cast(h) for h in heads], cast(truths), net, seen=100)[0])
        if G is JG:
            want = got
    assert got == pytest.approx(want, rel=1e-5)
    from yolo_quantization_tpu.core.tree import parse_tree as jparse
    from yolo_quantization_tpu_torch.core.tree import parse_tree

    lines = ["a -1", "b -1", "c 0", "d 0"]
    head = rng.uniform(0.05, 0.95, (2, 3, 3, 2 * 9)).astype(np.float32)
    for G, lib, cast, tree in ((JG, jloss, jnp.asarray, jparse(lines)), (TG, tloss, torch.from_numpy,
                                                                          parse_tree(lines))):
        net = G.NetworkDef(specs=(G.RegionSpec(anchors=((1, 1), (2, 2)), classes=4, num=2, tree=tree),),
                           width=32, height=32)
        got = float(lib.total_loss([cast(head)], cast(truths), net, seen=100)[0])
        if G is JG:
            want = got
    assert got == pytest.approx(want, rel=1e-5)


def small_net(G, size=32):
    """conv(BN, relu6) -> pool -> conv(BN, leaky) -> route -> 1x1 head ->
    yolo, at 32x32: every kind of range (act, route) and both folds."""
    return G.NetworkDef(specs=(
        G.ConvSpec(filters=8, activation="relu6"),
        G.MaxPoolSpec(2, 2),
        G.ConvSpec(filters=16, activation="leaky"),
        G.RouteSpec(layers=(2, 1)),
        G.ConvSpec(filters=3 * 9, size=1, pad=0, activation="linear", batch_normalize=False, quant_stop=True),
        G.YoloSpec(mask=(0, 1, 2), anchors=ANCHORS, classes=4),
    ), width=size, height=size)


PHASES = {  # name -> (qat, learned_ranges, freeze_ranges)
    "float": (False, False, False),
    "ema-qat": (True, False, False),
    "learned": (True, True, False),
    "frozen": (True, False, True),
}


def _run_steps(tnet, jnet, params_np, qs_np, images, truths, phase, steps=2, jit=False, **cfg):
    qat, learned, frozen = PHASES[phase]
    base = dict(burn_in=0, quant_start_step=0, learning_rate=1e-3, range_lr=0.01, **cfg)
    jcfg, tcfg = jqat.TrainConfig(donate_state=False, **base), tqat.TrainConfig(**base)
    jp = jax.tree.map(jnp.asarray, params_np)
    tx = jqat.make_optimizer(jcfg)
    jstate = jqat.TrainState(jp, tx.init(jp), jax.tree.map(jnp.asarray, qs_np), jnp.int32(0), jnp.int32(0))
    # the un-jitted step: under jit XLA's fusion moves the QAT gradients of
    # this net by about 1% from its own eager ones, which the port matches
    jstep = jqat.make_train_step(jnet, jcfg, qat=qat, learned_ranges=learned, freeze_ranges=frozen)
    jstep = jstep if jit else jstep.__wrapped__
    tp = TG.params_to_torch(params_np, "cpu", requires_grad=True)
    tstate = tqat.TrainState(tp, tqat.make_optimizer(tcfg, tp), TG.quant_state_to_torch(qs_np, "cpu"), 0, 0)
    tstep = tqat.make_train_step(tnet, tcfg, qat=qat, learned_ranges=learned, freeze_ranges=frozen)
    out = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(truths))
        tstate, tm = tstep(tstate, torch.from_numpy(images), torch.from_numpy(truths))
        out.append((jm, tm))
    return jstate, tstate, out


def _assert_states_match(jstate, tstate, metrics):
    for jm, tm in metrics:
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert tm["lr"] == float(jm["lr"])
        if "sparsity" in jm:
            assert float(tm["sparsity"]) == pytest.approx(float(jm["sparsity"]), rel=1e-6)
    for i, p in tstate.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jstate.params[i][k]),
                                       rtol=1e-3, atol=1e-6, err_msg=f"params[{i}][{k}]")
    for k, st in tstate.quant_state.items():
        for n, v in st.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate.quant_state[k][n]), rtol=1e-3,
                                       atol=1e-6, err_msg=f"{k}.{n}")
    assert (tstate.step, tstate.seen) == (int(jstate.step), int(jstate.seen))


@pytest.fixture(scope="module")
def small_setup():
    tnet, jnet = small_net(TG), small_net(JG)
    params_np = TG.init_params_numpy(5, tnet)
    rng = np.random.default_rng(6)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    truths = make_truths(2, COLLIDING)
    qs = Q.calibrated_ranges(tnet, TG.params_to_torch(params_np, "cpu"), torch.from_numpy(images))
    return tnet, jnet, params_np, TG.quant_state_to_numpy(qs), images, truths


@pytest.mark.parametrize("prune", [False, True], ids=["prune-off", "prune-on"])
@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
@pytest.mark.parametrize("phase", list(PHASES))
def test_train_steps_match_jax(small_setup, phase, adam, prune):
    """One step in the QAT phases (a second would start from params that
    differ by float rounding, and a folded weight on the other side of its
    grid moves the loss by about 1% at this size); two in the float phase,
    so the second reads the momentum the first wrote (pruned in place)."""
    tnet, jnet, params_np, qs_np, images, truths = small_setup
    jstate, tstate, metrics = _run_steps(tnet, jnet, params_np, qs_np, images, truths, phase,
                                         steps=2 if phase == "float" else 1,
                                         adam=adam, prune=prune, prune_threshold=0.05)
    _assert_states_match(jstate, tstate, metrics)
    if prune:
        assert float(metrics[0][1]["sparsity"]) > 0


def test_float_step_on_tiny_96_matches_jax():
    tnet = tzoo.yolov3_tiny(classes=5, width=96, height=96)
    jnet = jzoo.yolov3_tiny(classes=5, width=96, height=96)
    params_np = TG.init_params_numpy(0, tnet)
    images = np.random.default_rng(1).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    truths = make_truths(2, [(0.5, 0.5, 0.4, 0.4, 0.0)] + COLLIDING)
    # the float phase has no fake-quant: the jitted step is as close as the eager one
    jstate, tstate, metrics = _run_steps(tnet, jnet, params_np, TG.init_quant_state(tnet), images,
                                         truths, "float", steps=1, jit=True)
    _assert_states_match(jstate, tstate, metrics)


def test_trainer_phase_plan_and_ranges():
    """Float, EMA warm-up, then the learned phase (sign-SGD moves each
    range by at most range_lr, min <= 0, max >= 1e-3); the frozen phase
    leaves the ranges bit-identical while params move."""
    net = small_net(TG)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    truths = make_truths(2, [(0.5, 0.5, 0.4, 0.4, 0.0)])
    cfg = tqat.TrainConfig(burn_in=0, quant_start_step=1, learned_ranges=True, range_warmup=1)
    tr = tqat.Trainer(net, cfg, seed=0, device="cpu")
    tr.step(images, truths)                       # float
    assert tr._learned_step is None
    assert all(float(v) == 0.0 for st in tr.state.quant_state.values() for v in st.values())
    tr.step(images, truths)                       # EMA warm-up
    seeded = TG.quant_state_to_numpy(tr.state.quant_state)
    assert tr._learned_step is None and float(seeded["act_0"]["max"]) > 0
    m = tr.step(images, truths)                   # learned
    assert tr._learned_step is not None and np.isfinite(float(m["loss"]))
    moved = TG.quant_state_to_numpy(tr.state.quant_state)
    deltas = [abs(float(moved[k][n]) - float(seeded[k][n])) for k in seeded for n in ("min", "max")]
    assert max(deltas) <= cfg.range_lr + 1e-6 and sum(d > 0 for d in deltas) > 0
    assert all(float(st["min"]) <= 0.0 and float(st["max"]) >= 1e-3 for st in moved.values())
    cfg = tqat.TrainConfig(burn_in=0, quant_start_step=0, freeze_ranges_after=1)
    tr = tqat.Trainer(net, cfg, seed=0, device="cpu")
    tr.step(images, truths)
    frozen = TG.quant_state_to_numpy(tr.state.quant_state)
    before = TG.params_to_numpy(tr.state.params)
    tr.step(images, truths)
    tr.step(images, truths)
    assert tr._frozen_step is not None
    assert TG.quant_state_to_numpy(tr.state.quant_state) == frozen
    after = TG.params_to_numpy(tr.state.params)
    assert any(not np.array_equal(before[i][k], after[i][k]) for i in before for k in before[i])
    assert (tr.state.step, tr.state.seen) == (3, 6)


def test_loss_decreases_on_fixed_batch():
    net = tzoo.yolov3_tiny(classes=5, width=96, height=96)
    tr = tqat.Trainer(net, tqat.TrainConfig(learning_rate=5e-4, burn_in=0, quant_start_step=10**9),
                      seed=0, device="cpu")
    images = np.random.default_rng(1).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    truths = make_truths(2, [(0.5, 0.5, 0.4, 0.4, 0.0)])
    losses = [float(tr.step(images, truths)["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0], losses


def test_checkpoint_round_trip_and_cadence(tmp_path):
    net = small_net(TG)
    cfg = tqat.TrainConfig(burn_in=0, quant_start_step=1)
    images = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    truths = make_truths(2, [(0.5, 0.5, 0.4, 0.4, 0.0)])
    tr = tqat.Trainer(net, cfg, seed=0, device="cpu")
    d = str(tmp_path / "ckpt")
    assert ck.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(d, tr.state)
    for _ in range(7):
        tr.step(images, truths)
        ck.save_checkpoint(d, tr.state)
    assert ck.latest_step(d) == 7
    assert sorted(int(x) for x in __import__("os").listdir(d)) == [3, 4, 5, 6, 7]  # max_to_keep 5
    other = tqat.Trainer(net, cfg, seed=1, device="cpu")
    st = ck.restore_checkpoint(d, other.state)
    assert (st.step, st.seen) == (7, 14)
    for i, p in tr.state.params.items():
        for k, v in p.items():
            assert torch.equal(st.params[i][k], v)
    assert TG.quant_state_to_numpy(st.quant_state) == TG.quant_state_to_numpy(tr.state.quant_state)
    # the resumed trainer takes the next step exactly as the original does
    other.state = st
    a, b = tr.step(images, truths), other.step(images, truths)
    assert float(a["loss"]) == float(b["loss"])
    assert [ck.checkpoint_cadence(s) for s in (0, 100, 150, 1000, 10000, 20000, 25000)] == \
        [True, True, False, False, True, True, False]
    assert ck.checkpoint_cadence(500) == jax_cadence(500)


def jax_cadence(step):
    """The JAX package's cadence (its module imports orbax, which the
    checkpoint test does not need)."""
    return step % 100 == 0 if step < 1000 else step % 10000 == 0


def test_multiscale_resolutions_match_jax():
    assert tqat.multiscale_resolutions() == jqat.multiscale_resolutions()


def test_trainer_runs_on_cuda_unless_asked():
    net = small_net(TG)
    if torch.cuda.is_available():
        assert tqat.Trainer(net, tqat.TrainConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tqat.Trainer(net, tqat.TrainConfig())


@pytest.mark.cuda
def test_cuda_train_steps_track_the_cpu():
    """Two EMA-QAT steps of the small net on the card against the CPU: the
    loss within rtol=1e-4, params within rtol=1e-3 (the card sums its
    convolutions in another order than the CPU, so never bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    net = small_net(TG)
    images = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    truths = make_truths(2, COLLIDING)
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = tqat.Trainer(net, tqat.TrainConfig(burn_in=0, quant_start_step=1), seed=0, device=dev)
        losses = [float(tr.step(images, truths)["loss"]) for _ in range(2)]
        runs[dev] = (losses, TG.params_to_numpy(tr.state.params))
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for i, p in runs["cpu"][1].items():
        for k, v in p.items():
            np.testing.assert_allclose(runs["cuda"][1][i][k], v, rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_cuda_training_is_deterministic():
    """Two runs of three steps (float, then EMA-QAT) from one seed on the card
    give equal losses and params, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    net = small_net(TG)
    images = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    truths = make_truths(2, COLLIDING)
    runs = []
    for _ in range(2):
        tr = tqat.Trainer(net, tqat.TrainConfig(burn_in=0, quant_start_step=1), seed=0, device="cuda")
        losses = [float(tr.step(images, truths)["loss"]) for _ in range(3)]
        runs.append((losses, TG.params_to_numpy(tr.state.params)))
    assert runs[0][0] == runs[1][0]
    for i, p in runs[0][1].items():
        for k, v in p.items():
            np.testing.assert_array_equal(runs[1][1][i][k], v)
