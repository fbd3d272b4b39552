"""QAT training: config, LR policy, optimizer, the train step and the Trainer.

The counterpart of ``yolo_quantization_tpu/train/qat.py`` (darknet's
detector training with fake-quant after ``quant_start_step``):

- SGD with momentum 0.9 and weight decay 5e-4 on conv kernels only (optax's
  ``chain(add_decayed_weights(mask=w), sgd(lr, momentum))`` is
  ``torch.optim.SGD`` with dampening 0 and the decay in the kernels' group);
  Adam adds the decay to the gradient as L2 and keeps eps outside the
  square root (``torch.optim.Adam``, not ``AdamW``);
- darknet's LR policies with burn-in, read at the step count before the
  update (step 0 of a burn-in has rate 0), evaluated on the host in float32
  exactly as the reference evaluates them;
- magnitude pruning of conv kernels together with their momentum;
- BN rolling statistics decay at .99 after the update;
- four step kinds: float warm-up, EMA-tracked QAT, learned ranges (sign-SGD
  on the ranges) and frozen ranges.

Parameters live in a ``nn/graph.py::NetParams`` module (the functional
layout of ``nn/graph.py`` by index, what DDP and FSDP2 wrap) and ranges in
a dict of 0-d tensors; the step updates the parameter tensors in place
through the optimizer and returns the new ranges and counters in a fresh
``TrainState``.  Given a device mesh, the ``Trainer`` trains data-parallel
over its ``data`` dimension (``parallel/mesh.py``: DDP, or
``parallel/fsdp.py``: FSDP2): each rank steps on its rows of the global
batch, and the step is the global batch's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device
from yolo_quantization_tpu_torch.nn.graph import (
    TRAINABLE,
    ConvSpec,
    ForwardMode,
    NetParams,
    NetworkDef,
    forward,
    init_params_numpy,
    init_quant_state,
    params_to_torch,
    quant_state_to_torch,
)
from yolo_quantization_tpu_torch.parallel import mesh as pmesh
from yolo_quantization_tpu_torch.train.loss import _threefry2x32, total_loss

BN_ROLLING_DECAY = 0.99


@dataclass(frozen=True)
class TrainConfig:
    """[net] hyperparameters, with the reference's field names and defaults
    (its ``donate_state`` is a JAX buffer-donation switch: the port's step
    always updates the parameter tensors in place)."""

    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    burn_in: int = 1000
    max_batches: int = 550200
    policy: str = "steps"  # constant|step|steps|exp|poly|random|sig
    lr_steps: tuple[int, ...] = (400000, 450000)
    lr_scales: tuple[float, ...] = (0.1, 0.1)
    power: float = 4.0     # burn-in + poly + random exponent
    gamma: float = 1.0     # exp + sig
    lr_step: int = 1       # step + sig policies' period/midpoint
    lr_scale: float = 1.0  # step policy's scale
    quant_start_step: int = 10000
    batch_size: int = 64
    adam: bool = False
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7
    input_calibration: tuple[float, ...] = ()
    # magnitude pruning: conv kernel weights with |w| < threshold are zeroed
    # with their momentum before every update
    prune: bool = False
    prune_threshold: float = 0.001
    compute_dtype: str = "float32"  # conv operands: "float32" or "bfloat16"
    range_stat: str = "minmax"      # or "percentile[:p]" (nn/graph._batch_range)
    # learnable ranges: after `range_warmup` EMA-seeded QAT steps the ranges
    # move by sign-SGD (+-range_lr a step)
    learned_ranges: bool = False
    range_lr: float = 0.01
    range_warmup: int = 200
    # freeze the EMA ranges N QAT steps after quant_start (None: track to the end)
    freeze_ranges_after: int | None = None


class TrainState(NamedTuple):
    params: Any        # NetParams (or {layer: {name: tensor}}), updated in place by the optimizer
    opt_state: Any     # the torch.optim optimizer over ``params``
    quant_state: Any   # {name: {"min", "max"}} 0-d tensors
    step: int
    seen: int = 0      # images consumed over all ranks (darknet's net.seen)
    model: Any = None  # what the step calls: DDP over ``params``, or ``params`` under FSDP2


# ---------------------------------------------------------------------------
# LR policy: float32 arithmetic as the reference's XLA computes it on the CPU
# ---------------------------------------------------------------------------

_f32 = np.float32
_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.powf.restype = ctypes.c_float
_libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]


def _powf(x, y) -> np.float32:
    """float32 pow through the C library's powf, which XLA's CPU pow calls."""
    return _f32(_libm.powf(float(x), float(y)))


def _fmaf(a, b, c) -> np.float32:
    """float32 fused multiply-add: the product of two float32 values is exact
    in float64, so one float64 add and the float32 cast round it."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


def _expf_xla(x) -> np.float32:
    """float32 exp with XLA's CPU algorithm, whose multiply-adds the x86
    backend contracts into FMAs: clamp to [-87.8, 88.8], n = floor(x log2(e)
    + 1/2) in [-127, 127], r = x - n ln2 (ln2 split in two), a degree-5
    polynomial, times 2^n.  It is not the correctly rounded exp."""
    c = lambda h: _f32(float.fromhex(h))  # noqa: E731
    x = _f32(x)
    x = x if x >= c("-0x1.5f3334p+6") else c("-0x1.5f3334p+6")
    x = x if x <= c("0x1.633334p+6") else c("0x1.633334p+6")
    n = np.floor(_fmaf(x, c("0x1.715476p+0"), 0.5))
    n = _f32(min(max(n, -127.0), 127.0))
    r = _fmaf(-c("-0x1.bd0106p-13"), n, _fmaf(-c("0x1.63p-1"), n, x))
    p = _fmaf(r, c("0x1.a0d2cep-13"), c("0x1.6e879cp-10"))
    for k in ("0x1.11121p-7", "0x1.555382p-5", "0x1.555554p-3", "0x1p-1"):
        p = _fmaf(p, r, c(k))
    y = _f32(1.0) + _fmaf(p, r * r, r)
    with np.errstate(over="ignore"):
        return _f32(y * np.array([(int(n) + 127) << 23], np.uint32).view(np.float32)[0])


def _uniform_at(step: int) -> np.float32:
    """uniform(fold_in(PRNGKey(0), step)) of the reference's counter-based
    draw, bit for bit: the key (0, 0) folded with the step, then one 32-bit
    draw (counter (0, 0), the two words xor'ed) as a mantissa in [1, 2)."""
    k = _threefry2x32(0, 0, 0, step & 0xFFFFFFFF)
    b1, b2 = _threefry2x32(k[0], k[1], 0, 0)
    bits = (int(b1 ^ b2) >> 9) | 0x3F800000
    return np.array([bits], np.uint32).view(np.float32)[0] - _f32(1.0)


def lr_schedule(cfg: TrainConfig):
    """darknet's LR policies (get_current_rate): burn-in
    lr*(t/burn_in)^power, then constant / step / steps / exp / poly / random
    / sig.  ``random`` is a counter-based draw per step (resume-stable).
    Returns lr(step) -> float, equal to the reference's float32 value."""
    base = _f32(cfg.learning_rate)
    if cfg.policy not in ("constant", "step", "steps", "exp", "poly", "random", "sig"):
        raise ValueError(f"unknown LR policy {cfg.policy!r}")

    def lr(step: int) -> float:
        step = int(step)
        stepf = _f32(step)
        if step < cfg.burn_in:
            return float(base * _powf(stepf / _f32(max(cfg.burn_in, 1)), cfg.power))
        if cfg.policy == "constant":
            rate = base
        elif cfg.policy == "step":
            rate = base * _powf(cfg.lr_scale, np.floor(stepf / _f32(max(cfg.lr_step, 1))))
        elif cfg.policy == "steps":
            # the scale applies at the boundary step itself
            rate = base
            for s, sc in zip(cfg.lr_steps, cfg.lr_scales):
                if step >= s:
                    rate = rate * _f32(sc)
        elif cfg.policy == "exp":
            rate = base * _powf(cfg.gamma, stepf)
        elif cfg.policy == "poly":
            rate = base * _powf(max(_f32(1.0) - stepf / _f32(max(cfg.max_batches, 1)), _f32(0.0)),
                                cfg.power)
        elif cfg.policy == "random":
            rate = base * _powf(_uniform_at(step), cfg.power)
        else:  # sig
            rate = base / (_f32(1.0) + _expf_xla(_f32(cfg.gamma) * (stepf - _f32(cfg.lr_step))))
        return float(rate)

    return lr


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _decay_mask(params) -> dict[int, dict[str, bool]]:
    """Weight decay applies to conv kernels only (darknet's update rule)."""
    return {i: {k: (k == "w") for k in p} for i, p in params.items()}


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """SGD with momentum (or Adam) over the trainable tensors, in two groups:
    the conv kernels with weight decay, the rest without.  The rate is set
    per step by the train step."""
    mask = _decay_mask(params)
    decayed, plain = [], []
    for i, p in params.items():
        for k, t in p.items():
            if k in TRAINABLE:
                (decayed if mask[i][k] else plain).append(t)
    groups = [{"params": decayed, "weight_decay": cfg.weight_decay},
              {"params": plain, "weight_decay": 0.0}]
    if cfg.adam:
        return torch.optim.Adam(groups, lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps)
    return torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum, dampening=0.0)


@torch.no_grad()
def _prune_step(net: NetworkDef, cfg: TrainConfig, params, optimizer) -> torch.Tensor:
    """Conv kernel weights with |w| < threshold are zeroed in place together
    with their momentum (SGD's momentum buffer, which exists from the first
    update on, or Adam's first moment), just before the update.  Returns the
    zeroed fraction as a 0-d tensor, over the whole tensors when FSDP2
    shards them."""
    zeros, total = None, 0
    for i, s in enumerate(net.specs):
        if not (isinstance(s, ConvSpec) and i in params):
            continue
        w = params[i]["w"]
        pruned = torch.abs(w) < cfg.prune_threshold
        w.masked_fill_(pruned, 0.0)
        st = optimizer.state.get(w, {})
        for name in ("momentum_buffer", "exp_avg"):
            if st.get(name) is not None:
                st[name].masked_fill_(pruned, 0.0)
        n = torch.sum(pruned)
        n = n.full_tensor() if isinstance(n, DTensor) else n
        zeros = n if zeros is None else zeros + n
        total += w.numel()
    return zeros.to(torch.float32) / zeros.new_tensor(float(max(total, 1)), dtype=torch.float32)


def init_train_state(net: NetworkDef, cfg: TrainConfig, seed: int = 0, device=None) -> TrainState:
    """Params (a ``NetParams`` module) from ``init_params_numpy(seed)``,
    unseen ranges (the input seeded from ``cfg.input_calibration``), a fresh
    optimizer, step 0."""
    device = resolve_device(device, "init_train_state")
    params = NetParams(net, params_to_torch(init_params_numpy(seed, net), device))
    qs = quant_state_to_torch(init_quant_state(net, cfg.input_calibration), device)
    return TrainState(params, make_optimizer(cfg, params), qs, 0, 0)


def run_forward(net: NetworkDef, state: TrainState, images, mode: ForwardMode, quant_state=None,
                generator: torch.Generator | None = None, return_outputs: bool = False):
    """The forward of a train step: through ``state.model`` (DDP or FSDP2,
    whose hooks must run) or a ``NetParams`` module where there is one,
    else over the params dict."""
    runner = state.model if state.model is not None else state.params
    if isinstance(runner, torch.nn.Module):
        return runner(images, mode, quant_state, generator, return_outputs)
    return forward(net, runner, images, mode, quant_state, return_outputs, generator)


@torch.no_grad()
def roll_bn_stats(params, bn_stats) -> None:
    """darknet's BN rolling statistics after the update, in place:
    .99 * rolling + .01 * batch (src/batchnorm_layer.c:143-146)."""
    for i, (mean, var) in bn_stats.items():
        p = params[i]
        p["mean"].copy_(BN_ROLLING_DECAY * p["mean"] + (1 - BN_ROLLING_DECAY) * mean)
        p["var"].copy_(BN_ROLLING_DECAY * p["var"] + (1 - BN_ROLLING_DECAY) * var)


def to_device(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """numpy or tensor -> ``dtype`` on ``device``, through pinned memory
    from the host to a card."""
    t = torch.as_tensor(a, dtype=dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_train_step(net: NetworkDef, cfg: TrainConfig, qat: bool,
                    learned_ranges: bool = False, freeze_ranges: bool = False, group=None):
    """The step of one phase (float warm-up / EMA-QAT / learned-range QAT /
    frozen-range QAT): step(state, images, truths) -> (state, metrics).

    Images (B, H, W, 3) float32 and truths (B, MAX_BOXES, 5) are tensors on
    the state's device.  The optimizer updates the parameter tensors in
    place; the returned state carries the new ranges, step and seen.
    ``metrics["loss"]`` (and ``"sparsity"`` when pruning) are 0-d device
    tensors, ``metrics["lr"]`` the rate used.  Dropout (and the training
    crop) draw from ``generator``; without one they are the identity, as in
    the reference's step.  With a data-parallel ``group`` the images are
    this rank's rows of the global batch: batch statistics, ranges, dropout
    masks, the learned ranges' gradients and ``seen`` are the global
    batch's.
    """
    mode = ForwardMode(
        train=True, qat=qat, update_ranges=qat and not learned_ranges and not freeze_ranges,
        compute_dtype=cfg.compute_dtype, range_stat=cfg.range_stat, learned_ranges=learned_ranges,
        group=group,
    )
    _, world = pmesh.rank_world(group)
    lr_fn = lr_schedule(cfg)

    def step(state: TrainState, images: torch.Tensor, truths: torch.Tensor,
             generator: torch.Generator | None = None):
        opt = state.opt_state
        lr = lr_fn(state.step)
        for pg in opt.param_groups:
            pg["lr"] = lr
        opt.zero_grad(set_to_none=True)
        qs_in = state.quant_state
        if learned_ranges:
            qs_in = {k: {n: v.detach().requires_grad_(True) for n, v in st.items()}
                     for k, st in qs_in.items()}
        heads, aux = run_forward(net, state, images, mode, qs_in, generator)
        loss, _ = total_loss(heads, truths, net, input_hw=tuple(images.shape[1:3]), seen=state.seen)
        loss.backward()
        metrics = {"loss": pmesh.global_mean(loss.detach(), group), "lr": lr}
        if cfg.prune:
            with torch.profiler.record_function("train_state_update"):
                metrics["sparsity"] = _prune_step(net, cfg, state.params, opt)
        opt.step()
        with torch.no_grad(), torch.profiler.record_function("train_state_update"):
            roll_bn_stats(state.params, aux["bn_stats"])
            if learned_ranges:
                # sign-SGD with clamps that keep the nudge well defined:
                # min <= 0, max >= 1e-3.  The ranges are not module
                # parameters, so DDP does not reduce their gradients: the
                # sum over ranks has the sign of the global batch's
                rate = float(_f32(cfg.range_lr))
                flat = [(name, k, r) for name, st in qs_in.items() for k, r in st.items()]
                grads = torch.stack([r.grad if r.grad is not None else torch.zeros_like(r)
                                     for _, _, r in flat])
                if world > 1:
                    torch.distributed.all_reduce(grads, group=group)
                quant_state = {name: {} for name in qs_in}
                for (name, k, r), g in zip(flat, grads):
                    v = r.detach() - rate * torch.sign(g)
                    quant_state[name][k] = (torch.minimum(v, v.new_tensor(0.0)) if k == "min"
                                            else torch.maximum(v, v.new_tensor(1e-3)))
            elif qat:
                quant_state = {k: {n: v.detach() for n, v in st.items()}
                               for k, st in aux["quant_state"].items()}
            else:
                quant_state = state.quant_state
        new_state = state._replace(opt_state=opt, quant_state=quant_state, step=state.step + 1,
                                   seen=state.seen + images.shape[0] * world)
        return new_state, metrics

    return step


class Trainer:
    """Host-side loop that selects the step by the global step count: float
    before ``quant_start_step``, then EMA-QAT, then learned-range or
    frozen-range QAT when configured.

    Runs on the GPU unless ``device`` says otherwise (``"cpu"``), and raises
    where there is no GPU and no device was given.  Params come from
    ``init_params_numpy(seed)``, and dropout's masks from a generator on
    the device seeded with ``seed``.  ``step`` takes numpy or torch batches
    and moves them to the device (through pinned memory on CUDA).
    Multi-scale training is a batch of another size: the graph is
    shape-free.

    With a device ``mesh`` (``parallel/distributed.py::global_mesh``) the
    trainer is data-parallel over its ``data`` dimension: params wrapped in
    DDP, or sharded by FSDP2 with ``fsdp``; ``step`` then takes this rank's
    rows of the global batch (``parallel/mesh.py::shard_batch``), and every
    rank's generator draws the same numbers.
    """

    def __init__(self, net: NetworkDef, cfg: TrainConfig, seed: int = 0, device=None,
                 mesh=None, fsdp: bool = False):
        self.net = net
        self.cfg = cfg
        self.device = resolve_device(device, "Trainer")
        self.state, self.group = pmesh.data_parallel(init_train_state(net, cfg, seed, self.device), mesh, fsdp)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._float_step = make_train_step(net, cfg, qat=False, group=self.group)
        self._qat_step = make_train_step(net, cfg, qat=True, group=self.group)
        self._learned_step = None  # built on first use
        self._frozen_step = None

    def step(self, images, truths):
        step_i = self.state.step
        cfg = self.cfg
        if step_i < cfg.quant_start_step:
            fn = self._float_step
        elif cfg.learned_ranges and step_i >= cfg.quant_start_step + cfg.range_warmup:
            if self._learned_step is None:
                self._learned_step = make_train_step(self.net, cfg, qat=True, learned_ranges=True,
                                                     group=self.group)
            fn = self._learned_step
        elif (cfg.freeze_ranges_after is not None
              and step_i >= cfg.quant_start_step + cfg.freeze_ranges_after):
            if self._frozen_step is None:
                self._frozen_step = make_train_step(self.net, cfg, qat=True, freeze_ranges=True,
                                                    group=self.group)
            fn = self._frozen_step
        else:
            fn = self._qat_step
        self.state, metrics = fn(self.state, to_device(images, self.device), to_device(truths, self.device),
                                 self.generator)
        return metrics


def multiscale_resolutions(base: int = 416, lo: int = 320, hi: int = 608,
                           stride: int = 32) -> tuple[int, ...]:
    """darknet's random-dim set: multiples of 32 in [320, 608]."""
    del base
    return tuple(range(lo, hi + 1, stride))
