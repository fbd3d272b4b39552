"""Layer-by-layer comparison of the QAT forward and backward on two devices.

A whole QAT forward cannot be compared element by element between two
implementations, or between two devices: a conv output that differs by an
ulp moves a fake-quant code by one step now and then, the next layer
carries the step on, and a folded-BN weight that lands on the other side of
its grid moves a whole channel.  The reference's own jitted and eager
forwards disagree on most head elements in the QAT training modes for this
reason.  So each layer is run on both sides from the same inputs (the
reference side's inputs), and its output, range update, batch statistics
and vector-Jacobian product are compared; the cotangent of a layer is the
reference's gradient of the yolo loss with respect to its output, so the
gradients have the loss's scale, zeroed at outputs that sit on an
activation's kink (``kink_safe_cotangent``) or at an output where an ulp
decides its fake-quant differently on the two devices, at its range's edge
(``fake_quant_safe_cotangent``).  A folded weight at a rounding tie may take
the next code on one device (``weight_code_flips`` holds each such code to
its tie); the reference's pass then runs with the tested device's
fake-quantized weights, so nothing is excluded for it.

    python -m yolo_quantization_tpu_torch.tools.qat_check [--seeds N]

runs the comparison of the card against the CPU for yolov3-tiny at 416x416
(batch 4) in the float-train, EMA-QAT-train, QAT-eval and learned modes, on
the synthetic batches of seeds 1..N.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_quantization_tpu_torch.core.quant import QUANT_MAX, QUANT_MIN, nudge_min_max
from yolo_quantization_tpu_torch.nn.graph import (
    TRAINABLE,
    ConvSpec,
    ForwardMode,
    RouteSpec,
    ShortcutSpec,
    forward,
    input_forward,
    layer_forward,
)

# the acceptance rule of a compared tensor: within (rtol, atol) on at least
# SHARE of its elements, and (for a fake-quantized output) every element
# within one step of its layer's grid.  A gradient's atol is taken relative
# to the tensor's largest magnitude when that exceeds 1: a loss gradient is a
# sum of many terms, and its float32 summation error scales with them (the
# weight gradients of a 64x64 float-train conv reach 16, and two summation
# orders differ there by 5e-5 on the elements that cancel to near zero).
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5, scaled=True)
STATE_RTOL = 1e-5  # ranges and batch statistics; atol 1e-6 of the largest
SHARE = 0.999

MODES = {
    "float-train": ForwardMode(train=True),
    "ema-qat-train": ForwardMode(train=True, qat=True, update_ranges=True),
    "qat-eval": ForwardMode(train=False, qat=True),
    "learned": ForwardMode(train=True, qat=True, learned_ranges=True),
    "frozen": ForwardMode(train=True, qat=True),
}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def check_share(name: str, got, ref, rtol: float, atol: float, step: float | None = None,
                share: float = SHARE, scaled: bool = False) -> float:
    """Raise unless ``got`` is within (rtol, atol) of ``ref`` on at least
    ``share`` of the elements and, with ``step``, everywhere within one grid
    step; ``scaled`` multiplies atol by max(1, max|ref|).  Returns the share
    that is close."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if scaled and ref.size:
        atol = atol * max(1.0, float(np.abs(ref).max()))
    diff = np.abs(got - ref)
    close = diff <= atol + rtol * np.abs(ref)
    frac = float(np.mean(close)) if close.size else 1.0
    if frac < share:
        raise AssertionError(f"{name}: {frac:.6f} of elements within rtol={rtol}, atol={atol} "
                             f"(< {share}); max |diff| {diff.max():.3e}")
    if step is not None and diff.size and diff.max() > step * (1 + 1e-3) + atol:
        raise AssertionError(f"{name}: max |diff| {diff.max():.3e} exceeds one grid step {step:.3e}")
    return frac


def check_state(name: str, got, ref, rtol: float = STATE_RTOL) -> None:
    """Ranges and batch statistics: within rtol, with an atol of 1e-6 of the
    largest magnitude for a batch mean that cancels to near zero."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    atol = 1e-6 * float(np.abs(ref).max()) if ref.size else 0.0
    if got.shape != ref.shape or not np.allclose(got, ref, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: {got} != {ref} within rtol={rtol}, atol={atol:.2e}")


def grid_step(qs_range) -> float:
    """The step of the nudged grid of a {min, max} range."""
    lo, hi = (torch.tensor(_np(qs_range[n]), dtype=torch.float32) for n in ("min", "max"))
    return float(nudge_min_max(lo, hi).scale)


def output_range_key(net, i: int, qs) -> str | None:
    """The quant-state key whose grid layer i's output lies on, if any."""
    s = net.specs[i]
    key = f"act_{i}"
    if isinstance(s, (ConvSpec, RouteSpec, ShortcutSpec)) and key in qs:
        return key
    return None


def layer_inputs(net, i: int) -> list[int]:
    """Indices of the earlier layers' outputs layer i reads besides its input."""
    s = net.specs[i]
    if isinstance(s, RouteSpec):
        return list(s.layers)
    if isinstance(s, ShortcutSpec):
        return [s.index]
    return []


# where each activation's derivative jumps
KINKS = {"leaky": (0.0,), "relu": (0.0,), "relie": (0.0,), "ramp": (0.0,), "elu": (0.0,),
         "selu": (0.0,), "relu6": (0.0, 6.0), "leaky6": (0.0, 6.0), "hardtan": (-1.0, 1.0),
         "lhtan": (0.0, 1.0), "plse": (-4.0, 4.0)}


def kink_safe_cotangent(net, i: int, y_ref: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """The cotangent, zero where the reference's output of layer i lies
    within 1e-6 of its largest magnitude of one of the activation's kinks.
    There, which side of the kink the pre-activation falls on (gradient 1 or
    0.1 for leaky, pass or stop for relu6 and a fake-quant clamp at 0) is
    decided by an ulp of a conv output, and one such element moves its whole
    channel's bias, gamma and weight gradients by its own contribution."""
    kinks = KINKS.get(getattr(net.specs[i], "activation", None), ())
    if not kinks:
        return cot
    y = y_ref.detach().cpu()
    delta = 1e-6 * float(y.abs().max())
    near = torch.zeros(y.shape, dtype=torch.bool)
    for k in kinks:
        near |= (y - k).abs() <= delta
    return torch.where(near, torch.zeros_like(cot), cot.cpu()).to(cot.device)


def fake_quant_inputs(net, i: int, params, x, outputs, mode: ForwardMode, quant_state,
                      device) -> dict:
    """What layer i's fake-quants see when it runs on ``device`` from the
    given inputs (recorded through ``layer_forward``'s ``fq_hook``):
    ``"act"``, the (value, min, max) its output fake-quant receives (the
    last activation fake-quant it calls: a conv at a float -> quant boundary
    fake-quantizes its input first), and ``"w"``, its conv's (folded,
    fake-quantized) weights; None where the layer has none."""
    rec = {"act": None, "w": None}
    if not mode.qat:
        return rec

    def record(kind, out, *inputs):
        rec[kind] = (*(t.detach() for t in inputs), out.detach()) if kind == "w" else \
            tuple(t.detach() for t in inputs)
        return out

    dev = torch.device(device)
    p = {i: {k: v.detach().to(dev) for k, v in params[i].items()}} if i in params else {}
    outs = [None if o is None else o.detach().to(dev) for o in outputs[:i]]
    qs = {k: {n: v.detach().to(dev) for n, v in st.items()} for k, st in quant_state.items()}
    with torch.no_grad():
        layer_forward(net, i, p, x.detach().to(dev), outs, mode, qs, {}, fq_hook=record)
    if output_range_key(net, i, quant_state) is None:
        rec["act"] = None
    return rec


def _gate(v: torch.Tensor, lo, hi) -> tuple[torch.Tensor, torch.Tensor]:
    """The straight-through gate of ``v`` under the nudged range of [lo,
    hi], and whether ``v`` lies within one float32 ulp (at the tensor's
    largest magnitude) of one of the range's two edges."""
    qp = nudge_min_max(lo, hi)
    edges = [float((q - qp.zero_point).to(torch.float32) * qp.scale) for q in (QUANT_MIN, QUANT_MAX)]
    ulp = float(np.spacing(np.float32(max(float(v.abs().max()), *map(abs, edges)))))
    v = v.to(torch.float64)
    return (v >= edges[0]) & (v <= edges[1]), ((v - edges[0]).abs() <= ulp) | ((v - edges[1]).abs() <= ulp)


# a weight code may differ between the devices only where the reference's
# folded weight lies within TIE_TOL of a code step of a rounding tie (the
# devices' batch statistics, and so their folded weights, differ by about
# 1e-6 relative: 1e-4 of a step at most), and then by one step
TIE_TOL = 1e-3
# the largest share of a layer's cotangent ``fake_quant_safe_cotangent`` may
# zero: no more than the gradient rule itself lets fail
MAX_EXCLUDED = 1 - SHARE


def weight_step(w_folded: torch.Tensor, symmetric: bool) -> torch.Tensor:
    """The per-output-channel code step of the weight fake-quant."""
    if symmetric:
        absmax = torch.amax(w_folded.abs(), dim=(0, 1, 2))
        return torch.where(absmax > 0, absmax, torch.ones_like(absmax)) / 127
    return nudge_min_max(torch.amin(w_folded, dim=(0, 1, 2)), torch.amax(w_folded, dim=(0, 1, 2))).scale


def weight_code_flips(ref: dict, test: dict, symmetric: bool) -> int:
    """The number of weight codes that differ between the two devices'
    records (``fake_quant_inputs``).  Raises unless each differs by one
    step and the reference's folded weight lies at that step's rounding
    tie: there an ulp of the folded weight decides the code."""
    if ref["w"] is None:
        return 0
    w, wr = (t.cpu().to(torch.float64) for t in ref["w"])
    wt = test["w"][1].cpu().to(torch.float64)
    step = weight_step(ref["w"][0].cpu(), symmetric).to(torch.float64)
    d = wt - wr
    flipped = d.abs() > step / 4  # ulp-level scale differences stay far below
    one_step = (d.abs() - step).abs() <= TIE_TOL * step
    at_tie = ((w - wr).abs() - step / 2).abs() <= TIE_TOL * step
    toward = torch.sign(w - wr) == torch.sign(d)
    bad = flipped & ~(one_step & at_tie & toward)
    if bad.any():
        k = tuple(int(v) for v in torch.nonzero(bad)[0])
        raise AssertionError(f"{int(bad.sum())} of {bad.numel()} weight codes differ between the devices "
                             f"off a rounding tie, e.g. at {k}: reference {float(wr[k]):.8e} (folded "
                             f"{float(w[k]):.8e}), tested {float(wt[k]):.8e}, step {float(step[k[-1]]):.3e}")
    return int(flipped.sum())


def fake_quant_safe_cotangent(ref: dict, test: dict, cot: torch.Tensor) -> tuple[torch.Tensor, float]:
    """The cotangent of a layer, the same for both devices, zero at the
    output elements where an ulp decides its output fake-quant differently
    on the two (``fake_quant_inputs`` records): those whose straight-through
    gate differs, or whose value differs between the devices and lies
    within an ulp of its range's nudged edge on either; which side such an
    element falls (and in learned mode which range gradient it feeds) is
    decided by that ulp.  Raises if more than ``MAX_EXCLUDED`` of the
    elements are zeroed.  Returns the cotangent and the share zeroed."""
    if ref["act"] is None:
        return cot, 0.0
    (vr, *range_r), (vt, *range_t) = ([t.detach().cpu() for t in rec["act"]] for rec in (ref, test))
    (gate_r, near_r), (gate_t, near_t) = _gate(vr, *range_r), _gate(vt, *range_t)
    zero = (gate_r != gate_t) | ((vr != vt) & (near_r | near_t))
    share = float(zero.to(torch.float64).mean())
    if share > MAX_EXCLUDED:
        raise AssertionError(f"{share:.3e} of the output's elements sit where an ulp decides the "
                             f"fake-quant differently on the two devices (> {MAX_EXCLUDED:.0e})")
    return torch.where(zero, torch.zeros_like(cot.cpu()), cot.cpu()).to(cot.device), share


def layer_pass(net, i: int, params, x, outputs, mode: ForwardMode, quant_state, cotangent,
               device, weights: torch.Tensor | None = None) -> dict:
    """Layer i on ``device`` from the given inputs: its output, range
    updates, batch statistics, and the VJP of ``cotangent`` into its
    parameters, its input, the earlier outputs it reads and (learned mode)
    its ranges.  ``weights``: fake-quantized conv weights to use in place of
    the layer's own, with their straight-through gradient kept."""
    dev = torch.device(device)
    p = {i: {k: v.detach().to(dev).clone().requires_grad_(k in TRAINABLE)
             for k, v in params[i].items()}} if i in params else {}
    xin = x.detach().to(dev).clone().requires_grad_(True)
    reads = layer_inputs(net, i)
    outs = [None] * i
    for j in reads:
        outs[j] = outputs[j].detach().to(dev).clone().requires_grad_(True)
    qs = {k: {n: v.detach().to(dev).clone().requires_grad_(mode.learned_ranges)
              for n, v in st.items()} for k, st in quant_state.items()} if quant_state else None
    qs_in = dict(qs) if qs is not None else None
    bn_stats = {}

    def use_weights(kind, out, *inputs):
        return out + (weights.to(dev) - out).detach() if kind == "w" else out

    y = layer_forward(net, i, p, xin, outs, mode, qs, bn_stats,
                      fq_hook=use_weights if weights is not None else None)
    out = {"y": y.detach(), "bn_stats": {k: tuple(t.detach() for t in v) for k, v in bn_stats.items()},
           "ranges": {k: {n: v.detach() for n, v in st.items()} for k, st in (qs or {}).items()
                      if qs_in is not None and st is not qs_in.get(k)}}
    if y.requires_grad:
        y.backward(cotangent.to(dev))
    out["grads"] = {f"p.{k}": t.grad for k, t in p.get(i, {}).items() if t.grad is not None}
    if xin.grad is not None:
        out["grads"]["x"] = xin.grad
    for j in reads:
        if outs[j].grad is not None:
            out["grads"][f"out{j}"] = outs[j].grad
    if mode.learned_ranges and qs is not None:
        for k, st in qs_in.items():
            for n, v in st.items():
                if v.grad is not None:
                    out["grads"][f"{k}.{n}"] = v.grad
    return out


def check_pass(net, i: int, mode: ForwardMode, got: dict, ref: dict, quant_state) -> dict:
    """Layer i's pass on the device under test against the reference's
    (``layer_pass`` dicts): the output by the value rule (within one grid
    step where it is fake-quantized), the range updates and batch
    statistics within STATE_RTOL, every gradient by the gradient rule.
    Returns the smallest close shares."""
    key = output_range_key(net, i, quant_state or {})
    step = None
    if mode.qat and key is not None:
        step = grid_step(ref["ranges"].get(key, quant_state[key]))
    shares = {"value": check_share(f"layer {i} output", got["y"], ref["y"], **VALUE_TOL, step=step),
              "grad": 1.0}
    if set(got["ranges"]) != set(ref["ranges"]):
        raise AssertionError(f"layer {i}: range updates {sorted(got['ranges'])} != {sorted(ref['ranges'])}")
    for k in ref["ranges"]:
        for n in ("min", "max"):
            check_state(f"layer {i} range {k}.{n}", got["ranges"][k][n], ref["ranges"][k][n])
    if set(got["bn_stats"]) != set(ref["bn_stats"]):
        raise AssertionError(f"layer {i}: batch statistics present on one side only")
    for k, (m, v) in ref["bn_stats"].items():
        check_state(f"layer {i} batch mean", got["bn_stats"][k][0], m)
        check_state(f"layer {i} batch var", got["bn_stats"][k][1], v)
    if set(got["grads"]) != set(ref["grads"]):
        raise AssertionError(f"layer {i}: gradients {sorted(got['grads'])} != {sorted(ref['grads'])}")
    for k, g in ref["grads"].items():
        shares["grad"] = min(shares["grad"], check_share(f"layer {i} grad {k}", got["grads"][k], g,
                                                         **GRAD_TOL))
    return shares


def reference_pass(net, params, x, mode: ForwardMode, quant_state, device, truths, seen=None):
    """The whole forward and the loss's backward on ``device``: the
    fake-quantized input, every layer's output and the loss's gradient
    with respect to it (``seen`` gates the region loss's warm-up), the
    shared inputs and cotangents of the per-layer comparison."""
    from yolo_quantization_tpu_torch.train.loss import total_loss

    dev = torch.device(device)
    p = {i: {k: v.detach().to(dev) for k, v in d.items()} for i, d in params.items()}
    qs = ({k: {n: v.detach().to(dev) for n, v in st.items()} for k, st in quant_state.items()}
          if quant_state else None)
    xin = x.detach().to(dev).requires_grad_(True)
    heads, aux = forward(net, p, xin, mode, qs, return_outputs=True)
    for o in aux["outputs"]:
        o.retain_grad()
    total_loss(heads, truths.to(dev), net, seen=seen)[0].backward()
    cots = [o.grad.detach() if o.grad is not None else torch.zeros_like(o) for o in aux["outputs"]]
    return aux["input"].detach(), [o.detach() for o in aux["outputs"]], cots


def compare_devices(net, params, x, truths, mode: ForwardMode, quant_state, ref_device, test_device,
                    log=None, seen=None) -> dict:
    """Every layer of ``net`` on ``test_device`` against ``ref_device`` from
    the reference's inputs and loss cotangents (``truths`` the batch's
    boxes, ``seen`` the images-seen count the loss reads).  Raises on the
    first tensor outside its rule; returns the smallest close share seen
    per kind, under ``"excluded"`` the largest share of a layer's cotangent
    that ``fake_quant_safe_cotangent`` zeroed, and under ``"code_flips"``
    the weight codes, each at a rounding tie, that differ between the
    devices.  The reference's pass of each layer runs with the tested
    device's fake-quantized weights, so such a code moves no gradient."""
    x0, outputs, cots = reference_pass(net, params, x, mode, quant_state, ref_device, truths, seen)
    cots = [kink_safe_cotangent(net, i, y, c) for i, (y, c) in enumerate(zip(outputs, cots))]
    worst = {"value": 1.0, "grad": 1.0, "excluded": 0.0, "code_flips": 0}
    qs_cpu = ({k: {n: v.detach().cpu() for n, v in st.items()} for k, st in quant_state.items()}
              if quant_state else None)
    test_weights = [None] * len(net.specs)
    for i in range(len(net.specs)):
        x_in = x0 if i == 0 else outputs[i - 1]
        ref, test = (fake_quant_inputs(net, i, params, x_in, outputs, mode, qs_cpu, dev)
                     for dev in (ref_device, test_device))
        worst["code_flips"] += weight_code_flips(ref, test, mode.symmetric_w)
        test_weights[i] = test["w"][1] if test["w"] is not None else None
        cots[i], share = fake_quant_safe_cotangent(ref, test, cots[i])
        worst["excluded"] = max(worst["excluded"], share)
    # the input's fake-quant and range update
    ins = {}
    for dev in (test_device, ref_device):
        qs = ({k: {n: v.to(dev) for n, v in st.items()} for k, st in qs_cpu.items()}
              if qs_cpu else None)
        ins[dev] = (input_forward(x.to(dev), mode, qs), qs)
    (xi_t, qs_t), (xi_r, qs_r) = ins[test_device], ins[ref_device]
    step = grid_step(qs_r["input"]) if mode.qat else None
    worst["value"] = min(worst["value"], check_share("input", xi_t, xi_r, **VALUE_TOL, step=step))
    if mode.qat:
        for n in ("min", "max"):
            check_state(f"input range {n}", qs_t["input"][n], qs_r["input"][n])
    for i in range(len(net.specs)):
        x_in = x0 if i == 0 else outputs[i - 1]
        got = layer_pass(net, i, params, x_in, outputs, mode, qs_cpu, cots[i], test_device)
        ref = layer_pass(net, i, params, x_in, outputs, mode, qs_cpu, cots[i], ref_device, test_weights[i])
        shares = check_pass(net, i, mode, got, ref, qs_cpu)
        for k in shares:
            worst[k] = min(worst[k], shares[k])
        if log:
            log(f"    layer {i:3d} {type(net.specs[i]).__name__:12s}: output, "
                f"{len(ref['ranges'])} range(s), {len(ref['bn_stats'])} BN stat pair(s), "
                f"{len(ref['grads'])} gradient(s) within the rules")
    return worst


def main(argv: list[str] | None = None) -> int:
    """The card against the CPU, yolov3-tiny at 416x416, batch 4, on the
    synthetic batches of seeds 1..--seeds (default 1)."""
    import argparse

    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn.graph import init_params_numpy, params_to_torch

    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch

    ap = argparse.ArgumentParser(prog="python -m yolo_quantization_tpu_torch.tools.qat_check")
    ap.add_argument("--seeds", type=int, default=1, help="batches of seeds 1..N")
    args = ap.parse_args(argv)
    net = zoo.yolov3_tiny(classes=5)
    params = params_to_torch(init_params_numpy(0, net), "cpu")
    for seed in range(1, args.seeds + 1):
        images, truths = synthetic_batch(np.random.default_rng(seed), 4, 416, 5)
        x, t = torch.from_numpy(images), torch.from_numpy(truths)
        qs = calibrated_ranges(net, params, x)
        for name in ("float-train", "ema-qat-train", "qat-eval", "learned"):
            worst = compare_devices(net, params, x, t, MODES[name], qs, "cpu", "cuda")
            print(f"seed {seed} {name}: every layer within the rules; {worst}", flush=True)
    return 0


def calibrated_ranges(net, params, x):
    """Ranges from an EMA-tracking forward over ``x`` (unseen ranges would
    nudge to [0, 1]), each end scaled by its own factor in [0.8, 0.9).  A
    range fresh from a batch ends exactly at that batch's extreme element,
    so the straight-through gate of that element is decided by an ulp of its
    value, and so is its whole contribution to its channel's gradients;
    mid-training ranges are EMA averages, off the current batch's extremes.
    Distinct factors keep a route's or shortcut's range off its inputs' grid
    points (one common factor would put the route's end on its input's top
    code)."""
    from yolo_quantization_tpu_torch.nn.graph import init_quant_state, quant_state_to_torch

    qs = quant_state_to_torch(init_quant_state(net), x.device)
    with torch.no_grad():
        _, aux = forward(net, params, x, MODES["ema-qat-train"], qs)
    out = {}
    for j, (k, st) in enumerate(sorted(aux["quant_state"].items())):
        f_lo, f_hi = (0.8 + 0.1 * ((2 * j + d) * 0.6180339887 % 1.0) for d in (0, 1))
        out[k] = {"min": st["min"] * f_lo, "max": st["max"] * f_hi}
    return out


if __name__ == "__main__":
    raise SystemExit(main())
