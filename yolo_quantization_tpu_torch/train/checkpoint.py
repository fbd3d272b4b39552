"""Checkpoint / resume of a TrainState, with darknet's cadence.

The counterpart of ``yolo_quantization_tpu/train/checkpoint.py``: the whole
state (params, optimizer state, EMA ranges, step, seen) round-trips, so a
resume continues in the same QAT phase at the same point of the LR
schedule.  Each save is ``<ckpt_dir>/<step>/state.pt`` (torch state dicts
and CPU tensors), written to a temporary directory and renamed into place;
the newest ``max_to_keep`` steps stay.  Model interchange with the JAX
package is darknet ``.weights`` I/O (ROADMAP queue 1.8).
"""

from __future__ import annotations

import os
import shutil

import torch

from yolo_quantization_tpu_torch.train.qat import TrainState

_FILE = "state.pt"


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, _FILE)))


def _cpu(tree):
    return {k: {n: v.detach().cpu().clone() for n, v in d.items()} for k, d in tree.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int | None = None,
                    max_to_keep: int = 5) -> None:
    step = int(state.step) if step is None else int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({
        "params": _cpu(state.params),
        "optimizer": state.opt_state.state_dict(),
        "quant_state": _cpu(state.quant_state),
        "step": int(state.step),
        "seen": int(state.seen),
    }, os.path.join(tmp, _FILE))
    final = os.path.join(ckpt_dir, str(step))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, template: TrainState, step: int | None = None) -> TrainState:
    """Restore into ``template`` (from ``init_train_state`` or a Trainer):
    its parameter tensors take the saved values in place on their device,
    its optimizer the saved state; the ranges, step and seen come back in
    the returned state."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    saved = torch.load(os.path.join(ckpt_dir, str(step), _FILE), map_location="cpu",
                       weights_only=True)
    for i, p in template.params.items():
        for k, t in p.items():
            t.copy_(saved["params"][i][k])
    template.opt_state.load_state_dict(saved["optimizer"])
    device = next(iter(template.params[next(iter(template.params))].values())).device
    qs = {k: {n: v.to(device) for n, v in d.items()} for k, d in saved["quant_state"].items()}
    return TrainState(template.params, template.opt_state, qs, saved["step"], saved["seen"])


def checkpoint_cadence(step: int) -> bool:
    """darknet's cadence: every 100 steps below 1000, then every 10000."""
    if step < 1000:
        return step % 100 == 0
    return step % 10000 == 0
