"""Checkpoint / resume of a TrainState, with darknet's cadence.

The counterpart of ``yolo_quantization_tpu/train/checkpoint.py``: the whole
state (params, optimizer state, EMA ranges, step, seen) round-trips, so a
resume continues in the same QAT phase at the same point of the LR
schedule.  Each save is ``<ckpt_dir>/<step>/state.pt`` (torch state dicts
and CPU tensors), written to a temporary directory and renamed into place;
the newest ``max_to_keep`` steps stay.  Model interchange with darknet
and the JAX package is ``.weights`` I/O (``models/darknet_weights.py``).

A state sharded by FSDP2 is saved whole: the params as the module's full
state dict (``get_model_state_dict(..., full_state_dict=True)``) and each
optimizer tensor gathered, in the same file format, so restoring and
``export`` read it as any other.  Every rank of the group calls
``save_checkpoint`` (the gathers are collectives) and rank 0 writes.
"""

from __future__ import annotations

import os
import shutil

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from yolo_quantization_tpu_torch.train.qat import TrainState

_FILE = "state.pt"


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, _FILE)))


def _cpu(tree):
    return {k: {n: v.detach().cpu().clone() for n, v in d.items()} for k, d in tree.items()}


def _whole_params(params):
    """{layer: {name: CPU tensor}}; a sharded module through its full state
    dict (keys ``layers.<i>.<name>``)."""
    if isinstance(params, torch.nn.Module) and any(isinstance(p, DTensor) for p in params.parameters()):
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        full = get_model_state_dict(params, options=StateDictOptions(full_state_dict=True))
        out: dict = {}
        for key, v in full.items():
            _, i, name = key.split(".")
            out.setdefault(int(i), {})[name] = v.detach().cpu().clone()
        return out
    return _cpu(params)


def _whole_optimizer(opt):
    sd = opt.state_dict()
    sd["state"] = {i: {k: (v.full_tensor() if isinstance(v, DTensor) else v) for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int | None = None,
                    max_to_keep: int = 5) -> None:
    step = int(state.step) if step is None else int(step)
    params, optimizer = _whole_params(state.params), _whole_optimizer(state.opt_state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({
        "params": params,
        "optimizer": optimizer,
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
    its parameter tensors take the saved values in place on their device
    (each rank its shard of a tensor FSDP2 shards), its optimizer the saved
    state; the ranges, step and seen come back in the returned state, which
    keeps the template's DDP or FSDP2 model."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    saved = torch.load(os.path.join(ckpt_dir, str(step), _FILE), map_location="cpu",
                       weights_only=True)
    for i, p in template.params.items():
        for k, t in p.items():
            t.copy_(_like(saved["params"][i][k], t))
    opt = template.opt_state
    opt.load_state_dict(saved["optimizer"])
    for p, st in opt.state.items():
        st.update({k: _like(v, p) for k, v in st.items() if torch.is_tensor(v) and v.shape == p.shape})
    device = next(iter(template.params[next(iter(template.params))].values())).device
    qs = {k: {n: v.to(device) for n, v in d.items()} for k, d in saved["quant_state"].items()}
    return template._replace(quant_state=qs, step=saved["step"], seen=saved["seen"])


def _like(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A whole saved tensor placed as ``t`` is: its shard where ``t`` is a
    sharded DTensor, else on ``t``'s device."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(v.full_tensor() if isinstance(v, DTensor) else v.to(t.device),
                                 t.device_mesh, t.placements)
    return v.to(t.device)


def checkpoint_cadence(step: int) -> bool:
    """darknet's cadence: every 100 steps below 1000, then every 10000."""
    if step < 1000:
        return step % 100 == 0
    return step % 10000 == 0
