"""Data parallelism: the rank's device, its rows of a global batch, DDP, and
the global-batch statistics a data-parallel step needs.

The counterpart of ``yolo_quantization_tpu/parallel/mesh.py``.  The JAX
step is one jitted program over the global batch: GSPMD computes the BN
batch statistics, the activation ranges and the loss over every row.  Here
each rank runs the same step on its rows, so every quantity the step takes
over the batch is taken over the global batch explicitly:

- BN batch statistics in two passes (the sum, then the sum of squared
  deviations from the global mean), through an all-reduce whose
  gradient is the all-reduce of the gradient, so the backward is the
  global batch's too;
- minmax ranges by an all-reduce of (-min, max) under MAX;
- percentile ranges from the global batch's strided subsample: each rank
  takes the elements whose global index is a multiple of the stride and
  the ranks' samples are joined in rank order, which is exact;
- dropout masks as this rank's rows of the global batch's mask
  (``nn/layers.py::dropout``).

Every collective is an ``all_reduce`` (a gather is a zero-padded
all-reduce of the values' bits), the one collective that both NCCL and
gloo take on CUDA tensors, so both backends run the same code.  Too few
devices is an error: nothing falls back to the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from yolo_quantization_tpu_torch.nn import layers as L

# the subsample of a percentile range: every (n // SUBSAMPLE)-th element
SUBSAMPLE = 65536


def rank_world(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(device=None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (torchrun's variable, 0
    without it) unless ``device`` names the CPU.  Raises when the card it
    names is not there."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("data parallelism runs on the GPU unless device='cpu' is given, and "
                           "torch.cuda.is_available() is false")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device) if device is not None else torch.device("cuda", local)
    index = local if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank's device cuda:{index} does not exist: {torch.cuda.device_count()} "
                           "CUDA devices")
    return torch.device("cuda", index)


def shard_batch(group, *arrays):
    """This rank's rows of each global-batch array (numpy or tensor): rows
    [rank * n, (rank + 1) * n) with n = len / world.  A batch that does not
    split evenly raises: the loss is a mean over the local rows, averaged
    over ranks, which is the global mean only for equal shards."""
    rank, world = rank_world(group)
    out = []
    for a in arrays:
        if a.shape[0] % world:
            raise ValueError(f"global batch of {a.shape[0]} does not split evenly over {world} ranks")
        n = a.shape[0] // world
        out.append(a[rank * n : (rank + 1) * n])
    return tuple(out) if len(out) > 1 else out[0]


def data_parallel(state, mesh, fsdp: bool = False):
    """(state, group) for a trainer: with a device ``mesh``, the state
    wrapped in DDP (``replicate``) or sharded by FSDP2
    (``parallel/fsdp.py::shard_state``) over its ``data`` dimension, and
    that dimension's process group; without one, the state as it is and no
    group."""
    if mesh is None:
        if fsdp:
            raise ValueError("fsdp needs a device mesh")
        return state, None
    from yolo_quantization_tpu_torch.parallel import fsdp as pfsdp

    state = pfsdp.shard_state(mesh, state) if fsdp else replicate(mesh, state)
    return state, mesh.get_group("data")


def replicate(mesh, state):
    """The TrainState with its params module wrapped in DDP over the mesh's
    ``data`` dimension: gradients are averaged over the ranks in buckets.
    BN buffers are not broadcast: every rank updates them with the global
    batch statistics."""
    from torch.nn.parallel import DistributedDataParallel

    group = mesh.get_group("data")
    p = next(iter(state.params.parameters()))
    ddp = DistributedDataParallel(
        state.params, process_group=group, broadcast_buffers=False,
        device_ids=[p.device.index] if p.device.type == "cuda" else None)
    return state._replace(model=ddp)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient is the sum of the ranks' gradients
    (each rank's loss depends on every rank's contribution)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.float16: torch.int16,
         torch.bfloat16: torch.int16}


def gather_cat(t: torch.Tensor, group, dim: int = 0, sizes: list[int] | None = None) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order, equal on
    every rank.  ``sizes`` (each rank's extent along ``dim``) defaults to
    this rank's, taken as every rank's.  A zero-padded all-reduce of the
    values' bits (integer sums of one value and zeros), so each value comes
    through exactly, signed zeros and NaNs included."""
    rank, world = rank_world(group)
    if world == 1:
        return t
    dim = dim % t.dim()
    sizes = sizes or [t.shape[dim]] * world
    shape = list(t.shape)
    shape[dim] = sum(sizes)
    bits = t.view(_BITS[t.dtype]) if t.dtype in _BITS else t
    buf = bits.new_zeros(shape)
    start = sum(sizes[:rank])
    buf.narrow(dim, start, sizes[rank]).copy_(bits)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.view(t.dtype) if t.dtype in _BITS else buf


def global_mean(v: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean over equal shards: the
    global batch's mean (no gradient)."""
    _, world = rank_world(group)
    if world == 1:
        return v
    v = v.clone()
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    return v / v.new_tensor(float(world))


def _counts(n: int, group, device) -> list[int]:
    """Every rank's count ``n`` (a zero-padded all-reduce)."""
    return [int(v) for v in gather_cat(torch.tensor([n], dtype=torch.int64, device=device), group).tolist()]


# ---------------------------------------------------------------------------
# Global-batch statistics
# ---------------------------------------------------------------------------


def batch_stats(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NHWC ``x`` over (N, H, W) of
    the global batch, whose ranks hold equal shards (``shard_batch``).  One
    process: ``nn/layers.py::batch_stats``."""
    _, world = rank_world(group)
    if world == 1:
        return L.batch_stats(x)
    # a divisor on the device: CUDA multiplies by a host scalar's reciprocal
    count = x.new_tensor(float(x.numel() // x.shape[-1] * world))
    mean = all_reduce_sum(torch.sum(x, dim=(0, 1, 2)), group) / count
    var = all_reduce_sum(torch.sum((x - mean) ** 2, dim=(0, 1, 2)), group) / count
    return mean, var


def batch_minmax(y: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch's (min, max) as 0-d tensors (no gradient)."""
    lo, hi = torch.amin(y), torch.amax(y)
    _, world = rank_world(group)
    if world == 1:
        return lo, hi
    both = torch.stack([-lo, hi])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    return -both[0], both[1]


def strided_sample(flat: torch.Tensor, group) -> torch.Tensor:
    """Every (n // SUBSAMPLE)-th element of the global batch's flat array
    (n its length), in global order: rank r's elements start at global
    index r_offset, so it takes local index j where (r_offset + j) is a
    multiple of the stride, phase (-r_offset) mod stride."""
    rank, world = rank_world(group)
    if world == 1:
        return flat[:: max(flat.shape[0] // SUBSAMPLE, 1)]
    counts = _counts(flat.shape[0], group, flat.device)
    stride = max(sum(counts) // SUBSAMPLE, 1)
    offsets = np.cumsum([0] + counts[:-1])
    phases = [int((-o) % stride) for o in offsets]
    takes = [max(0, -(-(c - p) // stride)) for c, p in zip(counts, phases)]
    mine = flat[phases[rank] :: stride]
    return gather_cat(mine, group, 0, takes)
