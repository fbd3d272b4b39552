"""Process-group setup, the global device mesh, and a scaling measurement.

The counterpart of ``yolo_quantization_tpu/parallel/distributed.py``.  One
process runs per device (torchrun starts them, or the caller names a
coordinator); NCCL joins CUDA devices and gloo the CPU.  ``global_mesh`` is
a ``DeviceMesh`` of shape (data, model) over every rank: data-parallel
training splits the batch over ``data`` (``parallel/mesh.py``,
``parallel/fsdp.py``), tensor-parallel inference the conv channels over
``model`` (``parallel/tp.py``).

Usage (one process per device):

    from yolo_quantization_tpu_torch.parallel import distributed
    distributed.initialize()                 # torchrun's variables, or a coordinator
    mesh = distributed.global_mesh()         # every rank, ("data", "model")
"""

from __future__ import annotations

import datetime
import os
import time
import warnings

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, initialization_timeout: int = 300,
               device="cuda") -> None:
    """``torch.distributed.init_process_group`` for ``device``'s backend.

    With ``coordinator_address`` ("host:port") the group has
    ``num_processes`` ranks and this is ``process_id``; when the coordinator
    cannot be reached the call raises, never running on alone (each process
    would average only its own gradients).  Without one it reads torchrun's
    variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and where there
    are none it forms a group of this one process.  A no-op when a group is
    already up.  For NCCL the rank's card (``cuda:LOCAL_RANK``) becomes the
    current device first.
    """
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        from yolo_quantization_tpu_torch.parallel.mesh import rank_device

        torch.cuda.set_device(rank_device(device))
    timeout = datetime.timedelta(seconds=initialization_timeout)
    if coordinator_address:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)


def global_mesh(n_model: int = 1, device="cuda"):
    """The (data, model) ``DeviceMesh`` over every rank; rank = d * n_model +
    m.  A world that ``n_model`` does not divide raises."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"mesh (data x {n_model} model) needs a multiple of {n_model} ranks; "
                         f"the world has {world}")
    return init_device_mesh(torch.device(device).type, (world // n_model, n_model),
                            mesh_dim_names=("data", "model"))


def scaling_efficiency(step_fn, make_batch, device_counts: list[int], iters: int = 10) -> dict[int, float]:
    """Items per second at each device count: ``step_fn(group, batch)``
    runs one step on the first n ranks' group and waits for it.  Counts
    above the world's ranks are skipped with a warning; ranks outside a
    count's group wait.  Returns {n: items/s} as this rank measured it, for
    the counts whose group holds it."""
    world, rank = dist.get_world_size(), dist.get_rank()
    results = {}
    for n in device_counts:
        if n > world:
            warnings.warn(f"scaling_efficiency: {n} devices skipped; the world has {world}", stacklevel=2)
            continue
        group = dist.new_group(ranks=list(range(n)))
        if rank < n:
            batch = make_batch(n)
            step_fn(group, batch)
            t0 = time.perf_counter()
            for _ in range(iters):
                step_fn(group, batch)
            results[n] = iters * int(batch[0].shape[0]) / (time.perf_counter() - t0)
        dist.barrier()
    return results
