"""Device-time breakdown of the engine's forward on one GPU (torch.profiler).

    python -m yolo_quantization_tpu_torch.tools.profile_engine [--v3] [batch ...]

For the flagship, ``use_s2d`` and C-parity configurations (yolov3-tiny, 416,
5 classes, seeded weights), or with ``--v3`` the yolov3 ones (80 classes,
416: synthetic ranges, and perturbed ranges with asymmetric weights,
``dynamic_input`` and ``exact_leaky``), at each batch (default 16 and 64):
the wall time per forward, the summed device kernel time, the device busy
share (kernel time over wall time of the profiled window) and the kernels
that take the most device time, and the share of each hand-written kernel
(K1 and K2 sum their tile instantiations, and are split by design).  Prints
one JSON line per configuration and batch.  ``python -m ... profile_engine
1 16 64 256`` gives the ``s2d`` configuration's K2 by design at the four
batches.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from yolo_quantization_tpu_torch.infer.engine import build_forward, device_arrays
from yolo_quantization_tpu_torch.models.presets import flagship_program, parity_program, v3_program
from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity

ITERS = 5
# the hand-written kernels by the names of their __global__ functions (a
# pattern searched in the profiler's name); K1 and K2 whole, then by
# design.  The halo design's kernel is halo.cuh's template for both, told
# apart by its parameter type (qconv.cu's Params, s2d_qconv.cu's HaloConv).
_K1_HALO, _K2_HALO = r"halo_kernel.*Params", r"halo_kernel.*HaloConv"
KERNELS = {"K1 qconv": rf"qconv_(wgmma|mma|i16)_kernel|{_K1_HALO}",
           "K1 wgmma": r"qconv_wgmma_kernel", "K1 halo": _K1_HALO, "K1 mma.sync": r"qconv_mma_kernel",
           "K2 s2d_qconv": rf"s2d_mma_kernel|{_K2_HALO}", "K2 halo": _K2_HALO, "K2 mma.sync": r"s2d_mma_kernel",
           "shortcut": r"shortcut_kernel"}


def configurations(v3: bool = False):
    if v3:
        return {
            "v3": (v3_program(classes=80, size=416, seed=0), {}),
            "v3-perturbed": (v3_program(classes=80, size=416, seed=0, perturbed=True,
                                        symmetric_weights=False),
                             dict(dynamic_input=True, exact_leaky=True)),
        }
    flagship = flagship_program(classes=5, size=416, seed=0)
    return {
        "flagship": (flagship, {}),
        "s2d": (flagship, dict(use_s2d=True)),
        "parity": (parity_program(classes=5, size=416, seed=0),
                   dict(dynamic_input=True, exact_leaky=True)),
    }


def kernel_time(fn, iters: int = ITERS) -> tuple[float, float, list]:
    """``iters`` back-to-back calls of ``fn`` under torch.profiler: (device
    ms, wall ms, the kernels' profiler entries, most time first), per call.
    The device time sums the kernels' own durations, so the gaps between
    launches are not in it; the wall time is the host clock over the same
    calls, ended by a synchronize."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # the kernels themselves: an operator's entry repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return sum(e.self_device_time_total for e in events) / 1e3 / iters, wall_ms, events


def breakdown(program, option: dict, batch: int, top: int = 6) -> dict:
    forward = build_forward(program, **option)
    arrays = device_arrays(program, "cuda")
    x = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (batch, 416, 416, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        for _ in range(2):  # builds the kernels, warms the allocator
            forward(arrays, x)
        device_ms, wall_ms, events = kernel_time(lambda: forward(arrays, x), ITERS)

    def share(pattern) -> float:
        ms = sum(e.self_device_time_total for e in events if re.search(pattern, e.key))
        return ms / 1e3 / ITERS / device_ms

    return {
        "wall_ms_per_forward": wall_ms,
        "device_ms_per_forward": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernel_shares": {name: share(pattern) for name, pattern in KERNELS.items()},
        "top_kernels": [
            {"name": e.key[:80], "share": e.self_device_time_total / 1e3 / ITERS / device_ms,
             "calls_per_forward": e.count / ITERS}
            for e in events[:top]
        ],
    }


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA GPU")
    card = card_identity()
    v3 = "--v3" in argv
    batches = [int(a) for a in argv if a != "--v3"] or [16, 64]
    for name, (program, option) in configurations(v3).items():
        for batch in batches:
            row = {"config": name, "batch": batch, "card": card, **breakdown(program, option, batch)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
