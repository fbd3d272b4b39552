"""Probe: int8 dot throughput of the two GEMM orientations of the stem conv.

The counterpart of ``scripts/mxu_orientation_probe.py``.  The stem conv
(416^2 x 3 -> 16, K = 27) can be written as two GEMMs:

  A. rows = pixels   : (P, K) x (K, O)  the engine's NHWC form
  B. pixels along a row: (O, K) x (K, P)  weights-stationary

and the s2d form is A or B with (P/4, 4K) x (4K, 4O).  The kernels
(``csrc/gemm_probe.cu``, both on the int8 tensor cores; B transposes x's
bytes on the way from shared memory to the tensor cores) compute the products with int32 accumulation and narrow to int8 with the
wrap of XLA's convert (int32 128 -> int8 -128), so the probe moves the
bytes a real layer would.  The cases are the script's four, on seeded
random int8 inputs (on all-ones inputs K = 128 gives 128, which wraps to
-128; random codes exercise the wrap everywhere).

    python -m yolo_quantization_tpu_torch.tools.orientation_probe

runs the four cases on the card, checks each kernel against its plain
version bit for bit, and prints CUDA-event times.  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.  ``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import json
import threading

import numpy as np
import torch

from yolo_quantization_tpu_torch.ops import _build

launches = {"orientation_a": 0, "orientation_b": 0}
_launches_lock = threading.Lock()

# the script's stem-equivalent load: 416^2 x 128 output pixels, probed at 1/8
ROWS_TOTAL = 416 * 416 * 128 // 8
# (name, orientation, K, O, P): P/4 rows for the s2d B case, as in the script
CASES = (
    ("A rows=pixels  K=32  O=16", "a", 32, 16, ROWS_TOTAL),
    ("A rows=pixels  K=128 O=64 (s2d)", "a", 128, 64, ROWS_TOTAL),
    ("B pixels=lanes K=32  O=16", "b", 32, 16, ROWS_TOTAL),
    ("B pixels=lanes K=128 O=64 (s2d, P/4)", "b", 128, 64, ROWS_TOTAL // 4),
)


def _library() -> ctypes.CDLL:
    lib = _build.load("gemm_probe")
    for fn in (lib.yq_orientation_a, lib.yq_orientation_b):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def plain_matmul_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M,K) x (K,N) with int32 accumulation, wrapped to int8.

    Float64 holds every partial sum exactly (|acc| <= K * 128^2 < 2^53) and
    runs on any device; int32 -> int8 ``.to`` wraps modulo 256, as XLA's
    convert does."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32).to(torch.int8)


def _check_shapes(p: int, k: int, o: int, orientation: str):
    ok = k % 32 == 0 and 32 <= k <= 256 and o % 16 == 0 and 16 <= o <= 64 and p >= 1
    rule = "K % 32 == 0 (<= 256), O % 16 == 0 (<= 64)"
    if orientation == "b":  # x's rows and the output's are read and written 16 bytes at a time
        ok = ok and p % 16 == 0
        rule = "B: " + rule + ", P % 16 == 0"
    else:
        rule = "A: " + rule
    if not ok:
        raise ValueError(f"probe kernel shapes: {rule}; got P={p} K={k} O={o}")


def _launch(name: str, first: torch.Tensor, second: torch.Tensor, out: torch.Tensor,
            p: int, k: int, o: int) -> torch.Tensor:
    for label, t in (("first", first), ("second", second)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != out.device:
            raise ValueError(f"{name} {label} operand: expected contiguous int8 on {out.device}")
        if t.data_ptr() % 16:  # the kernels copy 16 bytes at a time
            raise ValueError(f"{name} {label} operand: data must start on a 16-byte boundary")
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, f"yq_{name}")(first.data_ptr(), second.data_ptr(), out.data_ptr(),
                                         p, k, o, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    with _launches_lock:
        launches[name] += 1
    return out


def orientation_a(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (P,K) int8 . w (K,O) int8 -> (P,O) int8, int32 accumulation, wrapped."""
    (p, k), (k2, o) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"orientation_a: {tuple(x.shape)} x {tuple(w.shape)}")
    if x.device.type == "cpu":
        return plain_matmul_i8(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_shapes(p, k, o, "a")
    out = torch.empty((p, o), dtype=torch.int8, device=x.device)
    return _launch("orientation_a", x, w, out, p, k, o)


def orientation_b(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w (O,K) int8 . x (K,P) int8 -> (O,P) int8, int32 accumulation, wrapped."""
    (o, k), (k2, p) = w.shape, x.shape
    if k != k2:
        raise ValueError(f"orientation_b: {tuple(w.shape)} x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain_matmul_i8(w, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_shapes(p, k, o, "b")
    out = torch.empty((o, p), dtype=torch.int8, device=x.device)
    return _launch("orientation_b", w, x, out, p, k, o)


def case_inputs(orientation: str, k: int, o: int, p: int, seed: int, device) -> tuple:
    """Seeded random int8 operands of one case, in the kernel's argument order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (p, k) if orientation == "a" else (k, p), dtype=np.int8)
    w = rng.integers(-128, 128, (k, o) if orientation == "a" else (o, k), dtype=np.int8)
    x, w = torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)
    return (x, w) if orientation == "a" else (w, x)


def run_cases(device, scale: int = 1, seed: int = 0):
    """Run the four cases once at 1/``scale`` of their rows; yields
    (name, orientation, K, O, P, args, out)."""
    for i, (name, orientation, k, o, p) in enumerate(CASES):
        p = p // scale // 16 * 16  # B's kernel takes P % 16 == 0
        args = case_inputs(orientation, k, o, p, seed + i, device)
        fn = orientation_a if orientation == "a" else orientation_b
        yield name, orientation, k, o, p, args, fn(*args)


def main() -> int:
    from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity, cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("orientation_probe: needs a CUDA GPU")
    card = card_identity()
    rows = []
    for name, orientation, k, o, p, args, out in run_cases("cuda"):
        ref = plain_matmul_i8(*args)
        if not torch.equal(out, ref):
            raise AssertionError(f"{name}: kernel != plain version")
        fn = orientation_a if orientation == "a" else orientation_b
        ms = cuda_time_ms(lambda: fn(*args), 20)
        rows.append({"case": name, "P": p, "K": k, "O": o, "ms": ms, "equal": True})
        print(f"{name}: {ms:.4f} ms, equal to the plain version [{card}]", flush=True)
    print(json.dumps({"card": card, "cases": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
