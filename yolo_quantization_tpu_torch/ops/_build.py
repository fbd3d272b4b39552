"""Build and load the port's CUDA kernels: nvcc into a plain-C shared library.

Each kernel is one ``csrc/<name>.cu`` file with an ``extern "C"`` entry,
compiled for Hopper (``sm_90a``) by ``nvcc`` into
``build/torch_kernels/libyoloq_<name>.<hash>.so`` at the repository root and bound
with ``ctypes``.  The hash covers the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source rebuilds on first use and an
unchanged one loads the cached library.  ``build_all`` starts one nvcc per
source at once.  Nothing here runs at import time; the first kernel call
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
LIBRARIES = ("qconv", "s2d_qconv", "gemm_probe", "shortcut", "spp")  # csrc/<name>.cu, one library each
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc output (ptxas register/spill report)
build_seconds: dict[str, float] = {}  # name -> wall time of the build (0 when cached)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libyoloq_{name}.{digest.hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing, one
    nvcc process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                build_seconds.setdefault(name, 0.0)
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            procs[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            build_log[name] = proc.communicate(timeout=600)[0]
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(name)
            else:
                os.replace(tmp, out)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"csrc/{n}.cu:\n{build_log[n]}" for n in failed))


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load (once per process) the kernel library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
