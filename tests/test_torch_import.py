"""The PyTorch port imports without jax, without the JAX package and without nvcc."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "yolo_quantization_tpu_torch"


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_blocked():
    mods = port_modules()
    assert "yolo_quantization_tpu_torch.ops.cuda_qconv" in mods
    # the darknet I/O and yolov2/yolov1 modules are held to the same rule
    for m in ("models.cfg", "models.darknet_weights", "models.weights_tools", "models.zoo",
              "nn.layers", "train.loss", "eval.detect",
              # the command line and the modules it joins
              "cli", "cli.main", "cli.__main__", "eval.valid", "utils.native", "utils.profiling",
              "data.video",
              # parallelism, WordTree and the other trainers
              "parallel", "parallel.distributed", "parallel.mesh", "parallel.fsdp", "parallel.tp",
              "core.tree", "train.classify", "train.segment",
              # the parity harness, the benchmarks and the dry run
              "parity", "parity.ctwin", "tools.parity_check", "tools.crossf1", "tools.bench",
              "tools.bench_serving", "tools.bench_train", "tools.dryrun",
              # the synthetic accuracy loop and the accuracy capstone
              "tools.synthetic_accuracy_loop", "tools.accuracy_capstone"):
        assert f"yolo_quantization_tpu_torch.{m}" in mods
    code = "\n".join([
        "import importlib, sys",
        # None in sys.modules makes any import of these names raise
        "sys.modules['jax'] = None",
        "sys.modules['yolo_quantization_tpu'] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "from yolo_quantization_tpu_torch.ops import _build, cuda_qconv",
        "assert cuda_qconv.launches == 0 and not _build._libs, 'import built or loaded a kernel'",
        "from yolo_quantization_tpu_torch.utils import native",
        "assert native._lib is None and not native._lib_failed, 'import built the host library'",
        "bad = [k for k, v in sys.modules.items() if v is not None and (k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'yolo_quantization_tpu.')))]",
        "assert not bad, bad",
        "print('ok', len(" + repr(mods) + "))",
    ])
    env = dict(os.environ)
    # no CUDA toolkit reachable: the kernel module must still import
    env["PATH"] = "/usr/bin:/bin"
    env["CUDA_HOME"] = "/nonexistent"
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    """No port source imports jax or the JAX package, even lazily."""
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), f"{path}: {s}"
            assert not s.startswith(("import yolo_quantization_tpu.", "from yolo_quantization_tpu.",
                                     "import yolo_quantization_tpu ", "from yolo_quantization_tpu ")), \
                f"{path}: {s}"
