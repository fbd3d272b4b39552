"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: by the sources, and by what a
run of a cell leaves in ``sys.modules``.  Module names are compared by
their top-level name, whole: the port's name begins with the JAX
package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

FORBIDDEN = {"jax", "jaxlib", "flax", "yolo_quantization_tpu"}
PORT = "yolo_quantization_tpu_torch"


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def benchmark_modules(path: Path) -> set:
    """The modules of the benchmark that ``path`` imports by name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module == "portbench" and node.level == 0:
            names.update(f"portbench.{a.name}" for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    return {n for n in names if n.split(".")[0] == "portbench"}


def test_sources(root):
    """The reference's files and the range rules import nothing of the
    program and no JAX: numpy, torch and, of the benchmark, the reference
    (and for a range rule ``inputs``) alone."""
    files = sorted((root / "portbench").rglob("*.py"))
    assert files
    for f in files:
        assert not imported(f) & FORBIDDEN, f
    for folder, own in (("reference", ("portbench.reference",)),
                        ("ranges", ("portbench.reference", "portbench.inputs"))):
        for f in sorted((root / "portbench" / folder).rglob("*.py")):
            names = imported(f)
            assert PORT not in names, f
            assert names <= {"__future__", "dataclasses", "numpy", "torch", "portbench"}, (f, names)
            for module in benchmark_modules(f):
                assert module.startswith(own), (f, module)


def test_a_run_loads_no_jax(root):
    code = ("import sys, time, json; sys.path.insert(0, sys.argv[1]);"
            "from pathlib import Path; from portbench import harness;"
            "r = harness.run_cell(Path(sys.argv[1]), 'tiny416-b128-closed', 4, 0.5, True, 'cpu',"
            " time.perf_counter(), overrides={'size': 64, 'batch': 2, 'pool': 2});"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and not loaded & FORBIDDEN
