"""One run of one cell: inputs from the seed, the program built and warmed,
the measured window, the traced stretch, the check against the reference,
and the result line.

Everything is found by name: ``BENCHMARK.json`` at the checkout's root
names the metrics and the cells they belong to; a cell is
``workloads/<cell>.json``, its configuration ``configs/<config>.json``, its
traffic kind ``traffic/<kind>.py`` and each per-layer metric
``metrics/<name>.py`` or ``metrics/<stem>.py``.  A configuration may name
its own reference, ``reference/<module>.py``, and a range rule of its own,
``ranges/<rule>.py``; without them it takes ``reference/darknet_cfg.py``
and ``reference/model.py`` and a rule of ``inputs.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import random
import re
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

from portbench import compare, inputs, system, trace
from portbench.reference import darknet_cfg, model

HERE = Path(__file__).resolve().parent
FILE_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def shown(path: Path) -> str:
    """``path`` as the benchmark's own, ``portbench/...``."""
    return str(path.relative_to(HERE.parent))


def load_file(folder: str, name: str, required: tuple, what: str):
    """The module ``portbench/<folder>/<name>.py``, loaded by its path; stops
    the run, naming the file, where it is missing or lacks a function of
    ``required``."""
    if not isinstance(name, str) or not FILE_NAME.match(name):
        raise SystemExit(f"{what} {name!r} is not a file name of portbench/{folder}/")
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"{what} {name!r}: {shown(path)} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in required if not callable(getattr(module, f, None))]
    if missing:
        raise SystemExit(f"{what} {name!r}: {shown(path)} has no {', '.join(missing)}")
    return module


class Reference(NamedTuple):
    """A configuration's plain reference (``reference/model.py`` says what
    each function does)."""
    parse: Callable
    convert: Callable
    heads: Callable
    candidates: Callable
    answers: Callable
    answer_count: Callable


REFERENCE_FUNCTIONS = ("parse", "convert", "heads", "candidates", "answers")


def yolo_answer_count(net, max_det: int) -> int:
    """Detections in an answer: ``max_det``, or every candidate of the
    ``[yolo]`` heads where they hold fewer."""
    return min(max_det, sum(layer.out_shape[0] * layer.out_shape[1] * len(layer.mask)
                            for layer in net.layers if layer.kind == "yolo"))


def reference(config: dict) -> Reference:
    """The reference a configuration names with ``"reference": "<module>"``,
    ``reference/<module>.py``; without the key, ``darknet_cfg`` and
    ``model`` themselves.  A module may reuse their functions but may not
    rebind any of them: that would change the reference of every other
    cell in the process, so it stops the run."""
    name = config.get("reference")
    if name is None:
        return Reference(darknet_cfg.parse, model.convert, model.heads, model.candidates,
                         model.answers, yolo_answer_count)
    bound = {m: dict(vars(m)) for m in (darknet_cfg, model)}
    module = load_file("reference", name, REFERENCE_FUNCTIONS, "reference")
    for m, names in bound.items():
        changed = sorted(k for k, v in names.items() if k not in vars(m) or vars(m)[k] is not v)
        if changed:
            vars(m).update(names)
            raise SystemExit(f"reference {name!r}: {shown(HERE / 'reference' / f'{name}.py')} "
                             f"rebinds {m.__name__}.{', '.join(changed)}")
    return Reference(*(getattr(module, f) for f in REFERENCE_FUNCTIONS),
                     getattr(module, "answer_count", yolo_answer_count))


def range_rule(config: dict) -> Callable:
    """``ranges(net)`` of the rule a configuration names: one of ``inputs.py``,
    else ``ranges/<rule>.py``."""
    rule = config["ranges"]
    if rule in inputs.RANGE_RULES:
        return lambda net: inputs.ranges(net, rule)
    return load_file("ranges", rule, ("ranges",), "range rule").ranges


def cell_files(root: Path, name: str) -> tuple[dict, dict]:
    """(the cell's workload file, its configuration file).  Every piece the
    configuration names is looked up here, before anything is built, so
    that a missing one costs no build."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no cell {name!r}: {path.relative_to(root)} is missing")
    cell = load_json(path)
    path = HERE / "configs" / f"{cell['config']}.json"
    config = load_json(path)
    reference(config)
    range_rule(config)
    try:
        system.options(config)
    except ValueError as e:
        raise SystemExit(f"{shown(path)}: {e}") from None
    return cell, config


def cfg_text(config: dict, size: int) -> str:
    """The config's .cfg text, at ``size`` where that differs from its own."""
    lines = list(config["cfg"])
    if size != config["size"]:
        lines = [f"width={size}" if ln.startswith("width=") else
                 f"height={size}" if ln.startswith("height=") else ln for ln in lines]
    return "\n".join(lines) + "\n"


def metrics_of(manifest: dict, group: str, cell: str) -> list[dict]:
    return [m for m in manifest[group] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The reader of per-layer metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        if (HERE / "metrics" / f"{stem}.py").exists():
            return load_file("metrics", stem, ("read",), "metric").read
    raise SystemExit(f"no reader for metric {name!r} under portbench/metrics/")


class Sample:
    """A uniform sample of ``k`` answers, drawn from the seed, among the
    requests in the order they finished (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(inputs.sub_seed(seed, "sample")), 0, []

    def offer(self, request, answer) -> None:
        item = (request.pool, answer)
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def images_per_s(records, t0: float, seconds: float) -> float:
    """Images whose answers reached the host inside the window, a second."""
    return sum(r.images for r in records if r.error is None and r.t_done <= t0 + seconds) / seconds


def latency_p95_ms(records, t0: float, seconds: float) -> float:
    """The 95th percentile (nearest rank) over every request of the window
    of its time from the call to its answer on the host; a failed request
    counts as never answered."""
    lat = sorted(math.inf if r.error else r.t_done - r.t_send for r in records)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3


END_TO_END = {"images_per_s": images_per_s, "latency_p95_ms": latency_p95_ms}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def nothing(request, answer) -> None:
    return None


def cell_inputs(ref: Reference, cell: dict, config: dict, seed: int, device,
                overrides: dict | None = None):
    """(traffic params, .cfg text, the reference's network, float weights,
    ranges, frame pool) of a cell from ``seed``; ``overrides`` (size, and
    params such as batch and pool) shrink it for the tests."""
    params = dict(cell["params"])
    size = config["size"]
    if overrides:
        size = overrides.get("size", size)
        params.update({k: v for k, v in overrides.items() if k != "size"})
    text = cfg_text(config, size)
    net = ref.parse(text)
    return (params, text, net, inputs.float_params(net, seed, device), range_rule(config)(net),
            inputs.frame_pool(int(params["pool"]), int(params["batch"]), size, seed, device))


class Cell:
    """One cell made ready from a seed: its inputs, the program built from
    them and warmed up on the cell's own traffic.  ``overrides`` (size,
    batch, pool) and ``plant`` (a function that wraps the entry) are for
    the tests' small runs on the CPU."""

    def __init__(self, root: Path, name: str, seed: int, device, overrides: dict | None = None,
                 plant=None):
        self.device = device
        self.cell, self.config = cell_files(root, name)
        self.ref = reference(self.config)
        (self.params, text, self.net, self.weights, self.ranges,
         self.pool) = cell_inputs(self.ref, self.cell, self.config, seed, device, overrides)
        self.batch, self.max_det = int(self.params["batch"]), int(self.config["max_det"])
        self.engine = system.engine(self.config, text, self.weights, self.ranges, device)
        entry = self.engine.predict_async
        self.submit = entry if plant is None else plant(entry)
        self.traffic = importlib.import_module(f"portbench.traffic.{self.cell['traffic_kind']}")
        # warm-up: the traffic itself, through every frame batch (on a
        # checkout's first run the first request builds the kernels)
        self.send(lambda now, sent: sent >= len(self.pool) + 2, nothing)
        synchronize(device)

    def send(self, stop, on_done, submit=None) -> list:
        return self.traffic.run(submit or self.submit, self.pool, self.params, stop, on_done)

    def release(self) -> int:
        """Free the program's state; the peak of device memory it reached."""
        cuda = torch.device(self.device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        self.engine = self.submit = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return int(peak)

    def judge(self, items: list) -> dict:
        return judge(self.ref, self.net, self.weights, self.ranges, self.pool, self.device,
                     self.max_det, items)


def judge(ref: Reference, net, weights, ranges, pool, device, max_det: int,
          items: list) -> dict:
    """``compare.judge`` of sampled answers ``items`` [(pool index, answer)]
    against the reference ``ref``, which runs once over each frame batch
    they answered."""
    program = ref.convert(net, weights, ranges, device)
    rows: dict = {}

    def reference_rows(p):
        if p not in rows:
            rows[p] = ref.candidates(program, pool[p], max_det, compare.TIE)
        return rows[p]

    return compare.judge(items, reference_rows, pool.shape[1], ref.answer_count(net, max_det))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace_on: bool, device,
             t_start: float, overrides: dict | None = None, plant=None) -> dict:
    """The result dict of one run.  ``t_start`` is the process's start on
    the ``time.perf_counter`` clock."""
    manifest = load_json(root / "BENCHMARK.json")
    c = Cell(root, name, seed, device, overrides, plant)
    sample = Sample(int(c.cell["sample_requests"]), seed)
    # what set-up left behind is collected now and kept out of the
    # collector's later passes, so they scan only what the window makes
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    records = c.send(lambda now, sent: now >= t0 + seconds, sample.offer)

    reduced = None
    if trace_on:
        k = int(c.cell["trace_requests"])

        def traced_submit(frames):
            with record_function("portbench.submit"):
                resolve = c.submit(frames)

            def traced_resolve():
                with record_function("portbench.resolve"):
                    return resolve()
            return traced_resolve

        _, events = trace.traced(lambda: c.send(lambda now, sent: sent >= k, nothing,
                                                traced_submit))
        reduced = trace.reduce(events)
        reduced.update(forwards=k, images=k * c.batch)
        del events

    gc.unfreeze()
    memory_peak = c.release()
    t_check = time.perf_counter()
    found = c.judge(sample.items)
    check_s = time.perf_counter() - t_check
    errors = [r.error for r in records if r.error is not None]
    failed = len(errors)
    if errors:
        print(f"portbench: {failed} requests failed; the first: {errors[0]}", file=sys.stderr)
    limits = c.cell["checks"]
    checks = {key: {"value": found[key], "limit": limits[key]} for key in limits}
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in checks.values())

    if not trace_on:
        metrics = {m["name"]: {"value": setup_s if m["name"] == "setup_s" else
                               END_TO_END[m["name"]](records, t0, seconds), "unit": m["unit"]}
                   for m in metrics_of(manifest, "end_to_end", name)}
    else:
        summary = {"net": c.net, "batch": c.batch, "trace": reduced,
                   "window": {"seconds": seconds,
                              "images": sum(r.images for r in records
                                            if r.error is None and r.t_done <= t0 + seconds),
                              "dispatch_s": [r.t_sent - r.t_send for r in records]}}
        metrics = {}
        for m in metrics_of(manifest, "per_layer", name):
            value = reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cuda = torch.device(device).type == "cuda"
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(c.cell["chips"]) if cuda else 1,
                   "memory_peak_bytes": memory_peak},
    }
    if reduced is not None:
        result["device"].update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": [[n, s] for n, s, _ in reduced["device_ops"][:10]],
                               "idle_gaps": reduced["idle_gaps"]}
    result["sampled"] = len(sample.items)
    result["check_s"] = check_s
    result["checks"] = checks  # last in the line
    return result
