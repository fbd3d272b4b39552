"""The readings the limits of ``correct`` are set from, at a cell's own
size and load, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--faults]

- for each of ``--seeds``: the program built from the seed, a short
  window of the cell's traffic, its sampled answers judged against the
  reference (the sound runs: the lower readings);
- for each of ``--control-seeds``: the control, the configuration's
  reference (``harness.reference``) put in the program's place with int4
  weights (W4A8, the precision below the configuration's int8), its
  answers for the cell's frame batches judged the same way (the upper
  readings);
- with ``--faults``, for each control seed, each fault of ``faults.py``
  planted under the program's entry.

Prints one JSON line a reading, then one with the largest sound and the
smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from portbench import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int)
    ap.add_argument("--batch", type=int)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = {k: v for k, v in (("size", args.size), ("batch", args.batch)) if v}
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def program_run(seed, plant=None, label="program"):
        t = time.perf_counter()
        c = harness.Cell(ROOT, args.workload, seed, args.device, overrides, plant)
        sample = harness.Sample(int(c.cell["sample_requests"]), seed)
        t0 = time.perf_counter()
        records = c.send(lambda now, sent: now >= t0 + args.seconds, sample.offer)
        c.release()
        found = c.judge(sample.items)
        emit({"kind": label, "seed": seed, "requests": len(records),
              "failed": sum(r.error is not None for r in records), **found,
              "seconds": time.perf_counter() - t})

    for seed in (int(s) for s in args.seeds.split(",")):
        program_run(seed)

    cell, config = harness.cell_files(ROOT, args.workload)
    ref = harness.reference(config)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        t = time.perf_counter()
        _, _, net, weights, ranges, pool = harness.cell_inputs(ref, cell, config, seed,
                                                               args.device, overrides)
        control = ref.convert(net, weights, ranges, args.device, bits=4)
        items = [(p, ref.answers(control, pool[p], int(config["max_det"])))
                 for p in range(min(len(pool), int(cell["sample_requests"])))]

        emit({"kind": "control", "seed": seed,
              **harness.judge(ref, net, weights, ranges, pool, args.device,
                              int(config["max_det"]), items),
              "seconds": time.perf_counter() - t})
        if args.faults:
            for name, plant in faults.FAULTS.items():
                program_run(seed, plant, f"fault:{name}")

    summary = {}
    for key in ("det_gap",):
        sound = [r[key] for r in rows if r["kind"] == "program"]
        summary[key] = {"lower": max(sound),
                        **{kind: min(r[key] for r in rows if r["kind"] == kind)
                           for kind in sorted({r["kind"] for r in rows} - {"program"})}}
    print(json.dumps({"kind": "summary", "workload": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
