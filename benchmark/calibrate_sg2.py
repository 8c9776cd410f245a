"""The readings that a StyleGAN2 sampling cell's limits are set from, at the
cell's own size (not part of a benchmark run); `calibrate.py` runs a window
for the `sample` kind alone, so this script does it for `sample_sg2`:

    python3 benchmark/calibrate_sg2.py --workload <name> --seeds 1 2 ... \\
        [--control_seeds 1 2 3] [--fault_seeds 1 2 3] [--seconds 3] [--out FILE]

For each of `--seeds`, set-up, a window of `--seconds` at the cell's load,
then the check as a run reads it (`program`) and the share of checked pixels
at 0 or 255 (`clip_share`, %); for `--control_seeds` also the control's
numbers (the reference rounded below each part's precision, in the
program's place; `control`) and those of the reference rounded to TF32 in
its float32 part alone (`control_tf32`: what the program would read with
TF32 there); for each of `--fault_seeds`, the numbers of the program with
each fault of `faults_sg2.py` planted under the timed path. One JSON line
each, to standard output and to `--out`. Needs a card unless `device` is
given.
"""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))

from benchmark import faults_sg2, harness  # noqa: E402
from benchmark.run import derive_seeds  # noqa: E402


def readings(cell, seed: int, device, seconds: float, *, control: bool = False,
             fault=None) -> dict:
    driver = harness.load_driver(cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, derive_seeds(seed), device, harness.Spans(), seconds)
    undo = fault() if fault is not None else None
    try:
        driver.setup()
        driver.window(seconds)
        driver.release()
        out = {"program": driver.check(), "clip_share": driver.clip_share,
               "failed": driver.failed, "attempted": driver.attempted}
        if control:
            out["control"] = driver.control()
            out["control_tf32"] = driver.control(parts=("float32",))
        return out
    finally:
        if undo is not None:
            undo()


def main(argv=None, *, device=None, spec_path=harness.SPEC_PATH,
         data_dir=harness.BENCH_DIR) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    import torch

    cell = harness.resolve(ns.workload, spec_path, data_dir)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate_sg2: needs a CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    sink = open(ns.out, "a") if ns.out else None
    try:
        def emit(record):
            line = json.dumps({"workload": ns.workload, **record})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()

        for seed in sorted(set(ns.seeds) | set(ns.control_seeds)):
            emit({"seed": seed, "kind": "sound",
                  **readings(cell, seed, device, ns.seconds,
                             control=seed in ns.control_seeds)})
        for name, plant in faults_sg2.FAULTS.items():
            for seed in ns.fault_seeds:
                emit({"seed": seed, "kind": f"fault:{name}",
                      **readings(cell, seed, device, ns.seconds, fault=plant)})
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
