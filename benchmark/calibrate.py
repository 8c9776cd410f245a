"""The readings that the limits of a cell are set from, at the cell's own
size (not part of a benchmark run):

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 ... \\
        [--control_seeds 1 2 3] [--fault_seeds 1 2 3] [--seconds 3] [--out FILE]

For each of `--seeds`, the program's numbers against the reference, as a
run's check reads them (set-up, for sampling a short window at the cell's
load, then the reference). For each of `--control_seeds`, the control's:
the reference computed in the precision below the configuration's (TF32
below float32, fp8 below bfloat16) put in the program's place. For each
of `--fault_seeds`, the numbers of the program with each fault of
`faults.py` that the cell's driver can have planted under the timed path. One JSON line each, to
standard output and to `--out`. Needs a card unless `device` is given.
"""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))

from benchmark import faults, harness  # noqa: E402
from benchmark.run import derive_seeds  # noqa: E402


def readings(cell, seed: int, device, seconds: float, *, control: bool = False,
             fault=None):
    import torch

    driver = harness.load_driver(cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, derive_seeds(seed), device, harness.Spans(), seconds)
    undo = fault() if fault is not None else None
    try:
        driver.setup()
        if cell.traffic["driver"] == "sample":
            driver.window(seconds)
        driver.release()
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        out = {"program": driver.check(), "failed": driver.failed,
               "attempted": driver.attempted}
        if control:
            out["control"] = driver.control()
        raw = getattr(driver, "raw_losses", None)
        if raw is not None:
            out["losses"] = raw()
        look = getattr(driver, "look", None)
        if look is not None:
            out["look"] = look()
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
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="the sampling window (training reads no window)")
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    import torch

    cell = harness.resolve(ns.workload, spec_path, data_dir)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: needs a CUDA card", file=sys.stderr)
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
        for name, plant in faults.FAULTS[cell.traffic["driver"]].items():
            for seed in ns.fault_seeds:
                emit({"seed": seed, "kind": f"fault:{name}",
                      **readings(cell, seed, device, ns.seconds, fault=plant)})
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
