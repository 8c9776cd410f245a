"""The readings that a StyleGAN3 sampling cell's limits are set from, at the
cell's own size (not part of a benchmark run): `calibrate_sg2.py`'s
readings, with the faults of `faults_sg3.py` planted in place of
`faults_sg2.py`'s:

    python3 benchmark/calibrate_sg3.py --workload <name> --seeds 1 2 ... \\
        [--control_seeds 1 2 3] [--fault_seeds 1 2 3] [--seconds 3] [--out FILE]

One JSON line a reading (`program`, `clip_share`, with --control_seeds
`control` and `control_tf32`, with --fault_seeds each fault's), to standard
output and to `--out`. Needs a card unless `device` is given.
"""

import os
import sys
from unittest import mock

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))

from benchmark import calibrate_sg2, faults_sg3, harness  # noqa: E402


def main(argv=None, *, device=None, spec_path=harness.SPEC_PATH,
         data_dir=harness.BENCH_DIR) -> int:
    # calibrate_sg2 looks its faults up in the module it imported as faults_sg2
    with mock.patch.object(calibrate_sg2, "faults_sg2", faults_sg3):
        return calibrate_sg2.main(argv, device=device, spec_path=spec_path, data_dir=data_dir)


if __name__ == "__main__":
    raise SystemExit(main())
