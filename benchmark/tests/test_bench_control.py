"""The check fails what it must: the lower-precision control (the
reference in the precision below the configuration's, put in the program's
place) and each fault a cell can
have, planted under the timed path of a whole run (the harness's look for a
card skipped). At the tiny size on the CPU, against the tiny cells' limits,
which were set from CPU readings as the cells' limits were from the card's
(PERF.md)."""

import json

import pytest

from benchmark import calibrate, compare, faults, harness, run

SEEDS = [101, 102, 103]


@pytest.mark.parametrize("workload", ["tiny.train_lazy_r1", "tiny16.train_r1", "tiny.sample"])
def test_the_control_is_not_correct(workload, tiny):
    cell = harness.resolve(workload, tiny["spec_path"], tiny["data_dir"])
    import torch

    for seed in SEEDS:
        out = calibrate.readings(cell, seed, torch.device("cpu"), 0.5, control=True)
        ok, _ = compare.verdict(out["program"], cell.limits, out["failed"])
        assert ok, (seed, out["program"])
        control = dict(out["control"])
        control.setdefault("batch_mismatch", 0.0)
        bad, checks = compare.verdict(control, cell.limits, 0)
        assert not bad, (seed, checks)


@pytest.mark.parametrize("workload, fault", [
    ("tiny.train_lazy_r1", "state_unchanged"), ("tiny.train_lazy_r1", "half_batch"),
    ("tiny16.train_r1", "state_unchanged"), ("tiny16.train_r1", "half_batch"),
    ("tiny.sample", "answer_altered"),
])
def test_a_fault_under_the_timed_path_is_not_correct(workload, fault, tiny, capsys):
    kind = harness.resolve(workload, tiny["spec_path"], tiny["data_dir"]).traffic["driver"]
    undo = faults.FAULTS[kind][fault]()
    try:
        rc = run.main(["--workload", workload, "--seed", "11", "--seconds", "0.5"],
                      device="cpu", **tiny)
    finally:
        undo()
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]
