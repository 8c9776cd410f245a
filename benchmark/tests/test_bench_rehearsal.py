"""`run.py` end to end on the CPU, at the tiny size, for each driver kind,
untraced and traced, through the tests' device switch; and a run from the
command line without a card fails and prints no result."""

import json
import subprocess
import sys

import pytest

from benchmark import harness, run

CELLS = ["tiny.train_lazy_r1", "tiny16.train_r1", "tiny.sample"]


def _run(tiny, capsys, workload, trace, seed=2 ** 31 + 977):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", **tiny)
    out = capsys.readouterr()
    return rc, out


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_cpu(workload, trace, tiny, capsys):
    rc, out = _run(tiny, capsys, workload, trace)
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    cell = harness.resolve(workload, **{"spec_path": tiny["spec_path"],
                                        "data_dir": tiny["data_dir"]})
    if trace:
        # no device number is written from a CPU run
        assert result["metrics"] == {} and "breakdown" not in result
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert out.err.strip().splitlines()[-1].startswith("check failed: 0 of")


def test_same_seed_same_check(tiny, capsys):
    a = json.loads(_run(tiny, capsys, "tiny16.train_r1", 0, seed=5)[1].out.splitlines()[-1])
    b = json.loads(_run(tiny, capsys, "tiny16.train_r1", 0, seed=5)[1].out.splitlines()[-1])
    assert a["checks"] == b["checks"]


def test_the_command_line_needs_a_card():
    """Without a card (this machine), the command exits 2 and prints nothing
    on standard output: a timed run never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "pggan256.train_lazy_r1", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=harness.REPO_DIR, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


@pytest.mark.card
def test_a_run_on_the_card(card, tmp_path):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "pggan256.sample", "--seed", "7", "--seconds", "2", "--trace", "0"],
                          cwd=harness.REPO_DIR, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
