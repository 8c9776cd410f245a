"""The StyleGAN2 sampling cell's pieces on the CPU: a whole run of the
`sample_sg2` driver at a tiny size (32², channels ≤ 32, batch 4) through
the tests' device switch, untraced and traced; the control and the planted
fault each coming out not correct against the tiny cell's limit (set, as
the cell's, between the program's CPU readings and the control's: 0.76-1.55
against 7.5-10.6 levels over 8 seeds, so 3.4); the kernel op's calls; the
FLOPs; the span shares' charging rule."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import calibrate_sg2, compare, faults_sg2, flops_sg2, harness, run
from benchmark.drivers import sample_sg2
from benchmark.kernels import bias_lrelu_gain

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_sg2")
TINY = {"spec_path": os.path.join(DATA, "BENCHMARK.json"), "data_dir": DATA}
CELL = "tiny_sg2.sample_sg2"


def _config(name):
    with open(os.path.join(harness.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_of_the_driver_on_the_cpu(trace, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 977), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", **TINY)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        assert result["metrics"] == {}           # no device number from a CPU run
    else:
        assert set(result["metrics"]) == {"sample_img_per_s", "sample_p95_ms", "setup_s"}
    assert "% of the checked pixels are 0 or 255" in out.err


def test_the_control_and_the_fault_are_not_correct(capsys):
    cell = harness.resolve(CELL, **TINY)
    for seed in (101, 102, 103):
        out = calibrate_sg2.readings(cell, seed, torch.device("cpu"), 0.5, control=True)
        assert compare.verdict(out["program"], cell.limits, out["failed"])[0], out
        assert not compare.verdict(out["control"], cell.limits, 0)[0], out
        # TF32 in the float32 part alone moves the images less than the control
        assert 0.0 < out["control_tf32"]["image_gap"] < out["control"]["image_gap"], out
        assert 0.0 < out["clip_share"] < 100.0
    undo = faults_sg2.answer_altered()
    try:
        assert run.main(["--workload", CELL, "--seed", "11", "--seconds", "0.5"],
                        device="cpu", **TINY) == 0
    finally:
        undo()
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


def test_bias_lrelu_gain_calls_a_stylegan2_forward_25_times():
    sg2 = _config("stylegan2f1024")
    shapes = bias_lrelu_gain.calls(sg2, 16, "forward")
    assert len(shapes) == 25 and shapes[:8] == [(16, 512)] * 8
    assert shapes[8] == (16, 512, 4, 4) and shapes[-2:] == [(16, 64, 1024, 1024)] * 2
    assert bias_lrelu_gain.calls(sg2, 16, "r1") == []
    for pggan in ("pggan256", "pggan1024"):
        for kind in ("forward", "r1", "plain"):
            assert bias_lrelu_gain.calls(_config(pggan), 16, kind) == []


def test_config_f_flops():
    """451 GMAC an image, 94 % of it in the four bf16 resolutions."""
    sg2 = _config("stylegan2f1024")
    assert flops_sg2.forward_flops(sg2, 16) == pytest.approx(14.44e12, rel=1e-3)
    below = flops_sg2.forward_flops(dict(sg2, resolution=64), 1)
    assert 1.0 - below / flops_sg2.forward_flops(sg2, 1) == pytest.approx(0.943, abs=0.005)


def _event(name, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_span_shares_charge_the_innermost_range():
    """A kernel inside conv0's resample range, itself inside a modconv range,
    counts as resample; a kernel outside both counts in the total only."""
    events = [_event("stylegan2.modconv", 0, 100, True), _event("stylegan2.resample", 10, 40, True),
              _event("conv", 50, 90), _event("upfirdn", 10, 40), _event("epilogue", 100, 120),
              _event("stylegan2.resample", 150, 160, True), _event("skip", 150, 160)]
    shares = sample_sg2.span_shares(events)
    assert shares == pytest.approx({"stylegan2.modconv": 40.0, "stylegan2.resample": 40.0})
    assert sample_sg2.span_shares([_event("conv", 0, 5)]) is None
