"""The StyleGAN3-T sampling cell's pieces on the CPU: a whole run of the
`sample_sg3` driver at a tiny size (32², channel_base 1024, channels ≤ 32,
all 14 layers, batch 4) through the tests' device switch, untraced and
traced; the control and the planted fault each coming out not correct
against the tiny cell's limit (set, as the cell's, between the program's
CPU readings and the control's: 0.73-2.82 against 10.2-32.8 levels over 8
seeds, so 5.0); the FIR kernels' op (28 calls a StyleGAN3 forward, none for
StyleGAN2 or PGGAN); the FLOPs."""

import json
import os

import pytest
import torch

from benchmark import calibrate_sg3, compare, faults_sg3, flops_sg3, harness, readout, run
from benchmark.kernels import filtered_lrelu_fir

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_sg3")
TINY = {"spec_path": os.path.join(DATA, "BENCHMARK.json"), "data_dir": DATA}
CELL = "tiny_sg3.sample_sg3"


def _config(name):
    with open(os.path.join(harness.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_of_the_driver_on_the_cpu(trace, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 1013), "--seconds", "0.5",
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
        out = calibrate_sg3.calibrate_sg2.readings(cell, seed, torch.device("cpu"), 0.5,
                                                   control=True)
        assert compare.verdict(out["program"], cell.limits, out["failed"])[0], out
        assert not compare.verdict(out["control"], cell.limits, 0)[0], out
        # TF32 in the float32 part alone moves the images less than the control
        assert 0.0 < out["control_tf32"]["image_gap"] < out["control"]["image_gap"], out
        assert 0.0 <= out["clip_share"] < 100.0
    undo = faults_sg3.answer_altered()
    try:
        assert run.main(["--workload", CELL, "--seed", "11", "--seconds", "0.5"],
                        device="cpu", **TINY) == 0
    finally:
        undo()
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


def test_calibrate_sg3_plants_the_stylegan3_fault(monkeypatch, tmp_path):
    """`calibrate_sg3.main` runs calibrate_sg2's readings with faults_sg3's
    faults, and leaves calibrate_sg2 as it found it."""
    seen = []

    def readings(cell, seed, device, seconds, *, control=False, fault=None):
        seen.append((seed, fault))
        return {"program": {}}
    monkeypatch.setattr(calibrate_sg3.calibrate_sg2, "readings", readings)
    out = tmp_path / "cal.jsonl"
    assert calibrate_sg3.main(["--workload", CELL, "--seeds", "5", "--fault_seeds", "6",
                               "--out", str(out)], device="cpu", **TINY) == 0
    assert seen == [(5, None), (6, faults_sg3.answer_altered)]
    assert calibrate_sg3.calibrate_sg2.faults_sg2.__name__ == "benchmark.faults_sg2"
    assert len(out.read_text().splitlines()) == 2


def test_the_fir_op_calls_a_stylegan3_forward_28_times():
    """Two FIR stages for each of the 14 conv layers: up 2 (12 taps) or up 4
    (24 taps) into the activation's rate, then down 2 (12 taps); float32 in
    layers 0-4, bf16 from layer 5; layer 10's up 4 and layer 11's down 2
    at their StyleGAN3-T shapes."""
    sg3 = _config("stylegan3t1024")
    shapes = filtered_lrelu_fir.calls(sg3, 16, "forward")
    assert len(shapes) == 28
    assert [s[7] for s in shapes[::2]] == [2, 2, 4, 2, 4, 4, 2, 4, 2, 4, 4, 2, 2, 2]
    assert {s[8] for s in shapes[1::2]} == {2} and {s[6] for s in shapes[1::2]} == {12}
    assert [s[9] for s in shapes[::2]] == [4] * 5 + [2] * 9
    assert shapes[20] == (16, 81, 534, 534, 2098, 2098, 24, 4, 1, 2)
    assert shapes[23] == (16, 51, 2098, 2098, 1044, 1044, 12, 1, 2, 2)
    assert filtered_lrelu_fir.calls(sg3, 16, "r1") == []
    for other in ("stylegan2f1024", "pggan256", "pggan1024"):
        for kind in ("forward", "r1", "plain"):
            assert filtered_lrelu_fir.calls(_config(other), 16, kind) == []
    flops, nbytes = filtered_lrelu_fir.cost(shapes[20], 2)
    assert nbytes == 16 * 81 * (534 ** 2 + 2098 ** 2) * 2
    assert flops == 2.0 * 16 * 81 * (534 * 2098 + 2098 * 2098) * 6


def test_no_kernel_op_matches_another_ops_kernels():
    """The FIR op's names match none of the kernels the other cells launch,
    so `kernel_roofline` reads the same there as before."""
    others = ["void (anonymous namespace)::upfirdn2d_up2_kernel<__nv_bfloat16, 8, 2>",
              "void (anonymous namespace)::upfirdn2d_kernel<float, 4, false>",
              "void (anonymous namespace)::upfirdn2d_kernel<float, 2, true>",
              "void (anonymous namespace)::bias_lrelu_gain_kernel<__nv_bfloat16, float, 8, true>"]
    ours = ["void (anonymous namespace)::upfirdn2d_sep_up_kernel<__nv_bfloat16, 1, 4, 24>",
            "void (anonymous namespace)::upfirdn2d_sep_down_kernel<float, 2, 12>"]
    for name in others:
        assert not readout._matches(filtered_lrelu_fir.NAMES, name), name
    for name in ours:
        assert readout._matches(filtered_lrelu_fir.NAMES, name), name
        for op in readout.kernel_ops():
            if op is not filtered_lrelu_fir:
                assert not readout._matches(op.NAMES, name), (op.__name__, name)


def test_stylegan3_t_flops():
    """285.6 GMAC an image, 9.14 TFLOP a request of 16; 8.4 % of it in the
    float32 layers 0-4 and the input."""
    sg3 = _config("stylegan3t1024")
    assert flops_sg3.forward_flops(sg3, 16) == pytest.approx(9.14e12, rel=5e-3)
    assert flops_sg3.forward_flops(sg3, 1) == pytest.approx(2 * 285.6e9, rel=1e-3)
