"""BENCHMARK.json against the shape its readers expect: every cell resolves to its
files by name, every name and unit is made of the allowed characters, and
every per-layer metric has its reader and moves a metric its cells report."""

import json
import os
import re

import pytest

from benchmark import harness, readout
from benchmark.reference import model as ref

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _spec():
    with open(harness.SPEC_PATH) as f:
        return json.load(f)


def _cells():
    return [w["name"] for w in _spec()["workloads"]]


def test_top_level_keys_and_paths():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) for p in spec["paths"])
    assert spec["command"][:2] == ["python3", "benchmark/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(harness.SPEC_PATH) <= 64 * 1024


@pytest.mark.parametrize("workload", _cells())
def test_cell_resolves(workload):
    cell = harness.resolve(workload)
    assert cell.chips in (1, 4)
    harness.load_driver(cell.traffic["driver"])
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
    assert cell.limits, "a cell needs the limits of its check"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_names_units_and_keys():
    spec = _spec()
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            assert NAME.match(entry["name"]), entry["name"]
            key = (group in ("end_to_end", "per_layer"), entry["name"])
            assert key not in seen
            seen.add(key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(harness.REPO_DIR, c["file"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_per_layer_moves_a_metric_its_cells_report():
    spec = _spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)


def test_shares_are_percent_and_never_named_loosely():
    for m in _spec()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or "share" in m["name"]:
            assert m["unit"] == "%", m["name"]


def test_traffic_and_limits_are_data_files():
    for sub, exts in (("traffic", (".json",)), ("limits", (".json",)), ("configs", (".json",))):
        for name in os.listdir(os.path.join(harness.BENCH_DIR, sub)):
            assert name.endswith(exts), name


def test_kernel_ops_define_their_work():
    model = {"depths": [512, 512, 512, 512, 256, 128, 64], "scale": 6, "latent_dim": 512}
    ops = readout.kernel_ops()
    assert len(ops) >= 3
    for op in ops:
        assert op.NAMES
        for kind in ("r1", "plain", "forward"):
            for shape in op.calls(model, 16, kind):
                flops, nbytes = op.cost(shape, 2)
                assert flops > 0 and nbytes > 0


def test_launches_a_step_match_the_ports_counts():
    """The epilogue launches of a 256² step, as the kernels' launch counters
    read them on the card:
    pixel norm 4 + lrelu_pixel_norm 26 forward, 13 backward, mb-stddev 3
    with R1 and 2 without."""
    from benchmark.kernels import lrelu_norm_rows_bwd, mb_stddev, norm_rows_fwd

    model = {"depths": [512, 512, 512, 512, 256, 128, 64], "scale": 6, "latent_dim": 512}
    assert len(norm_rows_fwd.calls(model, 16, "r1")) == 30
    assert len(norm_rows_fwd.calls(model, 16, "forward")) == 15
    assert len(lrelu_norm_rows_bwd.calls(model, 16, "plain")) == 13
    assert len(mb_stddev.calls(model, 16, "r1")) == 3
    assert len(mb_stddev.calls(model, 16, "plain")) == 2


def test_config_layers_are_the_published_widths():
    for name in ("pggan256", "pggan1024"):
        with open(os.path.join(harness.BENCH_DIR, "configs", name + ".json")) as f:
            cfg = json.load(f)
        m = cfg["model"]
        assert m["latent_dim"] == 512 and m["depths"][:4] == [512] * 4
        assert m["scale"] == len(m["depths"]) - 1
        widths = [s for _, s in ref.g_layers(m["depths"], m["scale"], 512)]
        assert widths[0] == (8192, 512)
