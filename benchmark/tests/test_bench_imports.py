"""No module that a run loads has a forbidden top-level name (JAX, the JAX
package, bench, chip_smoke, tools), compared whole, and the reference
loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

PROBE = """
import sys
sys.path.insert(0, {repo!r})
import benchmark.run, benchmark.calibrate, benchmark.faults, benchmark.readout
from benchmark import harness
for kind in ("train", "sample"):
    harness.load_driver(kind)
import pggan_tpu_torch.registry, pggan_tpu_torch.train.trainer
import pggan_tpu_torch.models.generator, pggan_tpu_torch.utils.image
import json, os
for name in os.listdir(os.path.join(harness.BENCH_DIR, "metrics")):
    harness.load_reader(name[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF_PROBE = """
import sys
sys.path.insert(0, {repo!r})
import benchmark.reference.model, benchmark.reference.train, benchmark.reference.data
import json
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code):
    out = subprocess.run([sys.executable, "-c", code.format(repo=harness.REPO_DIR)],
                         capture_output=True, text=True, timeout=120, check=True)
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_forbidden_module():
    loaded = _top_levels(PROBE)
    assert "pggan_tpu_torch" in loaded          # the whole-name rule, not a prefix
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_levels(REF_PROBE)
    assert not loaded & (set(harness.FORBIDDEN_MODULES) | {"pggan_tpu_torch"})


def test_no_source_of_the_benchmark_imports_a_forbidden_name():
    for root, _, files in os.walk(harness.BENCH_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module] if isinstance(node, ast.ImportFrom) and node.module
                        else [])
                for mod in mods:
                    assert mod.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, mod)
                    if os.sep + "reference" + os.sep in path:
                        assert mod.split(".")[0] != "pggan_tpu_torch", (path, mod)


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pggan_tpu_torch_probe", object())
    assert "pggan_tpu_torch_probe" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_loaded()
