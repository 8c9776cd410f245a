"""The port's tools on the CPU: `tools/bench_pipeline_torch.py --json` on a
folder that `tools/make_synth_dataset.py` writes (each tier and loader),
`tools/train_watchdog_torch.py` with a fake trainer and probe, as
tests/test_watchdog.py drives the JAX package's watchdog: it restarts the
trainer after a stall with `--ckpt_id` and gives up after `--max_restarts`;
and `chip_smoke.py`, which runs only on a card, imported here so that every
name its phases call, and every name `tools/time_row_kernels.py` reads of
it, is checked to exist. No JAX program is compiled; the watchdog and its
children import no framework.
"""

import ast
import builtins
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
WATCHDOG = os.path.join(TOOLS, "train_watchdog_torch.py")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool(name):
    return _load(name, os.path.join(TOOLS, f"{name}.py"))


def _bound_names(function):
    """Every name bound inside `function`: its arguments, assignments, loop
    and `with` targets, nested functions and classes, imports and except
    names, at any depth."""
    names = set()
    for node in ast.walk(function):
        if isinstance(node, ast.arg):
            names.add(node.arg)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((alias.asname or alias.name).split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
    return names


def test_chip_smoke_names_resolve():
    """chip_smoke.py imports on the CPU (its top level needs no card); every
    name called in each of its functions, `main` and the `run_*` phases
    among them, is bound in that function, defined in the module or a
    builtin; and the names `tools/time_row_kernels.py` reads of it exist.
    A phase left calling a deleted helper would otherwise fail only on the
    card."""
    path = os.path.join(REPO, "chip_smoke.py")
    smoke = _load("chip_smoke", path)
    tree = ast.parse(open(path).read(), filename=path)
    functions = [node for node in tree.body if isinstance(node, ast.FunctionDef)]
    assert {"main", "run_train", "run_chunk_phase", "run_upfirdn_phase"} <= {
        f.name for f in functions}
    known = set(vars(smoke)) | set(dir(builtins))
    missing = []
    for function in functions:
        local = _bound_names(function)
        for node in ast.walk(function):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id not in local | known):
                missing.append(f"{function.name}: {node.func.id} (line {node.lineno})")
    assert missing == []

    # time_row_kernels reads these of `smoke = _chip_smoke()` and of
    # `_chip_smoke()` itself
    tool = ast.parse(open(os.path.join(TOOLS, "time_row_kernels.py")).read())
    read = {node.attr for node in ast.walk(tool) if isinstance(node, ast.Attribute) and (
        (isinstance(node.value, ast.Name) and node.value.id == "smoke")
        or (isinstance(node.value, ast.Call) and isinstance(node.value.func, ast.Name)
            and node.value.func.id == "_chip_smoke"))}
    assert {"time_kernels", "time_train_kernels", "epilogue_shapes", "card_line", "BATCH",
            "SCALE"} <= read
    assert sorted(name for name in read if not hasattr(smoke, name)) == []


@pytest.fixture(scope="module")
def synth_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    subprocess.run([sys.executable, os.path.join(TOOLS, "make_synth_dataset.py"), "--out",
                    str(root / "images"), "--n", "12", "--res", "40"], check=True,
                   capture_output=True, timeout=120)
    return root


@pytest.mark.parametrize("tier, loader", [("ram", "native"), ("store", "pil"),
                                          ("none", "auto"), ("auto", "auto")])
def test_bench_pipeline_torch_json(synth_folder, capsys, tier, loader):
    """One JSON line: the images, the tier and loader used, a positive draw
    rate over the requested draws."""
    rc = _tool("bench_pipeline_torch").main([
        "--root", str(synth_folder / "images"), "--scale", "2", "--tier", tier,
        "--loader", loader, "--batch", "4", "--draws", "16", "--warmup", "4",
        "--store_dir", str(synth_folder / f"store_{tier}_{loader}"), "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_images"] == 12 and rec["resolution"] == 16 and rec["draws"] == 16
    assert rec["draw_img_s"] > 0
    if tier != "auto":
        assert rec["tier_used"] == tier
    assert rec["loader"] == {"native": "native", "pil": "PIL"}.get(loader, rec["loader"])


@pytest.fixture
def fake_trainer(tmp_path):
    """Run 1 writes one metrics line and a `_latest` checkpoint alias, then
    hangs; a later run completes."""
    script = tmp_path / "fake_train.py"
    script.write_text(textwrap.dedent("""\
        import json, os, sys, time
        run_dir = sys.argv[1]
        with open(os.path.join(run_dir, "argv.log"), "a") as fh:
            fh.write(json.dumps(sys.argv[1:]) + "\\n")
        os.makedirs(os.path.join(run_dir, "ckpt"), exist_ok=True)
        open(os.path.join(run_dir, "ckpt", "G_latest.npz"), "w").close()
        with open(os.path.join(run_dir, "metrics.jsonl"), "a") as fh:
            fh.write('{"step": 1}\\n')
        marker = os.path.join(run_dir, "ran_once")
        if os.path.exists(marker):
            sys.exit(0)
        open(marker, "w").close()
        time.sleep(300)
    """))
    return script


def test_watchdog_restarts_after_a_stall(tmp_path, fake_trainer):
    """A trainer silent for longer than --stall_s is SIGTERMed (its exact
    PID); after two good probes it is relaunched with --ckpt_id RUN (the
    run has a `_latest` alias), and the watchdog exits 0 once it completes."""
    run_dir = tmp_path / "wd" / "run1"
    proc = subprocess.run(
        [sys.executable, WATCHDOG, "run1", "--save_root", str(tmp_path / "wd"),
         "--train_cmd", f"{sys.executable} {fake_trainer} {run_dir}", "--probe_cmd", "true",
         "--stall_s", "8", "--poll_s", "0.3", "--grace_s", "10", "--probe_interval_s", "0.1",
         "--max_restarts", "6", "--log_file", str(tmp_path / "child.log")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for line in ("STALL", "SIGTERM pid", "device probe OK (2/2)", "training completed (rc=0)"):
        assert line in proc.stdout
    launches = [json.loads(line) for line in (run_dir / "argv.log").read_text().splitlines()]
    assert len(launches) >= 2 and "--ckpt_id" not in launches[0]
    assert launches[-1][-2:] == ["--ckpt_id", "run1"]
    assert (run_dir / "watchdog_child.pid").read_text().isdigit()


def test_watchdog_gives_up_after_max_restarts(tmp_path):
    crash = tmp_path / "crash.py"
    crash.write_text("import sys; sys.exit(3)\n")
    proc = subprocess.run(
        [sys.executable, WATCHDOG, "run2", "--save_root", str(tmp_path / "wd"),
         "--train_cmd", f"{sys.executable} {crash}", "--probe_cmd", "true",
         "--poll_s", "0.2", "--probe_interval_s", "0.1", "--max_restarts", "2",
         "--log_file", str(tmp_path / "child.log")],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert proc.stdout.count("trainer exited rc=3") == 3
    assert "giving up after 2 restarts" in proc.stdout
