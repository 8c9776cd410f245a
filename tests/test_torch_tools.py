"""The port's tools on the CPU: `tools/bench_e2e_torch.py --device cpu` (the
trainer's rate; its device numbers are null there), `tools/bench_pipeline_
torch.py --json` on a folder that `tools/make_synth_dataset.py` writes (each
tier and loader), and `tools/train_watchdog_torch.py` with a fake trainer and
probe, as tests/test_watchdog.py drives the JAX package's watchdog: it
restarts the trainer after a stall with `--ckpt_id` and gives up after
`--max_restarts`. No JAX program is compiled; the watchdog and its children
import no framework.
"""

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


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("extra, k, dispatch", [
    ([], 1, "eager"), (["--steps_per_dispatch", "2"], 2, "eager"),
    (["--r1_interval", "2"], 1, "eager")], ids=["single", "spd2", "lazy2"])
def test_bench_e2e_torch_on_the_cpu(tmp_path, capsys, extra, k, dispatch):
    """Scale 1 (8×8) at narrow widths, 2 timed steps: one JSON line with the
    trainer's rate; the device numbers are null (not measured) on the CPU."""
    config = tmp_path / "tiny.yaml"
    config.write_text("latent_dim: 16\ndepths: [16, 8]\nnum_data_workers: 2\n")
    rc = _tool("bench_e2e_torch").main([
        "--device", "cpu", "--scale", "1", "--batch", "4", "--steps", "2", "--warmup", "1",
        "--config", str(config), *extra])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["scale"] == 1 and result["batch"] == 4
    assert result["steps_per_dispatch"] == k and result["dispatch"] == dispatch
    assert result["value"] > 0 and result["step_ms"] > 0 and result["steps"] >= 2
    assert result["device_step_ms"] is result["outside_share"] is result["idle_share"] is None


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
