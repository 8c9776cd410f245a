#!/usr/bin/env python
"""Stall detection and automatic resume for the PyTorch port's trainer (the
counterpart of tools/train_watchdog.py, which supervises train.py and probes
with JAX):

    python tools/train_watchdog_torch.py RUN_ID --config configs.yaml \\
        [--save_root train_result] [-- extra flags of pggan_tpu_torch.train]

It runs `python -m pggan_tpu_torch.train RUN_ID --config ...` and watches it:
  * liveness = the mtime of {save_root}/{RUN_ID}/metrics.jsonl (the trainer
    appends a line every loss_cycle steps), counted from the later of that
    and the last launch; silence longer than `--stall_s` is a stall;
  * on a stall: SIGTERM (the trainer checkpoints and exits), SIGKILL after
    `--grace_s`;
  * then the card is probed from fresh subprocesses (a small matmul through
    `torch.cuda`, bounded by `--probe_timeout_s`) every
    `--probe_interval_s`; after two probes in a row succeed the trainer is
    relaunched with `--ckpt_id RUN_ID`, which resumes from the `_latest`
    checkpoint aliases (`utils/checkpoint.py`), when the run has one;
  * a trainer that exits non-zero is restarted the same way, up to
    `--max_restarts`; exit 0 means the run completed, and so does the
    watchdog.

Kills go to the recorded PID only; it is also written to
{save_root}/{RUN_ID}/watchdog_child.pid. The watchdog imports neither torch
nor JAX: every contact with the card happens in a disposable subprocess.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE_SRC = ("import torch; x = torch.ones((64, 64), device='cuda'); "
             "print('probe_ok', float((x @ x).sum()))")


def log(msg: str) -> None:
    print(f"[watchdog {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def run_probe(cmd, timeout_s: float) -> bool:
    """Whether `cmd` exits 0 within `timeout_s` (a hung card hangs the
    probe rather than failing it)."""
    try:
        return subprocess.run(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL, timeout=timeout_s).returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


def terminate(proc: subprocess.Popen, grace_s: float) -> None:
    """SIGTERM (the trainer checkpoints, then exits), SIGKILL after the
    grace period. The recorded PID only."""
    if proc.poll() is not None:
        return
    log(f"SIGTERM pid {proc.pid}")
    try:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=grace_s)
        return
    except ProcessLookupError:
        return
    except subprocess.TimeoutExpired:
        pass
    log(f"SIGKILL pid {proc.pid} (no exit after {grace_s:.0f}s grace)")
    try:
        proc.kill()
    except ProcessLookupError:
        pass
    proc.wait()


def has_checkpoint(run_dir: str) -> bool:
    """Whether the run has written a checkpoint (its `_latest` aliases)."""
    ckpt = os.path.join(run_dir, "ckpt")
    return os.path.isdir(ckpt) and any(f.endswith("_latest.npz") for f in os.listdir(ckpt))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        usage="train_watchdog_torch.py RUN_ID [options] [-- trainer flags]")
    ap.add_argument("run_id")
    ap.add_argument("--config", default="configs.yaml")
    ap.add_argument("--save_root", default="train_result",
                    help="the config's save_root (where metrics.jsonl is)")
    ap.add_argument("--stall_s", type=float, default=1500.0,
                    help="silence of metrics.jsonl that declares a stall")
    ap.add_argument("--grace_s", type=float, default=120.0)
    ap.add_argument("--probe_timeout_s", type=float, default=90.0)
    ap.add_argument("--probe_interval_s", type=float, default=240.0)
    ap.add_argument("--poll_s", type=float, default=30.0)
    ap.add_argument("--max_restarts", type=int, default=20)
    ap.add_argument("--log_file", default=None,
                    help="the trainer's stdout and stderr (default "
                         "{save_root}/{run_id}/train.log, appended)")
    ap.add_argument("--train_cmd", default=None,
                    help="another trainer command (shlex-split; '--ckpt_id RUN_ID' is "
                         "appended on a resume)")
    ap.add_argument("--probe_cmd", default=None,
                    help="another card probe (shlex-split; exit 0 = healthy)")
    ns, extra = ap.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]

    run_dir = os.path.join(ns.save_root, ns.run_id)
    os.makedirs(run_dir, exist_ok=True)
    liveness = os.path.join(run_dir, "metrics.jsonl")
    pid_file = os.path.join(run_dir, "watchdog_child.pid")
    log_path = ns.log_file or os.path.join(run_dir, "train.log")
    probe_cmd = (shlex.split(ns.probe_cmd) if ns.probe_cmd
                 else [sys.executable, "-c", PROBE_SRC])
    last_launch = time.time()

    def launch() -> subprocess.Popen:
        nonlocal last_launch
        cmd = (shlex.split(ns.train_cmd) if ns.train_cmd else
               [sys.executable, "-m", "pggan_tpu_torch.train", ns.run_id,
                "--config", ns.config])
        if has_checkpoint(run_dir):
            cmd += ["--ckpt_id", ns.run_id]          # the latest aliases
        cmd += list(extra)
        with open(log_path, "ab", buffering=0) as out:
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=out)
        last_launch = time.time()
        with open(pid_file, "w") as fh:
            fh.write(str(proc.pid))
        log(f"launched pid {proc.pid}: {' '.join(cmd)} (log: {log_path})")
        return proc

    def wait_for_card() -> None:
        ok_streak = 0
        while ok_streak < 2:
            if run_probe(probe_cmd, ns.probe_timeout_s):
                ok_streak += 1
                log(f"device probe OK ({ok_streak}/2)")
            else:
                ok_streak = 0
                log(f"device probe failed; waiting {ns.probe_interval_s:.0f}s")
            if ok_streak < 2:
                time.sleep(ns.probe_interval_s)

    restarts = 0
    proc = launch()
    start = time.time()
    while True:
        time.sleep(ns.poll_s)
        rc = proc.poll()
        if rc is not None:
            if rc == 0:
                log(f"training completed (rc=0) after {(time.time() - start) / 3600:.2f} h")
                return 0
            log(f"trainer exited rc={rc}")
        else:
            try:
                basis = max(os.path.getmtime(liveness), last_launch)
            except OSError:
                basis = last_launch
            age = time.time() - basis
            if age < ns.stall_s:
                continue
            log(f"STALL: {liveness} silent for {age:.0f}s (> {ns.stall_s:.0f}s)")
            terminate(proc, ns.grace_s)
        restarts += 1
        if restarts > ns.max_restarts:
            log(f"giving up after {ns.max_restarts} restarts")
            return 1
        log(f"waiting for the card before restart #{restarts}")
        wait_for_card()
        proc = launch()


if __name__ == "__main__":
    raise SystemExit(main())
