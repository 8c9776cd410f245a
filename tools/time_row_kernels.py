#!/usr/bin/env python3
"""Call and device times of the row kernels (`pixel_norm`,
`lrelu_pixel_norm`, `lrelu_pixel_norm_bwd`) and `minibatch_stddev_stat` of
one checkout of this repository, or of two in turns, on one CUDA card.

    python3 tools/time_row_kernels.py [--root DIR]
    python3 tools/time_row_kernels.py --ab OTHER_ROOT [--root DIR]

With `--root` (default: this checkout) it imports `pggan_tpu_torch` from
DIR, builds its kernels and runs this checkout's chip_smoke.py phase 6 and
10b timing (`time_kernels`, `time_train_kernels`) on them: the forwards at
pixel_norm's two path shapes ([16, 512], [16, 4, 4, 512]) and at the three
largest conv-epilogue shapes of the 256² model, the backward at those three,
minibatch_stddev_stat at [16, 4, 4, 512] sg 4, f32 and bf16: the call time
(eager calls), the device time (calls captured in a CUDA graph and
replayed) and the plain version's call time; pixel_norm's 4-D shapes also
against F.rms_norm, and minibatch_stddev_stat's call beside pixel_norm's in
the same turns. Only wrapper calls that every checkout of the port has are
made. It prints chip_smoke's lines and then one JSON object. With `--ab` it
runs that in four processes, OTHER_ROOT, DIR, DIR, OTHER_ROOT, and prints
for each entry the mean of each checkout's two runs and the runs
themselves (A = OTHER_ROOT, B = DIR), so two versions are compared on one
card in one call. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# configs.yaml's widths, which chip_smoke.py checks
DEPTHS = [512, 512, 512, 512, 256, 128, 64]


def _chip_smoke():
    """chip_smoke.py of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_root(root: str) -> dict:
    """{"kernel shape dtype": {"call_ms", "device_ms", "plain_ms"[,
    "rms_norm_call_ms", "rms_norm_device_ms" | "pixel_norm_call_ms"]}} for
    the package under `root`, from chip_smoke's phase 6 and 10b timing."""
    smoke = _chip_smoke()
    sys.path.insert(0, os.path.abspath(root))
    from pggan_tpu_torch.ops import kernels
    found = os.path.abspath(os.path.join(os.path.dirname(kernels.__file__), "..", ".."))
    if found != os.path.abspath(root):
        raise RuntimeError(f"imported pggan_tpu_torch from {found}, not {root}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_shapes = smoke.epilogue_shapes(DEPTHS, smoke.SCALE, smoke.BATCH)
    card = smoke.card_line()
    with torch.no_grad():
        times, rms = smoke.time_kernels(kernels, path_shapes, gen, card)
        train_times, pixel_norm_calls = smoke.time_train_kernels(kernels, gen, card)
    out = {}
    for (name, shape, dt), (call, device, plain) in {**times, **train_times}.items():
        entry = {"call_ms": call, "device_ms": device, "plain_ms": plain}
        if name == "pixel_norm" and (shape, dt) in rms:
            entry.update(zip(("rms_norm_call_ms", "rms_norm_device_ms"), rms[(shape, dt)]))
        if name == "minibatch_stddev_stat":
            entry["pixel_norm_call_ms"] = pixel_norm_calls[dt]
        out[f"{name} {list(shape)} {str(dt)[6:]}"] = entry
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="checkout whose kernels are timed")
    parser.add_argument("--ab", metavar="OTHER_ROOT",
                        help="time OTHER_ROOT and --root in turns (A, B, B, A)")
    ns = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_row_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    if not ns.ab:
        print(json.dumps({"root": os.path.abspath(ns.root), "card": _chip_smoke().card_line(),
                          "times": time_root(ns.root)}))
        return 0
    runs = []
    for root in (ns.ab, ns.root, ns.root, ns.ab):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    print(f"[time_row_kernels] A = {runs[0]['root']}, B = {runs[1]['root']}; runs in turns "
          f"A, B, B, A on {runs[0]['card']}; ms, the mean of each checkout's two runs "
          f"(the runs in brackets)")
    for key in runs[0]["times"]:
        line = []
        for metric in runs[0]["times"][key]:
            a1, b1, b2, a2 = (run["times"][key][metric] for run in runs)
            line.append(f"{metric} A {(a1 + a2) / 2:.4f} ({a1:.4f}, {a2:.4f}) "
                        f"B {(b1 + b2) / 2:.4f} ({b1:.4f}, {b2:.4f})")
        print(f"[time_row_kernels] {key}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
