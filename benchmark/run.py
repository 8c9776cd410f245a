"""Run one cell of the benchmark of pggan_tpu_torch once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the kernels' build, weights, data, warm-up and
the steps the check follows) is timed from the start of this process to the
window's start (`setup_s`). The window runs the cell's traffic for
`--seconds`; then, with `--trace 1`, the traced readings of the per-layer
metrics; then the program's state is freed and the plain reference checks
what the program produced. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error).

It needs as many CUDA cards as the cell names and exits with code 2
otherwise, printing no result; it exits with code 3, printing no result,
when a module of JAX or of the JAX package was loaded. Spans are written
to `$TMPDIR/benchmark_spans.jsonl` at the end.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)             # the folder's modules import as `benchmark.*`
sys.path.insert(0, os.path.dirname(_HERE))

import numpy as np  # noqa: E402

from benchmark import compare, harness  # noqa: E402


def derive_seeds(seed: int) -> dict:
    """The run's seeds, all drawn from --seed (any whole number ≥ 0)."""
    words = np.random.SeedSequence(int(seed)).generate_state(4, np.uint32)
    return {"config": int(words[0]) % (2 ** 31 - 64), "weights": int(words[1]),
            "latents": int(words[2]), "draw": int(words[3])}


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None, *, device=None, spec_path: str = harness.SPEC_PATH,
         data_dir: str = harness.BENCH_DIR) -> int:
    """`device`, `spec_path` and `data_dir` are for the CPU tests; a run from
    the command line takes the card or fails."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    if ns.seed < 0:
        ap.error("--seed must be >= 0")
    cell = harness.resolve(ns.workload, spec_path, data_dir)

    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"benchmark: {ns.workload} needs {cell.chips} CUDA card(s), found {have}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    spans = harness.Spans()
    driver_cls = harness.load_driver(cell.traffic["driver"]).Driver
    driver = driver_cls(cell.config, cell.traffic, derive_seeds(ns.seed), device, spans,
                        ns.seconds)
    driver.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    # the memory the process holds on the card: reserved, which holds the
    # CUDA graphs' private pools (a replay allocates nothing, so the
    # allocated peak does not see its working memory)
    peak = 0
    if on_card:
        peak = torch.cuda.max_memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)

    end_to_end = driver.window(ns.seconds)
    if on_card:
        window_peak = torch.cuda.max_memory_reserved(device)
        driver.ctx["peak_window_bytes"] = window_peak
        peak = max(peak, window_peak)
    if ns.trace:
        driver.trace()
    driver.release()
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = driver.check()
    check_s = time.perf_counter() - t_check
    correct, checks = compare.verdict(numbers, cell.limits, driver.failed)

    forbidden = harness.forbidden_loaded()
    if forbidden:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {forbidden[:10]}",
              file=sys.stderr)
        return 3

    metrics = {}
    if ns.trace:
        for m in cell.per_layer:
            value = harness.load_reader(m["name"]).read(driver.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        end_to_end["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "card": harness.card_line() if on_card else "cpu"}
    result = {"correct": bool(correct), "attempted": int(driver.attempted),
              "failed": int(driver.failed), "metrics": metrics, "device": dev}
    prof = driver.ctx.get("profile")
    if ns.trace and prof is not None:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.wall_s
        result["breakdown"] = {"device_ops": harness.top(prof.kernel_s),
                               "idle_gaps": harness.top(prof.idle_by_span)}
    result["checks"] = {name: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for name, c in checks.items()}

    spans.write(os.path.join(tempfile.gettempdir(), "benchmark_spans.jsonl"))
    print(f"benchmark: {ns.workload} seed {ns.seed} on {dev['card']}; setup_s {setup_s:.3f}, "
          f"check {check_s:.1f} s, run {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"check failed: {driver.failed} of {driver.attempted} (limit 0)", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
