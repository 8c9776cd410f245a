"""What every cell shares: finding a cell's files by the names in
`BENCHMARK.json`, the spans the benchmark records around its calls into
the program, the profiler's reading, the card's line, and the check that
no JAX module was loaded.

A cell `<config>.<traffic>` is resolved to
  configs/<config>.json    the model as it is run (and its source, cuts,
                           assumptions and precision),
  traffic/<traffic>.json   the mix: a driver kind (drivers/<kind>.py) and
                           its parameters,
  limits/<cell>.json       the limit of each number the check compares,
  metrics/<metric>.py      one reader for each per-layer metric (or for
                           each quantity: metrics/mfu.py reads mfu.train
                           and mfu.sample),
all under the benchmark's folder, by name alone.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(REPO_DIR, "BENCHMARK.json")

# top-level module names that no run may load, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pggan_tpu", "bench", "chip_smoke", "tools")

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 without TF32, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, spec_path: str = SPEC_PATH, data_dir: str = BENCH_DIR) -> Cell:
    """The cell `workload` of the spec, with its files read from
    `data_dir`. Raises KeyError for an unknown cell or a missing file."""
    spec = _load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {spec_path}; known: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config_file = configs[entry["config"]]["file"]
    config = _load_json(os.path.join(os.path.dirname(spec_path), config_file)
                        if not os.path.isabs(config_file) else config_file)
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config,
        traffic=_load_json(os.path.join(data_dir, "traffic", entry["traffic"] + ".json")),
        limits=_load_json(os.path.join(data_dir, "limits", workload + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def load_driver(kind: str):
    """drivers/<kind>.py as a module."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def load_reader(metric: str):
    """metrics/<metric>.py as a module (a metric's name may hold dots), else
    metrics/<the name up to its first dot>.py: one reader serves a quantity
    that is split by the end-to-end metric it moves (`mfu.train`,
    `mfu.sample`)."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def set_tf32(model: dict) -> None:
    """TF32 off where the configuration states float32, so that its float32
    convolutions and matrix products compute in float32 (PyTorch lets cuDNN
    run them in TF32 by default); a bfloat16 configuration keeps the
    defaults."""
    if model["compute_dtype"] == "float32":
        import torch

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or 'not read'."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclass
class Spans:
    """Spans the benchmark records around its calls into the program:
    (name, start ns, end ns) on the host's monotonic clock, kept in memory.
    While `profiling` is set each span is also a `record_function` range, so
    the profiler's trace names what the host was doing."""
    records: List[tuple] = field(default_factory=list)
    profiling: bool = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        if self.profiling:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter_ns()))

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for name, t0, t1 in self.records:
                f.write(json.dumps({"name": name, "start_ns": t0, "end_ns": t1}) + "\n")


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

@dataclass
class Profile:
    """What one profiled stretch showed: its wall, the union of the device's
    kernel intervals, the kernels' summed time by name, and the idle time
    by the benchmark span the host was in (seconds)."""
    wall_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_by_span: Dict[str, float]


def profile(fn, span_names) -> Optional[Profile]:
    """Run `fn()` (which ends with a synchronisation) under torch.profiler
    and read its trace; None when the trace holds no device kernel."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels, marks = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append(e)
        elif e.name in span_names:
            marks.append((e.time_range.start, e.time_range.end, e.name))
    if not kernels:
        return None
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end, gaps = 0.0, intervals[0][0], []
    for start, stop in intervals:
        if start > end:
            gaps.append((end, start))
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    kernel_s: Dict[str, float] = {}
    for e in kernels:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        # the innermost (latest-starting) span that holds the gap's start
        inside = [m for m in marks if m[0] <= g0 < m[1]]
        name = max(inside)[2] if inside else "(no span)"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    return Profile(wall, busy / 1e6, kernel_s, idle)


NAME_CHARS = 160


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest entries, names cut to NAME_CHARS (a kernel's demangled
    name runs to hundreds of characters of template arguments)."""
    return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
