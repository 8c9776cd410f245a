"""Chunked dispatch on the card: a scale's step captured in a CUDA graph and
replayed once a step — the counterpart of `make_chunked_train_step`
(`pggan_tpu/train/step.py:416-507`).

JAX runs a window of k steps between host actions as one dispatched program
(`lax.scan`). The port captures the step of one scale with
`torch.cuda.CUDAGraph` over static inputs — a batch slot, the alpha scalar
and the R1 scale — and replays it once for each step of the window: the
host issues one graph launch a step in place of the step's kernels and its
Python. Three kinds of step, each captured once a scale:

- "step": the every-step program (`steps_per_dispatch` windows at
  `r1_interval: 1`);
- "lead": the first step of a lazy-R1 window, its penalty scaled by the
  window length that `r1_scale` holds (JAX's `r1_leading` sub-step 0);
- "tail": the window's other steps, without the penalty.

The first run of a kind is a real step of the run, eager, on the capture
stream: it makes what the graph must find made (cuDNN and cuBLAS handles
and workspaces, Adam's moments, autograd's state), as the torch docs' warm-up
before a capture. Then the kind is captured. A capture runs nothing, so the
state moves only by real steps. Later runs of the kind replay it.

- The state's random generator is registered with every graph: a replay
  draws z₁, z₂ and eps at the generator's offset and advances it as an
  eager step does, so k replays leave `rng.get_state()` where k eager steps
  do (an exact resume depends on it).
- The kinds of one scale share one memory pool; they never run at once.
- A graph holds the addresses of the weights, Adam's moments, G_ema and the
  slots: whatever replaces one of them (a scale jump's new optimizers, a
  checkpoint load) must drop the `StepGraphs` (the trainer does).
- The step's `grad_sync` (NCCL's all-reduce in a process group) is captured
  with it.
- A kernel wrapper counts its launch when it is called, so at capture, and a
  replay calls no wrapper. Each graph keeps its capture's counts and its
  replays (`launches_replayed`).

There is no fallback: a capture or a replay that fails raises. On the CPU
the trainer runs the eager steps (`graphed`), as the kernels run their plain
versions there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from pggan_tpu_torch.ops import kernels

# kind → the `make_train_step` options of its step (`r1_scale` is the
# StepGraphs' scalar for "lead")
_KINDS = {"step": {}, "lead": {"include_r1": True}, "tail": {"include_r1": False}}

Metrics = Dict[str, torch.Tensor]


def graphed(device) -> bool:
    """Whether windows on `device` replay captured steps: on a card."""
    return torch.device(device).type == "cuda"


@dataclass
class Captured:
    graph: "torch.cuda.CUDAGraph"
    metrics: Metrics            # static outputs, rewritten by every replay
    launches: Dict[str, int]    # the kernel wrappers' calls at capture
    seconds: float              # the capture's wall time
    replays: int = 0


class StepGraphs:
    """The captured steps of one scale over one train state.

    `make_step(**options)` builds the scale's step (`make_train_step` with
    the trainer's data-parallel settings). `note` is added to the error of a
    failed capture."""

    def __init__(self, state, make_step: Callable, device, *, note: str = "",
                 verbose: bool = False):
        self.state = state
        self.device = torch.device(device)
        self.note = note
        self.verbose = verbose
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.alpha = torch.zeros((), device=self.device)
        self.r1_scale = torch.ones((), device=self.device)
        self._values = {"alpha": None, "r1_scale": 1.0}
        self.slot: Optional[torch.Tensor] = None
        self._steps = {kind: make_step(**options, **(
            {"r1_scale": self.r1_scale} if kind == "lead" else {}))
            for kind, options in _KINDS.items()}
        self.captured: Dict[str, Captured] = {}

    def _fill(self, name: str, value: float) -> None:
        if self._values[name] != value:     # one small launch, only on a change
            getattr(self, name).fill_(value)
            self._values[name] = value

    def run(self, kind: str, batch: torch.Tensor, alpha: float,
            r1_scale: float = 1.0) -> Metrics:
        """One step of `kind` on `batch` at `alpha` (`r1_scale`: the lead's
        window length). Returns its metrics: a replay's are the graph's
        static outputs, which its next replay rewrites."""
        if self.slot is None:
            self.slot = torch.empty_like(batch, device=self.device)
        elif batch.shape != self.slot.shape or batch.dtype != self.slot.dtype:
            raise ValueError(f"batch {tuple(batch.shape)} {batch.dtype} does not fit the "
                             f"captured slot {tuple(self.slot.shape)} {self.slot.dtype}")
        # on the current stream, which the replay and the batch's producer use
        self.slot.copy_(batch, non_blocking=True)
        self._fill("alpha", float(alpha))
        if kind == "lead":
            self._fill("r1_scale", float(r1_scale))
        captured = self.captured.get(kind)
        if captured is not None:
            captured.graph.replay()
            captured.replays += 1
            return captured.metrics
        metrics = self._warm_up(kind)
        self.captured[kind] = self._capture(kind)
        return metrics

    def _warm_up(self, kind: str) -> Metrics:
        """A real step, eager, on the capture stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            metrics, _ = self._steps[kind](self.state, self.slot, self.alpha)
        current.wait_stream(self.stream)
        return metrics

    def _capture(self, kind: str) -> Captured:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.rng)
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                metrics, _ = self._steps[kind](self.state, self.slot, self.alpha)
        except RuntimeError as exc:
            raise RuntimeError(f"capturing the {kind} step in a CUDA graph failed; a "
                               f"chunked window does not run eagerly on a card"
                               f"{self.note}: {exc}") from exc
        captured = Captured(graph, metrics, {k: kernels.launches[k] - before[k]
                                             for k in before}, time.perf_counter() - t0)
        if self.verbose:
            print(f"[pggan_tpu_torch] captured the {kind} step in a CUDA graph in "
                  f"{captured.seconds:.2f} s ({sum(captured.launches.values())} kernel "
                  f"wrapper launches a replay)")
        return captured

    def launches_replayed(self) -> Dict[str, int]:
        """The kernel launches the replays made: each graph's launches at
        capture times its replays."""
        total = dict.fromkeys(kernels.launches, 0)
        for captured in self.captured.values():
            for name, n in captured.launches.items():
                total[name] += n * captured.replays
        return total
