"""The `train` driver: the port's trainer at one pinned scale, driven by one
call back to back (`ProgressiveGANTrainer.train_window(k)` or
`train_step()`), as `fit` issues them in a stretch with no host action.

Set-up builds the trainer through `registry.create_model`, pins the
schedule at the model's scale and the mix's alpha (the checkpoint-load
path: networks, data and step rebuilt there), loads the benchmark's weights,
and runs `warmup_calls` calls, which build every kernel and capture every
graph the window replays. Then it puts the same trainer back at the seed's
state in place (weights, Adam's moments and counts, the latent generator;
the captured graphs keep their addresses) and runs one more call, whose
first CHECK_STEPS steps are recorded: each step's batch and losses, the
first step's gradients from Adam's first moment, the weights after the
last. The window follows on the same object.

Mix parameters: `call` ('train_window' | 'train_step'), `steps_per_call`,
`r1_interval`, `alpha`, `warmup_calls`, `trace_calls` (calls under the
profiler), `device_replays` (replays a step kind is timed over),
`synthetic_dataset_size`.
"""

from __future__ import annotations

import gc
import os
import statistics
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, harness, weights
from benchmark.flops import step_model_tflops
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

LOSSES = ("L_D", "L_G", "L_D_r1")
CHECK_STEPS = 3             # the steps the reference follows
LOOKAHEAD_CALLS = 2         # calls the host may run ahead of the device
SPANS = ("train_window", "train_step", "pipeline.next", "step")


class SpanFeed:
    """The trainer's batch stream, each `next` inside a span."""

    def __init__(self, pipeline, spans: harness.Spans):
        self.pipeline, self.spans = pipeline, spans

    def __next__(self):
        with self.spans.span("pipeline.next"):
            return next(self.pipeline)

    def close(self):
        self.pipeline.close()


class Recorder:
    """What the checked steps leave: batches, losses, the first step's
    gradients (Adam's first moment / (1 − β1)) and the weights after the
    last checked step."""

    def __init__(self, state, steps: int, beta1: float):
        self.state, self.steps, self.beta1 = state, steps, beta1
        self.count = 0
        self.batches: List[torch.Tensor] = []
        self.losses: List[Dict[str, torch.Tensor]] = []
        self.grads = self.params = None

    def _named(self):
        return {"G": (self.state.G, self.state.opt_G), "D": (self.state.D, self.state.opt_D)}

    def after(self, batch: torch.Tensor, metrics: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        if self.count > self.steps:
            return
        self.batches.append(batch.detach().clone())
        self.losses.append({k: metrics[k].detach().clone() for k in LOSSES})
        if self.count == 1:
            self.grads = {net: {k: opt.state[p]["exp_avg"].detach().clone() / (1.0 - self.beta1)
                                if p in opt.state else torch.zeros_like(p)
                                for k, p in module.named_parameters()}
                          for net, (module, opt) in self._named().items()}
        if self.count == self.steps:
            self.params = {net: {k: p.detach().clone() for k, p in module.named_parameters()}
                           for net, (module, _) in self._named().items()}


def _recording_step(step, recorder: Recorder):
    def recorded(state, img_real, alpha, **kw):
        metrics, images = step(state, img_real, alpha, **kw)
        recorder.after(img_real, metrics)
        return metrics, images
    return recorded


class Driver:
    def __init__(self, config: dict, traffic: dict, seeds: dict, device: torch.device,
                 spans: harness.Spans, seconds: float):
        # `seconds` is the sampling driver's; the checked steps need no window
        self.model = dict(config["model"])
        self.traffic = traffic
        self.seeds = seeds
        self.device = device
        self.on_card = device.type == "cuda"
        self.spans = spans
        self.trainer = None
        self.k = int(traffic["steps_per_call"])
        self.batch = int(self.model["batch_per_gpu"])
        self.ctx: dict = {"on_card": self.on_card, "model": self.model, "batch": self.batch,
                          "itemsize": 2 if self.model["compute_dtype"] == "bfloat16" else 4}
        self.attempted = self.failed = 0
        self.checked: Optional[dict] = None
        self._f32_reference: Optional[dict] = None
        self._control: Optional[dict] = None

    # -- set-up ---------------------------------------------------------------
    def _config(self):
        from pggan_tpu_torch.config import Config

        cfg = Config({k: v for k, v in self.model.items() if k != "scale"})
        cfg.update({
            "seed": self.seeds["config"], "r1_interval": int(self.traffic["r1_interval"]),
            "steps_per_dispatch": 1, "data_backend": "synthetic",
            "synthetic_dataset_size": int(self.traffic["synthetic_dataset_size"]),
            "use_mGPU": False, "ckpt_id": None, "use_validation": False, "fid_cycle": 0,
            "loss_cycle": 10 ** 9, "test_cycle": 10 ** 9, "ckpt_cycle": 10 ** 9,
            # nothing is written there: no log, grid or checkpoint is due
            "save_root": os.path.join(tempfile.gettempdir(), "benchmark_train_result")})
        return cfg

    def _call(self):
        t = self.trainer
        if self.traffic["call"] == "train_window":
            def call():
                with self.spans.span("train_window"):
                    t.train_window(self.k)
        else:
            def call():
                with self.spans.span("train_step"):
                    t.train_step()
        return call

    def _reset(self) -> None:
        """The trainer's state back at the seed's, in place."""
        state = self.trainer.state
        w0 = weights.make_weights(self.model, self.seeds["weights"], self.device)
        weights.load_into(state.G, w0["G"])
        weights.load_into(state.D, w0["D"])
        with torch.no_grad():
            for opt in (state.opt_G, state.opt_D):
                for s in opt.state.values():
                    for v in s.values():
                        v.zero_()
        state.rng.manual_seed(self.seeds["latents"])

    def _hook(self, recorder: Recorder):
        """Record the checked steps where the call runs them: the graph
        runner's `run` on a card's window, else the eager steps."""
        t = self.trainer
        if self.traffic["call"] == "train_step":
            inner = t._step_fn
            t._step_fn = _recording_step(inner, recorder)
            return lambda: setattr(t, "_step_fn", inner)
        if t.use_graphs:
            runner = t._step_graphs()
            inner_run = runner.run

            def run(kind, batch, alpha, r1_scale=1.0):
                metrics = inner_run(kind, batch, alpha, r1_scale=r1_scale)
                recorder.after(batch, metrics)
                return metrics
            runner.run = run
            return lambda: delattr(runner, "run")
        inner_make = t._make_step
        t._make_step = lambda **kw: _recording_step(inner_make(**kw), recorder)
        return lambda: delattr(t, "_make_step")

    def setup(self) -> None:
        from pggan_tpu_torch.registry import create_model

        harness.set_tf32(self.model)
        t = self.trainer = create_model(self._config(), device=self.device)
        sched = t.schedule
        sched.scale_index = int(self.model["scale"])
        sched.alpha = float(self.traffic["alpha"])
        sched.next_scale_jump_step = t.global_step + 10 ** 9
        sched.next_alpha_jump_step = 0
        t.initialize_models()
        t.set_dataset()
        t.set_data_iterator()
        t._build_step_fn()
        t._pipeline = SpanFeed(t._pipeline, self.spans)
        self.call = self._call()
        self._reset()
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call()
        self._sync()
        self.first_checked = int(self.traffic["warmup_calls"]) * self.k
        self._reset()
        n = CHECK_STEPS
        recorder = Recorder(t.state, n, float(self.model["beta1"]))
        unhook = self._hook(recorder)
        try:
            while recorder.count < n:
                self.call()
        finally:
            unhook()
        self._sync()
        w0 = weights.make_weights(self.model, self.seeds["weights"], self.device)
        self.checked = {
            "batches": [b.cpu() for b in recorder.batches],
            "losses": [{k: float(v) for k, v in m.items()} for m in recorder.losses],
            "grads": compare.to_host(recorder.grads),
            "change": compare.changes(recorder.params, w0)}
        del recorder, w0

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    # -- the window -----------------------------------------------------------
    def _metrics_finite(self) -> torch.Tensor:
        m = self.trainer._last_metrics
        return torch.isfinite(torch.stack([m[k].float() for k in LOSSES])).all()

    def window(self, seconds: float) -> Dict[str, float]:
        """Calls back to back for `seconds`, then the synchronised end of the
        last; the host runs at most LOOKAHEAD_CALLS calls ahead."""
        pending: deque = deque()
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        calls = 0
        t0 = time.perf_counter()
        while True:
            self.call()
            bad += (~self._metrics_finite()).long()
            calls += 1
            if self.on_card:
                event = torch.cuda.Event()
                event.record()
                pending.append(event)
                if len(pending) > LOOKAHEAD_CALLS:
                    pending.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        self.calls = calls
        self.attempted = calls * self.k
        self.failed = int(bad) * self.k
        images = self.attempted * self.batch
        r1 = int(self.traffic["r1_interval"])
        m = self.model
        self.ctx.update(window_s=elapsed, steps=self.attempted, flops=1e12 * self.attempted *
                        step_model_tflops(m["depths"], int(m["scale"]), self.batch,
                                          int(m["latent_dim"]), str(m["loss_mode"]), r1))
        return {"train_img_per_s": images / elapsed}

    # -- the traced readings --------------------------------------------------
    def _kinds(self) -> List[str]:
        """The step kinds of one call: a lazy window's lead and tails."""
        if int(self.traffic["r1_interval"]) > 1:
            return ["r1"] + ["plain"] * (self.k - 1)
        return ["r1"] * self.k

    def trace(self) -> None:
        """Device ms of each step kind (CUDA events), then `trace_calls`
        calls under the profiler."""
        if not self.on_card:
            return
        t = self.trainer
        device_ms = {}
        replays = int(self.traffic["device_replays"])
        if t.use_graphs and self.traffic["call"] == "train_window":
            runner = t._step_graphs()
            for kind, name in (("lead", "r1"), ("tail", "plain")):
                graph = runner.captured[kind].graph
                for _ in range(replays):
                    graph.replay()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(replays):
                    graph.replay()
                end.record()
                end.synchronize()
                device_ms[name] = start.elapsed_time(end) / replays
        else:
            # calls back to back with events between them, as the window runs
            # them: after the first, each call's kernels wait on the device,
            # not on the host, so an interval holds one call's device time
            events = [torch.cuda.Event(enable_timing=True) for _ in range(replays + 2)]
            events[0].record()
            for event in events[1:]:
                self.call()
                event.record()
            events[-1].synchronize()
            device_ms["r1"] = statistics.median(
                a.elapsed_time(b) / self.k for a, b in zip(events[1:-1], events[2:]))
        kinds = self._kinds()
        self.ctx["device_ms"] = device_ms
        self.ctx["steps_device_s"] = self.calls * sum(
            device_ms["r1" if k == "r1" else "plain"] for k in kinds) / 1e3

        def block():
            for _ in range(int(self.traffic["trace_calls"])):
                self.call()
            self._sync()
        self.spans.profiling = True
        try:
            self.ctx["profile"] = harness.profile(block, SPANS)
        finally:
            self.spans.profiling = False
        self.ctx["profiled_kinds"] = kinds * int(self.traffic["trace_calls"])

    # -- the check ------------------------------------------------------------
    def release(self) -> None:
        if self.trainer is not None:
            self.trainer.close()
            self.trainer = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def reference(self, quant: Optional[str] = None) -> dict:
        """The plain reference over the checked steps: its losses, the first
        step's gradients and the weights' change, on the host."""
        m = self.model
        n = CHECK_STEPS
        w0 = weights.make_weights(m, self.seeds["weights"], self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["latents"])
        latent = (self.batch, int(m["latent_dim"]))
        latents = []
        for _ in range(n):
            z1 = torch.randn(latent, generator=gen, device=self.device)
            z2 = torch.randn(latent, generator=gen, device=self.device)
            torch.rand((self.batch,), generator=gen, device=self.device)     # the step's eps
            latents.append((z1, z2))
        r1 = int(self.traffic["r1_interval"])
        scales = [float(r1) if i % r1 == 0 else None for i in range(n)]
        batches = [torch.from_numpy(b).to(self.device) for b in self._reference_batches()]
        out = ref_train.run_steps(m, w0["G"], w0["D"], batches, latents,
                                  float(self.traffic["alpha"]), scales, quant)
        return {"losses": out["losses"], "grads": compare.to_host(out["grads"]),
                "change": compare.changes(out["params"], w0)}

    def _reference_batches(self) -> List[np.ndarray]:
        return ref_data.train_batches(
            self.seeds["config"], int(self.model["scale"]),
            int(self.traffic["synthetic_dataset_size"]), self.batch, self.first_checked,
            CHECK_STEPS)

    def _f32(self) -> dict:
        if self._f32_reference is None:
            self._f32_reference = self.reference()
        return self._f32_reference

    def check(self) -> Dict[str, float]:
        """The numbers against the f32 reference (TF32 off)."""
        ref_batches = self._reference_batches()
        mismatch = sum(int((b.numpy() != r).sum()) if b.shape == r.shape else b.numel()
                       for b, r in zip(self.checked["batches"], ref_batches))
        numbers = compare.training_numbers(self.checked, self._f32())
        numbers["batch_mismatch"] = float(mismatch)
        return numbers

    def raw_losses(self) -> dict:
        """Each checked step's losses: the program's, the reference's and,
        when it was run, the control's."""
        out = {"program": self.checked["losses"], "reference": self._f32()["losses"]}
        if self._control is not None:
            out["control"] = self._control["losses"]
        return out

    def look(self) -> dict:
        """The leaves behind the gradient and change gaps and the gradient's
        difference, for the program and, when it was run, the control."""
        f32 = self._f32()
        ref = {q: compare.leaf_norms(f32[q]) for q in ("grads", "change")}
        kept = compare.kept_leaves(ref["grads"])
        sides = {"program": self.checked, "control": self._control}
        return {side: {**{q: compare.gap_look(compare.leaf_norms(got[q]), ref[q], kept)
                          for q in ("grads", "change")},
                       "grad_diff": compare.diff_look(got["grads"], f32["grads"], kept)}
                for side, got in sides.items() if got is not None}

    def control(self) -> Dict[str, float]:
        """The numbers of the reference in the precision below the
        configuration's, put in the program's place."""
        self._control = self.reference(ref.CONTROL[self.model["compute_dtype"]])
        return compare.training_numbers(self._control, self._f32())
