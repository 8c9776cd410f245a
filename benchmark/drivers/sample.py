"""The `sample` driver: the port's generator served in a closed loop, the
demo's sampling loop without its JPEG writes, from one closed-loop client:
a request is sent when the one before has come back. A request: `batch` latents drawn on
the card from the request's own seed → `Generator.forward(z, alpha,
compute_dtype)` → the finite check (one synchronisation, as the demo) →
`denorm_to_uint8` → the copy to the host.

Set-up builds G at the model's scale and loads the benchmark's weights, then
serves `warmup_requests` requests (every shape the window sends) and times
them to choose which requests to keep for the check: those whose number is
`offset` modulo a stride that leaves about `check_requests` of the window's,
the offset drawn from the seed. The check runs the reference on their
latents once the window has closed.

Mix parameters: `batch`, `alpha`, `warmup_requests`,
`check_requests`, `trace_requests` (requests under the profiler),
`device_forwards` (forwards enqueued back to back for the device time).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, harness, weights
from benchmark.flops import g_forward_flops
from benchmark.reference import model as ref

SPANS = ("request", "latents", "forward", "finite", "denorm", "to_host")
# request numbers of the warm-up and traced requests, apart from the window's
WARMUP_IDS = 10 ** 9


def denorm(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → uint8: clip(x·0.5 + 0.5, 0, 1)·255, truncated (the
    reference sampler's own convention)."""
    return (torch.clamp(images.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


class Driver:
    def __init__(self, config: dict, traffic: dict, seeds: dict, device: torch.device,
                 spans: harness.Spans, seconds: float):
        self.model = dict(config["model"])
        self.seconds = float(seconds)
        self.traffic = traffic
        self.seeds = seeds
        self.device = device
        self.on_card = device.type == "cuda"
        self.spans = spans
        self.batch = int(traffic["batch"])
        self.alpha = float(traffic["alpha"])
        self.dtype = torch.bfloat16 if self.model["compute_dtype"] == "bfloat16" else torch.float32
        self.ctx: dict = {"on_card": self.on_card, "model": self.model, "batch": self.batch,
                          "itemsize": 2 if self.dtype == torch.bfloat16 else 4}
        self.G = None
        self.gen = None
        self.kept: Dict[int, np.ndarray] = {}
        self.attempted = self.failed = 0
        self.requests = 0

    def _latents(self, i: int) -> torch.Tensor:
        self.gen.manual_seed(self.seeds["latents"] * 1_000_003 + i)
        return torch.randn((self.batch, int(self.model["latent_dim"])), generator=self.gen,
                           device=self.device)

    def setup(self) -> None:
        from pggan_tpu_torch.models.generator import Generator
        from pggan_tpu_torch.utils.image import denorm_to_uint8

        m = self.model
        harness.set_tf32(m)
        G = Generator(latent_dim=int(m["latent_dim"]), depths=m["depths"],
                      scale=int(m["scale"]), output_dim=int(m["output_dim"]),
                      equalized_lr=bool(m["equalized_lr"]),
                      init_bias_to_zero=bool(m["init_bias_to_zero"]),
                      slope=float(m["LReLU_slope"]),
                      apply_pixel_norm=bool(m["apply_pixel_norm"]),
                      last_activation=m["generator_last_activation"],
                      fused_scale=m["fused_scale"], seed=self.seeds["config"])
        G = G.to(self.device).eval().requires_grad_(False)
        weights.load_into(G, weights.make_weights(m, self.seeds["weights"], self.device)["G"])
        self.G = G
        self.denorm_to_uint8 = denorm_to_uint8
        self.gen = torch.Generator(device=self.device)
        n = int(self.traffic["warmup_requests"])
        for i in range(n):
            if i == n // 2:             # the first requests build and choose kernels
                t0 = time.perf_counter()
            self.request(WARMUP_IDS + i)
        per_request = (time.perf_counter() - t0) / (n - n // 2)
        self.stride = max(1, round(self.seconds / per_request
                                   / int(self.traffic["check_requests"])))
        self.offset = self.seeds["draw"] % self.stride

    def request(self, i: int) -> Optional[np.ndarray]:
        """One request; its uint8 images on the host, or None when a pixel is
        not finite."""
        with self.spans.span("request"):
            with self.spans.span("latents"):
                z = self._latents(i)
            with torch.no_grad():
                with self.spans.span("forward"):
                    images = self.G(z, self.alpha, compute_dtype=self.dtype)
                with self.spans.span("finite"):
                    finite = bool(torch.isfinite(images).all())
                if not finite:
                    return None
                with self.spans.span("denorm"):
                    pixels = self.denorm_to_uint8(images)
                with self.spans.span("to_host"):
                    return pixels.cpu().numpy()

    def window(self, seconds: float) -> Dict[str, float]:
        latencies: List[float] = []
        i = 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            pixels = self.request(i)
            latencies.append(time.perf_counter() - ts)
            if pixels is None:
                self.failed += 1
                latencies[-1] = float("inf")
            elif i % self.stride == self.offset:
                self.kept[i] = pixels
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.attempted = self.requests = i
        delivered = (i - self.failed) * self.batch
        finite = [x for x in latencies if x != float("inf")]
        m = self.model
        self.ctx.update(window_s=elapsed, requests=i,
                        mean_request_ms=1e3 * sum(finite) / max(len(finite), 1),
                        flops=i * g_forward_flops(m["depths"], int(m["scale"]), self.batch,
                                                  int(m["latent_dim"])))
        p95 = np.percentile(np.asarray(latencies), 95) if latencies else float("inf")
        return {"sample_img_per_s": delivered / elapsed, "sample_p95_ms": 1e3 * float(p95)}

    def trace(self) -> None:
        if not self.on_card:
            return
        n = int(self.traffic["device_forwards"])
        z = self._latents(0)
        with torch.no_grad():
            for _ in range(n):
                self.G(z, self.alpha, compute_dtype=self.dtype)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(n):
                self.G(z, self.alpha, compute_dtype=self.dtype)
            end.record()
            end.synchronize()
        self.ctx["device_ms"] = {"forward": start.elapsed_time(end) / n}

        def block():
            for i in range(int(self.traffic["trace_requests"])):
                self.request(2 * WARMUP_IDS + i)
        self.spans.profiling = True
        try:
            self.ctx["profile"] = harness.profile(block, SPANS)
        finally:
            self.spans.profiling = False
        self.ctx["profiled_kinds"] = ["forward"] * int(self.traffic["trace_requests"])

    def release(self) -> None:
        self.G = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def reference(self, quant: Optional[str] = None) -> Dict[int, torch.Tensor]:
        """The reference's images of the kept requests' latents, uint8."""
        m = self.model
        params = weights.make_weights(m, self.seeds["weights"], self.device)["G"]
        q = ref.QUANTS[quant or "float32"]
        out = {}
        with torch.no_grad():
            for i in sorted(self.kept):
                x = ref.generator(params, self._latents(i), self.alpha, int(m["scale"]),
                                  int(m["depths"][0]), q)
                out[i] = denorm(x).cpu()
        return out

    def check(self) -> Dict[str, float]:
        if not self.kept:
            return {}
        reference = self.reference()
        served = torch.cat([torch.from_numpy(self.kept[i]) for i in sorted(self.kept)])
        return {"image_gap": compare.image_gap(served, torch.cat(list(reference.values())))}

    def control(self) -> Dict[str, float]:
        """The image gap of the reference in the precision below the
        configuration's, put in the program's place."""
        if not self.kept:
            return {}
        lower = torch.cat(list(self.reference(ref.CONTROL[self.model["compute_dtype"]]).values()))
        return {"image_gap": compare.image_gap(lower, torch.cat(list(self.reference().values())))}
