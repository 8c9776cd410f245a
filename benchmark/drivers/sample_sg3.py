"""The `sample_sg3` driver: StyleGAN3-T's generator served by `sample`'s
closed-loop client. A request: `batch` latents drawn on the card from the
request's own seed → `StyleGAN3Generator.forward(z, psi)` (mapping, the
Fourier input, 14 modulated convs each with a filtered leaky ReLU, the
toRGB; the layers at sampling rates of 128 and above in the configuration's
`compute_dtype`) → the finite check → `denorm_to_uint8` → the copy to the
host; `sample.Driver.request` runs it, and `trace` its device timing and
profiled requests.

What differs from `sample_sg2`: the model and its weights (`weights_sg3.py`),
its FLOPs (`flops_sg3.py`: `sample_sg2`'s window counts config-f's inline,
through `flops_sg2`, which needs `fmap_base`, so `window` is its copy with
this model's count), the reference (`reference/stylegan3.py`, which
computes a kept request's images one at a time), and the ranges of the
profiled pass of `device_forwards` back-to-back forwards: each kernel is
charged to the innermost `stylegan2.modconv` or `stylegan3.filtered_lrelu`
range that holds it (`modconv_share.sample`, `filtered_lrelu_share.sample`).
The check (`image_gap` and the share of clipped pixels) and the control
are `sample_sg2`'s: the control is the reference rounded below each part's
precision (TF32 where the program computes in float32, amax-scaled fp8 in
its bf16 layers).

Mix parameters: `batch`, `psi`, and `sample`'s `warmup_requests`,
`check_requests`, `trace_requests`, `device_forwards`.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights_sg3
from benchmark.drivers import sample, sample_sg2
from benchmark.flops_sg3 import forward_flops
from benchmark.reference import stylegan3 as ref
from benchmark.weights_sg2 import load_into

SHARE_SPANS = ("stylegan2.modconv", "stylegan3.filtered_lrelu")
MODEL_KEYS = ("z_dim", "w_dim", "mapping_layers", "mapping_lr_multiplier", "resolution",
              "channel_base", "channel_max", "num_layers", "num_critical", "first_cutoff",
              "first_stopband", "last_stopband_rel", "margin_size", "output_scale",
              "num_fp16_res", "conv_clamp", "conv_kernel", "filter_size", "lrelu_upsampling",
              "img_channels")


class Driver(sample_sg2.Driver):
    def setup(self) -> None:
        from pggan_tpu_torch.models.stylegan3 import StyleGAN3Generator
        from pggan_tpu_torch.utils.image import denorm_to_uint8

        m = self.model
        # the reference computes in float32 (and the control rounds to TF32 itself)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        G = StyleGAN3Generator(**{k: m[k] for k in MODEL_KEYS}, seed=self.seeds["config"])
        G = G.to(self.device).eval().requires_grad_(False)
        load_into(G, weights_sg3.make_weights(m, self.seeds["weights"], self.device))
        self.G = G
        self.denorm_to_uint8 = denorm_to_uint8
        self.gen = torch.Generator(device=self.device)
        n = int(self.traffic["warmup_requests"])
        for i in range(n):
            if i == n // 2:             # the first requests build and choose kernels
                t0 = time.perf_counter()
            self.request(sample.WARMUP_IDS + i)
        per_request = (time.perf_counter() - t0) / (n - n // 2)
        self.stride = max(1, round(self.seconds / per_request
                                   / int(self.traffic["check_requests"])))
        self.offset = self.seeds["draw"] % self.stride

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
        self.ctx.update(window_s=elapsed, requests=i,
                        mean_request_ms=1e3 * sum(finite) / max(len(finite), 1),
                        flops=i * forward_flops(self.model, self.batch))
        p95 = np.percentile(np.asarray(latencies), 95) if latencies else float("inf")
        return {"sample_img_per_s": delivered / elapsed, "sample_p95_ms": 1e3 * float(p95)}

    def trace(self) -> None:
        sample.Driver.trace(self)
        if not self.on_card:
            return
        z = self._latents(0)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.no_grad(), torch.profiler.profile(activities=activities) as prof:
            for _ in range(int(self.traffic["device_forwards"])):
                self.G(z, self.alpha, compute_dtype=self.dtype)
            torch.cuda.synchronize(self.device)
        shares = sample_sg2.span_shares(prof.events(), SHARE_SPANS)
        if shares is not None:
            self.ctx["span_shares"] = shares

    def reference(self, quants=(None, None)) -> Dict[int, torch.Tensor]:
        """The reference's uint8 images of the kept requests' latents (the
        reference computes one image at a time); `quants` round the float32
        part's and the reduced part's conv and linear inputs
        (`reference.stylegan3.generator`)."""
        m = self.model
        params = weights_sg3.make_weights(m, self.seeds["weights"], self.device)
        out = {}
        with torch.no_grad():
            for i in sorted(self.kept):
                x = ref.generator(params, self._latents(i), m, self.alpha, *quants)
                out[i] = sample.denorm(x).cpu()
        return out
