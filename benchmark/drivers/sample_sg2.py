"""The `sample_sg2` driver: StyleGAN2's generator served by `sample`'s
closed-loop client. A request: `batch` latents drawn on the card from the
request's own seed → `StyleGAN2Generator.forward(z, psi)` (mapping, then
synthesis with its top `num_fp16_res` blocks in the configuration's
`compute_dtype`) → the finite check → `denorm_to_uint8` → the copy to the
host; `sample.Driver.request` runs it, and `trace` its device timing and
profiled requests.

What differs from `sample`: the model and its weights (`weights_sg2.py`),
its FLOPs (`flops_sg2.py`), TF32 off for the reference (the generator's
forward turns it off for its own float32 parts), the reference
(`reference/stylegan2.py`, each kept request's images computed as one
block, so that it fits), the control (the reference rounded below each
part's precision: TF32 where the program computes in float32, amax-scaled
fp8 in the bf16 blocks), and one more profiled pass of `device_forwards`
back-to-back forwards, whose kernels the innermost `stylegan2.modconv` or
`stylegan2.resample` range that holds them is charged with
(`span_shares`: `modconv_share.sample`, `resample_share.sample`).

Mix parameters: `batch`, `psi`, `noise_mode` ('const' only), and
`sample`'s `warmup_requests`, `check_requests`, `trace_requests`,
`device_forwards`.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, weights_sg2
from benchmark.drivers import sample
from benchmark.flops_sg2 import forward_flops
from benchmark.reference import model as ref_model
from benchmark.reference import stylegan2 as ref

SHARE_SPANS = ("stylegan2.modconv", "stylegan2.resample")


def span_shares(events, names=SHARE_SPANS) -> Optional[Dict[str, float]]:
    """{range name: % of the summed kernel time} from a profiler's events:
    each kernel is charged to the innermost (shortest) device-side range
    of `names` that holds it; None when the trace holds no such range."""
    kernels, marks = [], []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False):
            if e.name in names:
                marks.append((*span, e.name))
        else:
            kernels.append(span)
    total = sum(end - start for start, end in kernels)
    if not marks or total <= 0:
        return None
    charged = dict.fromkeys(names, 0.0)
    for start, end in kernels:
        inside = [m for m in marks if m[0] <= start and end <= m[1]]
        if inside:
            charged[min(inside, key=lambda m: m[1] - m[0])[2]] += end - start
    return {name: 100.0 * t / total for name, t in charged.items()}


class Driver(sample.Driver):
    def __init__(self, config: dict, traffic: dict, seeds: dict, device: torch.device,
                 spans, seconds: float):
        if traffic.get("noise_mode", "const") != "const":
            raise ValueError(f"noise_mode {traffic['noise_mode']!r}: only 'const' is served")
        # `sample`'s request passes `alpha` as G's second argument: here ψ
        super().__init__(config, dict(traffic, alpha=traffic["psi"]), seeds, device, spans,
                         seconds)
        self.clip_share: Optional[float] = None

    def _latents(self, i: int) -> torch.Tensor:
        self.gen.manual_seed(self.seeds["latents"] * 1_000_003 + i)
        return torch.randn((self.batch, int(self.model["z_dim"])), generator=self.gen,
                           device=self.device)

    def setup(self) -> None:
        from pggan_tpu_torch.models.stylegan2 import StyleGAN2Generator
        from pggan_tpu_torch.utils.image import denorm_to_uint8

        m = self.model
        # the reference computes in float32 (and the control rounds to TF32 itself)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        G = StyleGAN2Generator(
            z_dim=int(m["z_dim"]), w_dim=int(m["w_dim"]), mapping_layers=int(m["mapping_layers"]),
            mapping_lr_multiplier=float(m["mapping_lr_multiplier"]),
            resolution=int(m["resolution"]), fmap_base=int(m["fmap_base"]),
            fmap_max=int(m["fmap_max"]), num_fp16_res=int(m["num_fp16_res"]),
            conv_clamp=float(m["conv_clamp"]), img_channels=int(m["img_channels"]),
            seed=self.seeds["config"])
        G = G.to(self.device).eval().requires_grad_(False)
        weights_sg2.load_into(G, weights_sg2.make_weights(m, self.seeds["weights"], self.device))
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
        super().trace()
        if not self.on_card:
            return
        z = self._latents(0)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.no_grad(), torch.profiler.profile(activities=activities) as prof:
            for _ in range(int(self.traffic["device_forwards"])):
                self.G(z, self.alpha, compute_dtype=self.dtype)
            torch.cuda.synchronize(self.device)
        shares = span_shares(prof.events())
        if shares is not None:
            self.ctx["span_shares"] = shares

    def reference(self, quants=(None, None)) -> Dict[int, torch.Tensor]:
        """The reference's uint8 images of the kept requests' latents, one
        request at a time; `quants` round the float32 part's and the reduced
        part's conv and linear inputs (`reference.stylegan2.generator`)."""
        m = self.model
        params = weights_sg2.make_weights(m, self.seeds["weights"], self.device)
        out = {}
        with torch.no_grad():
            for i in sorted(self.kept):
                x = ref.generator(params, self._latents(i), m, self.alpha, *quants)
                out[i] = sample.denorm(x).cpu()
        return out

    def check(self) -> Dict[str, float]:
        if not self.kept:
            return {}
        served = torch.cat([torch.from_numpy(self.kept[i]) for i in sorted(self.kept)])
        self.clip_share = 100.0 * float(((served == 0) | (served == 255)).float().mean())
        print(f"sample_sg2: {self.clip_share:.2f} % of the checked pixels are 0 or 255",
              file=sys.stderr)
        return {"image_gap": compare.image_gap(served, torch.cat(list(self.reference().values())))}

    def control(self, parts=("float32", "reduced")) -> Dict[str, float]:
        """The check's numbers of the control, the reference rounded below
        the precision of each part in `parts`: TF32 in the float32 part,
        the configuration's control rounding (`reference.model.CONTROL`) in
        the reduced one. `("float32",)` alone reads what TF32 in the
        float32 part would cost the program."""
        if not self.kept:
            return {}
        m = self.model
        quants = (ref_model.QUANTS["tf32"] if "float32" in parts else None,
                  ref_model.QUANTS[ref_model.CONTROL[m["compute_dtype"]]]
                  if "reduced" in parts else None)
        lower = torch.cat(list(self.reference(quants).values()))
        return {"image_gap": compare.image_gap(lower, torch.cat(list(self.reference().values())))}
