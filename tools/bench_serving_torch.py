#!/usr/bin/env python3
"""Serving throughput of the PyTorch port's generator on one CUDA card — the
counterpart of tools/bench_serving.py.

    python3 tools/bench_serving_torch.py [--mode direct|artifact] [--scale 6]
        [--batch 16] [--compute_dtype bfloat16|float32] [--steps 40] [--warmup 3]
    python3 tools/bench_serving_torch.py --all [--scales 2 3 4 5 6 7 8] [--out FILE]

Two modes, latents in and images out:
  * `direct`: the eager `Generator` with its weights on the card (the
    demo's and the trainer's sampling path);
  * `artifact`: the `torch.export` serving artifact of the same generator
    (`pggan_tpu_torch.export`), exported with the batch pinned, saved to
    bytes, loaded back and called through `ExportedProgram.module()`.

G is built at the full widths of the reference's depth law
(`config.default_depths`; latent 512) from numpy-seeded weights
(chip_smoke.py's), alpha 1.
Two rates: device img/s (`--steps` forwards enqueued back to back, one
synchronisation at the end) and e2e img/s (each batch denormalised to uint8
and copied to the host before the next forward). Also: `export_s` (export,
save and load; artifact mode), `first_call_s` (the first forward with its
synchronisation), `artifact_mb`, the kernel launches of one forward, the
card's name and power limit. Prints one JSON line. `--all` runs every scale
in a subprocess of its own (batch 8 at scale 7 and 4 at scale 8; both
modes at scale 6, direct elsewhere) and prints a JSON document and a
markdown table. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT = 512


def run_one(ns) -> int:
    if not torch.cuda.is_available():
        print("bench_serving_torch: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke                   # its numpy-seeded weights and card line
    from pggan_tpu_torch.config import default_depths
    from pggan_tpu_torch.export import export_generator, load_exported
    from pggan_tpu_torch.models.generator import params_from_jax
    from pggan_tpu_torch.ops import kernels
    from pggan_tpu_torch.utils.image import denorm_to_uint8

    res = 2 ** (ns.scale + 2)
    dtype = getattr(torch, ns.compute_dtype)
    arrays = chip_smoke.numpy_generator_arrays(0, LATENT, default_depths(ns.scale), ns.scale)
    generator = params_from_jax(arrays)
    generator = generator.to("cuda").eval().requires_grad_(False)

    t0 = time.perf_counter()
    if ns.mode == "artifact":
        blob = export_generator(generator, latent_dim=LATENT, alpha=1.0, batch=ns.batch,
                                compute_dtype=dtype, device="cuda")
        sample = load_exported(blob).module()
        artifact_mb = len(blob) / 1e6
    else:
        def sample(z):
            return generator(z, 1.0, compute_dtype=dtype)
        artifact_mb = None
    export_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    zs = [torch.from_numpy(rng.randn(ns.batch, LATENT).astype(np.float32)).to("cuda")
          for _ in range(max(ns.steps, ns.warmup))]
    with torch.inference_mode():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = sample(zs[0])
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        for i in range(1, ns.warmup):
            out = sample(zs[i % len(zs)])
        torch.cuda.synchronize()

        t0 = time.perf_counter()
        for i in range(ns.steps):
            out = sample(zs[i % len(zs)])
        torch.cuda.synchronize()
        device_img_s = ns.batch * ns.steps / (time.perf_counter() - t0)

        n_e2e = max(4, min(ns.steps, int(2.0 * device_img_s / ns.batch) or 4))
        t0 = time.perf_counter()
        for i in range(n_e2e):
            images = denorm_to_uint8(sample(zs[i % len(zs)])).cpu().numpy()
        e2e_img_s = ns.batch * n_e2e / (time.perf_counter() - t0)
    if images.shape != (ns.batch, res, res, 3) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"output {images.shape}, finite {bool(torch.isfinite(out).all())}")

    print(json.dumps({
        "metric": f"serving images/sec, {res}x{res} generator sampling "
                  f"({ns.mode}, {ns.compute_dtype})",
        "value": round(device_img_s, 1), "unit": "images/sec/card",
        "e2e_img_s": round(e2e_img_s, 1), "batch": ns.batch, "scale": ns.scale,
        "mode": ns.mode, "compute_dtype": ns.compute_dtype, "steps": ns.steps,
        "export_s": round(export_s, 3) if ns.mode == "artifact" else None,
        "first_call_s": round(first_call_s, 4),
        "artifact_mb": round(artifact_mb, 2) if artifact_mb else None,
        "launches_per_forward": launches,
        "device": torch.cuda.get_device_name(0), "card": chip_smoke.card_line()}))
    return 0


def run_all(ns) -> int:
    rows = []
    for scale in ns.scales:
        batch = {7: 8, 8: 4}.get(scale, ns.batch)
        for mode in (["direct", "artifact"] if scale == 6 else ["direct"]):
            cmd = [sys.executable, os.path.abspath(__file__), "--scale", str(scale),
                   "--batch", str(batch), "--steps", str(ns.steps), "--mode", mode,
                   "--warmup", str(ns.warmup), "--compute_dtype", ns.compute_dtype]
            print(f"[serving] scale {scale} ({2 ** (scale + 2)}px) {mode} batch {batch} ...",
                  file=sys.stderr)
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=3600)
            if proc.returncode != 0:
                rows.append({"scale": scale, "mode": mode, "error": proc.stderr[-800:]})
                print("[serving]   -> ERROR", file=sys.stderr)
                continue
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            rows.append(row)
            print(f"[serving]   -> {row['value']} img/s (e2e {row['e2e_img_s']})",
                  file=sys.stderr)
    doc = {"rows": rows}
    print(json.dumps(doc, indent=1))
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(doc, f, indent=1)
    print("\n| Scale | Res | mode | batch | device img/s | e2e img/s |", file=sys.stderr)
    print("|---|---|---|---|---|---|", file=sys.stderr)
    for r in rows:
        res = 2 ** (r["scale"] + 2)
        if "error" in r:
            print(f"| {r['scale']} | {res} | {r['mode']} | | ERROR | |", file=sys.stderr)
        else:
            print(f"| {r['scale']} | {res} | {r['mode']} | {r['batch']} | **{r['value']}** | "
                  f"{r['e2e_img_s']} |", file=sys.stderr)
    return 1 if any("error" in r for r in rows) else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=6)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--mode", default="direct", choices=["direct", "artifact"])
    parser.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--all", action="store_true",
                        help="every scale of --scales in a subprocess of its own")
    parser.add_argument("--scales", type=int, nargs="*", default=[2, 3, 4, 5, 6, 7, 8])
    parser.add_argument("--out", default=None, help="--all: also write the document here")
    ns = parser.parse_args(argv)
    return run_all(ns) if ns.all else run_one(ns)


if __name__ == "__main__":
    raise SystemExit(main())
