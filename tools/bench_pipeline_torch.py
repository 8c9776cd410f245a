#!/usr/bin/env python
"""The PyTorch port's host input pipeline alone, at a dataset's real size
(the counterpart of tools/bench_pipeline.py, which measures the JAX
package's loader): `pggan_tpu_torch.data`'s ImageFolderDataset through its
DataPipeline (the producer thread, worker threads and prefetch queue the
trainer uses), with the batches left on the host.

  tier ram    the RAM decode cache (the resized set within decode_cache_mb)
  tier store  the out-of-core resized store (memory-mapped, built once a scale)
  tier none   no cache (each draw decodes its source image)
  tier auto   the trainer's policy

`--loader native|pil|auto`: the native C++ loader (`native/`: where
libjpeg/libpng link it decodes too, else PIL decodes and it resizes and
jitters), PIL alone, or the default (native where it builds).

For each run: the dataset's construction time (a cache or store build
included), the steady-state augmented draw rate, the loader and tier used,
and the host RSS growth.

  python tools/bench_pipeline_torch.py --root datasets/synth37k --scale 5 \\
      --tier store --draws 2048 --json

Host work only; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--scale", type=int, required=True,
                    help="scale index; resolution = 2**(scale+2)")
    ap.add_argument("--tier", choices=["ram", "store", "none", "auto"], default="auto",
                    help="cache tier to force (auto = the trainer's policy)")
    ap.add_argument("--loader", choices=["native", "pil", "auto"], default="auto")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--draws", type=int, default=2048,
                    help="steady-state images to draw (after the warm-up)")
    ap.add_argument("--warmup", type=int, default=256,
                    help="images drawn before the timing starts")
    ap.add_argument("--decode_cache_mb", type=int, default=8192)
    ap.add_argument("--store_dir", default=None)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--fill", action="store_true",
                    help="fill the RAM decode cache (one pass over the images) before "
                         "the timing, and report the fill time")
    ap.add_argument("--json", action="store_true")
    ns = ap.parse_args(argv)

    from pggan_tpu_torch.data.dataset import ImageFolderDataset
    from pggan_tpu_torch.data.pipeline import DataPipeline

    tier_kw = {
        "ram": dict(cache_decoded=True, resized_store=False),
        "store": dict(cache_decoded=False, resized_store=True),
        "none": dict(cache_decoded=False, resized_store=False),
        "auto": dict(cache_decoded="auto", resized_store="auto"),
    }[ns.tier]
    use_native = {"native": True, "pil": False, "auto": None}[ns.loader]
    store_dir = ns.store_dir
    if store_dir is None and ns.tier in ("store", "auto"):
        store_dir = os.path.join(os.path.dirname(ns.root.rstrip("/")) or ".", "resized_store")

    rss0 = rss_mb()
    t0 = time.time()
    ds = ImageFolderDataset([ns.root], ns.scale, is_master=True, use_native=use_native,
                            decode_cache_mb=ns.decode_cache_mb, store_dir=store_dir, **tier_kw)
    t_construct = time.time() - t0
    n, res = len(ds), ds.resolution
    tier_used = "store" if ds._store is not None else "ram" if ds._cache is not None else "none"

    t_fill = None
    if ns.fill and ds._cache is not None:
        t0 = time.time()
        for i in range(n):
            ds.resized_array(i)
        t_fill = time.time() - t0

    with DataPipeline(ds, ns.batch, num_workers=ns.workers, prefetch_depth=2, seed=0) as pipe:
        drawn = 0
        while drawn < ns.warmup:
            next(pipe)
            drawn += ns.batch
        t0 = time.time()
        drawn = checksum = 0
        while drawn < ns.draws:
            batch = next(pipe)
            checksum += int(np.asarray(batch[0, 0, 0]).sum())
            drawn += ns.batch
        dt = time.time() - t0

    rec = {
        "n_images": n, "resolution": res, "tier_requested": ns.tier, "tier_used": tier_used,
        "loader": ds.backend, "decoder": ds._native.decoder if ds._native else "PIL",
        "resized_gb": round(n * res * res * 3 / 1e9, 2),
        "construct_s": round(t_construct, 1),
        "fill_s": round(t_fill, 1) if t_fill is not None else None,
        "draw_img_s": round(drawn / dt, 1),
        "batch": ns.batch, "draws": drawn, "workers": ns.workers,
        "rss_mb_start": round(rss0, 1), "rss_mb_peak": round(rss_mb(), 1),
        "checksum": checksum % 1000003,
    }
    print(json.dumps(rec) if ns.json else json.dumps(rec, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
