"""Metrics logging — the counterpart of `pggan_tpu/utils/logging.py`: one
JSON line per logged step appended to {save_root}/{run_id}/metrics.jsonl
(the file `tools/analyze_run.py` and `tools/compare_runs.py` read), and
wandb (project = model_id, name = run_id) only when asked for and
installed."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, save_root: str, run_id: str, *, model_id: str = "pggan",
                 use_wandb: bool = False):
        self.run_dir = os.path.join(str(save_root), str(run_id))
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=model_id, name=str(run_id))
                self._wandb = wandb
            except Exception as exc:    # not installed, or offline
                print(f"[pggan_tpu_torch] wandb unavailable ({exc!r}); "
                      f"JSONL logging only")

    def log(self, global_step: int, metrics: Mapping[str, float]) -> None:
        record = {"step": int(global_step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=int(global_step))

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
