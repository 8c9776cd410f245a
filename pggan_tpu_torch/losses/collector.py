"""Host-side loss bookkeeping — a copy of `pggan_tpu/losses/collector.py`,
so the port's trainer prints its loss lines as the JAX trainer does: a
`loss_dict` of floats rounded to 4 decimals and `print_loss` with the
dd/hh/mm/ss elapsed time. Values arrive as 0-d tensors from the train step;
the conversion to floats (a device sync) happens here, on loss_cycle steps
only.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping


class LossCollector:
    def __init__(self, max_step: int):
        self.max_step = max_step
        self.start_time = time.time()
        self.loss_dict: Dict[str, float] = {}

    def update(self, metrics: Mapping[str, object]):
        """Record a step's metrics (0-d tensors or floats), rounded to 4
        decimals."""
        for key, value in metrics.items():
            self.loss_dict[key] = round(float(value), 4)

    def print_loss(self, global_step: int):
        seconds = int(time.time() - self.start_time)
        print("")
        print(f"[ {seconds//3600//24:02}d {(seconds//3600)%24:02}h "
              f"{(seconds//60)%60:02}m {seconds%60:02}s ]")
        print(f"steps: {global_step:06} / {self.max_step}")
        loss_d = self.loss_dict.get("L_D", float("nan"))
        loss_g = self.loss_dict.get("L_G", float("nan"))
        print(f"lossD: {loss_d} | lossG: {loss_g}")
