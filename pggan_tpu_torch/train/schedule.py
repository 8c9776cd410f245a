"""Progressive growth schedule — the scale/alpha state machine. A copy of
the framework-free `pggan_tpu/train/schedule.py`, with its behaviour and
quirks (jump checks are equality comparisons; `round(alpha + 1/Ntimes, 4)`
overshoots to 1.0008 at Ntimes 24), so the two packages step through the
same schedule and read each other's checkpointed schedule state.

  init: alpha=0, alpha_index=0, scale_index=0, alpha_jump_value=0,
        next_scale_jump_step = max_step_at_scale[0],
        next_alpha_jump_step = alpha_jump_start[0]   (-1 → never fires)

  check_jump(step):
    if step == next_scale_jump_step → change_scale:
        scale_index += 1
        next_scale_jump_step += max_step_at_scale[scale_index]
        (caller grows nets, resets data/optimizers)
        reset_alpha: alpha=0, alpha_index=0,
            next_alpha_jump_step = step + alpha_jump_start[scale_index],
            alpha_jump_value = 1 / alpha_jump_Ntimes[scale_index]
    if step == next_alpha_jump_step → change_alpha:
        alpha_index += 1; alpha = round(alpha + jump_value, 4)
        next_alpha_jump_step = 0 if alpha_index == Ntimes[scale_index]
                               else step + interval[scale_index]
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence


@dataclass
class ProgressiveSchedule:
    max_step_at_scale: Sequence[int]
    alpha_jump_start: Sequence[int]
    alpha_jump_interval: Sequence[int]
    alpha_jump_Ntimes: Sequence[int]

    scale_index: int = 0
    alpha: float = 0.0
    alpha_index: int = 0
    alpha_jump_value: float = 0.0
    next_scale_jump_step: int = field(default=None)  # type: ignore[assignment]
    next_alpha_jump_step: int = field(default=None)  # type: ignore[assignment]
    verbose: bool = False

    def __post_init__(self):
        if self.next_scale_jump_step is None:
            self.next_scale_jump_step = int(self.max_step_at_scale[0])
        if self.next_alpha_jump_step is None:
            self.next_alpha_jump_step = int(self.alpha_jump_start[0])

    # -- transitions ---------------------------------------------------------
    def check_jump(self, global_step: int) -> Dict[str, bool]:
        """Returns {'scale_jumped': ..., 'alpha_jumped': ...}. On a scale
        jump the caller must grow both nets, rebuild the data pipeline at
        the new resolution, and reset optimizer state (the reference's
        `reset_solver`, `pggan/model.py:131-139`)."""
        scale_jumped = False
        alpha_jumped = False
        if self.next_scale_jump_step == global_step:
            self._change_scale(global_step)
            scale_jumped = True
        if self.next_alpha_jump_step == global_step:
            self._change_alpha(global_step)
            alpha_jumped = True
        return {"scale_jumped": scale_jumped, "alpha_jumped": alpha_jumped}

    def _change_scale(self, global_step: int):
        self.scale_index += 1
        self.next_scale_jump_step += int(self.max_step_at_scale[self.scale_index])
        self._reset_alpha(global_step)
        if self.verbose:
            print(f"\nNOW global_step is {global_step}")
            print(f"scale_index is updated to {self.scale_index}")
            print(f"next_scale_jump_step is {self.next_scale_jump_step}")

    def _reset_alpha(self, global_step: int):
        self.alpha = 0.0
        self.alpha_index = 0
        self.next_alpha_jump_step = global_step + int(
            self.alpha_jump_start[self.scale_index])
        self.alpha_jump_value = 1.0 / float(
            self.alpha_jump_Ntimes[self.scale_index])
        if self.verbose:
            print("alpha and alpha_index are initialized to 0")
            print(f"next_alpha_jump_step is set to {self.next_alpha_jump_step}")
            print(f"alpha_jump_value is set to {self.alpha_jump_value}")

    def _change_alpha(self, global_step: int):
        self.alpha_index += 1
        self.alpha = round(self.alpha + self.alpha_jump_value, 4)
        if self.alpha_index == int(self.alpha_jump_Ntimes[self.scale_index]):
            self.next_alpha_jump_step = 0
        else:
            self.next_alpha_jump_step = global_step + int(
                self.alpha_jump_interval[self.scale_index])
        if self.verbose:
            print(f"\nNOW global_step is {global_step}")
            print(f"alpha_index is updated to {self.alpha_index}")
            print(f"next_alpha_jump_step is {self.next_alpha_jump_step}")
            print(f"alpha is now {self.alpha}")

    # -- resolution helpers ---------------------------------------------------
    @property
    def resolution(self) -> int:
        """Input/output side length at the current scale: 2^(scale+2)
        (`lib/dataset.py:101`, README.md:7)."""
        return 2 ** (self.scale_index + 2)

    # -- (de)serialization for checkpointing ----------------------------------
    def state_dict(self) -> Dict:
        """The exact schedule fields the reference checkpoints
        (`pggan/model.py:54-64`)."""
        return {
            "scale_index": self.scale_index,
            "alpha": self.alpha,
            "alpha_index": self.alpha_index,
            "alpha_jump_value": self.alpha_jump_value,
            "next_scale_jump_step": self.next_scale_jump_step,
            "next_alpha_jump_step": self.next_alpha_jump_step,
        }

    def load_state_dict(self, state: Dict):
        for key, value in state.items():
            setattr(self, key, value)

    @staticmethod
    def from_config(cfg, verbose: bool = False) -> "ProgressiveSchedule":
        return ProgressiveSchedule(
            max_step_at_scale=list(cfg.max_step_at_scale),
            alpha_jump_start=list(cfg.alpha_jump_start),
            alpha_jump_interval=list(cfg.alpha_jump_interval),
            alpha_jump_Ntimes=list(cfg.alpha_jump_Ntimes),
            verbose=verbose,
        )
