"""Adaptive curriculum schedulers (+ the MultiStepLR re-export).

`multistep_lr` (defined in train.step, re-exported here) mirrors torch
MultiStepLR as used by all three stages: milestones (60, 90) stage 1 —
reference train.py:571-572; (40, 60) stages 2/3 with `step()` called
TWICE per epoch — reference train.py:387-390, 466+493 — so the
effective decay epochs are 20/30 there.

The curriculum schedulers reproduce the reference's adaptive sampling
state machines exactly (SURVEY.md §7 hard part 5):

  * Stage 2 (reference data.py:273-281, 327-349): hard_ratio starts
    0.4, bounded [0.2, 0.8], updated every 5 epochs from (random-vs-
    hard val Dice-loss gap, TD/BD trends) in +/-0.05 steps.
  * Stage 3 (reference data.py:422-429, 493-533): hard_ratio starts
    0.8 in [0.5, 0.9]; break_ratio starts 0.625 in [0.2, 0.8]; both
    updated every epoch.

They are pure-Python host logic (they gate host-side crop sampling,
not device code), deliberately kept dependency-free so unit tests can
drive them with scripted metric sequences. A copy of the JAX package's
`train/schedule.py`; `multistep_lr` comes from the port's `train/step.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .step import multistep_lr  # noqa: F401  (single implementation)


@dataclasses.dataclass
class CurriculumScheduler:
    """Stage-2 hard-mining ratio controller (reference data.py:327-349)."""

    hard_ratio: float = 0.4
    min_ratio: float = 0.2
    max_ratio: float = 0.8
    decay_step: int = 5
    decay_rate: float = 0.05

    def update(self, epoch, val_loss_random, val_loss_hard, val_td, val_bd):
        """All list arguments are running histories (latest last)."""
        if epoch % self.decay_step != 0 or epoch == 0:
            return self.hard_ratio
        window = min(3, len(val_loss_random))
        diff = float(
            np.mean(val_loss_random[-window:]) - np.mean(val_loss_hard[-window:])
        )
        if len(val_td) > 1:
            td_trend = val_td[-1] - val_td[-2]
            bd_trend = val_bd[-1] - val_bd[-2]
        else:
            td_trend = bd_trend = 0.0
        if diff > 0.04 or td_trend < 0 or bd_trend < 0:
            self.hard_ratio = min(self.max_ratio, self.hard_ratio + self.decay_rate)
        elif diff < 0.02 and td_trend >= 0 and bd_trend >= 0:
            self.hard_ratio = max(self.min_ratio, self.hard_ratio - self.decay_rate)
        # (the reference's third branch is unreachable — any diff > 0.05
        # already matched the first condition; kept out deliberately)
        return self.hard_ratio


@dataclasses.dataclass
class Stage3Scheduler:
    """Stage-3 hard+break ratio controller (reference data.py:493-533)."""

    hard_ratio: float = 0.8
    break_ratio: float = 0.625
    min_hard: float = 0.5
    max_hard: float = 0.9
    min_break: float = 0.2
    max_break: float = 0.8
    decay_step: int = 1
    decay_rate: float = 0.05

    def update(self, epoch, val_loss_random, val_loss_hard, val_td, val_bd):
        if epoch % self.decay_step != 0 or epoch == 0:
            return self.hard_ratio, self.break_ratio
        window = min(3, len(val_loss_random))
        diff = float(
            np.mean(val_loss_random[-window:]) - np.mean(val_loss_hard[-window:])
        )
        if len(val_td) > 1:
            td_trend = val_td[-1] - val_td[-2]
            bd_trend = val_bd[-1] - val_bd[-2]
        else:
            td_trend = bd_trend = 0.0
        step = self.decay_rate
        if diff > 0.04 or td_trend < 0 or bd_trend < 0:
            self.hard_ratio = min(self.max_hard, self.hard_ratio + step)
        elif diff < 0.02 and td_trend >= 0 and bd_trend >= 0:
            self.hard_ratio = max(self.min_hard, self.hard_ratio - step)
        if td_trend < 0 or bd_trend < 0:
            self.break_ratio = min(self.max_break, self.break_ratio + step)
        elif td_trend > 0 and bd_trend > 0:
            self.break_ratio = max(self.min_break, self.break_ratio - step)
        return self.hard_ratio, self.break_ratio
