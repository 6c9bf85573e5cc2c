"""ASHA: asynchronous successive halving.

Port of ``distributed_machine_learning_tpu/tune/schedulers/asha.py`` (the
whole file).

Native implementation of the capability the reference consumed from Ray's
``ASHAScheduler`` (`ray-tune-hpo-regression.py:473`, `-sample.py:163`) — and
actually effective here, because trainables report per epoch instead of once
at trial end (SURVEY.md §3.1/§3.4).

Algorithm (Li et al. 2018): rungs at iteration r, r*eta, r*eta^2, ... up to
``max_t``.  When a trial reaches a rung, record its metric; it is promoted
(continues) iff it is in the top 1/eta of results recorded *so far* at that
rung — asynchronous, so no waiting for a full bracket.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

from distributed_machine_learning_tpu_torch.tune.schedulers.base import (
    CONTINUE,
    STOP,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.trial import Trial


class ASHAScheduler(TrialScheduler):
    def __init__(
        self,
        metric: str = None,
        mode: str = None,
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 3.0,
        time_attr: str = "training_iteration",
    ):
        if grace_period < 1:
            raise ValueError("grace_period must be >= 1")
        if reduction_factor <= 1:
            raise ValueError("reduction_factor must be > 1")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.eta = reduction_factor
        self.time_attr = time_attr

        # rung iteration -> list of scores recorded at that rung (lower=better)
        max_rungs = int(
            math.log(max(max_t / grace_period, 1), reduction_factor) + 1
        )
        self.rungs: List[int] = [
            int(grace_period * reduction_factor ** k) for k in range(max_rungs)
        ]
        self.rung_scores: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._trial_next_rung: Dict[str, int] = {}

    def set_experiment(self, metric: str, mode: str):
        # Respect an explicitly configured metric/mode (Ray allows scheduler-
        # level settings overriding the experiment default); None means unset.
        self.metric = self.metric if self.metric is not None else metric
        self.mode = self.mode if self.mode is not None else mode

    def on_trial_add(self, trial: Trial):
        self._trial_next_rung[trial.trial_id] = 0

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        if self.metric not in result:
            return CONTINUE
        t = int(result.get(self.time_attr, trial.training_iteration))
        if t >= self.max_t:
            return STOP

        rung_idx = self._trial_next_rung.get(trial.trial_id, 0)
        if rung_idx >= len(self.rungs) or t < self.rungs[rung_idx]:
            return CONTINUE

        # The trial may skip rungs if it reports sparsely; use the highest
        # rung it has reached.
        while rung_idx + 1 < len(self.rungs) and t >= self.rungs[rung_idx + 1]:
            rung_idx += 1
        rung = self.rungs[rung_idx]
        score = self._score(result)
        scores = self.rung_scores[rung]
        scores.append(score)
        self._trial_next_rung[trial.trial_id] = rung_idx + 1

        # Promote iff within the top 1/eta of scores seen at this rung so far.
        k = int(len(scores) / self.eta)
        if k < 1:
            # Not enough peers yet: ASHA promotes optimistically.
            return CONTINUE
        cutoff = sorted(scores)[k - 1]
        return CONTINUE if score <= cutoff else STOP

    def save_state(self) -> Dict[str, Any]:
        return {
            "rung_scores": {
                str(r): list(s) for r, s in self.rung_scores.items()
            },
            "trial_next_rung": dict(self._trial_next_rung),
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        # Runs AFTER on_trial_add re-registered every live trial, so the
        # journaled rung positions overwrite the fresh zeros.
        for r, scores in state.get("rung_scores", {}).items():
            if int(r) in self.rung_scores:
                self.rung_scores[int(r)] = [float(v) for v in scores]
        self._trial_next_rung.update({
            str(t): int(r)
            for t, r in state.get("trial_next_rung", {}).items()
        })

    def debug_state(self) -> Dict[int, int]:
        return {r: len(s) for r, s in self.rung_scores.items()}
