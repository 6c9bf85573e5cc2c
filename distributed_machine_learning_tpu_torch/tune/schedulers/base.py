"""Trial-scheduler interface.

Port of ``distributed_machine_learning_tpu/tune/schedulers/base.py`` (the
whole file).

Native replacement for the ASHA/PBT scheduling the reference delegated to Ray
Tune (`ray-tune-hpo-regression.py:473`; SURVEY.md §2b D1).  The runner calls
``on_trial_result`` synchronously on every per-epoch report; the returned
decision takes effect before the trainable runs its next epoch.
"""

from __future__ import annotations

from typing import Any, Dict

from distributed_machine_learning_tpu_torch.tune.trial import Trial

CONTINUE = "continue"
STOP = "stop"
REQUEUE = "requeue"  # stop, then re-run the same trial (mutated config / restore)


class TrialScheduler:
    def set_experiment(self, metric: str, mode: str):
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict[str, Any]) -> float:
        """Normalize so that LOWER is always better internally."""
        value = float(result[self.metric])
        return value if self.mode == "min" else -value

    def on_trial_add(self, trial: Trial):
        pass

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial):
        pass

    def on_trial_error(self, trial: Trial):
        pass

    def save_state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of ALL decision-relevant mutable
        state — journaled after every scheduling decision
        (``tune/journal.py``) so a restarted head restores a scheduler
        that makes bit-identical decisions (ASHA resumes mid-rung, PBT
        keeps its exploit history).  Live ``Trial`` references are NOT
        state — resume rebuilds them via ``on_trial_add`` before calling
        ``restore_state``.  Stateless schedulers (FIFO) inherit this
        empty default."""
        return {}

    def restore_state(self, state: Dict[str, Any]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """No early stopping; trials run to completion in submission order."""
