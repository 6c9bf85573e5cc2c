"""Stopper objects for ``tune.run(stop=...)`` (Ray's Stopper surface).

Port of ``distributed_machine_learning_tpu/tune/stoppers.py`` (the whole
file).

The reference passes no stop conditions at all (its trials always run the
full epoch budget — `ray-tune-hpo-regression.py:469-478`); the framework's
``stop`` accepts, interchangeably:

* a dict of ``result-key -> threshold`` (stop when any key reaches it),
* a callable ``(trial_id, result) -> bool``,
* a ``Stopper`` instance from this module.

Stoppers complement schedulers: a scheduler ranks trials against EACH
OTHER (ASHA rungs, PBT quantiles); a stopper looks at ONE trial's own
trajectory (converged, exploded, out of budget) — both can be active.
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Any, Dict, Optional


class Stopper:
    """Base: return True from __call__ to stop that trial."""

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        raise NotImplementedError


class MaximumIterationStopper(Stopper):
    """Stop every trial at ``max_iter`` reported results."""

    def __init__(self, max_iter: int):
        self.max_iter = int(max_iter)

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        return int(result.get("training_iteration", 0)) >= self.max_iter


class TrialPlateauStopper(Stopper):
    """Stop a trial whose metric has flattened out.

    Once a trial has at least ``num_results`` reports past
    ``grace_period``, it stops when the standard deviation of the metric
    over its last ``num_results`` reports drops below ``std`` — the
    trial has converged and further epochs spend FLOPs on noise.
    ``metric_threshold`` (with ``mode``) restricts stopping to trials on
    the right side of a quality bar, so a plateaued-but-bad trial can
    still be left to the scheduler's comparative logic.
    """

    def __init__(
        self,
        metric: str,
        std: float = 0.01,
        num_results: int = 4,
        grace_period: int = 4,
        metric_threshold: Optional[float] = None,
        mode: str = "min",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.metric = metric
        self.std = float(std)
        self.num_results = int(num_results)
        self.grace_period = int(grace_period)
        self.metric_threshold = metric_threshold
        self.mode = mode
        self._window = defaultdict(
            lambda: deque(maxlen=self.num_results)
        )
        self._count = defaultdict(int)

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        if self.metric not in result:
            return False
        value = float(result[self.metric])
        self._count[trial_id] += 1
        window = self._window[trial_id]
        window.append(value)
        if (
            self._count[trial_id] <= self.grace_period
            or len(window) < self.num_results
        ):
            return False
        if self.metric_threshold is not None:
            ok = (value <= self.metric_threshold if self.mode == "min"
                  else value >= self.metric_threshold)
            if not ok:
                return False
        mean = sum(window) / len(window)
        var = sum((x - mean) ** 2 for x in window) / len(window)
        return math.sqrt(var) < self.std


def stop_hit(stop, trial_id: str, result: Dict[str, Any]) -> bool:
    """Apply a resolved ``stop`` (dict / callable / Stopper / None) to one
    result — THE dispatch both drivers share, so their stop semantics
    cannot diverge."""
    if stop is None:
        return False
    if callable(stop):
        return bool(stop(trial_id, result))
    return any(
        k in result and float(result[k]) >= v for k, v in stop.items()
    )


def resolve_stop(stop) -> Optional[object]:
    """Normalize tune.run's ``stop`` argument: dict / callable / Stopper /
    None all become something _driver.process_result can apply."""
    if stop is None or isinstance(stop, dict) or callable(stop):
        return stop
    raise ValueError(
        f"stop must be a dict, callable, or Stopper; got {type(stop)!r}"
    )
