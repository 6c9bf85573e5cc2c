"""Trial state: the unit of work the scheduler and executor reason about.

Port of ``distributed_machine_learning_tpu/tune/trial.py`` (the whole
file; it imports no JAX).

A Trial owns its sampled config, a monotonically growing result stream (the
per-epoch metric records the reference never produced — it reported once at
trial end, `ray-tune-hpo-regression.py:373`, leaving ASHA inert; SURVEY.md
§3.1), resource requirements, and checkpoint bookkeeping for PBT/fault
recovery.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class TrialStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    # Dispatched but past its progress deadline (liveness.py watchdog): the
    # trial is *probably* wedged but may still be alive.  A beat flips it
    # back to RUNNING (recovery); a kill/requeue follows the ordinary error
    # path.  On resume, STALLED counts as interrupted — requeued from its
    # newest checkpoint like RUNNING.
    STALLED = "STALLED"
    TERMINATED = "TERMINATED"  # finished or early-stopped, successfully
    ERROR = "ERROR"


@dataclass
class Resources:
    """Per-trial resource request, parity with ``resources_per_trial``
    (`ray-tune-hpo-regression.py:475`): ``devices`` cards per trial."""

    devices: int = 1  # cards (or CPU lease slots in tests)
    cpus: int = 1

    @classmethod
    def parse(cls, spec) -> "Resources":
        if spec is None:
            return cls()
        if isinstance(spec, Resources):
            return spec
        if isinstance(spec, dict):
            return cls(
                devices=int(spec.get("devices", spec.get("tpu", spec.get("gpu", 1)))) or 1,
                cpus=int(spec.get("cpu", 1)),
            )
        raise TypeError(f"Cannot parse resources from {spec!r}")


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    resources: Resources = field(default_factory=Resources)
    status: TrialStatus = TrialStatus.PENDING

    results: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[str] = None
    num_failures: int = 0

    # Checkpoint/restore bookkeeping (PBT exploit, fault recovery).
    restore_path: Optional[str] = None
    latest_checkpoint: Optional[str] = None
    # Training iteration the latest checkpoint was taken at — PBT uses it to
    # refuse exploiting donor state ahead of a laggard's own progress.
    latest_checkpoint_iteration: int = 0

    # Progress accounting. ``training_iteration`` must mean *restorable
    # progress*, not "reports ever made": a respawned trial restored from an
    # epoch-e checkpoint continues at e+1, so its iteration counter has to
    # rewind with it — otherwise schedulers comparing iterations (PBT's
    # budget gate, ASHA rungs) mix incompatible units after any respawn.
    restore_base: int = 0  # progress at the last (re)start
    reports_since_restart: int = 0
    # Monotone (re)start counter.  Executor events are tagged with the
    # incarnation that produced them so the runner can drop a dead
    # incarnation's late events instead of applying them to a retry.
    incarnation: int = 0

    # Liveness bookkeeping (liveness.py): how many times this trial's
    # dispatch went silent past the progress deadline, and how many of
    # those episodes later produced a beat again ("slow, not dead").
    stall_count: int = 0
    stall_recoveries: int = 0

    # Runtime bookkeeping.  ``started_at`` is the FIRST start (total-runtime
    # accounting); ``restarted_at`` is the current incarnation's start —
    # per-trial time limits measure against it so a retried trial gets a
    # fresh budget instead of being instantly over-limit.
    created_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    restarted_at: Optional[float] = None
    finished_at: Optional[float] = None
    stop_requested: bool = False
    pause_requested: bool = False
    assigned_devices: List[Any] = field(default_factory=list)

    @property
    def last_result(self) -> Optional[Dict[str, Any]]:
        return self.results[-1] if self.results else None

    @property
    def training_iteration(self) -> int:
        """Current restorable progress (see field comment above); equals
        ``len(results)`` for a trial that never restored."""
        return self.restore_base + self.reports_since_restart

    def metric_history(self, metric: str) -> List[float]:
        return [r[metric] for r in self.results if metric in r]

    def runtime_s(self) -> float:
        if self.started_at is None:
            return 0.0
        end = self.finished_at or time.time()
        return end - self.started_at

    def incarnation_runtime_s(self) -> float:
        """Runtime of the current (re)start only — the time-limit clock."""
        if self.restarted_at is None:
            return self.runtime_s()
        end = self.finished_at or time.time()
        return end - self.restarted_at

    def __repr__(self) -> str:  # keep logs compact
        return f"Trial({self.trial_id}, {self.status.value}, iters={self.training_iteration})"
