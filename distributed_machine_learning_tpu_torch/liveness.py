"""Liveness primitives: detecting SILENCE, not just failure.

Port of ``distributed_machine_learning_tpu/liveness.py`` (the whole
module).  A dispatch that never returns, a trial that hangs while its
process stays alive: nothing raises, so nothing recovers.  This module
owns the two primitives that turn silence into an event:

* :class:`Heartbeat` — a monotonic progress marker.  ``beat()`` at real
  progress points (report boundaries, mid-epoch ``tune.heartbeat()``
  calls); ``age_s()`` is the time since the last one.  Monotonic clock,
  so clock steps can't fake progress.

* :class:`DispatchWatchdog` — a registry of heartbeats with a progress
  deadline.  Consumers either poll :meth:`expired` from their own event
  loop (the tune runner, which ticks every 0.5 s) or run the built-in
  monitor thread and get an ``on_stall`` callback.  A key that beats
  again after being flagged is a *recovery* — counted, not forgotten,
  because "slow but alive" and "dead" need different responses.

The watchdog never unblocks a wedged call itself.  What it enables is the
layer's response: the process executor SIGTERMs the trial's incarnation
and restarts it from its checkpoint, the thread executor marks the trial
STALLED, and the streaming input ring (``data/pipeline.py``), which
watches its producer thread with one, counts ``producer_stalls`` and
past its hard timeout raises ``ProducerStalled`` in the trial.

The JAX module records each detected stall in the flight recorder of its
observability plane (``obs.record_event``); that plane is ROADMAP.md A10,
so the call site below is a no-op until it is ported.  The JAX module's
locks come from its lock-order recorder (``analysis.locks``), which the
port does not have; these are plain locks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional


def _obs_event(kind: str, fields: Dict[str, Any]) -> None:
    """The flight-recorder event of the JAX module (ROADMAP.md A10)."""


class Heartbeat:
    """Thread-safe monotonic progress marker."""

    __slots__ = ("_lock", "_last", "beats", "created")

    def __init__(self):
        self._lock = threading.Lock()
        now = time.monotonic()
        self._last = now
        self.created = now
        self.beats = 0

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self.beats += 1

    def age_s(self) -> float:
        """Seconds since the last beat (or since creation)."""
        with self._lock:
            return time.monotonic() - self._last


class StallEvent:
    """What the watchdog hands to ``on_stall`` observers."""

    __slots__ = ("key", "age_s", "deadline_s", "info")

    def __init__(self, key: str, age_s: float, deadline_s: float, info: Any):
        self.key = key
        self.age_s = age_s
        self.deadline_s = deadline_s
        self.info = info

    def __repr__(self) -> str:
        return (
            f"StallEvent({self.key!r}, age={self.age_s:.1f}s > "
            f"deadline={self.deadline_s:.1f}s)"
        )


class _Tracked:
    __slots__ = ("heartbeat", "deadline_s", "grace_s", "info", "stalled")

    def __init__(self, deadline_s: float, grace_s: float, info: Any):
        self.heartbeat = Heartbeat()
        self.deadline_s = deadline_s
        self.grace_s = grace_s
        self.info = info
        self.stalled = False

    def threshold_s(self) -> float:
        # Until the FIRST beat the activity is still starting up (process
        # spawn, torch import, the CUDA context, a kernel build): that
        # latency is real but it is not a wedged dispatch; the deadline
        # alone applies once the activity has proven it can make progress.
        return (
            self.deadline_s
            if self.heartbeat.beats > 0
            else self.deadline_s + self.grace_s
        )


class DispatchWatchdog:
    """Progress-deadline tracking over a set of named activities.

    ``expired()`` is edge-triggered: each tracked key is returned once per
    stall episode (re-armed by the next ``beat``), so pollers can treat a
    returned key as "act now" without dedup bookkeeping.  Counters
    (``stalls_total``, ``recoveries_total``, per-key ``beats``) surface in
    :meth:`snapshot` for experiment_state.json / TensorBoard.
    """

    def __init__(
        self,
        deadline_s: float,
        on_stall: Optional[Callable[[StallEvent], None]] = None,
        poll_s: Optional[float] = None,
        first_beat_grace_s: Optional[float] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0: {deadline_s}")
        self.deadline_s = float(deadline_s)
        # Extra allowance before the first beat only (see _Tracked): cold
        # starts legitimately dwarf steady-state report gaps.
        self.first_beat_grace_s = (
            float(first_beat_grace_s)
            if first_beat_grace_s is not None
            else max(3.0 * self.deadline_s, 30.0)
        )
        self._on_stall = on_stall
        self._poll_s = poll_s or max(min(self.deadline_s / 4.0, 1.0), 0.02)
        self._lock = threading.Lock()
        self._tracked: Dict[str, _Tracked] = {}
        self.stalls_total = 0
        self.recoveries_total = 0
        self.observer_errors = 0
        self._monitor: Optional[threading.Thread] = None
        self._closing = threading.Event()

    # -- registry ------------------------------------------------------------

    def track(self, key: str, deadline_s: Optional[float] = None,
              info: Any = None,
              first_beat_grace_s: Optional[float] = None) -> None:
        """(Re)register ``key`` with a fresh heartbeat."""
        with self._lock:
            self._tracked[key] = _Tracked(
                deadline_s or self.deadline_s,
                self.first_beat_grace_s
                if first_beat_grace_s is None else float(first_beat_grace_s),
                info,
            )

    def beat(self, key: str) -> None:
        """Record progress for ``key``; a beat on a stalled key counts as a
        recovery.  Unknown keys are ignored (a late beat from an activity
        already untracked must not resurrect it)."""
        with self._lock:
            entry = self._tracked.get(key)
            if entry is None:
                return
            if entry.stalled:
                entry.stalled = False
                self.recoveries_total += 1
            entry.heartbeat.beat()

    def untrack(self, key: str) -> None:
        with self._lock:
            self._tracked.pop(key, None)

    def is_stalled(self, key: str) -> bool:
        with self._lock:
            entry = self._tracked.get(key)
            return bool(entry and entry.stalled)

    # -- detection -----------------------------------------------------------

    def expired(self) -> List[StallEvent]:
        """Keys newly past their deadline (each stall episode fires once)."""
        out: List[StallEvent] = []
        with self._lock:
            for key, entry in self._tracked.items():
                if entry.stalled:
                    continue
                age = entry.heartbeat.age_s()
                if age > entry.threshold_s():
                    entry.stalled = True
                    self.stalls_total += 1
                    out.append(StallEvent(key, age, entry.deadline_s,
                                          entry.info))
        for event in out:
            _obs_event("watchdog_stall", {
                "key": event.key,
                "age_s": round(event.age_s, 2),
                "deadline_s": event.deadline_s,
            })
        return out

    # -- blocking-call guard (monitor-thread mode) ---------------------------

    def guard(self, key: str, info: Any = None):
        """Context manager wrapping ONE blocking dispatch: tracks on entry,
        untracks on exit.  Needs the monitor thread (``start()``) for the
        ``on_stall`` callback to fire while the caller is blocked."""
        return _Guard(self, key, info)

    def start(self) -> "DispatchWatchdog":
        """Run the monitor thread: polls ``expired()`` and invokes
        ``on_stall`` for each event.  Idempotent; daemon thread."""
        if self._monitor is None or not self._monitor.is_alive():
            self._closing.clear()
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="dispatch-watchdog",
                daemon=True,
            )
            self._monitor.start()
        return self

    def close(self) -> None:
        self._closing.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None

    def _monitor_loop(self) -> None:
        while not self._closing.wait(self._poll_s):
            for event in self.expired():
                if self._on_stall is not None:
                    try:
                        self._on_stall(event)
                    except Exception:  # noqa: BLE001 - observer isolation
                        # Isolated on purpose (a broken observer must not
                        # kill stall detection) but never silent: the count
                        # surfaces in snapshot()/experiment_state.json.
                        self.observer_errors += 1

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "stalls_detected": self.stalls_total,
                "stall_recoveries": self.recoveries_total,
                "currently_stalled": sum(
                    1 for e in self._tracked.values() if e.stalled
                ),
                "observer_errors": self.observer_errors,
            }


class _Guard:
    __slots__ = ("_dog", "_key", "_info")

    def __init__(self, dog: DispatchWatchdog, key: str, info: Any):
        self._dog = dog
        self._key = key
        self._info = info

    def __enter__(self):
        self._dog.track(self._key, info=self._info)
        return self._dog

    def __exit__(self, *exc):
        self._dog.untrack(self._key)
        return False
