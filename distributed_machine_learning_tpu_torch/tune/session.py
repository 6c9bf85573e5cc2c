"""Per-trial session: the contract between a trainable and the runner.

Port of ``distributed_machine_learning_tpu/tune/session.py`` (the whole
file; it imports no JAX).  A trainable is any callable
``fn(config, **bound_params)`` that calls ``report(**metrics)`` per epoch.
``report`` returns the runner's decision, and a stop or pause raises in
the trainable at the epoch boundary.  The devices a session carries are
``torch.device``s.  ``tune.run``'s executor installs one per trial;
``standalone()`` runs one trial outside a sweep.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, Optional

_session_store = threading.local()


class StopTrial(Exception):
    """Raised inside a trainable when the scheduler stops the trial early."""


class PauseTrial(Exception):
    """Raised inside a trainable when the scheduler pauses the trial (PBT)."""


class Session:
    """Thread-local handle wired up by the executor before the trainable runs."""

    def __init__(
        self,
        trial,
        report_fn: Callable[[Dict[str, Any], Optional[Any]], str],
        checkpoint_loader: Callable[[], Optional[Dict[str, Any]]],
        devices=None,
        heartbeat_fn: Optional[Callable[[], None]] = None,
    ):
        self.trial = trial
        self._report_fn = report_fn
        self._checkpoint_loader = checkpoint_loader
        self.devices = devices or []
        self._heartbeat_fn = heartbeat_fn

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Any] = None):
        decision = self._report_fn(metrics, checkpoint)
        if decision == "stop":
            raise StopTrial()
        if decision == "pause":
            raise PauseTrial()

    def heartbeat(self):
        """Signal liveness WITHOUT reporting (see module-level
        :func:`heartbeat`); no-op when the executor wired no sink."""
        if self._heartbeat_fn is not None:
            self._heartbeat_fn()

    def get_checkpoint(self) -> Optional[Dict[str, Any]]:
        return self._checkpoint_loader()


def _get_session() -> Session:
    sess = getattr(_session_store, "session", None)
    if sess is None:
        raise RuntimeError(
            "No active trial session: tune.report()/tune.get_checkpoint() must "
            "be called from inside a trainable running under tune.run()"
        )
    return sess


def set_session(session: Optional[Session]):
    _session_store.session = session


def report(_metrics: Optional[Dict[str, Any]] = None, *, checkpoint=None, **kwargs):
    """Report metrics (kwargs-style like the reference's ``tune.report``).

    Optionally attach a ``checkpoint`` pytree; the framework persists it and
    PBT/fault-recovery restore from it.
    """
    metrics = dict(_metrics or {})
    metrics.update(kwargs)
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Dict[str, Any]]:
    """Return the checkpoint pytree this trial should resume from, if any."""
    return _get_session().get_checkpoint()


def heartbeat() -> None:
    """Mark this trial as making progress WITHOUT reporting metrics.

    The liveness watchdog (``tune.run(progress_deadline_s=...)``,
    ``run_distributed(progress_deadline_s=...)``) measures the gap between
    progress signals; ``report`` is one implicitly.  A trainable whose
    single epoch legitimately exceeds the deadline (huge model, cold
    compile) calls this inside its step loop so slow-but-alive is never
    misread as wedged.  No-op outside a watchdog-enabled run — safe to
    call unconditionally."""
    _get_session().heartbeat()


def get_trial_id() -> str:
    return _get_session().trial.trial_id


def current_trial_id(default=None):
    """``get_trial_id()`` that degrades to ``default`` when no session is
    installed (or the session carries no trial object) — for telemetry
    attribution (perf/anomaly.py) from a trainable invoked bare, where
    raising would fail the trial over a label."""
    sess = getattr(_session_store, "session", None)
    trial = getattr(sess, "trial", None)
    return getattr(trial, "trial_id", default)


def get_devices():
    """The ``torch.device``s assigned to this trial by the executor."""
    return list(_get_session().devices)


class _StandaloneTrial:
    trial_id = "standalone"
    training_iteration = 0


@contextlib.contextmanager
def standalone(devices=None, report_fn=None):
    """Run a trainable OUTSIDE ``tune.run``: a no-op session is installed
    for the calling thread — reports are accepted and discarded (decision
    always "continue"), no checkpoint to resume from.

    ``devices``: the ``torch.device``s the trial runs on (``[cpu]`` to
    train on the CPU; the trainable's default is the current card).
    ``report_fn``: optional ``fn(metrics, checkpoint)`` that sees each
    report first (the decision stays "continue").
    """
    def report(metrics, checkpoint):
        if report_fn is not None:
            report_fn(metrics, checkpoint)
        return "continue"

    prev = getattr(_session_store, "session", None)
    _session_store.session = Session(
        trial=_StandaloneTrial(),
        report_fn=report,
        checkpoint_loader=lambda: None,
        devices=devices,
    )
    try:
        yield
    finally:
        _session_store.session = prev


def with_parameters(fn: Callable, **bound) -> Callable:
    """Bind large objects (datasets) to a trainable once, outside the config.

    In-process execution means binding is a closure, not an object-store
    broadcast.
    """
    partial = functools.partial(fn, **bound)
    functools.update_wrapper(partial, fn)
    return partial
