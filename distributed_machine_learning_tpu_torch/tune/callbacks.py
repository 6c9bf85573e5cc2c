"""Experiment callbacks: observability hooks on the runner's event loop.

The reference had no observability beyond a log file and Ray's results dir
(SURVEY.md §5).  Callbacks receive every trial lifecycle event from the
single-threaded runner loop (so they never need locks) and power the built-in
structured logging, JSONL event stream, and the live progress table.

Port of ``distributed_machine_learning_tpu/tune/callbacks.py``:
``Callback``, ``LoggerCallback``, ``JsonlCallback``, ``ProgressReporter``,
``TensorBoardCallback`` (over the port's own ``utils/tensorboard.py``),
``ProfilerCallback`` (a ``torch.profiler`` capture where the JAX package
takes a ``jax.profiler`` trace), ``with_default_reporter``,
``dispatch_safely`` and :func:`experiment_counters`, the scalars both
runners hand to ``on_experiment_counters``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from distributed_machine_learning_tpu_torch.tune.trial import Trial
from distributed_machine_learning_tpu_torch.utils.numeric import finite_number
from distributed_machine_learning_tpu_torch.utils.logging import (
    JsonlEventLog,
    add_file_handler,
    get_logger,
    remove_handler,
)


def with_default_reporter(callbacks, verbose: int):
    """The shared verbose>=2 convention for both runners: a live trial
    table (Ray Tune's default console surface) unless one is already
    wired.  Returns a fresh list; never mutates the caller's."""
    callbacks = list(callbacks or [])
    if verbose >= 2 and not any(
        isinstance(cb, ProgressReporter) for cb in callbacks
    ):
        callbacks.append(ProgressReporter())
    return callbacks


# The experiment state's counter blocks and their scalar prefixes, in the
# JAX runners' order.  The port keeps the checkpoint, pbt, journal and
# host_input families (the last from data/pipeline.py's counters:
# ``host_input/prefetch_hits``, ``.../overlap_efficiency``, ...); the
# others stay empty until their layers are ported.
COUNTER_FAMILIES = (
    ("liveness", "liveness"), ("injected_faults", "faults"),
    ("checkpoint", "checkpoint"), ("compile", "compile"),
    ("host_input", "host_input"), ("pbt", "pbt"), ("obs", "obs"),
    ("journal", "journal"),
)


def experiment_counters(extra: Dict[str, Any]) -> Dict[str, float]:
    """``{"<family>/<counter>": value}`` over the numeric fields of each
    counter block of an experiment state's ``extra`` (strings and flags,
    such as ``pbt.mode``, are left out)."""
    return {
        f"{prefix}/{key}": value
        for block, prefix in COUNTER_FAMILIES
        for key, value in (extra.get(block) or {}).items()
        if isinstance(value, (int, float)) and not isinstance(value, bool)
    }


def dispatch_safely(callbacks, hook: str, *args, log=lambda msg: None):
    """Invoke ``hook`` on every callback, isolating observer failures.

    Shared by the threaded and vectorized drivers: a raising callback is
    logged and dropped for that event, never fatal to the sweep (a trial
    thread may be blocked waiting on the event loop that runs observers)."""
    for cb in callbacks:
        try:
            getattr(cb, hook)(*args)
        except Exception as exc:  # noqa: BLE001 - observer isolation
            log(f"{type(cb).__name__}.{hook} raised: {exc!r}")


class Callback:
    """Base class; override any subset of hooks.

    Hooks run on the single runner thread, after the trial thread has been
    unblocked — a raising callback is logged and skipped, never fatal.
    ``on_trial_start`` may fire more than once per trial (fault retries, PBT
    requeues), and every failure fires ``on_trial_error`` even when the trial
    will be retried.  ``on_heartbeat`` ticks whenever the runner is idle
    (~every 0.5s) so time-based callbacks don't depend on trial traffic.
    """

    def setup(self, experiment_root: str, metric: str, mode: str):
        pass

    def on_heartbeat(self):
        pass

    def on_trial_start(self, trial: Trial):
        pass

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial: Trial):
        pass

    def on_trial_error(self, trial: Trial, error: str):
        pass

    def on_experiment_counters(self, counters: Dict[str, int]):
        """Experiment-level counters at teardown, prefixed by family
        (``pbt/exploits``, ``host_input/mode_fallbacks``, ...).  Fires
        just before ``on_experiment_end``, and only when any counter
        family is active (:func:`experiment_counters`)."""
        pass

    def on_experiment_end(self, trials: List[Trial], wall_clock_s: float):
        pass


class LoggerCallback(Callback):
    """Structured per-event logging through the framework logger tree.

    Replaces the reference's hard-coded-path file logging (C23,
    `ray-tune-hpo-regression-sample.py:16-23`): pass ``log_file`` to also log
    to a file of your choosing.
    """

    def __init__(self, log_file: Optional[str] = None):
        self._log_file = log_file
        self._log = None
        self._handler = None

    def setup(self, experiment_root: str, metric: str, mode: str):
        self._log = get_logger("tune")
        if self._log_file is not None:
            self._handler = add_file_handler(self._log_file)
        self._metric = metric
        self._log.info("experiment started (root=%s, metric=%s/%s)",
                       experiment_root, metric, mode)

    def on_trial_start(self, trial: Trial):
        self._log.info("%s started: %s", trial.trial_id, trial.config)

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        val = result.get(self._metric)
        self._log.info("%s iter %s: %s=%s", trial.trial_id,
                       result.get("training_iteration"), self._metric, val)

    def on_trial_complete(self, trial: Trial):
        self._log.info("%s terminated after %d result(s) in %.1fs",
                       trial.trial_id, len(trial.results), trial.runtime_s())

    def on_trial_error(self, trial: Trial, error: str):
        self._log.error("%s errored: %s", trial.trial_id,
                        error.strip().splitlines()[-1] if error else "?")

    def on_experiment_end(self, trials: List[Trial], wall_clock_s: float):
        self._log.info("experiment finished: %d trials in %.1fs",
                       len(trials), wall_clock_s)
        if self._handler is not None:
            remove_handler(self._handler)
            self._handler = None


class JsonlCallback(Callback):
    """Machine-readable experiment event stream -> ``<root>/events.jsonl``."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._log: Optional[JsonlEventLog] = None

    def setup(self, experiment_root: str, metric: str, mode: str):
        path = self._path or os.path.join(experiment_root, "events.jsonl")
        self._log = JsonlEventLog(path)
        self._log.write("experiment_start", {"root": experiment_root,
                                             "metric": metric, "mode": mode})

    def on_trial_start(self, trial: Trial):
        self._log.write("trial_start", {"trial_id": trial.trial_id,
                                        "config": trial.config})

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        # The runner already stamps trial_id into each result record.
        self._log.write("trial_result", {**result, "trial_id": trial.trial_id})

    def on_trial_complete(self, trial: Trial):
        self._log.write("trial_complete", {"trial_id": trial.trial_id,
                                           "num_results": len(trial.results),
                                           "runtime_s": trial.runtime_s()})

    def on_trial_error(self, trial: Trial, error: str):
        self._log.write("trial_error", {"trial_id": trial.trial_id,
                                        "error": error})

    def on_experiment_end(self, trials: List[Trial], wall_clock_s: float):
        self._log.write("experiment_end", {"num_trials": len(trials),
                                           "wall_clock_s": wall_clock_s})
        self._log.close()


class TensorBoardCallback(Callback):
    """Per-trial TensorBoard scalar logging (Ray Tune's default TB surface).

    One run directory per trial under ``<root>/tensorboard/<trial_id>/``;
    every numeric field of every ``tune.report`` lands as a scalar at
    ``step=training_iteration``, and the trial's numeric hyperparameters
    once as ``config/<key>`` scalars at step 0.  A trial's writer closes
    when it completes or errors (one open file per live trial); a retried
    trial gets a fresh event file in the same run directory, which
    TensorBoard merges.  The experiment's counters go to the
    ``_experiment`` run.  No tensorflow/tensorboardX is needed: the
    event-file format is hand-encoded (``utils/tensorboard.py``)."""

    def __init__(self, logdir: Optional[str] = None):
        self._logdir = logdir
        self._writers: Dict[str, Any] = {}

    def setup(self, experiment_root: str, metric: str, mode: str):
        self._root = self._logdir or os.path.join(experiment_root,
                                                  "tensorboard")

    @staticmethod
    def _numeric(items) -> List:
        return [(key, float(val)) for key, val in items
                if not isinstance(val, bool) and isinstance(val, (int, float))]

    def _writer(self, trial: Trial):
        w = self._writers.get(trial.trial_id)
        if w is None:
            from distributed_machine_learning_tpu_torch.utils.tensorboard \
                import SummaryWriter

            w = SummaryWriter(os.path.join(self._root, trial.trial_id))
            self._writers[trial.trial_id] = w
            for key, val in self._numeric((trial.config or {}).items()):
                w.add_scalar(f"config/{key}", val, step=0)
        return w

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        step = int(result.get("training_iteration", len(trial.results)) or 0)
        scalars = self._numeric(result.items())
        if scalars:
            self._writer(trial).add_scalars(scalars, step=step)

    def _close(self, trial_id: str):
        w = self._writers.pop(trial_id, None)
        if w is not None:
            w.close()

    def on_trial_complete(self, trial: Trial):
        self._close(trial.trial_id)

    def on_trial_error(self, trial: Trial, error: str):
        self._close(trial.trial_id)

    def on_experiment_counters(self, counters: Dict[str, int]):
        from distributed_machine_learning_tpu_torch.utils.tensorboard import (
            SummaryWriter,
        )

        w = SummaryWriter(os.path.join(self._root, "_experiment"))
        try:
            w.add_scalars(self._numeric(sorted(counters.items())), step=0)
        finally:
            w.close()

    def on_experiment_end(self, trials: List[Trial], wall_clock_s: float):
        for w in self._writers.values():
            w.close()
        self._writers.clear()


class ProfilerCallback(Callback):
    """A ``torch.profiler`` capture of the experiment (host ops, and the
    card's kernels when one is present) into ``<root>/profile``, as a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin and
    chrome://tracing read.  Trials share the process, so this profiles the
    whole sweep; ``duration_s`` bounds the capture by wall clock (checked
    on every result and heartbeat) to keep traces small."""

    def __init__(self, logdir: Optional[str] = None,
                 duration_s: Optional[float] = None):
        self._logdir = logdir
        self._duration_s = duration_s
        self._started_at: Optional[float] = None
        self._prof = None

    def setup(self, experiment_root: str, metric: str, mode: str):
        import torch
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        self._dir = self._logdir or os.path.join(experiment_root, "profile")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities,
                             on_trace_ready=tensorboard_trace_handler(
                                 self._dir))
        self._prof.start()
        self._started_at = time.time()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _maybe_stop(self):
        if self.active and self._duration_s is not None and (
            time.time() - self._started_at > self._duration_s
        ):
            self._stop()

    def _stop(self):
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.stop()

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        self._maybe_stop()

    def on_heartbeat(self):
        self._maybe_stop()

    def on_experiment_end(self, trials: List[Trial], wall_clock_s: float):
        self._stop()


class ProgressReporter(Callback):
    """Live console status table — parity with Ray Tune's ``CLIReporter``.

    The reference's only live feedback was Ray's built-in trial table; the
    runner's ``verbose`` one-liner carries counts but no per-trial state.
    This callback renders, at most every ``interval_s`` seconds and only when
    something changed, a compact table of running trials (iteration, latest
    metric, runtime) plus status counts, the best value so far, and measured
    throughput (terminated trials/hour, as
    ``ExperimentAnalysis.trials_per_hour`` counts it).  A final summary with the best trial's
    config always prints at experiment end.

    Pass ``file`` to redirect (e.g. a log file); default is stdout, matching
    the runner's own ``[tune]`` lines.
    """

    def __init__(self, interval_s: float = 15.0, max_rows: int = 12,
                 file=None):
        self._interval_s = interval_s
        self._max_rows = max_rows
        self._file = file
        self._trials: Dict[str, Trial] = {}
        self._best_value: Optional[float] = None
        self._best_trial_id: Optional[str] = None
        self._last_print = 0.0
        self._dirty = False
        self._start = time.time()

    def setup(self, experiment_root: str, metric: str, mode: str):
        self._metric = metric
        self._mode = mode
        # Full reset: a reporter reused across tune.run calls must not carry
        # the previous experiment's trials/best into the new run's output.
        self._trials = {}
        self._best_value = None
        self._best_trial_id = None
        self._dirty = False
        self._start = time.time()
        self._last_print = 0.0  # first event after setup prints immediately

    # -- event tracking ----------------------------------------------------

    def _touch(self, trial: Trial):
        self._trials[trial.trial_id] = trial
        self._dirty = True

    def on_trial_start(self, trial: Trial):
        self._touch(trial)

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        self._touch(trial)
        val = finite_number(result.get(self._metric))
        if val is not None:  # NaN/inf (diverged trial) never becomes best
            better = (
                self._best_value is None
                or (self._mode == "min" and val < self._best_value)
                or (self._mode == "max" and val > self._best_value)
            )
            if better:
                self._best_value = val
                self._best_trial_id = trial.trial_id
        self._maybe_render()

    def on_trial_complete(self, trial: Trial):
        self._touch(trial)
        self._maybe_render()

    def on_trial_error(self, trial: Trial, error: str):
        self._touch(trial)
        self._maybe_render()

    def on_heartbeat(self):
        # Time-based refresh so runtime columns advance on quiet sweeps:
        # running trials make the table inherently dirty (their time_s
        # column is live), so render on interval whenever any trial runs.
        if any(t.status.value == "RUNNING" for t in self._trials.values()):
            self._dirty = True
        self._maybe_render()

    def on_experiment_end(self, trials: List[Trial], wall_clock_s: float):
        for t in trials:
            self._trials[t.trial_id] = t
        self._render(final=True, wall_clock_s=wall_clock_s)

    # -- rendering ---------------------------------------------------------

    def _numeric_history(self, trial: Trial) -> List[float]:
        """The trial's plottable metric values: numbers only (a trainable
        may report None/strings),
        NaN dropped (a diverged epoch must not rank or display)."""
        return [
            f for f in map(finite_number, trial.metric_history(self._metric))
            if f is not None
        ]

    def _maybe_render(self):
        if self._dirty and time.time() - self._last_print >= self._interval_s:
            self._render()

    def _render(self, final: bool = False, wall_clock_s: float = None):
        import sys

        self._last_print = time.time()
        self._dirty = False
        out = self._file or sys.stdout
        trials = list(self._trials.values())
        counts: Dict[str, int] = {}
        for t in trials:
            counts[t.status.value] = counts.get(t.status.value, 0) + 1
        elapsed = wall_clock_s if wall_clock_s is not None else (
            time.time() - self._start
        )
        done = counts.get("TERMINATED", 0)
        tph = done / (elapsed / 3600.0) if elapsed > 0 and done else 0.0
        status = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
        lines = [
            f"== {'Final result' if final else 'Status'} "
            f"({elapsed:.0f}s) == {status or 'no trials yet'}"
            + (f" | {tph:.0f} trials/h" if done else "")
        ]
        if self._best_value is not None:
            lines.append(
                f"   best {self._metric}: {self._best_value:.6g} "
                f"({self._best_trial_id})"
            )
            best = self._trials.get(self._best_trial_id)
            if final and best is not None:
                lines.append(f"   best config: {best.config}")
        # Running trials first (what a live table is for); at the end, the
        # top finishers by metric instead.
        if final:
            def key(t):
                # Rank by best-in-history so the table agrees with the
                # "best" line (a trial can end worse than its best epoch);
                # non-numeric/NaN-only histories sort last.
                hist = self._numeric_history(t)
                if not hist:
                    return float("inf")
                return min(hist) if self._mode == "min" else -max(hist)
            rows = sorted(trials, key=key)[: self._max_rows]
        else:
            rows = [t for t in trials if t.status.value == "RUNNING"]
            rows.sort(key=lambda t: -t.training_iteration)
            rows = rows[: self._max_rows]
        if rows:
            header = ("trial", "status", "iter", self._metric, "time_s")
            table = [header]
            for t in rows:
                hist = self._numeric_history(t)
                # Final table shows each trial's BEST value (what it's
                # ranked by); the live table shows the latest.
                if hist and final:
                    shown = min(hist) if self._mode == "min" else max(hist)
                elif hist:
                    shown = hist[-1]
                table.append((
                    t.trial_id,
                    t.status.value,
                    str(t.training_iteration),
                    f"{shown:.6g}" if hist else "-",
                    f"{t.runtime_s():.1f}",
                ))
            widths = [max(len(r[i]) for r in table)
                      for i in range(len(header))]
            for row in table:
                lines.append("   " + "  ".join(
                    c.ljust(w) for c, w in zip(row, widths)
                ).rstrip())
            hidden = (len(trials) if final else
                      sum(1 for t in trials
                          if t.status.value == "RUNNING")) - len(rows)
            if hidden > 0:
                lines.append(f"   ... and {hidden} more")
        print("\n".join(lines), file=out, flush=True)
