"""The tune.run() driver loop.

Port of ``distributed_machine_learning_tpu/tune/runner.py``: samples trial
configs from the search algorithm, leases devices from the
DeviceManager, streams per-epoch results through the scheduler,
early-stops and retries, persists everything to the experiment store, and
returns an ExperimentAnalysis with ``best_config``
(`ray-tune-hpo-regression.py:469-480`).

Event-driven: trial threads block in ``report`` until this loop answers, so
all scheduler/searcher state is mutated from exactly one thread.

Trials run on every visible card unless ``devices`` says otherwise; with
no card and no ``devices`` the run raises.  The knobs of the reference
that are not ported yet raise ``NotImplementedError`` when set away from
their defaults, naming the ROADMAP.md item that will lift them
(:data:`UNPORTED_KNOB_ITEMS`): ``trial_executor="process"``,
``prewarm_runners``, ``progress_deadline_s``, ``progress_grace_s`` and
``time_limit_per_trial_s`` (A3b), ``resume="auto"`` (the journal, A3c),
``input_mode`` (A6), ``mesh_shape`` (A9), ``trace`` and
``trace_profile_trials`` (A10), a remote ``checkpoint_storage`` (A3f) and
a ``Repeater`` (A3d).  ``resume=True`` continues an interrupted
experiment from its directory (``_driver.py::restore_experiment``).
``PopulationBasedTraining`` and ``PB2`` run as stop and respawn: a
bottom-quantile trial is requeued from a top trial's checkpoint under a
mutated config, and ``experiment_state.json["pbt"]`` counts the
exploits.
``compile_cache_dir`` and ``checkpoint_format`` have no meaning in the
port and are not parameters.
"""

from __future__ import annotations

import os
import queue
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Union

from distributed_machine_learning_tpu_torch.tune._driver import (
    TrialLifecycle,
    scheduler_debug_block,
)
from distributed_machine_learning_tpu_torch.tune.callbacks import (
    dispatch_safely,
    experiment_counters,
    with_default_reporter,
)
from distributed_machine_learning_tpu_torch.tune.executor import (
    DeviceManager,
    ThreadTrialExecutor,
)
from distributed_machine_learning_tpu_torch.tune.experiment import (
    ExperimentAnalysis,
    ExperimentStore,
)
from distributed_machine_learning_tpu_torch.tune.schedulers.base import (
    FIFOScheduler,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
    pbt_state_block,
)
from distributed_machine_learning_tpu_torch.tune.search.base import (
    RandomSearch,
    Searcher,
    maybe_warm_start,
)
from distributed_machine_learning_tpu_torch.tune.search_space import SearchSpace
from distributed_machine_learning_tpu_torch.tune.stoppers import resolve_stop
from distributed_machine_learning_tpu_torch.tune.storage import get_storage
from distributed_machine_learning_tpu_torch.tune.trial import (
    Resources,
    Trial,
    TrialStatus,
)

DEFAULT_STORAGE = "~/dml_torch_results"


# The ROADMAP.md item that will lift each refused knob.
UNPORTED_KNOB_ITEMS = {
    "trial_executor": "A3b",
    "prewarm_runners": "A3b",
    "progress_deadline_s": "A3b",
    "progress_grace_s": "A3b",
    "time_limit_per_trial_s": "A3b",
    "resume": "A3c",
    "input_mode": "A6",
    "mesh_shape": "A9",
    "trace": "A10",
    "trace_profile_trials": "A10",
}


def _validate_resume(storage_path: str, name: Optional[str]) -> None:
    """The resume precondition: an explicit name whose experiment
    directory exists, so that a typo'd name does not start (and pay for)
    a fresh experiment while claiming to resume."""
    if not name:
        raise ValueError(
            "resume=True needs the explicit experiment `name` to resume"
        )
    root = ExperimentStore.root_for(storage_path, name)
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"resume=True but no experiment directory at {root}"
        )


def _refuse_unported(knobs: Dict[str, bool]) -> None:
    for knob, is_set in knobs.items():
        if is_set:
            raise NotImplementedError(
                f"tune.run({knob}=...) is not ported yet; see ROADMAP.md "
                f"{UNPORTED_KNOB_ITEMS[knob]}"
            )


def run(
    trainable: Callable,
    param_space: Union[Dict[str, Any], SearchSpace],
    *,
    metric: str,
    mode: str = "min",
    num_samples: int = 10,
    scheduler: Optional[TrialScheduler] = None,
    search_alg: Optional[Searcher] = None,
    resources_per_trial: Optional[Dict[str, int]] = None,
    mesh_shape: Optional[Dict[str, int]] = None,
    input_mode: Optional[str] = None,
    max_concurrent: Optional[int] = None,
    storage_path: str = DEFAULT_STORAGE,
    name: Optional[str] = None,
    seed: int = 0,
    max_failures: int = 0,
    stop=None,
    time_budget_s: Optional[float] = None,
    devices: Optional[List] = None,
    verbose: int = 1,
    callbacks: Optional[List] = None,
    keep_checkpoints_num: int = 0,
    checkpoint_storage: Optional[str] = None,
    time_limit_per_trial_s: Optional[float] = None,
    trial_executor: str = "thread",
    prewarm_runners: int = 0,
    resume: Union[bool, str] = False,
    points_to_evaluate: Optional[List[Dict[str, Any]]] = None,
    progress_deadline_s: Optional[float] = None,
    progress_grace_s: Optional[float] = None,
    trace: bool = False,
    trace_profile_trials: int = 0,
) -> ExperimentAnalysis:
    """Run an HPO experiment; see module docstring.

    ``devices``: the ``torch.device``s trials are leased from (default:
    every visible card; ``[torch.device("cpu")] * n`` gives n CPU lease
    slots).  ``points_to_evaluate``: configs (possibly partial — missing
    keys are sampled) run as the first trials before the searcher proposes
    its own; model-based searchers observe their results.
    ``stop``: dict of result-key -> threshold, a callable
    ``(trial_id, result) -> bool``, or a ``tune.Stopper``.
    ``max_failures``: per-trial retry budget; retries restore from the
    trial's newest checkpoint when one exists.
    ``keep_checkpoints_num``: keep only the newest k checkpoints per trial
    (0 = keep all); a checkpoint a pending retry points at is never pruned.
    ``checkpoint_storage``: another root for checkpoints (a local path, or
    ``mem://...`` in tests); metrics stay under ``storage_path``.
    ``resume=True``: continue the experiment ``name`` under
    ``storage_path``: finished trials stay finished, their records replay
    into the scheduler and searcher, interrupted ones run again from their
    newest checkpoint, and sampling continues to ``num_samples``.
    """
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    if trial_executor not in ("thread", "process"):
        raise ValueError(
            f"trial_executor must be 'thread' or 'process', got {trial_executor!r}"
        )
    _refuse_unported({
        "trial_executor": trial_executor == "process",
        "prewarm_runners": bool(prewarm_runners),
        "resume": resume == "auto",
        "mesh_shape": mesh_shape is not None,
        "input_mode": input_mode is not None,
        "trace": bool(trace),
        "trace_profile_trials": bool(trace_profile_trials),
        "progress_deadline_s": progress_deadline_s is not None,
        "progress_grace_s": progress_grace_s is not None,
        "time_limit_per_trial_s": time_limit_per_trial_s is not None,
    })
    if checkpoint_storage is not None:
        get_storage(checkpoint_storage)  # a remote scheme raises here
    if resume:
        _validate_resume(storage_path, name)
    space = (
        param_space
        if isinstance(param_space, SearchSpace)
        else SearchSpace(param_space)
    )
    stop = resolve_stop(stop)  # validate dict/callable/Stopper up front
    searcher = maybe_warm_start(search_alg or RandomSearch(), points_to_evaluate)
    searcher.set_search_space(space, seed)
    sched = scheduler or FIFOScheduler()
    sched.set_experiment(metric, mode)
    resources = Resources.parse(resources_per_trial)
    device_mgr = DeviceManager(devices)

    name = name or f"exp_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
    store = ExperimentStore(storage_path, name, checkpoint_storage)
    store.set_context(metric, mode)
    events: "queue.Queue" = queue.Queue()
    executor = ThreadTrialExecutor(store, events)
    callbacks = with_default_reporter(callbacks, verbose)

    max_concurrent = max_concurrent or device_mgr.num_devices
    running: Dict[str, List] = {}  # trial_id -> leased devices
    last_status_print = 0.0
    last_sched_persist = 0.0

    def log(msg: str):
        if verbose:
            print(f"[tune] {msg}", flush=True)

    lifecycle = TrialLifecycle(
        searcher=searcher,
        scheduler=sched,
        store=store,
        metric=metric,
        mode=mode,
        num_samples=num_samples,
        max_failures=max_failures,
        stop_rules=stop,
        time_budget_s=time_budget_s,
        keep_checkpoints_num=keep_checkpoints_num,
        log=log,
    )
    trials = lifecycle.trials
    pending = lifecycle.pending
    start_time = lifecycle.start_time
    if resume:
        counts = lifecycle.restore_experiment(resources=resources)
        log(f"resumed {name}: {counts['finished']} finished trials kept, "
            f"{counts['requeued']} interrupted trials requeued")

    def safe_cb(hook: str, *args):
        dispatch_safely(callbacks, hook, *args, log=log)

    def launch_ready():
        while pending and len(running) < max_concurrent:
            leased = device_mgr.acquire(pending[0].resources.devices)
            if leased is None:
                return
            trial = pending.pop(0)
            lifecycle.mark_running(trial)
            running[trial.trial_id] = leased
            safe_cb("on_trial_start", trial)
            executor.start_trial(trial, trainable, leased)

    def release_devices(trial: Trial):
        leased = running.pop(trial.trial_id, None)
        if leased:
            device_mgr.release(leased)

    # -------- main event loop ------------------------------------------------
    def event_loop():
        nonlocal last_status_print, last_sched_persist
        while True:
            while not lifecycle.exhausted() and (
                len(pending) + len(running) < max_concurrent + 2
            ):
                if lifecycle.create_trial(resources=resources) is None:
                    break
            launch_ready()

            if not running and not pending:
                if lifecycle.exhausted():
                    break
                if len(trials) == 0 and lifecycle.next_index == 0:
                    break  # nothing to do at all
                continue

            try:
                event = events.get(timeout=0.5)
            except queue.Empty:
                if verbose and time.time() - last_status_print > 15:
                    last_status_print = time.time()
                    log(
                        f"{sum(t.status == TrialStatus.TERMINATED for t in trials)}"
                        f"/{num_samples} done, {len(running)} running, "
                        f"{device_mgr.num_free}/{device_mgr.num_devices} devices free"
                    )
                # Reap trials whose thread died without a terminal event
                # (shouldn't happen: the executor posts one on every path),
                # through fail_trial like an ordinary trial error.
                for tid in list(running):
                    trial = lifecycle.by_id[tid]
                    if not executor.is_alive(trial):
                        why = "trial executor died without reporting"
                        safe_cb("on_trial_error", trial, why)
                        release_devices(trial)
                        lifecycle.fail_trial(trial, why)
                safe_cb("on_heartbeat")
                continue

            kind = event[0]
            # Stale-event guard: a dead incarnation's late events must not
            # be applied, least of all to a relaunched retry of the trial.
            if kind == "result":
                ev_trial, ev_inc = event[1].trial, event[1].incarnation
            else:
                ev_trial, ev_inc = event[1], event[3]
            if (
                ev_trial.trial_id not in running
                or ev_inc != ev_trial.incarnation
            ):
                if kind == "result":
                    event[1].decision = "stop"
                    event[1].done.set()
                continue

            if kind == "result":
                result_event = event[1]
                trial = result_event.trial
                try:
                    result_event.decision = lifecycle.process_result(
                        trial, result_event.metrics
                    )
                finally:
                    # Unblock the trial thread BEFORE observers run: a slow
                    # or buggy callback must not stall training.
                    result_event.done.set()
                safe_cb("on_trial_result", trial, trial.last_result)
                # Persist the scheduler/searcher debug snapshot at report
                # boundaries, throttled.
                if time.time() - last_sched_persist > 2.0:
                    last_sched_persist = time.time()
                    store.write_state(trials, extra={
                        "scheduler": scheduler_debug_block(searcher, sched),
                    })

            elif kind == "complete":
                trial = event[1]
                release_devices(trial)
                if not lifecycle.complete_trial(trial):
                    safe_cb("on_trial_complete", trial)
                store.write_state(trials, extra={
                    "scheduler": scheduler_debug_block(searcher, sched),
                })

            elif kind == "error":
                trial, tb = event[1], event[2]
                trial.error = tb
                # Every failure is observable, including retried ones.
                safe_cb("on_trial_error", trial, tb)
                release_devices(trial)
                retried = lifecycle.fail_trial(trial, tb)
                if not retried and verbose:
                    log(f"{trial.trial_id} errored:\n{tb}")
                store.write_state(trials, extra={
                    "scheduler": scheduler_debug_block(searcher, sched),
                })

    # Teardown always runs (Ctrl-C, store errors, a callback's setup
    # raising): the trial threads are stopped and joined, and callbacks see
    # the experiment end.
    try:
        for cb in callbacks:
            cb.setup(store.root, metric, mode)
        event_loop()
    finally:
        wall = time.time() - start_time
        if not executor.join_all():
            log("a trial thread outlived the teardown deadline")
        lifecycle.final_prune()
        utilization = device_mgr.utilization(wall)
        extra = {
            "wall_clock_s": wall,
            "device_utilization": utilization,
            "scheduler": scheduler_debug_block(searcher, sched),
        }
        pbt_block = pbt_state_block(sched)
        if pbt_block is not None:
            extra["pbt"] = pbt_block
        try:
            store.write_state(trials, extra=extra)
            store.close()
        except Exception as exc:  # noqa: BLE001 - callbacks still tear down
            log(f"experiment store teardown failed: {exc!r}")
        counters = experiment_counters(extra)
        if counters:
            safe_cb("on_experiment_counters", counters)
        safe_cb("on_experiment_end", trials, wall)
    analysis = ExperimentAnalysis(
        trials, metric=metric, mode=mode, root=store.root, wall_clock_s=wall,
        device_utilization=utilization,
    )
    n_done = analysis.num_terminated()
    log(
        f"experiment {name}: {n_done}/{len(trials)} trials terminated in "
        f"{wall:.1f}s ({analysis.trials_per_hour():.1f} trials/hour, "
        f"{100 * utilization:.0f}% device utilization)"
    )
    return analysis
