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
no card and no ``devices`` the run raises.  ``trial_executor="process"``
runs each trial in its own process (``executor.py::ProcessTrialExecutor``)
with ``prewarm_runners`` pre-warmed children; ``time_limit_per_trial_s``
stops a trial at its next report past the limit and, under processes,
kills one that goes quiet; ``progress_deadline_s`` and
``progress_grace_s`` arm the liveness watchdog (``liveness.py``).  The
knobs of the reference that are not ported yet raise
``NotImplementedError`` when set away from their defaults, naming the
ROADMAP.md item that will lift them (:data:`UNPORTED_KNOB_ITEMS`):
``mesh_shape`` (A9), ``trace`` and ``trace_profile_trials`` (A10).
``input_mode`` (``"auto"``, ``"resident"``, ``"streaming"``) is stamped
into every sampled config (a config's own value wins), and each run's
``host_input`` counters (``data/pipeline.py``: the prefetch ring's hits,
waits and overlap efficiency, the window cache) land in
``experiment_state.json["host_input"]``.  ``checkpoint_storage`` may be any
``tune.storage`` scheme (``gs://``, ``s3://``, fsspec's ``memory://``, a
local path), and ``checkpoint_format="sharded"`` writes COMMIT-last
generations through the content store (``ckpt/``); each run's checkpoint
I/O counters land in ``experiment_state.json["checkpoint"]``.
``resume=True`` continues an interrupted
experiment from its directory (``_driver.py::restore_experiment``).
Every run journals its decisions (``tune/journal.py``, under either
executor) and commits the journal at a clean end; ``resume="auto"``
restores a head that died from its journal
(``_driver.py::restore_from_journal``) and otherwise starts fresh.
``PopulationBasedTraining`` and ``PB2`` run as stop and respawn: a
bottom-quantile trial is requeued from a top trial's checkpoint under a
mutated config, and ``experiment_state.json["pbt"]`` counts the
exploits.
``compile_cache_dir`` has no meaning in the port and is not a parameter.
"""

from __future__ import annotations

import os
import queue
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Union

from distributed_machine_learning_tpu_torch import chaos
from distributed_machine_learning_tpu_torch.compilecache import program_key
from distributed_machine_learning_tpu_torch.data import pipeline as hostpipe
from distributed_machine_learning_tpu_torch.liveness import DispatchWatchdog
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
    ProcessTrialExecutor,
    ThreadTrialExecutor,
)
from distributed_machine_learning_tpu_torch.tune.experiment import (
    ExperimentAnalysis,
    ExperimentStore,
)
from distributed_machine_learning_tpu_torch.tune import journal as journal_lib
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
    checkpoint_format: str = "msgpack",
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
    ``input_mode``: the sweep-wide data staging mode stamped into every
    sampled config (a config carrying its own ``input_mode`` wins):
    ``"resident"`` (both splits on the device; raises over the device's
    budget), ``"streaming"`` (the prefetch ring, ``data/pipeline.py``) or
    ``"auto"`` (streaming past ``streaming_engage_fraction`` of the
    budget).  A run that streamed publishes the ``host_input`` counters
    (prefetch hits, producer and consumer waits, overlap efficiency) in
    ``experiment_state.json`` and as ``host_input/*`` scalars.
    ``max_failures``: per-trial retry budget; retries restore from the
    trial's newest checkpoint when one exists.
    ``keep_checkpoints_num``: keep only the newest k checkpoints per trial
    (0 = keep all); a checkpoint a pending retry points at is never pruned.
    ``checkpoint_storage``: another root for checkpoints (``gs://...`` for
    shared storage, any ``tune.storage`` scheme); metrics stay under
    ``storage_path``.
    ``checkpoint_format``: ``"msgpack"`` (the port's single blob, a JSON
    index and a tensor file per step) or ``"sharded"`` (the ``ckpt/``
    format: chunk payloads in the content store, a JSON index and a
    COMMIT marker per ``gen_NNNNNN`` directory, the JAX package's layout).
    Restores read every form, so it can change across a resume.
    Checkpoint save/restore counters land in
    ``experiment_state.json["checkpoint"]`` either way.
    ``resume=True``: continue the experiment ``name`` under
    ``storage_path``: finished trials stay finished, their records replay
    into the scheduler and searcher, interrupted ones run again from their
    newest checkpoint, and sampling continues to ``num_samples``.
    ``resume="auto"``: resume IFF a prior head left an uncommitted decision
    journal behind (it died mid-sweep): the journaled searcher and
    scheduler state is restored exactly, trials finished or stopped by a
    journaled decision stay so, the rest rerun from their newest valid
    checkpoint at or below their last journaled report, and each epoch is
    accounted once.  A committed journal or none runs fresh; it needs an
    explicit ``name``.
    ``time_limit_per_trial_s``: per-trial wall-clock budget, measured per
    incarnation.  Enforced softly at every report boundary (both
    executors), and enforced HARD — SIGTERM, then SIGKILL — for a trial
    that stops reporting, once it is ``max(2, limit / 4)`` seconds past
    the limit, when ``trial_executor="process"``.  A killed trial follows
    the normal error path: retried within ``max_failures`` (restoring its
    newest checkpoint) or marked ERROR; its lease is released either way.
    ``trial_executor``: "thread" (default; lowest overhead, no preemption)
    or "process" (one OS process per trial, its cards set by
    ``CUDA_VISIBLE_DEVICES``; trainables must pickle with cloudpickle).
    ``prewarm_runners``: with ``trial_executor="process"``, keep this many
    pre-warmed children pooled: spawned before any trial is assigned,
    they have imported torch, created the CUDA context and loaded the
    flash kernels.  During scheduler think-time an idle one runs the next
    pending trial's first epoch (warming its own cuBLAS handles,
    allocator and kernel modules).  ``experiment_state.json["compile"]``
    counts ``prewarmed_spawns``, ``cold_spawns`` and ``prewarm_compiles``.
    ``progress_deadline_s``: a trial that gives no progress signal
    (``tune.report`` or ``tune.heartbeat``) for this long is marked
    STALLED — and, under the process executor, killed and restarted from
    its newest checkpoint within ``max_failures``; the thread executor
    marks, counts, and clears the stall if the trial recovers.  Counters
    land in ``experiment_state.json["liveness"]``.
    ``progress_grace_s``: extra allowance before each incarnation's FIRST
    progress signal (process spawn, torch import, a kernel build; default
    ``max(3 * deadline, 30)``).
    """
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    if input_mode is not None and input_mode not in hostpipe.INPUT_MODES:
        raise ValueError(
            f"input_mode must be one of {hostpipe.INPUT_MODES}, "
            f"got {input_mode!r}"
        )
    if trial_executor not in ("thread", "process"):
        raise ValueError(
            f"trial_executor must be 'thread' or 'process', got {trial_executor!r}"
        )
    _refuse_unported({
        "mesh_shape": mesh_shape is not None,
        "trace": bool(trace),
        "trace_profile_trials": bool(trace_profile_trials),
    })
    if checkpoint_storage is not None:
        # A scheme whose driver is missing (gs:// without gcsfs) raises
        # here, before anything is written.
        get_storage(checkpoint_storage)
    # resume="auto": resume IFF a prior head left an uncommitted decision
    # journal behind (crash mid-sweep); a committed journal or no journal
    # means the experiment either finished cleanly or never started, and the
    # run proceeds fresh.  Unlike resume=True this never raises on a missing
    # directory — "auto" is safe to pass unconditionally in supervisor loops.
    journal_resume = False
    if resume == "auto":
        if not name:
            raise ValueError(
                'resume="auto" needs the explicit experiment `name`'
            )
        journal_resume = journal_lib.is_uncommitted(
            ExperimentStore.root_for(storage_path, name)
        )
        resume = journal_resume
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
    store = ExperimentStore(storage_path, name, checkpoint_storage,
                            checkpoint_format=checkpoint_format)
    store.set_context(metric, mode)
    from distributed_machine_learning_tpu_torch.ckpt import get_metrics

    ckpt_metrics_base = get_metrics().snapshot()
    host_input_base = hostpipe.get_host_input_counters().snapshot()
    # The dead head's journal is read before this head appends to it.
    replay = journal_lib.parse_journal(store.root) if journal_resume else None
    # Every scheduling decision is journaled (write-ahead) before it takes
    # effect; `journal.commit()` at clean teardown is what "auto" checks for.
    journal = journal_lib.ExperimentJournal(store.root)
    head_incarnation = journal.open()
    events: "queue.Queue" = queue.Queue()
    watchdog = None
    if progress_deadline_s is not None:
        # Polled from the event loop below (which ticks every <=0.5s); no
        # monitor thread needed.
        watchdog = DispatchWatchdog(
            progress_deadline_s, first_beat_grace_s=progress_grace_s
        )
    if trial_executor == "process":
        executor = ProcessTrialExecutor(store, events, watchdog=watchdog,
                                        prewarm=prewarm_runners,
                                        devices=device_mgr.devices)
    else:
        executor = ThreadTrialExecutor(store, events, watchdog=watchdog)
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
        time_limit_per_trial_s=time_limit_per_trial_s,
        log=log,
        config_overlay={"input_mode": input_mode} if input_mode else None,
        journal=journal,
    )
    trials = lifecycle.trials
    pending = lifecycle.pending
    start_time = lifecycle.start_time
    liveness_counters = {"stall_kills": 0, "stall_requeues": 0}
    if journal_resume and replay is not None:
        counts = lifecycle.restore_from_journal(replay, resources=resources)
        log(
            f"resumed {name} from journal (head incarnation "
            f"{head_incarnation}): {counts['finished']} finished trials "
            f"kept, {counts['requeued']} interrupted trials requeued, "
            f"{counts['suppress_windows']} replay suppression windows"
        )
    elif resume:
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
            if watchdog is not None:
                watchdog.track(trial.trial_id)
            safe_cb("on_trial_start", trial)
            executor.start_trial(trial, trainable, leased)

    def release_devices(trial: Trial):
        leased = running.pop(trial.trial_id, None)
        if leased:
            device_mgr.release(leased)
        if watchdog is not None:
            watchdog.untrack(trial.trial_id)

    # -------- main event loop ------------------------------------------------
    last_enforce = [0.0]
    _STALL_PREFIX = "stalled: no progress signal"

    def enforce_liveness():
        """Turn watchdog expiries into actions: kill+restart under the
        process executor (the error path restores the newest checksum-valid
        checkpoint within max_failures), mark STALLED under the thread
        executor (threads can't be preempted; a later beat flips the trial
        back to RUNNING).  The JAX runner also dumps its flight recorder
        here (ROADMAP.md A10)."""
        if watchdog is None:
            return
        # Reconcile recoveries first: a beat may have arrived straight from
        # the trial thread (tune.heartbeat()) since the stall was flagged.
        for tid in list(running):
            trial = lifecycle.by_id[tid]
            if (
                trial.status == TrialStatus.STALLED
                and not watchdog.is_stalled(tid)
            ):
                trial.status = TrialStatus.RUNNING
                trial.stall_recoveries += 1
                log(f"{tid} recovered after stall (progress resumed)")
        for event in watchdog.expired():
            trial = lifecycle.by_id.get(event.key)
            if trial is None or trial.trial_id not in running:
                watchdog.untrack(event.key)
                continue
            trial.stall_count += 1
            if getattr(executor, "supports_kill", False):
                why = (
                    f"{_STALL_PREFIX} in {event.age_s:.1f}s "
                    f"(deadline {event.deadline_s:.1f}s)"
                )
                log(f"{trial.trial_id} {why}; killing incarnation "
                    f"{trial.incarnation}")
                liveness_counters["stall_kills"] += 1
                executor.kill(trial, why)
            else:
                trial.status = TrialStatus.STALLED
                log(
                    f"{trial.trial_id} STALLED: no progress signal in "
                    f"{event.age_s:.1f}s (deadline {event.deadline_s:.1f}s; "
                    f"thread executor cannot preempt — the mark clears if "
                    f"it beats again; use trial_executor='process' for "
                    f"kill/restart)"
                )

    def enforce_time_limits():
        """Hard preemption: a trial past its time limit that has gone quiet
        (no report) is killed outright when the executor can (process
        executor); the thread executor can only flag it for stop at its next
        report.  Runs on EVERY loop iteration (rate-limited), not just idle
        ones — a busy event stream must not starve enforcement."""
        if time_limit_per_trial_s is None:
            return
        now = time.time()
        if now - last_enforce[0] < 1.0:
            return
        last_enforce[0] = now
        grace = max(2.0, 0.25 * time_limit_per_trial_s)
        for tid in list(running):
            trial = lifecycle.by_id[tid]
            overdue = trial.incarnation_runtime_s() - time_limit_per_trial_s
            if overdue <= grace or not executor.is_alive(trial):
                continue
            if getattr(executor, "supports_kill", False):
                log(
                    f"{trial.trial_id} exceeded time limit "
                    f"({trial.incarnation_runtime_s():.0f}s > "
                    f"{time_limit_per_trial_s:.0f}s); killing"
                )
                executor.kill(
                    trial,
                    f"time limit exceeded ({time_limit_per_trial_s:.0f}s)",
                )
            else:
                trial.stop_requested = True

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

            enforce_time_limits()
            enforce_liveness()
            try:
                event = events.get(timeout=0.5)
            except queue.Empty:
                # Scheduler think-time: ask an idle pre-warmed runner to
                # run the next pending trial's first epoch, so the child
                # that adopts it starts warm (no-op without a warm pool;
                # deduped per program key inside the executor).
                if pending and hasattr(executor, "prewarm_program"):
                    cand = pending[0]
                    executor.prewarm_program(
                        trainable, cand.config, program_key(cand.config),
                    )
                if verbose and time.time() - last_status_print > 15:
                    last_status_print = time.time()
                    log(
                        f"{sum(t.status == TrialStatus.TERMINATED for t in trials)}"
                        f"/{num_samples} done, {len(running)} running, "
                        f"{device_mgr.num_free}/{device_mgr.num_devices} devices free"
                    )
                # Reap trials whose thread died without a terminal event
                # (shouldn't happen: the executor posts one on every path),
                # through fail_trial like an ordinary trial error.  An
                # executor thread posts its terminal event as its last
                # act, so one that ended since the wait above timed out
                # has its event queued: reap only with none pending.
                dead = [tid for tid in running
                        if not executor.is_alive(lifecycle.by_id[tid])]
                if events.empty():
                    for tid in dead:
                        trial = lifecycle.by_id[tid]
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
                if watchdog is not None:
                    # A report IS progress: beat before deciding, and a
                    # STALLED-but-reporting trial is a recovery, not a kill.
                    watchdog.beat(trial.trial_id)
                    if trial.status == TrialStatus.STALLED:
                        trial.status = TrialStatus.RUNNING
                        trial.stall_recoveries += 1
                        log(f"{trial.trial_id} recovered after stall "
                            f"(report resumed)")
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
                if retried and tb and tb.startswith(_STALL_PREFIX):
                    liveness_counters["stall_requeues"] += 1
                if not retried and verbose:
                    log(f"{trial.trial_id} errored:\n{tb}")
                store.write_state(trials, extra={
                    "scheduler": scheduler_debug_block(searcher, sched),
                })

    # Teardown always runs (Ctrl-C, store errors, a callback's setup
    # raising): the trial threads are stopped and joined (the process
    # executor terminates and reaps its children), and callbacks see the
    # experiment end.
    clean_end = False
    try:
        for cb in callbacks:
            cb.setup(store.root, metric, mode)
        event_loop()
        # Reaching here means the sweep drained normally — only then is the
        # journal committed below; an exception (Ctrl-C, store failure)
        # leaves it uncommitted so resume="auto" picks the run back up.
        clean_end = True
    finally:
        wall = time.time() - start_time
        try:
            if not executor.join_all():
                log("a trial outlived the teardown deadline")
        except Exception as exc:  # noqa: BLE001
            log(f"executor teardown failed: {exc!r}")
        lifecycle.final_prune()
        utilization = device_mgr.utilization(wall)
        extra = {
            "wall_clock_s": wall,
            "device_utilization": utilization,
            "scheduler": scheduler_debug_block(searcher, sched),
        }
        counters = getattr(executor, "counters", None)
        if counters is not None:
            # The JAX runner's compile block also holds its XLA compile
            # tracker and artifact counters (ROADMAP.md A8).
            extra["compile"] = dict(counters)
        if watchdog is not None:
            # Fail-slow observability next to the fail-fast counters: how
            # many silences were detected, killed, requeued, or recovered.
            extra["liveness"] = {**watchdog.snapshot(), **liveness_counters}
        # Checkpoint I/O accounting for THIS run (the registry is
        # process-wide): save/restore wall and bytes, fallbacks taken, and
        # the async-overlap counters.
        ckpt_counters = get_metrics().delta_since(ckpt_metrics_base)
        if any(ckpt_counters.values()):
            extra["checkpoint"] = ckpt_counters
        # Host-input accounting for THIS run (streaming and the window
        # cache): present only when something streamed or the cache was
        # touched.
        host_input = hostpipe.host_input_block(host_input_base)
        if host_input is not None:
            extra["host_input"] = host_input
        plan = chaos.active_plan()
        if plan is not None:
            # A chaos run's state records what was injected.
            extra["injected_faults"] = plan.snapshot()
        pbt_block = pbt_state_block(sched)
        if pbt_block is not None:
            extra["pbt"] = pbt_block
        # The journal counters the crash-recovery runbook keys off.
        extra["journal"] = {
            "head_incarnation": head_incarnation,
            "decisions": journal.n,
            "journal_replays": (
                (replay.replays if replay is not None else 0)
                + (1 if journal_resume else 0)
            ),
            "duplicate_reports_suppressed":
                lifecycle.duplicate_reports_suppressed,
            "committed": clean_end,
        }
        try:
            store.write_state(trials, extra=extra)
            store.close()
        except Exception as exc:  # noqa: BLE001 - callbacks still tear down
            log(f"experiment store teardown failed: {exc!r}")
        # Commit AFTER the final state write: once the commit record lands,
        # resume="auto" treats the experiment as finished, so everything it
        # would need must already be durable.
        try:
            if clean_end:
                journal.commit()
            journal.close()
        except Exception as exc:  # noqa: BLE001
            log(f"journal teardown failed: {exc!r}")
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
