"""The trial-lifecycle core of ``tune.run``.

Port of ``distributed_machine_learning_tpu/tune/_driver.py``: the state
machine that samples configs from the searcher, stamps and persists
per-epoch results, routes them through the scheduler and the stoppers,
retries failed trials from their newest checkpoint, prunes checkpoints
and enforces the time budget.  (The reference delegated all of this to
Ray Tune's trial runner; SURVEY.md §1 L4.)

A REQUEUE decision (PBT's exploit) stops the trial at its report and
runs it again, from the restore target and under the config the
scheduler chose, when its thread completes.  ``restore_experiment``
resumes an interrupted experiment from its directory
(``tune.run(resume=True)``).

Not ported yet: the write-ahead journal and ``restore_from_journal``
(``resume="auto"``; ROADMAP.md A3c) and the per-trial time limit (A3b).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from distributed_machine_learning_tpu_torch.tune.schedulers.base import (
    CONTINUE,
    REQUEUE,
    STOP,
)
from distributed_machine_learning_tpu_torch.tune.stoppers import stop_hit
from distributed_machine_learning_tpu_torch.tune.trial import (
    Trial,
    TrialStatus,
)


def _summarize(value):
    """Collections collapse to their sizes — forensic shape, not payload
    (a BayesOpt X matrix in experiment_state.json would dwarf the trials)."""
    if isinstance(value, dict):
        return {str(k): _summarize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return len(value)
    return value


def scheduler_debug_block(searcher, scheduler) -> Dict[str, Any]:
    """The ``experiment_state.json["scheduler"]`` forensics block persisted
    at report boundaries (throttled) and at completion boundaries: who is
    deciding, and the summarized shape of their state."""
    block: Dict[str, Any] = {
        "scheduler_type": type(scheduler).__name__,
        "searcher_type": type(searcher).__name__,
    }
    debug = getattr(scheduler, "debug_state", None)
    if callable(debug):
        try:
            block["scheduler_state"] = debug()
        except Exception:  # noqa: BLE001 - forensics never kill a run
            pass
    try:
        block["searcher_state"] = _summarize(searcher.save_state())
    except Exception:  # noqa: BLE001
        pass
    return block


class TrialLifecycle:
    """Single-threaded trial state machine.

    The executor layer calls in with events; this class mutates
    trial/searcher/scheduler/store state and answers with decisions. It
    never blocks and never touches devices.
    """

    def __init__(
        self,
        *,
        searcher,
        scheduler,
        store,
        metric: str,
        mode: str,
        num_samples: int,
        max_failures: int = 0,
        stop_rules=None,
        time_budget_s: Optional[float] = None,
        keep_checkpoints_num: int = 0,
        log: Callable[[str], None] = lambda msg: None,
    ):
        self.searcher = searcher
        self.scheduler = scheduler
        self.store = store
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_failures = max_failures
        self.stop_rules = stop_rules or {}
        self.time_budget_s = time_budget_s
        self.keep_checkpoints_num = keep_checkpoints_num
        self.log = log

        self.trials: List[Trial] = []
        self.by_id: Dict[str, Trial] = {}
        self.pending: List[Trial] = []
        self.next_index = 0
        self.searcher_exhausted = False
        self.start_time = time.time()

    # -- creation ----------------------------------------------------------

    def budget_exceeded(self) -> bool:
        return (
            self.time_budget_s is not None
            and time.time() - self.start_time > self.time_budget_s
        )

    def exhausted(self) -> bool:
        """No further trials will ever be created."""
        return (
            self.searcher_exhausted
            or self.next_index >= self.num_samples
            or self.budget_exceeded()
        )

    def create_trial(self, **trial_kwargs) -> Optional[Trial]:
        """Sample the next config; returns the new PENDING trial or None."""
        if self.exhausted():
            return None
        config = self.searcher.suggest(self.next_index)
        if config is None:
            self.searcher_exhausted = True
            return None
        trial = Trial(
            trial_id=f"trial_{self.next_index:05d}", config=config, **trial_kwargs
        )
        self.next_index += 1
        self.trials.append(trial)
        self.by_id[trial.trial_id] = trial
        self.pending.append(trial)
        self.scheduler.on_trial_add(trial)
        self.store.write_params(trial)
        return trial

    def restore_experiment(self, resources=None) -> Dict[str, int]:
        """Resume an interrupted experiment from its directory (Ray's
        ``tune.run(resume=True)``).

        Every persisted trial is rebuilt from ``params.json`` and
        ``result.jsonl`` and its records replayed through the scheduler,
        the searcher and stateful stop rules (nothing is persisted
        again).  A trial the state file has as TERMINATED or ERROR stays
        finished; any other, or one the state file lacks, was interrupted
        and is requeued from its newest checkpoint, its records past that
        checkpoint dropped (memory and file).  Sampling continues
        afterwards until ``num_samples``.  Returns the counts of finished
        and requeued trials."""
        from distributed_machine_learning_tpu_torch.tune import (
            checkpoint as ckpt_lib,
        )
        from distributed_machine_learning_tpu_torch.tune.experiment import (
            iter_trial_records,
        )

        counts = {"finished": 0, "requeued": 0}
        for entry, config, records, meta in iter_trial_records(
                self.store.root):
            kwargs = {"resources": resources} if resources is not None else {}
            trial = Trial(trial_id=entry, config=config, **kwargs)
            self.trials.append(trial)
            self.by_id[entry] = trial
            try:
                self.next_index = max(self.next_index,
                                      int(entry.rsplit("_", 1)[-1]) + 1)
            except ValueError:
                self.next_index = max(self.next_index, len(self.trials))
            self.scheduler.on_trial_add(trial)

            # State snapshots are written at every completion, so a trial
            # the file lacks was in flight when the process died.
            status = meta.get("status", "PENDING") if meta else "PENDING"
            finished = status in ("TERMINATED", "ERROR")
            ck_path, ck_it = ckpt_lib.find_latest_checkpoint(
                self.store.checkpoint_dir(trial))
            if not finished:
                # The rerun reports everything after its checkpoint again;
                # the file is written anew (a killed process may have cut
                # its last line).
                records = [r for r in records
                           if int(r.get("training_iteration", 0)) <= ck_it]
                with open(os.path.join(self.store.trial_dir(trial),
                                       "result.jsonl"), "w") as f:
                    for r in records:
                        f.write(json.dumps(r) + "\n")

            # Replay rebuilds observer state and decides nothing: the
            # config snapshot undoes what a REQUEUE decision (PBT's
            # exploit) would change.
            config_snapshot = dict(trial.config)
            for rec in records:
                trial.results.append(rec)
                trial.reports_since_restart += 1
                self.scheduler.on_trial_result(trial, rec)
                self.searcher.on_trial_result(
                    entry, config_snapshot, rec, self.metric, self.mode)
                if callable(self.stop_rules):
                    stop_hit(self.stop_rules, trial.trial_id, rec)
            trial.config = config_snapshot
            trial._requeue_on_complete = False
            trial.restore_path = None
            trial.restore_base = 0
            trial.reports_since_restart = len(trial.results)
            if ck_path:
                trial.latest_checkpoint = ck_path
                trial.latest_checkpoint_iteration = ck_it

            if finished:
                trial.error = (meta or {}).get("error")
                self.finish(trial, TrialStatus(status))
                if status == "ERROR":
                    self.scheduler.on_trial_error(trial)
                counts["finished"] += 1
            else:
                # training_iteration = restore_base once requeued.
                if ck_path:
                    trial.restore_path = ck_path
                    trial.restore_base = ck_it
                self.requeue(trial)
                counts["requeued"] += 1
        # Searchers with suggest-side state (GridSearch's cursor) step past
        # what the prior run proposed.
        self.searcher.fast_forward(self.next_index)
        return counts

    # -- results -----------------------------------------------------------

    def process_result(self, trial: Trial, metrics: Dict[str, Any]) -> str:
        """Stamp + persist a result, run scheduler/searcher/stoppers;
        returns "stop" or "continue"."""
        metrics = dict(metrics)
        trial.reports_since_restart += 1
        metrics.setdefault("training_iteration", trial.training_iteration)
        metrics["trial_id"] = trial.trial_id
        metrics["timestamp"] = time.time()
        metrics["time_total_s"] = trial.runtime_s()
        trial.results.append(metrics)
        self.store.append_result(trial, metrics)
        self._prune_checkpoints(trial)

        # Snapshot before the scheduler runs: PBT mutates trial.config in
        # place on REQUEUE, and the searcher must see the config that
        # actually produced these metrics.
        reported_config = dict(trial.config)
        decision = self.scheduler.on_trial_result(trial, metrics)
        self.searcher.on_trial_result(
            trial.trial_id, reported_config, metrics, self.metric, self.mode
        )
        if self.stop_rules:
            # Dict of key->threshold, or a callable/Stopper
            # (tune/stoppers.py) judging this trial's own trajectory.
            if stop_hit(self.stop_rules, trial.trial_id, metrics):
                decision = STOP if decision == CONTINUE else decision
        if trial.stop_requested or self.budget_exceeded():
            decision = STOP
        if decision == REQUEUE:
            # PBT exploit: the scheduler rewrote config and restore target
            # in place; the trial stops here and is requeued on completion.
            # (The journal records this requeue once it is ported, A3c.)
            trial._requeue_on_complete = True
            decision = STOP
        return "stop" if decision == STOP else "continue"

    def final_prune(self) -> None:
        """End-of-run retention pass over every trial."""
        for trial in self.trials:
            self._prune_checkpoints(trial)

    def _prune_checkpoints(self, trial: Trial):
        """Retention: keep the last k checkpoints of ``trial``, never deleting
        one that any trial's pending restore (PBT exploit / retry) points
        at."""
        if self.keep_checkpoints_num <= 0 or not trial.latest_checkpoint:
            return
        from distributed_machine_learning_tpu_torch.tune import (
            checkpoint as ckpt_lib,
        )

        protected = {t.restore_path for t in self.trials if t.restore_path}
        protected.add(trial.latest_checkpoint)
        directory = self.store.checkpoint_dir(trial)
        try:
            ckpt_lib.prune_checkpoints(
                directory, self.keep_checkpoints_num, protect=protected,
            )
        except Exception as e:  # retention must never kill a run
            self.log(f"checkpoint pruning failed for {trial.trial_id}: {e}")

    # -- terminal events ---------------------------------------------------

    def complete_trial(self, trial: Trial) -> bool:
        """Trial finished cleanly. Returns True if it was requeued (PBT)."""
        if getattr(trial, "_requeue_on_complete", False):
            trial._requeue_on_complete = False
            self.requeue(trial)
            return True
        self.finish(trial, TrialStatus.TERMINATED)
        return False

    def fail_trial(self, trial: Trial, why: str) -> bool:
        """Trial errored. Returns True if it will be retried."""
        trial.num_failures += 1
        # A PBT requeue may be pending when the failure lands; the trial is
        # requeued now, so consume the flag (else its eventual completion
        # would run it once more).
        pbt_requeue = getattr(trial, "_requeue_on_complete", False)
        trial._requeue_on_complete = False
        if trial.num_failures <= self.max_failures:
            if pbt_requeue and trial.restore_path:
                # Keep the scheduler-chosen restore target (a DONOR's
                # checkpoint); the scheduler already set restore_base.
                pass
            elif (
                trial.latest_checkpoint
                and trial.latest_checkpoint_iteration >= trial.restore_base
            ):
                # Most-advanced restore point available: the trial's own
                # newest checkpoint, unless the incarnation was seeded by a
                # donor it has not checkpointed past yet (own checkpoint
                # older than restore_base), which would undo the exploit.
                trial.restore_path = trial.latest_checkpoint
                trial.restore_base = trial.latest_checkpoint_iteration
            elif not trial.restore_path:
                trial.restore_base = 0
            # else: keep the seed restore target (donor / previous retry).
            self.log(
                f"{trial.trial_id} failed "
                f"({trial.num_failures}/{self.max_failures}): {why.splitlines()[-1] if why else why}; retrying"
                + (" from checkpoint" if trial.restore_path else "")
            )
            self.requeue(trial)
            return True
        trial.error = why
        self.finish(trial, TrialStatus.ERROR)
        self.scheduler.on_trial_error(trial)
        return False

    def finish(self, trial: Trial, status: TrialStatus):
        trial.status = status
        trial.finished_at = time.time()
        if status == TrialStatus.TERMINATED:
            self.searcher.on_trial_complete(
                trial.trial_id, trial.config, trial.last_result, self.metric, self.mode
            )
        else:
            # Errored trials complete with result=None: model-based
            # searchers skip the observation (their None-score guard) but
            # clear their pending entry.
            self.searcher.on_trial_complete(
                trial.trial_id, trial.config, None, self.metric, self.mode
            )
        self.scheduler.on_trial_complete(trial)

    def requeue(self, trial: Trial):
        trial.status = TrialStatus.PENDING
        trial.reports_since_restart = 0
        self.pending.append(trial)

    def mark_running(self, trial: Trial):
        trial.status = TrialStatus.RUNNING
        now = time.time()
        trial.started_at = trial.started_at or now
        trial.restarted_at = now
        trial.incarnation += 1
        trial.stop_requested = False
