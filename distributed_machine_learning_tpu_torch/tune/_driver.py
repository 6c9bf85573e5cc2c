"""The trial-lifecycle core of ``tune.run``.

Port of ``distributed_machine_learning_tpu/tune/_driver.py``: the state
machine that samples configs from the searcher, stamps and persists
per-epoch results, routes them through the scheduler and the stoppers,
retries failed trials from their newest checkpoint, prunes checkpoints
and enforces the time budget and the per-trial time limit's soft half (a
stop at the first report boundary past it; the runner kills a trial that
stops reporting, under the process executor).  (The reference delegated
all of this to Ray Tune's trial runner; SURVEY.md §1 L4.)

A REQUEUE decision (PBT's exploit) stops the trial at its report and
runs it again, from the restore target and under the config the
scheduler chose, when its thread completes.  ``restore_experiment``
resumes an interrupted experiment from its directory
(``tune.run(resume=True)``).

With a journal (``tune/journal.py``), every decision — create, dispatch,
report (with the PBT requeue payload), complete, error — is journaled
with a searcher/scheduler snapshot before its effect, and
``restore_from_journal`` (``tune.run(resume="auto")``) restores that
state exactly after the head died, with each epoch accounted once.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from distributed_machine_learning_tpu_torch.tune.experiment import _jsonable
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


def _index_of(trial_id: str) -> Optional[int]:
    """The number in ``trial_NNNNN`` (None for any other id)."""
    try:
        return int(trial_id.rsplit("_", 1)[-1])
    except ValueError:
        return None


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
        time_limit_per_trial_s: Optional[float] = None,
        log: Callable[[str], None] = lambda msg: None,
        config_overlay: Optional[Dict[str, Any]] = None,
        journal=None,
    ):
        self.searcher = searcher
        self.scheduler = scheduler
        self.store = store
        # Write-ahead log (tune/journal.ExperimentJournal, or None): every
        # scheduling decision is journaled with a post-decision
        # searcher/scheduler snapshot BEFORE its externally visible effect,
        # so a killed head resumes to bit-identical decision state.
        self.journal = journal
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_failures = max_failures
        self.stop_rules = stop_rules or {}
        self.time_budget_s = time_budget_s
        self.keep_checkpoints_num = keep_checkpoints_num
        self.time_limit_per_trial_s = time_limit_per_trial_s
        self.log = log
        # Sweep-wide config defaults under every sampled config
        # (tune.run(input_mode=...) stamping the sweep-wide mode); a key
        # the search space samples wins over the overlay.
        self.config_overlay = dict(config_overlay or {})

        self.trials: List[Trial] = []
        self.by_id: Dict[str, Trial] = {}
        self.pending: List[Trial] = []
        self.next_index = 0
        self.searcher_exhausted = False
        self.start_time = time.time()
        # Exactly-once epoch accounting after a journal-based resume:
        # trial_id -> journaled report watermark.  A requeued trial
        # restored from a checkpoint BELOW its watermark re-reports the
        # gap; those re-reports are suppressed (counted, never re-persisted
        # or re-observed) until the watermark is reached.
        self._suppress: Dict[str, int] = {}
        self.duplicate_reports_suppressed = 0

    # -- journal -----------------------------------------------------------

    def _snapshot(self) -> Dict[str, Any]:
        """The decision-state snapshot a journal record carries: restore it
        and the searcher/scheduler make bit-identical decisions from here."""
        return {
            "searcher": self.searcher.save_state(),
            "scheduler": self.scheduler.save_state(),
            "next_index": self.next_index,
        }

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
        if self.config_overlay:
            config = {**self.config_overlay, **config}
        trial = Trial(
            trial_id=f"trial_{self.next_index:05d}", config=config, **trial_kwargs
        )
        self.next_index += 1
        self.trials.append(trial)
        self.by_id[trial.trial_id] = trial
        self.pending.append(trial)
        self.scheduler.on_trial_add(trial)
        if self.journal is not None:
            # WAL: the create decision (searcher suggestion consumed, trial
            # registered with the scheduler) is durable before its first
            # external effect (params.json) — a crash here resumes with the
            # trial recreated from the journaled config.
            self.journal.record_create(
                trial.trial_id, _jsonable(config), self._snapshot()
            )
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
            # No writer is live yet: bytes a killed save left without
            # their index are removed, so the newest index names a step.
            ckpt_lib.cleanup_uncommitted(self.store.checkpoint_dir(trial),
                                         log=self.log)
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

    def restore_from_journal(self, replay, resources=None) -> Dict[str, int]:
        """Resume from the write-ahead log (``resume="auto"``): restore the
        journaled searcher/scheduler snapshot instead of replaying metric
        streams through their hooks, so the restored decision state is
        BIT-IDENTICAL to the moment of the last journaled decision — not a
        reconstruction of it.

        ``replay`` is a :class:`tune.journal.ReplayState`.  Ordering is
        load-bearing: (1) every live trial is rebuilt and registered via
        ``on_trial_add`` (PBT's live-ref table, ASHA's rung defaults);
        (2) THEN ``restore_state`` overwrites the defaults with the
        journaled snapshot; (3) trials are disposed — journaled-terminal
        trials get their status set directly (completion hooks already ran
        and are inside the snapshot), a trial whose watermark decision was
        "stop" is finished NOW (the decision was journaled but the crash
        ate its effect), everything else requeues from its newest valid
        checkpoint at-or-below the journaled report watermark, with
        re-reports below the watermark suppressed (exactly-once epoch
        accounting — see :meth:`process_result`).
        """
        from distributed_machine_learning_tpu_torch.tune import (
            checkpoint as ckpt_lib,
        )
        from distributed_machine_learning_tpu_torch.tune.experiment import (
            iter_trial_records,
        )

        counts = {"finished": 0, "requeued": 0, "suppress_windows": 0}
        kwargs = {"resources": resources} if resources is not None else {}
        on_disk: Dict[str, Any] = {}
        for entry, config, records, _meta in iter_trial_records(
                self.store.root):
            on_disk[entry] = (config, records)
        # Union: a journaled create whose params.json never landed (crash
        # inside the create->write_params window) is recreated from the
        # journaled config.
        trial_ids = sorted(set(on_disk) | set(replay.trials))
        # Every trial of the journaled run has an index below the newest
        # snapshot's next_index; an id at or past it was left by an
        # earlier run under the same name and is not this run's.
        snap = replay.snapshot
        horizon = int(snap.get("next_index", 0)) if snap else None
        pending_disposal = []
        for entry in trial_ids:
            index = _index_of(entry)
            if horizon is not None and index is not None and index >= horizon:
                continue
            jt = replay.trials.get(entry)
            if jt is not None and jt["config"] is None and entry not in on_disk:
                continue  # journal mentions it but holds no config (torn)
            config, records = on_disk.get(entry) or (None, [])
            if jt is not None and jt["config"] is not None:
                # The journaled create is the config (params.json may
                # still be an earlier run's if the head died before it).
                config = dict(jt["config"])
            trial = Trial(trial_id=entry, config=config, **kwargs)
            self.trials.append(trial)
            self.by_id[entry] = trial
            try:
                self.next_index = max(self.next_index,
                                      int(entry.rsplit("_", 1)[-1]) + 1)
            except ValueError:
                self.next_index = max(self.next_index, len(self.trials))
            self.scheduler.on_trial_add(trial)
            if entry not in on_disk or on_disk[entry][0] != config:
                # Re-run the eaten effect of the create (which sets aside
                # what an earlier run left under the id).
                self.store.write_params(trial)
                records = []

            watermark = int(jt["reported_through"]) if jt else 0
            terminal = jt["terminal"] if jt else None
            # Disk results past the journaled watermark are evidence of
            # work whose report never became a decision (crash between
            # append_result and the journal append): truncate, so the
            # re-reported epoch lands exactly once on disk too.
            if terminal is None:
                kept = [r for r in records
                        if int(r.get("training_iteration", 0)) <= watermark]
                if len(kept) < len(records):
                    with open(os.path.join(self.store.trial_dir(trial),
                                           "result.jsonl"), "w") as f:
                        for r in kept:
                            f.write(json.dumps(r) + "\n")
                records = kept
            for rec in records:
                trial.results.append(rec)
                if callable(self.stop_rules):
                    # Warm STATEFUL stoppers only; scheduler/searcher state
                    # comes from the snapshot, not from replaying hooks.
                    stop_hit(self.stop_rules, trial.trial_id, rec)
            trial.reports_since_restart = len(trial.results)
            pending_disposal.append((trial, jt, watermark))

        # The journaled snapshot is authoritative: it overwrites the
        # defaults on_trial_add just installed (ASHA rung cursors, PBT
        # history) and the searcher's model/cursor state.  next_index from
        # the snapshot covers creates whose params.json landed but whose
        # ids don't parse.
        if snap:
            self.searcher.restore_state(snap.get("searcher") or {})
            self.scheduler.restore_state(snap.get("scheduler") or {})
            self.next_index = max(self.next_index,
                                  int(snap.get("next_index", 0)))
        else:
            self.searcher.fast_forward(self.next_index)

        for trial, jt, watermark in pending_disposal:
            terminal = jt["terminal"] if jt else None
            if terminal is not None:
                # Completion hooks ran before the complete record was
                # journaled and their mutations are inside the snapshot:
                # set the status directly, never re-run finish().
                trial.status = TrialStatus(terminal.get("status",
                                                        "TERMINATED"))
                trial.error = terminal.get("error")
                trial.finished_at = time.time()
                counts["finished"] += 1
                continue
            decision = jt["decision_at_watermark"] if jt else None
            if decision == "stop":
                # The stop decision is durable; the crash ate its effect.
                # finish() now runs the completion hooks exactly once (the
                # control run would have run them at this point too) and
                # journals the complete record.
                self.finish(trial, TrialStatus.TERMINATED)
                counts["finished"] += 1
                continue
            ck_dir = self.store.checkpoint_dir(trial)
            # No writer is live: bytes without an index are a torn save,
            # and checkpoints past the watermark hold epochs whose reports
            # never became decisions — quarantined, so no later fallback
            # can resurrect them.
            ckpt_lib.cleanup_uncommitted(ck_dir, log=self.log)
            ckpt_lib.quarantine_unreported(ck_dir, watermark, tag="head",
                                           log=self.log)
            last_requeue = jt["last_requeue"] if jt else None
            trial._requeue_on_complete = False
            if last_requeue is not None:
                # A journaled PBT exploit owns this trial's current config
                # and restore target (its in-memory config died with the
                # head; params.json still holds the original).  Re-apply
                # the exploit verbatim — re-reports up to the watermark are
                # suppressed, so re-running the donor window is wasted
                # compute, never duplicate accounting.
                trial.config = dict(last_requeue.get("config") or trial.config)
                trial.restore_path = last_requeue.get("restore_path")
                trial.restore_base = int(last_requeue.get("restore_base") or 0)
            else:
                ck_path, ck_it = ckpt_lib.newest_valid_checkpoint(
                    ck_dir, max_iteration=watermark)
                if ck_path:
                    trial.restore_path = ck_path
                    trial.restore_base = ck_it
                    trial.latest_checkpoint = ck_path
                    trial.latest_checkpoint_iteration = ck_it
                else:
                    trial.restore_path = None
                    trial.restore_base = 0
            if trial.restore_base < watermark:
                self._suppress[trial.trial_id] = watermark
                counts["suppress_windows"] += 1
            self.requeue(trial)
            counts["requeued"] += 1

        if self.journal is not None:
            self.journal.record_replay(**counts)
        return counts

    # -- results -----------------------------------------------------------

    def process_result(self, trial: Trial, metrics: Dict[str, Any]) -> str:
        """Stamp + persist a result, run scheduler/searcher/stoppers;
        returns "stop" or "continue" (REQUEUE is folded into stop + a flag
        consumed by :meth:`complete_trial`)."""
        metrics = dict(metrics)
        watermark = self._suppress.get(trial.trial_id)
        if watermark is not None:
            # Journal-resume duplicate window: this incarnation restored
            # from a checkpoint below the journaled report watermark, so it
            # re-reports epochs the control plane already observed.  The
            # iteration clock still advances (training_iteration must line
            # up when fresh reports start), but nothing is re-persisted,
            # re-observed, or re-decided — every such epoch was journaled
            # "continue" (a stop/requeue watermark is resolved at restore).
            trial.reports_since_restart += 1
            it = trial.training_iteration
            if it <= watermark:
                self.duplicate_reports_suppressed += 1
                if it == watermark:
                    del self._suppress[trial.trial_id]
                return "continue"
            # Already past the watermark (sparse reporting): fall through
            # to the normal path, undoing the early increment.
            del self._suppress[trial.trial_id]
            trial.reports_since_restart -= 1
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
        if (
            self.time_limit_per_trial_s is not None
            and trial.incarnation_runtime_s() > self.time_limit_per_trial_s
            and decision == CONTINUE
        ):
            # Soft per-trial time limit: stop at the report boundary.  Trials
            # that never reach a report boundary are reaped by the runner's
            # hard-kill path (process executor).  Measured per incarnation so
            # a retried trial gets a fresh clock.
            self.log(
                f"{trial.trial_id} hit time limit "
                f"({trial.incarnation_runtime_s():.0f}s); stopping"
            )
            decision = STOP
        requeued = decision == REQUEUE
        if requeued:
            # PBT exploit: the scheduler rewrote config and restore target
            # in place; the trial stops here and is requeued on completion.
            trial._requeue_on_complete = True
            decision = STOP
        if self.journal is not None:
            # WAL: scheduler/searcher/stopper mutations are all in; journal
            # the decision (with the post-mutation snapshot) before it is
            # returned to the executor.  A crash after the append replays
            # to this exact state and re-applies the decision at resume.
            requeue_payload = None
            if requeued:
                # Journaled so resume re-applies the exploit even if the
                # complete event (which performs the requeue) never got
                # processed.
                requeue_payload = {
                    "config": _jsonable(trial.config),
                    "restore_path": trial.restore_path,
                    "restore_base": trial.restore_base,
                }
            value = metrics.get(self.metric)
            self.journal.record_report(
                trial.trial_id,
                int(metrics.get("training_iteration",
                                trial.training_iteration)),
                "requeue" if requeued
                else ("stop" if decision == STOP else "continue"),
                float(value) if isinstance(value, (int, float)) else None,
                self._snapshot(),
                requeue=requeue_payload,
            )
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
            if self.journal is not None:
                self.journal.record_error(trial.trial_id, True,
                                          self._snapshot())
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
        if self.journal is not None:
            # Journaled AFTER the completion hooks mutate searcher/scheduler
            # state, so the snapshot is the post-completion decision state
            # (a resume that finds this record sets status directly — the
            # hooks must not run twice).
            self.journal.record_complete(
                trial.trial_id, status.value, self._snapshot(),
                error=trial.error,
            )

    def requeue(self, trial: Trial):
        trial.status = TrialStatus.PENDING
        trial.reports_since_restart = 0
        self.pending.append(trial)

    def mark_running(self, trial: Trial):
        if self.journal is not None:
            # WAL: dispatch journaled before the trial's thread or process
            # exists, so resume knows this trial was in flight (no state
            # snapshot — dispatch decides nothing).
            self.journal.record_dispatch(trial.trial_id)
        trial.status = TrialStatus.RUNNING
        now = time.time()
        trial.started_at = trial.started_at or now
        trial.restarted_at = now
        trial.incarnation += 1
        trial.stop_requested = False
