"""``tune.run(resume=True)`` in the port, against the JAX package's.

The seven cases of tests/test_resume.py on the port: an interrupted
experiment (``experiment_state.json`` rewritten as a dead driver leaves
it, the trial RUNNING and its last records unwritten) resumes with
finished trials kept, interrupted ones rerun from their newest checkpoint
with each epoch reported once, and sampling going on to ``num_samples``.
Then the JAX ``tune.run(resume=True)`` and the port's after the same edit
of the same experiment: the same finished and requeued counts, records
and ``best_config``.  And ``resume="auto"`` (the journal) is refused.

Every JAX ``tune.run`` passes ``compile_cache_dir=None`` and a
``storage_path`` under ``tmp_path``, with ``DML_TPU_COMPILE_CACHE`` in
``tmp_path`` (``restore_global_state``): nothing is written under HOME.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from _torch_tune_common import restore_global_state  # noqa: F401

torch = pytest.importorskip("torch")

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.tune import _driver as jax_driver  # noqa: E402
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import _driver as port_driver  # noqa: E402
from distributed_machine_learning_tpu_torch.tune.storage import (  # noqa: E402
    MemoryStorage,
)
from distributed_machine_learning_tpu_torch.tune.trial import TrialStatus  # noqa: E402

CPU = torch.device("cpu")


def _trainable(mod):
    """Reports and checkpoints every epoch; resumes from a restored one."""
    def checkpointing_trainable(config):
        restored = mod.get_checkpoint()
        start = int(restored["epoch"]) if restored else 0
        for epoch in range(start + 1, int(config.get("num_epochs", 4)) + 1):
            mod.report({"validation_loss": float(config["x"]) / epoch,
                        "epoch": epoch}, checkpoint={"epoch": epoch})
    return checkpointing_trainable


def _run(tmp_path, name, num_samples, resume=False, mod=tune, scheduler=None,
         seed=7, **kwargs):
    if mod is jax_tune:
        kwargs.update(compile_cache_dir=None)
        storage = tmp_path / "jax"
    else:
        kwargs.setdefault("devices", [CPU])
        storage = tmp_path / "port"
    return mod.run(
        _trainable(mod), {"x": mod.uniform(1.0, 2.0), "num_epochs": 4},
        metric="validation_loss", mode="min", num_samples=num_samples,
        scheduler=scheduler, storage_path=str(storage), name=name, seed=seed,
        max_concurrent=1, verbose=0, resume=resume, **kwargs)


def _truncate_results(root, trial_id, keep_records):
    path = os.path.join(root, trial_id, "result.jsonl")
    with open(path) as f:
        lines = [line for line in f if line.strip()]
    with open(path, "w") as f:
        f.writelines(lines[:keep_records])


def _mark_interrupted(root, trial_id, keep_records):
    """The state file and result stream as a crashed driver leaves them:
    the trial mid-flight (RUNNING), its last records unwritten."""
    state_path = os.path.join(root, "experiment_state.json")
    with open(state_path) as f:
        state = json.load(f)
    for t in state["trials"]:
        if t["trial_id"] == trial_id:
            t["status"] = "RUNNING"
    with open(state_path, "w") as f:
        json.dump(state, f)
    _truncate_results(root, trial_id, keep_records)


def _drop_checkpoints_after(root, trial_id, keep):
    """Delete every checkpoint of the trial but its ``keep`` oldest (each
    step's files: the port's index and tensors, or the JAX blob)."""
    ckdir = os.path.join(root, trial_id, "checkpoints")
    steps = sorted({int(m.group(1)) for m in map(
        re.compile(r"^ckpt_(\d+)\.").match, os.listdir(ckdir)) if m})
    for name in os.listdir(ckdir):
        m = re.match(r"^ckpt_(\d+)\.", name)
        if m and int(m.group(1)) in steps[keep:]:
            os.unlink(os.path.join(ckdir, name))


def _epochs(trial):
    return [r["epoch"] for r in trial.results]


def _on_disk(root, trial_id):
    with open(os.path.join(root, trial_id, "result.jsonl")) as f:
        return [json.loads(line)["epoch"] for line in f if line.strip()]


# -- tests/test_resume.py on the port ------------------------------------------

def test_resume_requires_name(tmp_path):
    with pytest.raises(ValueError, match="name"):
        _run(tmp_path, None, 1, resume=True)


def test_resume_missing_directory_raises(tmp_path):
    """A typo'd name must not silently start a fresh experiment."""
    with pytest.raises(FileNotFoundError, match="no experiment directory"):
        _run(tmp_path, "never_ran", 1, resume=True)
    assert not (tmp_path / "port" / "never_ran").exists()


def test_resume_without_state_file_requeues_everything(tmp_path):
    """The driver died before any trial completed: no state file.  Every
    trial is interrupted and runs its whole budget."""
    root = _run(tmp_path, "nostate", 2).root
    os.unlink(os.path.join(root, "experiment_state.json"))
    for tid in ("trial_00000", "trial_00001"):
        _truncate_results(root, tid, keep_records=2)
        _drop_checkpoints_after(root, tid, keep=2)
    resumed = _run(tmp_path, "nostate", 2, resume=True)
    for t in resumed.trials:
        assert t.status == TrialStatus.TERMINATED
        assert t.training_iteration == 4
        assert _epochs(t) == [1, 2, 3, 4]


def test_resume_deduplicates_rerun_epochs(tmp_path):
    """Records past the restore checkpoint go (memory and disk), so each
    epoch appears once after the rerun reports it again."""
    root = _run(tmp_path, "dedup", 1).root
    _mark_interrupted(root, "trial_00000", keep_records=3)
    _drop_checkpoints_after(root, "trial_00000", keep=2)
    resumed = _run(tmp_path, "dedup", 1, resume=True)
    trial = resumed.trials[0]
    assert _epochs(trial) == [1, 2, 3, 4]
    assert _on_disk(root, "trial_00000") == [1, 2, 3, 4]
    # The rerun restored epoch 2's checkpoint and reported 3 first.
    assert trial.restore_base == 2 and trial.results[2]["epoch"] == 3


def test_resume_reruns_interrupted_and_continues_sampling(tmp_path):
    first = _run(tmp_path, "resumable", 2)
    assert all(t.status == TrialStatus.TERMINATED for t in first.trials)
    _mark_interrupted(first.root, "trial_00001", keep_records=2)
    resumed = _run(tmp_path, "resumable", 3, resume=True)
    by_id = {t.trial_id: t for t in resumed.trials}
    assert set(by_id) == {"trial_00000", "trial_00001", "trial_00002"}
    assert all(t.status == TrialStatus.TERMINATED for t in resumed.trials)
    # The finished trial did not run again.
    assert len(by_id["trial_00000"].results) == 4
    # The interrupted one's epoch-4 checkpoint survived: nothing to rerun.
    assert by_id["trial_00001"].training_iteration == 4
    assert _epochs(by_id["trial_00001"]) == [1, 2]
    # Sampling went on from index 2, not from 0.
    assert len(by_id["trial_00002"].results) == 4
    fresh = _run(tmp_path, "fresh", 3)
    assert by_id["trial_00002"].config == fresh.trials[2].config


def test_resume_drops_a_record_cut_by_the_kill(tmp_path):
    """A driver killed inside a write leaves half a line at the end of a
    result stream: it is dropped, and the rerun reports that epoch."""
    root = _run(tmp_path, "torn", 1).root
    _mark_interrupted(root, "trial_00000", keep_records=2)
    _drop_checkpoints_after(root, "trial_00000", keep=2)
    with open(os.path.join(root, "trial_00000", "result.jsonl"), "a") as f:
        f.write('{"validation_loss": 0.5, "epo')
    resumed = _run(tmp_path, "torn", 1, resume=True)
    assert _epochs(resumed.trials[0]) == [1, 2, 3, 4]
    assert _on_disk(root, "trial_00000") == [1, 2, 3, 4]


def test_resume_restores_from_truncated_checkpoint(tmp_path):
    """An interrupted trial whose later checkpoints are gone restores from
    the newest that remains and reruns the tail."""
    root = _run(tmp_path, "resumable2", 1).root
    _mark_interrupted(root, "trial_00000", keep_records=1)
    _drop_checkpoints_after(root, "trial_00000", keep=2)
    resumed = _run(tmp_path, "resumable2", 1, resume=True)
    trial = resumed.trials[0]
    assert trial.status == TrialStatus.TERMINATED
    # The replayed record (epoch 1), then epochs 3 and 4 from epoch 2.
    assert _epochs(trial) == [1, 3, 4]
    assert _on_disk(root, "trial_00000") == [1, 3, 4]


def _asha(mod):
    return mod.ASHAScheduler(max_t=4, grace_period=1, reduction_factor=2)


def test_resume_with_asha_replays_rungs(tmp_path):
    first = _run(tmp_path, "resumable3", 4, scheduler=_asha(tune), seed=3)
    _mark_interrupted(first.root, "trial_00003", keep_records=1)
    resumed = _run(tmp_path, "resumable3", 6, resume=True,
                   scheduler=_asha(tune), seed=3)
    assert len(resumed.trials) == 6
    assert all(t.status == TrialStatus.TERMINATED for t in resumed.trials)
    assert np.isfinite(resumed.best_result["validation_loss"])
    # The finished trials kept their stops; the rerun trial's first
    # record is the one replayed.
    for a, b in zip(resumed.trials[:3], first.trials[:3]):
        assert _epochs(a) == _epochs(b)
    assert resumed.trials[3].results[0] == first.trials[3].results[0]


def test_resume_with_checkpoints_in_memory_storage(tmp_path):
    """Checkpoints under another root (``mem://``) restore the same way."""
    kw = dict(checkpoint_storage=f"mem://{tmp_path.name}")
    root = _run(tmp_path, "mem", 1, **kw).root
    _mark_interrupted(root, "trial_00000", keep_records=1)
    ckdir = f"mem://{tmp_path.name}/mem/trial_00000/checkpoints"
    for step in (3, 4):
        for suffix in (".json", ".tensors"):
            MemoryStorage().delete(f"{ckdir}/ckpt_{step:06d}{suffix}")
    resumed = _run(tmp_path, "mem", 1, resume=True, **kw)
    assert _epochs(resumed.trials[0]) == [1, 3, 4]
    MemoryStorage.clear()


def test_resume_fast_forwards_a_grid_search(tmp_path):
    """A grid search walks a cursor: resumed, it goes on past the points
    the first run proposed, as one uninterrupted run of the grid would."""
    def grid(name, n, resume=False):
        return tune.run(
            _trainable(tune), {"x": tune.choice([1.0, 1.25, 1.5, 1.75]),
                               "num_epochs": 4},
            metric="validation_loss", num_samples=n, search_alg=tune.GridSearch(),
            storage_path=str(tmp_path), name=name, seed=7, devices=[CPU],
            max_concurrent=1, verbose=0, resume=resume)

    first = grid("grid", 2)
    _mark_interrupted(first.root, "trial_00001", keep_records=2)
    resumed = grid("grid", 4, resume=True)
    whole = grid("whole", 4)
    assert [t.config for t in resumed.trials] == [t.config for t in whole.trials]
    assert len({t.config["x"] for t in resumed.trials}) == 4


def test_resume_auto_stays_refused(tmp_path):
    _run(tmp_path, "auto", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3c$"):
        _run(tmp_path, "auto", 1, resume="auto")


# -- against the JAX tune.run(resume=True) ---------------------------------------

def _edit_dedup(root):
    _mark_interrupted(root, "trial_00000", keep_records=3)
    _drop_checkpoints_after(root, "trial_00000", keep=2)


def _edit_two(root):
    _mark_interrupted(root, "trial_00001", keep_records=2)
    _drop_checkpoints_after(root, "trial_00001", keep=1)
    _mark_interrupted(root, "trial_00002", keep_records=0)
    _drop_checkpoints_after(root, "trial_00002", keep=0)


def _edit_nostate(root):
    os.unlink(os.path.join(root, "experiment_state.json"))
    for tid in ("trial_00000", "trial_00001"):
        _truncate_results(root, tid, keep_records=2)


CASES = {
    # name: (first num_samples, resumed num_samples, scheduler, edit)
    "dedup": (1, 1, None, _edit_dedup),
    "two_interrupted_more_samples": (3, 5, None, _edit_two),
    "asha": (4, 6, _asha, lambda root: _mark_interrupted(
        root, "trial_00003", keep_records=1)),
    "no_state_file": (2, 3, None, _edit_nostate),
}


def _resume_with(mod, case, tmp_path, monkeypatch):
    first_n, n, sched, edit = CASES[case]
    lifecycle = (jax_driver if mod is jax_tune else port_driver).TrialLifecycle
    counts = []
    restore = lifecycle.restore_experiment

    def counting(self, *args, **kwargs):
        counts.append(restore(self, *args, **kwargs))
        return counts[-1]

    monkeypatch.setattr(lifecycle, "restore_experiment", counting)
    first = _run(tmp_path, case, first_n, mod=mod, seed=3,
                 scheduler=sched(mod) if sched else None)
    edit(first.root)
    resumed = _run(tmp_path, case, n, resume=True, mod=mod, seed=3,
                   scheduler=sched(mod) if sched else None)
    return counts, resumed


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_decides_as_the_jax_runner(case, tmp_path, monkeypatch):
    want_counts, want = _resume_with(jax_tune, case, tmp_path, monkeypatch)
    got_counts, got = _resume_with(tune, case, tmp_path, monkeypatch)
    assert got_counts == want_counts and len(got_counts) == 1
    assert got_counts[0]["requeued"] >= 1

    def summary(analysis):
        return [(t.trial_id, t.config, t.status.value, t.training_iteration,
                 [(r["epoch"], r["training_iteration"], r["validation_loss"])
                  for r in t.results]) for t in analysis.trials]

    assert summary(got) == summary(want)
    assert got.best_config == want.best_config
