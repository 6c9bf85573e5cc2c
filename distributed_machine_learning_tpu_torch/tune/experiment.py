"""Experiment store + analysis.

Parity with Ray Tune's ``local_dir`` results persistence and
``analysis.best_config`` (`ray-tune-hpo-regression.py:476,480`), upgraded per
SURVEY.md §5: a structured per-trial JSONL metric stream (step, epoch, metrics,
wallclock) plus an experiment-level summary, all plain files so an experiment
directory is greppable and survives the driver.

Port of ``distributed_machine_learning_tpu/tune/experiment.py``: the same
on-disk layout (``params.json``, ``result.jsonl``, ``experiment_state.json``
per experiment root), so either package's ``ExperimentAnalysis`` reads the
other's experiments; checkpoints are the port's pickle-free format
(``tune/checkpoint.py``).  ``best_model`` returns one ``nn.Module`` with
the newest checkpoint's parameters loaded (for a ``run_vectorized``
experiment, each trial's final parameters).  ``export_bundle`` is not
ported yet (ROADMAP.md A3a).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from distributed_machine_learning_tpu_torch.tune.trial import Trial, TrialStatus


def _jsonable(value):
    if hasattr(value, "item"):  # numpy / torch scalars
        try:
            return value.item()
        except Exception:
            pass
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


class ExperimentStore:
    """Writes trial configs, per-epoch results, and experiment state to disk."""

    @staticmethod
    def root_for(storage_path: str, name: str) -> str:
        """THE experiment-root path rule (one place; the drivers' resume
        existence checks must agree with where the store actually writes)."""
        return os.path.join(os.path.expanduser(storage_path), name)

    def __init__(
        self,
        storage_path: str,
        name: str,
        checkpoint_storage: Optional[str] = None,
    ):
        self.root = self.root_for(storage_path, name)
        os.makedirs(self.root, exist_ok=True)
        # Checkpoints may live elsewhere than the metrics store (a local
        # path, or ``mem://`` in tests; remote schemes are not ported).
        self.checkpoint_root = (
            checkpoint_storage.rstrip("/") + "/" + name
            if checkpoint_storage else None
        )
        self._result_files = {}

    def trial_dir(self, trial: Trial) -> str:
        d = os.path.join(self.root, trial.trial_id)
        os.makedirs(d, exist_ok=True)
        return d

    def checkpoint_dir(self, trial: Trial) -> str:
        if self.checkpoint_root:
            from distributed_machine_learning_tpu_torch.tune.storage import (
                get_storage,
            )

            backend, d = get_storage(self.checkpoint_root)
            return backend.join(d, trial.trial_id, "checkpoints")
        d = os.path.join(self.trial_dir(trial), "checkpoints")
        os.makedirs(d, exist_ok=True)
        return d

    def write_params(self, trial: Trial):
        from distributed_machine_learning_tpu_torch.tune.storage import retry_call

        def _write():
            path = os.path.join(self.trial_dir(trial), "params.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(_jsonable(trial.config), f, indent=2)
            os.replace(tmp, path)

        retry_call(_write, key=f"params:{trial.trial_id}")

    def append_result(self, trial: Trial, result: Dict[str, Any]):
        f = self._result_files.get(trial.trial_id)
        if f is None or f.closed:
            f = open(os.path.join(self.trial_dir(trial), "result.jsonl"), "a")
            self._result_files[trial.trial_id] = f
        f.write(json.dumps(_jsonable(result)) + "\n")
        f.flush()

    def set_context(self, metric: str, mode: str):
        """Record the experiment's objective so the directory is
        self-describing (``analyze`` CLI / ``from_directory`` without
        re-supplying the metric)."""
        self._context = {"metric": metric, "mode": mode}

    def write_state(self, trials: List[Trial], extra: Optional[Dict] = None):
        state = {
            **getattr(self, "_context", {}),
            "timestamp": time.time(),
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "status": t.status.value,
                    "config": _jsonable(t.config),
                    "last_result": _jsonable(t.last_result),
                    "training_iteration": t.training_iteration,
                    "error": t.error,
                    "runtime_s": t.runtime_s(),
                }
                for t in trials
            ],
        }
        if extra:
            state.update(_jsonable(extra))

        # Retried as one unit (tune.storage policy): the tmp+rename pair is
        # atomic, so a transient fault anywhere in it re-runs cleanly and a
        # reader never observes a torn state snapshot.
        from distributed_machine_learning_tpu_torch.tune.storage import retry_call

        def _write():
            tmp = os.path.join(self.root, ".state.tmp")
            with open(tmp, "w") as f:
                json.dump(state, f, indent=2)
            os.replace(tmp, os.path.join(self.root, "experiment_state.json"))

        retry_call(_write, key=f"state:{self.root}")

    def close(self):
        for f in self._result_files.values():
            if not f.closed:
                f.close()


def iter_trial_records(root: str):
    """Yield ``(trial_id, config, records, state_meta)`` for every persisted
    trial under an experiment directory — THE parser of the on-disk layout,
    shared by ``ExperimentAnalysis.from_directory`` and experiment resume
    (`tune/_driver.py`) so the format lives in one place.

    ``state_meta`` is the trial's entry from experiment_state.json (dict) or
    None when the trial never made it into a state snapshot (e.g. the
    driver died before any trial completed).  A last record that does not
    parse was cut by a killed process and is left out; one before it that
    does not parse raises.
    """
    state_path = os.path.join(root, "experiment_state.json")
    state: Dict[str, Any] = {}
    if os.path.exists(state_path):
        with open(state_path) as f:
            state = json.load(f)
    by_id = {t["trial_id"]: t for t in state.get("trials", [])}
    for entry in sorted(os.listdir(root)):
        tdir = os.path.join(root, entry)
        params_path = os.path.join(tdir, "params.json")
        if not os.path.isdir(tdir) or not os.path.exists(params_path):
            continue
        with open(params_path) as f:
            config = json.load(f)
        records: List[Dict[str, Any]] = []
        results_path = os.path.join(tdir, "result.jsonl")
        if os.path.exists(results_path):
            with open(results_path) as f:
                lines = [line for line in f if line.strip()]
            for i, line in enumerate(lines):
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    if i < len(lines) - 1:
                        raise
        yield entry, config, records, by_id.get(entry)


class ExperimentAnalysis:
    """Query interface over a finished (or in-flight) experiment.

    ``best_config`` / ``best_trial`` parity with `analysis.best_config`
    (`ray-tune-hpo-regression.py:480`).
    """

    def __init__(
        self,
        trials: List[Trial],
        metric: str,
        mode: str = "min",
        root: Optional[str] = None,
        wall_clock_s: float = 0.0,
        device_utilization: float = 0.0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.trials = trials
        self.metric = metric
        self.mode = mode
        self.root = root
        self.wall_clock_s = wall_clock_s
        self.device_utilization = device_utilization

    def _score(self, trial: Trial) -> Optional[float]:
        hist = trial.metric_history(self.metric)
        if not hist:
            return None
        return min(hist) if self.mode == "min" else max(hist)

    @property
    def best_trial(self) -> Trial:
        scored = [(self._score(t), t) for t in self.trials]
        scored = [(s, t) for s, t in scored if s is not None]
        if not scored:
            raise ValueError(f"No trial reported metric {self.metric!r}")
        return min(scored, key=lambda p: p[0] if self.mode == "min" else -p[0])[1]

    @property
    def best_config(self) -> Dict[str, Any]:
        return self.best_trial.config

    @property
    def best_result(self) -> Dict[str, Any]:
        t = self.best_trial
        best = self._score(t)
        for r in t.results:
            if r.get(self.metric) == best:
                return r
        return t.last_result or {}

    @property
    def best_checkpoint(self) -> Optional[str]:
        return self.best_trial.latest_checkpoint

    def best_model(self):
        """Reconstruct the winning model: one ``nn.Module`` built from the
        best trial's config, its parameters loaded from the trial's newest
        checkpoint (on the CPU, in evaluation mode).

        The port's ``build_model`` needs the width of an input row; it is
        read from the checkpoint's input projection (``[d_model,
        features]``).  The deployment end of the HPO loop: sweep, pick,
        reload, predict."""
        import torch

        from distributed_machine_learning_tpu_torch.models import build_model
        from distributed_machine_learning_tpu_torch.tune.checkpoint import (
            load_checkpoint,
        )

        trial = self.best_trial
        path = trial.latest_checkpoint
        ckpt = load_checkpoint(path) if path else None
        if ckpt is None or "params" not in ckpt:
            raise ValueError(
                f"best trial {trial.trial_id} has no restorable checkpoint "
                f"(path={path!r}); run with checkpointing enabled "
                f"(the built-in trainables checkpoint each epoch by default)"
            )
        params = ckpt["params"]
        proj = params.get("input_projection.weight")
        if proj is None:
            raise ValueError(
                f"checkpoint {path} has no input_projection.weight to read "
                f"the feature count from"
            )
        model = build_model(trial.config, int(proj.shape[-1]))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
        return model.eval()

    def dataframe(self):
        """Last-result-per-trial table (pandas if available, else list of dicts)."""
        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status.value}
            row.update({f"config/{k}": v for k, v in t.config.items()})
            if t.last_result:
                row.update(t.last_result)
            rows.append(row)
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except Exception:
            return rows

    def num_terminated(self) -> int:
        return sum(t.status == TrialStatus.TERMINATED for t in self.trials)

    def trials_per_hour(self) -> float:
        if self.wall_clock_s <= 0:
            return 0.0
        return self.num_terminated() * 3600.0 / self.wall_clock_s

    @classmethod
    def from_directory(cls, root: str, metric: str, mode: str = "min"):
        """Rehydrate an analysis from an experiment directory on disk
        (each trial's newest checkpoint included, so ``best_model`` works
        on it too)."""
        from distributed_machine_learning_tpu_torch.tune.checkpoint import (
            find_latest_checkpoint,
        )

        trials: List[Trial] = []
        for trial_id, config, records, meta in iter_trial_records(root):
            trial = Trial(trial_id=trial_id, config=config)
            trial.results = records
            # Restore progress/runtime so consumers (analyze's table,
            # training_iteration comparisons) see real values, not zeros.
            trial.reports_since_restart = len(records)
            if meta:
                trial.status = TrialStatus(meta.get("status", "TERMINATED"))
                trial.error = meta.get("error")
                if "training_iteration" in meta:
                    trial.restore_base = (
                        int(meta["training_iteration"]) - len(records)
                    )
                runtime = meta.get("runtime_s")
                if runtime is not None:
                    trial.started_at = trial.created_at
                    trial.finished_at = trial.created_at + float(runtime)
            elif records:
                trial.status = TrialStatus.TERMINATED
            ck_path, ck_it = find_latest_checkpoint(
                os.path.join(root, trial_id, "checkpoints"))
            if ck_path:
                trial.latest_checkpoint = ck_path
                trial.latest_checkpoint_iteration = ck_it
            trials.append(trial)
        return cls(trials, metric=metric, mode=mode, root=root)
