"""Population checkpoints and ``run_vectorized(resume=True)`` in the port.

* Port against port, on a tiny transformer with dropout on: a sweep
  interrupted by a scheduler that raises (its process dying) and
  resumed gives the uninterrupted sweep's records and final parameters
  bit for bit; the same across chunks, for trials that never started, under ASHA
  with compaction before the checkpoint, and after a failure planted
  between the tensor write and the index write of a population save.
* ``checkpoint.save_replacing`` on local and ``mem://`` storage.
* The JAX ``_run_population``/``_load_resume_state`` against the port's,
  each driven by the scripted program of tests/test_torch_vectorized.py
  (FIFO, ASHA, a plateau stop rule): the finished, live and unstarted
  sets, the trimmed records, the scheduler state after the replay, the
  checkpoint's rows/active/lrs/wds/epoch0/trial_ids, and the resumed
  sweep's stops, compactions, records and ``best_config``.
* PBT: a compiled resume on a generation boundary stays compiled; one off
  a boundary falls back (``mode_fallbacks`` 1) and decides as the
  uninterrupted sweep; PB2 re-baselines on each trial's last record.

Every JAX oracle runs with ``DML_TPU_COMPILE_CACHE`` in ``tmp_path``
(``restore_global_state``); no JAX ``run_vectorized`` is called.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from _torch_tune_common import restore_global_state  # noqa: F401

torch = pytest.importorskip("torch")
# The first torch.func grad imports torch._dynamo, which sets
# TORCHINDUCTOR_CACHE_DIR: import it before restore_global_state takes its
# snapshot of the environment.
import torch._dynamo  # noqa: E402,F401

from test_torch_vectorized import (  # noqa: E402
    _JaxScripted,
    _NoCompiles,
    _PortScripted,
    EPOCHS,
)

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    checkpoint as port_ckpt,
)
from distributed_machine_learning_tpu_torch.tune import vectorized as port_vec  # noqa: E402
from distributed_machine_learning_tpu_torch.tune.storage import (  # noqa: E402
    LocalStorage,
    MemoryStorage,
)

jax_vec = importlib.import_module("distributed_machine_learning_tpu.tune.vectorized")
jax_trial = importlib.import_module("distributed_machine_learning_tpu.tune.trial")
jax_ckpt = importlib.import_module("distributed_machine_learning_tpu.tune.checkpoint")
jax_experiment = importlib.import_module(
    "distributed_machine_learning_tpu.tune.experiment")
jax_stoppers = importlib.import_module(
    "distributed_machine_learning_tpu.tune.stoppers")

METRIC = "validation_mse"
DATA = dict(num_samples=40, seq_len=8, num_features=4)
NUM_EPOCHS = 6


def _space(**overrides):
    space = dict(
        model="transformer", d_model=8, num_heads=2, num_layers=1,
        dim_feedforward=16, dropout=0.1, max_seq_length=8, batch_size=8,
        num_epochs=NUM_EPOCHS, lr_schedule="constant", loss_function="mse",
        learning_rate=tune.loguniform(1e-3, 1e-1),
        weight_decay=tune.loguniform(1e-6, 1e-3),
        seed=tune.randint(0, 10_000))
    space.update(overrides)
    return space


@pytest.fixture(scope="module")
def data():
    return dummy_regression_data(**DATA)


class _DiesAtEpoch(tune.FIFOScheduler):
    """The sweep process dying: raises on the first record at ``fatal``."""

    def __init__(self, fatal_iteration: int):
        self.fatal_iteration = fatal_iteration

    def on_trial_result(self, trial, result):
        if result["training_iteration"] >= self.fatal_iteration:
            raise RuntimeError("simulated preemption")
        return super().on_trial_result(trial, result)


def _dying(sched, fatal: int, trial_id=None):
    """``sched`` with an ``on_trial_result`` that raises at ``fatal`` (for
    ``trial_id`` only, when given)."""
    orig = sched.on_trial_result

    def on_trial_result(trial, result):
        if (result["training_iteration"] >= fatal
                and trial_id in (None, trial.trial_id)):
            raise RuntimeError("simulated preemption")
        return orig(trial, result)

    sched.on_trial_result = on_trial_result
    return sched


def _sweep(data, tmp_path, name, **kwargs):
    train, val = data
    kw = dict(train_data=train, val_data=val, metric=METRIC, mode="min",
              num_samples=6, seed=9, verbose=0, device="cpu",
              checkpoint_every_epochs=2, storage_path=str(tmp_path),
              name=name)
    kw.update(kwargs)
    return tune.run_vectorized(kw.pop("space", _space()), **kw)


def _crash(data, tmp_path, name, **kwargs):
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _sweep(data, tmp_path, name, **kwargs)


def _state(analysis):
    with open(os.path.join(analysis.root, "experiment_state.json")) as f:
        return json.load(f)


def _without_clock(record, also=()):
    return {k: v for k, v in record.items()
            if k not in ("timestamp", "time_total_s", *also)}


def _assert_same_sweep(got, want, also=()):
    """Records (less their clocks and the keys ``also``) and each trial's
    final parameters bit for bit; the same configs, states and
    ``best_config``."""
    a = sorted(got.trials, key=lambda t: t.trial_id)
    b = sorted(want.trials, key=lambda t: t.trial_id)
    assert [t.trial_id for t in a] == [t.trial_id for t in b]
    for x, y in zip(a, b):
        assert x.config == y.config, x.trial_id
        assert x.status == y.status == tune.TrialStatus.TERMINATED
        assert x.training_iteration == y.training_iteration
        assert [_without_clock(r, also) for r in x.results] == \
            [_without_clock(r, also) for r in y.results], x.trial_id
        pa = port_ckpt.load_checkpoint(x.latest_checkpoint)
        pb = port_ckpt.load_checkpoint(y.latest_checkpoint)
        assert pa["epoch"] == pb["epoch"] == x.training_iteration - 1
        assert all(torch.equal(pa["params"][k], pb["params"][k])
                   for k in pb["params"]), x.trial_id
    assert got.best_config == want.best_config


def _on_disk(analysis, trial_id):
    with open(os.path.join(analysis.root, trial_id, "result.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- port against port, after tests/test_vectorized_resume.py ------------------

def test_resume_matches_uninterrupted_run(data, tmp_path):
    ref = _sweep(data, tmp_path, "ref")
    # Dies at epoch 5: the checkpoint is from the epoch-4 boundary.
    _crash(data, tmp_path, "crash", scheduler=_DiesAtEpoch(5))
    ck = port_ckpt.load_checkpoint(str(tmp_path / "crash" /
                                       port_vec.POPULATION_CHECKPOINT))
    assert ck["epoch0"] == 4 and ck["rows"] == list(range(6))
    # The kill also cut a record in half.
    with open(tmp_path / "crash" / "trial_00003" / "result.jsonl", "a") as f:
        f.write('{"epoch": 5, "training_it')
    resumed = _sweep(data, tmp_path, "crash", resume=True)
    _assert_same_sweep(resumed, ref)
    # Epochs 4 and 5 only, and each epoch once in memory and on disk.
    assert _state(resumed)["row_epochs_computed"] == 6 * (NUM_EPOCHS - 4)
    for t in resumed.trials:
        its = [r["training_iteration"] for r in _on_disk(resumed, t.trial_id)]
        assert its == list(range(1, NUM_EPOCHS + 1)), (t.trial_id, its)
        # time_total_s goes on across the interruption.
        clocks = [r["time_total_s"] for r in t.results]
        assert clocks == sorted(clocks)


def test_resume_without_checkpoint_raises(data, tmp_path):
    with pytest.raises(ValueError, match="population checkpoint"):
        _sweep(data, tmp_path, "nothere", resume=True)
    assert not (tmp_path / "nothere").exists()
    with pytest.raises(ValueError, match="requires name"):
        _sweep(data, tmp_path, None, resume=True)
    # A run without checkpoints leaves nothing to resume from.
    _crash(data, tmp_path, "nockpt", scheduler=_DiesAtEpoch(3),
           checkpoint_every_epochs=0)
    assert not (tmp_path / "nockpt" / port_vec.POPULATION_CHECKPOINT).exists()
    with pytest.raises(ValueError, match="population checkpoint"):
        _sweep(data, tmp_path, "nockpt", resume=True)


def test_multichunk_resume(data, tmp_path):
    kw = dict(max_batch_trials=2, seed=11)
    ref = _sweep(data, tmp_path, "mref", **kw)
    _crash(data, tmp_path, "mcrash", scheduler=_dying(
        tune.FIFOScheduler(), 5, "trial_00002"), **kw)
    # The checkpoint is chunk 2's (2 trials), not the whole sweep's.
    ck = port_ckpt.load_checkpoint(str(tmp_path / "mcrash" /
                                       port_vec.POPULATION_CHECKPOINT))
    assert ck["trial_ids"] == ["trial_00002", "trial_00003"]
    resumed = _sweep(data, tmp_path, "mcrash", resume=True, **kw)
    assert len(resumed.trials) == 6
    _assert_same_sweep(resumed, ref)


def test_resume_reruns_unstarted_trials(data, tmp_path):
    """A crash between a chunk's params.json and its first checkpoint
    leaves a trial with no records and no population: it runs again as a
    chunk of its own, and sampling goes on after it."""
    kw = dict(num_samples=4, max_batch_trials=2, seed=13)
    ref = _sweep(data, tmp_path, "uref", **kw)
    _crash(data, tmp_path, "ucrash", scheduler=_DiesAtEpoch(5), **kw)
    ghost = tmp_path / "ucrash" / "trial_00002"
    ghost.mkdir()
    (ghost / "params.json").write_text(
        (tmp_path / "uref" / "trial_00002" / "params.json").read_text())
    resumed = _sweep(data, tmp_path, "ucrash", resume=True, **kw)
    assert [t.training_iteration for t in resumed.trials] == [NUM_EPOCHS] * 4
    # Trials 2 and 3 ran one by one, not as a population of two.
    assert {r["population_size"] for t in resumed.trials[2:]
            for r in t.results} == {1}
    _assert_same_sweep(resumed, ref, also=("population_size",))


def _asha():
    return tune.ASHAScheduler(max_t=NUM_EPOCHS, grace_period=1,
                              reduction_factor=2)


def test_resume_with_asha_rung_state(data, tmp_path):
    """ASHA's rungs are replayed: trials stopped before the checkpoint stay
    stopped with their clocks frozen, the population restored at its
    compacted size, and the rest stop where they did uninterrupted."""
    kw = dict(num_samples=8, seed=3)
    ref = _sweep(data, tmp_path, "aref", scheduler=_asha(), **kw)
    assert _state(ref)["population_compactions"] >= 1
    _crash(data, tmp_path, "acrash", scheduler=_dying(_asha(), 5), **kw)
    ck = port_ckpt.load_checkpoint(str(tmp_path / "acrash" /
                                       port_vec.POPULATION_CHECKPOINT))
    assert ck["epoch0"] == 4 and len(ck["rows"]) < 8  # saved after compaction
    assert not all(ck["active"])
    resumed = _sweep(data, tmp_path, "acrash", scheduler=_asha(), resume=True,
                     **kw)
    _assert_same_sweep(resumed, ref)
    lengths = sorted(len(t.results) for t in resumed.trials)
    assert lengths[0] < NUM_EPOCHS == lengths[-1]
    for t in resumed.trials:
        if t.training_iteration <= 4:  # stopped before the checkpoint
            assert t.runtime_s() == pytest.approx(
                t.results[-1]["time_total_s"], abs=1e-3)


def test_resume_warms_a_plateau_stopper(data, tmp_path):
    def stopper():
        return tune.TrialPlateauStopper(METRIC, std=0.005, num_results=2,
                                        grace_period=2)

    ref = _sweep(data, tmp_path, "pref", stop=stopper())
    # A trial the warmed window stops after the checkpoint at epoch 4.
    assert 4 < min(t.training_iteration for t in ref.trials
                   if t.training_iteration > 4) < NUM_EPOCHS
    _crash(data, tmp_path, "pcrash", stop=stopper(),
           scheduler=_DiesAtEpoch(5))
    resumed = _sweep(data, tmp_path, "pcrash", stop=stopper(), resume=True)
    _assert_same_sweep(resumed, ref)


def test_a_kill_between_the_two_writes_leaves_the_previous_checkpoint(
        data, tmp_path, monkeypatch):
    """The population save at epoch 4 dies after its tensor file landed
    and before its index: epoch 2's checkpoint is still whole, and the
    sweep resumed from it equals the uninterrupted one."""
    ref = _sweep(data, tmp_path, "kref")
    write = LocalStorage.write_bytes
    saves = []

    def planted(self, path, payload):
        if path.endswith(port_vec.POPULATION_CHECKPOINT):
            saves.append(path)
            if len(saves) == 3:  # epoch 0, epoch 2, then epoch 4
                raise RuntimeError("simulated preemption")
        return write(self, path, payload)

    monkeypatch.setattr(LocalStorage, "write_bytes", planted)
    _crash(data, tmp_path, "kcrash")
    monkeypatch.setattr(LocalStorage, "write_bytes", write)
    root = tmp_path / "kcrash"
    # The orphaned epoch-4 bytes and epoch 2's, which its index names.
    assert len(list(root.glob("population.*.tensors"))) == 2
    assert port_ckpt.load_checkpoint(
        str(root / port_vec.POPULATION_CHECKPOINT))["epoch0"] == 2
    resumed = _sweep(data, tmp_path, "kcrash", resume=True)
    _assert_same_sweep(resumed, ref)
    # The next save swept the orphan away with the old bytes.
    assert len(list(root.glob("population.*.tensors"))) == 1


@pytest.mark.parametrize("scheme", ["local", "mem"])
def test_save_replacing_keeps_one_whole_checkpoint(scheme, tmp_path,
                                                   monkeypatch):
    base = (str(tmp_path) if scheme == "local"
            else f"mem://{tmp_path.name}")
    backend_cls = LocalStorage if scheme == "local" else MemoryStorage
    path = f"{base}/exp/population.json"
    trees = [{"w": torch.full((3, 2), float(i)), "epoch0": i,
              "ids": ["a", "b"]} for i in range(3)]

    def tensor_files():
        return sorted(n for n in backend_cls().listdir(
            path.rsplit("/", 1)[0].replace("file://", ""))
            if n.endswith(".tensors"))

    port_ckpt.save_replacing(path, trees[0])
    port_ckpt.save_replacing(path, trees[1])
    got = port_ckpt.load_checkpoint(path)
    assert torch.equal(got["w"], trees[1]["w"]) and got["epoch0"] == 1
    assert len(tensor_files()) == 1
    write = backend_cls.write_bytes

    def cut(self, p, payload):
        if p.endswith(".json"):
            raise RuntimeError("killed before the index")
        return write(self, p, payload)

    monkeypatch.setattr(backend_cls, "write_bytes", cut)
    with pytest.raises(RuntimeError, match="killed"):
        port_ckpt.save_replacing(path, trees[2])
    monkeypatch.setattr(backend_cls, "write_bytes", write)
    assert port_ckpt.load_checkpoint(path)["epoch0"] == 1
    assert len(tensor_files()) == 2
    port_ckpt.save_replacing(path, trees[2])
    assert port_ckpt.load_checkpoint(path)["epoch0"] == 2
    assert len(tensor_files()) == 1
    # An index that names a file outside its directory is refused.
    raw = json.loads(backend_cls().read_bytes(
        path.replace("file://", "")).decode())
    raw["tensors"] = "../elsewhere.tensors"
    backend_cls().write_bytes(path, json.dumps(raw).encode())
    with pytest.raises(port_ckpt.CheckpointCorruptionError):
        port_ckpt.load_checkpoint(path)
    if scheme == "mem":
        MemoryStorage.clear()


# -- the decision layer against the JAX runner ---------------------------------

class _PortScriptedResumable(_PortScripted):
    """The scripted port program with the population checkpoint's two
    methods: its state is the rows' identities and lrs."""

    def population_tree(self, state):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}

    def restore_population(self, tree):
        return {k: v.numpy() for k, v in tree.items()}


SCRIPT_LRS = [1e-3, 2e-3, 4e-4, 8e-3, 1.5e-3, 3e-4, 6e-3, 1.1e-3]
DONE_LRS = [5e-4, 2.5e-3]
CKPT_EVERY, FATAL = 2, 5


def _scripted_setup(side, case):
    pkg = jax_tune if side == "jax" else tune
    if case == "asha":
        sched = pkg.ASHAScheduler(max_t=EPOCHS, grace_period=1,
                                  reduction_factor=2)
    else:
        sched = pkg.FIFOScheduler()
    sched.set_experiment("validation_mape", "min")
    searcher = pkg.RandomSearch()
    searcher.set_search_space(pkg.SearchSpace({"learning_rate": 1e-3}), 0)
    stop = None
    if case == "plateau":
        mod = jax_stoppers if side == "jax" else tune
        stop = mod.TrialPlateauStopper("validation_mape", std=0.15,
                                       num_results=3, grace_period=2)
    return sched, searcher, stop


def _scripted_population(side, program, batch, sched, searcher, store, log,
                         stop, ckpt_path, resume_state=None):
    if side == "jax":
        jax_vec._run_population(
            program, batch, sched, searcher, store, "validation_mape", "min",
            log, _NoCompiles(), "always", 1, None, None, None, 1, CKPT_EVERY,
            ckpt_path, resume_state, stop_rules=stop)
    else:
        port_vec._run_population(
            program, batch, sched, searcher, store, "validation_mape", "min",
            log, "auto", stop_rules=stop, checkpoint_every_epochs=CKPT_EVERY,
            ckpt_path=ckpt_path, resume_state=resume_state)


def _scripted_resume(side, case, tmp_path):
    """A finished chunk of 2, then the chunk of 8 dies at epoch 5, with a
    ghost trial made but never started; then the resume of the 8."""
    pkg = jax_tune if side == "jax" else tune
    trial_cls = jax_trial.Trial if side == "jax" else tune.Trial
    program_cls = _JaxScripted if side == "jax" else _PortScriptedResumable
    ckpt_name = "population.ckpt" if side == "jax" else \
        port_vec.POPULATION_CHECKPOINT
    store = pkg.ExperimentStore(str(tmp_path / side), "scripted")
    ckpt_path = os.path.join(store.root, ckpt_name)
    trials = [trial_cls(trial_id=f"trial_{i:05d}",
                        config={"learning_rate": lr, "seed": i})
              for i, lr in enumerate(DONE_LRS + SCRIPT_LRS + [7e-4])]
    for t in trials:
        store.write_params(t)
    done, batch = trials[:2], trials[2:10]
    logs = []
    sched, searcher, stop = _scripted_setup(side, case)
    for t in done + batch:
        sched.on_trial_add(t)
    _scripted_population(side, program_cls(), done, sched, searcher, store,
                         logs.append, stop, ckpt_path)
    _dying(sched, FATAL, "trial_00002")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _scripted_population(side, program_cls(), batch, sched, searcher,
                             store, logs.append, stop, ckpt_path)
    store.close()
    ck = (jax_ckpt if side == "jax" else port_ckpt).load_checkpoint(ckpt_path)
    ids = ck["trial_ids"]
    if isinstance(ids, dict):  # flax msgpack keeps a list as an index dict
        ids = [ids[k] for k in sorted(ids, key=int)]
    ckpt = {"rows": [int(r) for r in np.asarray(ck["rows"])],
            "active": [bool(a) for a in np.asarray(ck["active"])],
            "lrs": np.asarray(ck["lrs"], np.float32).tolist(),
            "wds": np.asarray(ck["wds"], np.float32).tolist(),
            "epoch0": int(ck["epoch0"]), "trial_ids": [str(i) for i in ids]}

    sched, searcher, stop = _scripted_setup(side, case)
    resume_state, finished, live, unstarted = (
        jax_vec if side == "jax" else port_vec)._load_resume_state(
        store.root, "validation_mape", "min", sched, searcher, None,
        stop_rules=stop)
    replayed = {
        "sets": [sorted(t.trial_id for t in ts)
                 for ts in (finished, live, unstarted)],
        "kept": {t.trial_id: len(t.results) for t in finished + live},
        "sched_state": sched.save_state(),
        "statuses": {t.trial_id: t.status.value for t in finished + live},
    }
    store = pkg.ExperimentStore(str(tmp_path / side), "scripted")
    _scripted_population(side, program_cls(), live, sched, searcher, store,
                         logs.append, stop, ckpt_path, resume_state)
    store.close()
    analysis = (jax_experiment.ExperimentAnalysis if side == "jax"
                else tune.ExperimentAnalysis)(finished + live,
                                              "validation_mape", "min")
    return dict(ckpt=ckpt, replayed=replayed, trials=finished + live,
                compacted=[m for m in logs if m.startswith("compacted")],
                best=(analysis.best_trial.trial_id, _f32(analysis.best_config)))


def _f32(config):
    """A config with its floats rounded to float32: the JAX resume writes
    the population's float32 lr/wd back into every live trial's config;
    the port only where PBT changed them."""
    return {k: float(np.float32(v)) if isinstance(v, float) else v
            for k, v in config.items()}


@pytest.mark.parametrize("case", ["fifo", "asha", "plateau"])
def test_resume_decides_as_the_jax_runner(case, tmp_path):
    want = _scripted_resume("jax", case, tmp_path)
    got = _scripted_resume("port", case, tmp_path)
    assert got["ckpt"] == want["ckpt"]
    assert got["ckpt"]["epoch0"] == 4
    assert got["replayed"] == want["replayed"]
    assert got["replayed"]["sets"] == [["trial_00000", "trial_00001"],
                                       [f"trial_{i:05d}" for i in range(2, 10)],
                                       ["trial_00010"]]
    assert got["compacted"] == want["compacted"]
    assert got["best"] == want["best"]
    if case == "asha":
        assert got["compacted"] and not all(got["ckpt"]["active"])
    stops = {t.trial_id: t.training_iteration for t in got["trials"]}
    assert stops == {t.trial_id: t.training_iteration for t in want["trials"]}
    if case != "fifo":
        assert set(stops.values()) != {EPOCHS}
    for a, b in zip(got["trials"], want["trials"]):
        assert a.status.value == b.status.value == "TERMINATED"
        assert len(a.results) == len(b.results)
        for ra, rb in zip(a.results, b.results):
            for k, v in rb.items():
                if k in ("timestamp", "time_total_s"):
                    continue
                if isinstance(v, float):
                    np.testing.assert_allclose(ra[k], v, rtol=1e-6, err_msg=k)
                else:
                    assert ra[k] == v, k


def test_scripted_resume_equals_the_uninterrupted_port_run(tmp_path):
    """The port's resumed scripted sweep against the port's uninterrupted
    one, record for record, with ASHA."""
    got = _scripted_resume("port", "asha", tmp_path)
    sched, searcher, stop = _scripted_setup("port", "asha")
    store = tune.ExperimentStore(str(tmp_path / "whole"), "scripted")
    done = [tune.Trial(trial_id=f"trial_{i:05d}",
                       config={"learning_rate": lr, "seed": i})
            for i, lr in enumerate(DONE_LRS + SCRIPT_LRS)]
    for t in done:
        sched.on_trial_add(t)
    for chunk in (done[:2], done[2:]):
        port_vec._run_population(_PortScriptedResumable(), chunk, sched,
                                 searcher, store, "validation_mape", "min",
                                 lambda m: None, "auto")
    store.close()
    for a, b in zip(got["trials"], done):
        assert [_without_clock(r) for r in a.results] == \
            [_without_clock(r) for r in b.results], a.trial_id


# -- PBT ---------------------------------------------------------------------------

PBT_EPOCHS = 8


class _DyingPBT(tune.PopulationBasedTraining):
    """Under PBT the scheduler only observes records: this one raises on
    the first record at ``fatal``."""

    def __init__(self, fatal_iteration: int, **kwargs):
        super().__init__(**kwargs)
        self.fatal_iteration = fatal_iteration

    def observe_result(self, trial, result):
        if result["training_iteration"] >= self.fatal_iteration:
            raise RuntimeError("simulated preemption")
        super().observe_result(trial, result)


def _pbt(cls=tune.PopulationBasedTraining, **kwargs):
    return cls(perturbation_interval=2, quantile_fraction=0.25, seed=1,
               hyperparam_mutations={
                   "learning_rate": tune.loguniform(1e-3, 1e-1),
                   "weight_decay": tune.loguniform(1e-6, 1e-3)}, **kwargs)


def _pbt_sweep(data, tmp_path, name, pbt, **kwargs):
    analysis = _sweep(data, tmp_path, name, scheduler=pbt, num_samples=8,
                      space=_space(num_epochs=PBT_EPOCHS), **kwargs)
    return analysis, _state(analysis)["pbt"], pbt._generation_log


def _notes(analysis, after: int = 0):
    return sorted((t.trial_id, r["training_iteration"],
                   r["pbt_exploited_from"]) for t in analysis.trials
                  for r in t.results if "pbt_exploited_from" in r
                  and r["training_iteration"] > after)


def _same_log(got, want):
    keys = ("gen", "fire", "scores", "row_lr", "row_wd", "valid", "src",
            "new_lr", "new_wd", "exploited")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in keys:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_compiled_pbt_resume_on_a_boundary_stays_compiled(data, tmp_path):
    kw = dict(epochs_per_dispatch=2)
    ref, ref_block, ref_log = _pbt_sweep(data, tmp_path, "cref", _pbt(), **kw)
    assert ref_block["mode"] == "compiled" and ref_block["exploits"] > 0
    # Dies on the first record of generation 2: the checkpoint is at 4.
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _pbt_sweep(data, tmp_path, "ccrash", _pbt(_DyingPBT, fatal_iteration=5),
                   **kw)
    resumed, block, log = _pbt_sweep(data, tmp_path, "ccrash", _pbt(),
                                     resume=True, **kw)
    assert block["mode"] == "compiled" and "mode_fallbacks" not in block
    assert block["host_dispatches"] == (PBT_EPOCHS - 4) // 2
    _same_log(log, [e for e in ref_log if e["gen"] >= 2])
    # The donor notes of generation 1 annotate epoch 4, after the resume.
    assert _notes(resumed) == _notes(ref)
    assert any(it == 5 for _, it, _ in _notes(ref))
    _assert_same_sweep(resumed, ref)


def test_compiled_pbt_resume_off_a_boundary_falls_back(data, tmp_path):
    """A boundary run saved at epoch 3 (interval 2); the resume asks for
    the compiled path, falls back, and decides as the uninterrupted
    boundary run."""
    kw = dict(pbt_mode="boundary", epochs_per_dispatch=1,
              checkpoint_every_epochs=3)
    ref, ref_block, ref_log = _pbt_sweep(data, tmp_path, "bref", _pbt(), **kw)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _pbt_sweep(data, tmp_path, "bcrash",
                   _pbt(_DyingPBT, fatal_iteration=5), **kw)
    assert port_ckpt.load_checkpoint(str(
        tmp_path / "bcrash" / port_vec.POPULATION_CHECKPOINT))["epoch0"] == 3
    resumed, block, log = _pbt_sweep(data, tmp_path, "bcrash", _pbt(),
                                     resume=True, checkpoint_every_epochs=3)
    assert block["mode"] == "boundary" and block["mode_fallbacks"] == 1
    _same_log(log, [e for e in ref_log if e["gen"] >= 1])
    assert _notes(resumed) == _notes(ref)
    _assert_same_sweep(resumed, ref)


def test_pb2_resume_rebaselines_on_the_last_records(data, tmp_path):
    def pb2(cls=tune.PB2, **kwargs):
        return cls(perturbation_interval=2, quantile_fraction=0.25, seed=1,
                   num_candidates=16, hyperparam_mutations={
                       "learning_rate": tune.loguniform(1e-3, 1e-1)},
                   **kwargs)

    class DyingPB2(tune.PB2):
        def observe_result(self, trial, result):
            if result["training_iteration"] >= 5:
                raise RuntimeError("simulated preemption")
            super().observe_result(trial, result)

    with pytest.raises(RuntimeError, match="simulated preemption"):
        _pbt_sweep(data, tmp_path, "pb2", pb2(DyingPB2))
    fresh = pb2()
    fresh.set_experiment(METRIC, "min")
    _, _, live, _ = port_vec._load_resume_state(
        str(tmp_path / "pb2"), METRIC, "min", fresh, tune.RandomSearch(),
        fresh)
    # One baseline per trial at its last kept record, and no delta
    # credited to a config from the replayed history.
    assert fresh._obs == []
    assert fresh._last_score == {
        t.trial_id: (t.results[-1]["training_iteration"],
                     fresh._score(t.results[-1])) for t in live}
    assert {it for it, _ in fresh._last_score.values()} == {4}
    resumed, block, _ = _pbt_sweep(data, tmp_path, "pb2", pb2(), resume=True)
    assert block["mode"] == "boundary" and block["num_observations"] > 0
    assert all(t.training_iteration == PBT_EPOCHS for t in resumed.trials)
