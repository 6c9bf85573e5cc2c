"""The port's PBT and PB2 schedulers against the JAX package's.

* ``generation_draws``: the port's numpy threefry against JAX's
  ``jax.random`` chain, bit for bit.
* ``reference_generation_step`` and its device form
  (``_regression_program.make_exploit_explore``, run here on the CPU)
  against the JAX reference step, bit for bit: NaN/inf scores, invalid
  rows, ``fire=False``, fewer than 4 valid rows, mode max, one and two
  mutated keys.
* The respawn decisions (``on_trial_result``, ``_mutate``) of PBT and PB2
  fed the same report stream as the JAX schedulers: the same decisions,
  restore targets and configs; the clamp, int, quantized and list cases
  of ``tests/test_pb2.py``.
* ``tune.run`` with respawn PBT: the scripted sweep makes the same
  requeues and reaches the same ``best_config`` as the JAX ``tune.run``;
  a requeued ``train_regressor`` trial resumes from its donor's
  checkpoint, with the donor's weights bit for bit; the driver keeps a
  donor checkpoint a lagger points at, and a failure consumes a pending
  requeue.

Every JAX ``tune.run`` runs with ``compile_cache_dir=None`` and its
cache variable in ``tmp_path`` (``restore_global_state``).
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from _torch_tune_common import restore_global_state, scripted_metric  # noqa: F401

torch = pytest.importorskip("torch")

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.tune.schedulers import (  # noqa: E402
    pbt as jax_pbt,
)
from distributed_machine_learning_tpu.tune.trial import (  # noqa: E402
    Trial as JaxTrial,
)
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    trainable as port_trainable,
)
from distributed_machine_learning_tpu_torch.tune._driver import (  # noqa: E402
    TrialLifecycle,
)
from distributed_machine_learning_tpu_torch.tune._regression_program import (  # noqa: E402
    make_exploit_explore,
)
from distributed_machine_learning_tpu_torch.tune.checkpoint import (  # noqa: E402
    list_checkpoints,
    load_checkpoint,
)
from distributed_machine_learning_tpu_torch.tune.schedulers import (  # noqa: E402
    pbt as port_pbt,
)

CPU = torch.device("cpu")
METRIC = "validation_mape"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# -- the draws ---------------------------------------------------------------

@pytest.mark.parametrize("seed,rows,gen,draws", [
    (1, 8, 0, 5), (3000, 50, 3, 5), (7, 16, 2, 3), (123456, 5, 11, 1),
    (0, 4, 0, 3), (2**31 - 1, 3, 7, 5), (2**33 + 5, 3, 1, 3), (-5, 4, 2, 3),
])
def test_generation_draws_are_jax_bits(seed, rows, gen, draws):
    got = port_pbt.generation_draws(seed, rows, gen, draws)
    want = jax_pbt.generation_draws(seed, rows, gen, draws)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (rows, draws)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert ((got >= 0) & (got < 1)).all()


# -- the decision step -------------------------------------------------------

def _spec(mod, keys=("learning_rate",), mode="min", quantile=0.25):
    domains = {"learning_rate": mod.loguniform(1e-4, 1e-1),
               "weight_decay": mod.uniform(0.0, 1e-3)}
    sched = mod.PopulationBasedTraining(
        mode=mode, quantile_fraction=quantile, seed=3,
        hyperparam_mutations={k: domains[k] for k in keys})
    return sched.device_mutation_spec()


# (rows, keys, mode, quantile, fire, score pattern, invalid rows)
STEP_CASES = {
    "plain": (16, ("learning_rate",), "min", 0.25, True, "normal", ()),
    "nan_inf": (16, ("learning_rate",), "min", 0.25, True, "nonfinite", ()),
    "invalid_rows": (12, ("learning_rate",), "min", 0.25, True, "normal",
                     (0, 3, 7)),
    "no_fire": (16, ("learning_rate",), "min", 0.25, False, "normal", ()),
    "under_four_valid": (6, ("learning_rate",), "min", 0.25, True, "normal",
                         (0, 1, 2)),
    "mode_max": (16, ("learning_rate",), "max", 0.25, True, "nonfinite", ()),
    "weight_decay_only": (10, ("weight_decay",), "min", 0.5, True, "normal",
                          ()),
    "two_keys": (32, ("learning_rate", "weight_decay"), "min", 0.25, True,
                 "nonfinite", (5,)),
    "all_nonfinite": (8, ("learning_rate",), "min", 0.25, True, "nan", ()),
    "ties": (9, ("learning_rate", "weight_decay"), "min", 0.5, True, "ties",
             ()),
}


def _step_inputs(name):
    rows, keys, mode, quantile, fire, pattern, invalid = STEP_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    scores = rng.normal(size=rows).astype(np.float32)
    if pattern == "nonfinite":
        scores[[1, 4]] = np.nan
        scores[2] = np.inf
        scores[5] = -np.inf
    elif pattern == "nan":
        scores[:] = np.nan
    elif pattern == "ties":
        scores[:] = np.float32(0.5)
    valid = np.ones(rows, bool)
    valid[list(invalid)] = False
    lr = rng.uniform(1e-4, 1e-1, rows).astype(np.float32)
    wd = rng.uniform(0.0, 1e-3, rows).astype(np.float32)
    spec = _spec(jax_tune, keys, mode, quantile)
    draws = np.array(jax_pbt.generation_draws(
        11, rows, 2, jax_pbt.generation_draw_count(spec)))
    return spec, scores, lr, wd, valid, draws, fire, keys, mode, quantile


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_reference_generation_step_is_bit_equal(name):
    spec, scores, lr, wd, valid, draws, fire, keys, mode, q = \
        _step_inputs(name)
    assert _spec(tune, keys, mode, q) == spec
    want = jax_pbt.reference_generation_step(spec, scores, lr, wd, valid,
                                             draws, fire)
    got = port_pbt.reference_generation_step(spec, scores, lr, wd, valid,
                                             draws, fire)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if name in ("plain", "two_keys", "invalid_rows", "mode_max"):
        assert want[3].any(), "the case exploits nothing"
    if name in ("no_fire", "under_four_valid", "all_nonfinite"):
        assert not want[3].any()


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_device_step_on_the_cpu_is_bit_equal(name):
    spec, scores, lr, wd, valid, draws, fire, *_ = _step_inputs(name)
    want = jax_pbt.reference_generation_step(spec, scores, lr, wd, valid,
                                             draws, fire)
    step = make_exploit_explore(spec, valid, CPU)
    got = step(torch.from_numpy(scores), torch.from_numpy(lr),
               torch.from_numpy(wd), torch.from_numpy(draws), fire)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()),
                                      _bits(np.asarray(w, g.numpy().dtype)))


def test_grid_draw_count_and_state_block_match():
    for keys in (("learning_rate",), ("learning_rate", "weight_decay")):
        spec = _spec(tune, keys)
        assert port_pbt.generation_draw_count(spec) == \
            jax_pbt.generation_draw_count(spec) == 1 + 2 * len(keys)
        for e in spec["specs"]:
            np.testing.assert_array_equal(port_pbt.resample_grid(e),
                                          jax_pbt.resample_grid(e))
    for mod in (tune, jax_tune):
        assert mod.PB2(hyperparam_mutations={
            "learning_rate": mod.loguniform(1e-4, 1e-1)}
        ).device_mutation_spec() is None
        for spec in ([1e-3, 1e-2], mod.qloguniform(1e-4, 1e-1, 1e-4)):
            assert mod.PopulationBasedTraining(hyperparam_mutations={
                "learning_rate": spec}).device_mutation_spec() is None
        assert mod.PopulationBasedTraining(hyperparam_mutations={
            "dropout": mod.uniform(0, 0.5)}).device_mutation_spec() is None
    s = tune.PopulationBasedTraining(hyperparam_mutations={"lr": [1]},
                                     objective={"latency": 0.5})
    s._num_perturbations = 3
    assert port_pbt.pbt_state_block(s) == {
        "mode": "respawn", "exploits": 3, "explores": 3,
        "objective": "custom_lat0.5_par0"}
    assert port_pbt.pbt_state_block(tune.ASHAScheduler()) is None
    with pytest.raises(ValueError, match="objective must be one of"):
        tune.PopulationBasedTraining(hyperparam_mutations={"lr": [1]},
                                     objective="speed")
    with pytest.raises(ValueError, match="requires hyperparam_mutations"):
        tune.PopulationBasedTraining()


# -- respawn decisions on the same report stream -----------------------------

def _scheduler(mod, kind, mutations):
    cls = mod.PB2 if kind == "pb2" else mod.PopulationBasedTraining
    extra = {"num_candidates": 32} if kind == "pb2" else {}
    return cls(metric="loss", mode="min", perturbation_interval=2,
               hyperparam_mutations=mutations(mod), quantile_fraction=0.25,
               seed=5, **extra)


MUTATIONS = {
    "loguniform": lambda mod: {"learning_rate": mod.loguniform(1e-4, 1e-1)},
    "mixed": lambda mod: {"learning_rate": mod.loguniform(1e-4, 1e-1),
                          "weight_decay": mod.uniform(0.0, 1e-2),
                          "layers": mod.randint(1, 6),
                          "width": [16, 32, 64, 128]},
    "quantized": lambda mod: {"learning_rate": mod.qloguniform(1e-4, 1e-1,
                                                               1e-4),
                              "batch": mod.qrandint(8, 64, 8)},
}


def _stream(mod, trial_cls, kind, mutations, n_trials=8, epochs=6):
    """Round robin over trials; each reports its next iteration with a
    score of its config and progress; a REQUEUE restarts it at the
    restore base.  Returns every decision and the scheduler state."""
    sched = _scheduler(mod, kind, mutations)
    rng = np.random.default_rng(0)
    trials = []
    for i in range(n_trials):
        cfg = {"learning_rate": float(10 ** rng.uniform(-4, -1)),
               "weight_decay": float(rng.uniform(0, 1e-2)),
               "layers": int(rng.integers(1, 6)),
               "width": [16, 32, 64, 128][i % 4], "batch": 16,
               "num_epochs": epochs}
        t = trial_cls(trial_id=f"trial_{i:05d}", config=cfg)
        sched.on_trial_add(t)
        trials.append(t)
    it = {t.trial_id: 0 for t in trials}
    log = []
    for _ in range(n_trials * epochs * 2):
        live = [t for t in trials if it[t.trial_id] < epochs]
        if not live:
            break
        for t in live:
            it[t.trial_id] += 1
            n = it[t.trial_id]
            t.latest_checkpoint = f"/ck/{t.trial_id}/{n}"
            t.latest_checkpoint_iteration = n
            loss = scripted_metric(t.config, n) + 0.1 * t.config["layers"]
            decision = sched.on_trial_result(
                t, {"loss": loss, "training_iteration": n})
            log.append((t.trial_id, n, decision, t.restore_path,
                        t.restore_base, dict(t.config)))
            if decision == "requeue":
                it[t.trial_id] = t.restore_base
    return log, sched.save_state(), sched.debug_state()


@pytest.mark.parametrize("kind", ["pbt", "pb2"])
@pytest.mark.parametrize("mutations", sorted(MUTATIONS))
def test_respawn_decisions_match_the_jax_scheduler(kind, mutations):
    got = _stream(tune, tune.Trial, kind, MUTATIONS[mutations])
    want = _stream(jax_tune, JaxTrial, kind, MUTATIONS[mutations])
    assert got[0] == want[0]
    assert json.dumps(got[1], sort_keys=True) == \
        json.dumps(want[1], sort_keys=True)
    assert got[2] == want[2]
    assert sum(d == "requeue" for _, _, d, *_ in got[0]) > 0
    if kind == "pb2":
        # Quantized domains are not continuous: PB2 mutates them as PBT.
        assert (got[2]["num_observations"] > 0) == (mutations != "quantized")


def _mutate_both(mutations, config, seed, resample=0.0, n=40):
    out = []
    for mod in (tune, jax_tune):
        s = mod.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=1,
            hyperparam_mutations=mutations(mod),
            resample_probability=resample)
        rng = np.random.default_rng(seed)
        out.append([s._mutate(dict(config), rng) for _ in range(n)])
    return out


def test_mutate_clamps_into_the_domain():
    got, want = _mutate_both(
        lambda m: {"learning_rate": m.loguniform(1e-4, 1e-1)},
        {"learning_rate": 0.09}, 0)
    assert got == want
    assert all(1e-4 <= c["learning_rate"] <= 1e-1 + 1e-12 for c in got)


def test_mutate_zero_value_and_int_preservation():
    got, want = _mutate_both(
        lambda m: {"weight_decay": m.loguniform(1e-6, 1e-2),
                   "hidden": m.uniform(32, 256)},
        {"weight_decay": 0.0, "hidden": 64}, 1, n=30)
    assert got == want
    for c in got:
        assert 1e-6 <= c["weight_decay"] <= 1e-2
        assert isinstance(c["hidden"], int) and 32 <= c["hidden"] <= 256


def test_mutate_randint_clamp_respects_exclusive_high():
    got, want = _mutate_both(lambda m: {"layers": m.randint(1, 10)},
                             {"layers": 9}, 2, n=30)
    assert got == want
    assert all(isinstance(c["layers"], int) and 1 <= c["layers"] <= 9
               for c in got)


def test_mutate_quantized_and_list_specs():
    got, want = _mutate_both(
        lambda m: {"lr": m.qloguniform(1e-4, 1e-1, 1e-4),
                   "batch": m.qrandint(8, 64, 8),
                   "width": [16, 32, 64]},
        {"lr": 0.1, "batch": 64, "width": 64}, 3, resample=0.25)
    assert got == want
    for c in got:
        assert c["batch"] % 8 == 0 and 8 <= c["batch"] <= 64
        assert 1e-4 <= c["lr"] <= 1e-1 + 1e-12
        assert abs(round(c["lr"] / 1e-4) * 1e-4 - c["lr"]) < 1e-12
        assert c["width"] in (16, 32, 64)


# -- tune.run respawn --------------------------------------------------------

FIRST_EPOCHS, BUDGET = 2, 3


def _respawn_trainable(mod):
    """A scripted trainable that resumes from its checkpoint: its state
    ``w`` grows each epoch by a function of its config, and its metric
    reads config, epoch and state, so an exploit changes what it reports.
    A first incarnation runs ``FIRST_EPOCHS``, below the ``num_epochs``
    budget, so a finished trial can still donate (one at a time, as
    ``max_concurrent=1`` runs them, makes the sweep deterministic); a
    requeued one runs on to the budget, past the last perturbation."""
    def trainable(config):
        ckpt = mod.get_checkpoint()
        start, w = 0, np.float32(0)
        if ckpt is not None:
            start = int(ckpt["epoch"])
            w = np.float32(np.asarray(ckpt["w"]).reshape(-1)[0])
        stop = config["num_epochs"] if ckpt is not None else FIRST_EPOCHS
        lr = float(config["learning_rate"])
        for it in range(start + 1, stop + 1):
            w = np.float32(w + 1.0 / (1.0 + abs(math.log10(lr) + 2.5)))
            arr = np.full((2, 3), w, np.float32)
            mod.report({METRIC: scripted_metric(config, it) - 0.05 * float(w),
                        "epoch": it - 1},
                       checkpoint={"w": torch.from_numpy(arr)
                                   if mod is tune else arr, "epoch": it})
    return trainable


def _respawn_run(mod, tmp_path, **extra):
    kwargs = ({"compile_cache_dir": None} if mod is jax_tune
              else {"devices": [CPU]})
    kwargs.update(extra)
    pbt = mod.PopulationBasedTraining(
        perturbation_interval=2, quantile_fraction=0.25, seed=7,
        hyperparam_mutations={"learning_rate": mod.loguniform(1e-5, 1e-1)})
    space = {"learning_rate": mod.loguniform(1e-5, 1e-1),
             "d_model": mod.choice([16, 32, 64]), "num_epochs": BUDGET}
    side = "jax" if mod is jax_tune else "port"
    analysis = mod.run(
        _respawn_trainable(mod), space, metric=METRIC, mode="min",
        num_samples=12, scheduler=pbt, max_concurrent=1, seed=5, verbose=0,
        name="pbt", storage_path=str(tmp_path / side), **kwargs)
    state = json.loads((tmp_path / side / "pbt" / "experiment_state.json")
                       .read_text())
    return analysis, state


def _respawn_summary(analysis):
    return [(t.trial_id, t.config, t.status.value, t.training_iteration,
             # The same donor and step; the file formats differ.
             t.restore_base,
             t.restore_path and t.restore_path.rsplit(".", 1)[0].split("/")[-3:],
             [(r["training_iteration"], r[METRIC]) for r in t.results])
            for t in analysis.trials]


def test_run_respawn_pbt_decides_like_the_reference(tmp_path):
    want, want_state = _respawn_run(jax_tune, tmp_path)
    got, got_state = _respawn_run(tune, tmp_path)
    assert _respawn_summary(got) == _respawn_summary(want)
    assert got.best_config == want.best_config
    assert got_state["pbt"] == want_state["pbt"]
    requeued = [t for t in got.trials if t.restore_path]
    assert got_state["pbt"]["exploits"] == len(requeued) > 0
    assert all(t.status.value == "TERMINATED" for t in got.trials)
    for t in requeued:
        # Restored from a donor's checkpoint at the donor's progress, then
        # trained on to the budget under the mutated config.
        assert t.restore_path.split("/")[-3] != t.trial_id
        assert t.restore_base == FIRST_EPOCHS
        assert t.training_iteration == BUDGET


def test_donor_checkpoint_survives_retention(tmp_path):
    """keep_checkpoints_num=1 prunes every trial to its newest checkpoint,
    except one a requeued lagger points at; the sweep still ends as the
    JAX sweep with the same retention."""
    want, _ = _respawn_run(jax_tune, tmp_path, keep_checkpoints_num=1)
    got, _ = _respawn_run(tune, tmp_path, keep_checkpoints_num=1)
    assert _respawn_summary(got) == _respawn_summary(want)
    for t in got.trials:
        kept = list_checkpoints(str(tmp_path / "port" / "pbt" / t.trial_id
                                    / "checkpoints"))
        assert len(kept) == 1
    # Every lagger restored its donor's checkpoint, not a fallback: the
    # sweep reports what it reports when nothing is pruned.
    assert any(t.restore_path for t in got.trials)
    unpruned, _ = _respawn_run(tune, tmp_path / "unpruned")
    assert _respawn_summary(got) == _respawn_summary(unpruned)


def test_requeued_trial_resumes_from_the_donor_checkpoint(tmp_path,
                                                          monkeypatch):
    train, val = dummy_regression_data(num_samples=64, seq_len=8,
                                       num_features=4)
    space = {"model": "transformer", "d_model": 16, "num_heads": 2,
             "num_layers": 1, "dim_feedforward": 32, "dropout": 0.1,
             "attention_type": "flash", "batch_size": 16, "num_epochs": 4,
             "learning_rate": tune.loguniform(1e-5, 1e-1),
             "seed": tune.randint(0, 1000)}
    restored = {}
    make_epoch_fn = port_trainable.make_epoch_fn

    def spy(model, *args):
        # Called right after the restore: the weights the trial resumes on,
        # and (at its first epoch) the lr/wd its optimizer carries.
        trial = tune.session._get_session().trial
        epoch = make_epoch_fn(model, *args)
        if not trial.restore_path:
            return epoch
        entry = [trial.restore_path, trial.restore_base,
                 {k: p.detach().clone() for k, p in model.named_parameters()},
                 dict(trial.config), None]
        restored.setdefault(trial.trial_id, []).append(entry)

        def first_epoch(opt_state, *a):
            if entry[4] is None:
                entry[4] = {k: float(v) for k, v in
                            opt_state["hyperparams"].items()}
            return epoch(opt_state, *a)
        return first_epoch

    monkeypatch.setattr(port_trainable, "make_epoch_fn", spy)
    pbt = tune.PopulationBasedTraining(
        perturbation_interval=1, quantile_fraction=0.5, seed=1,
        hyperparam_mutations={"learning_rate": tune.loguniform(1e-5, 1e-1)})
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        space, metric=METRIC, num_samples=6, scheduler=pbt, seed=2,
        devices=[CPU] * 6, storage_path=str(tmp_path), name="respawn",
        verbose=0)
    assert all(t.status.value == "TERMINATED" for t in analysis.trials)
    assert restored, "no trial was requeued"
    root = tmp_path / "respawn"
    by_id = {t.trial_id: t for t in analysis.trials}
    for tid, restarts in restored.items():
        trial = by_id[tid]
        for path, base, weights, config, hyper in restarts:
            # The lagger's own (mutated) config wins over the restored
            # optimizer slots.
            assert hyper == {
                "learning_rate": float(np.float32(config["learning_rate"])),
                "weight_decay": float(np.float32(
                    config.get("weight_decay", 0.0)))}
            donor_dir = str(root / path.split("/")[-3])
            assert path.split("/")[-3] != tid, "restored its own checkpoint"
            assert path.startswith(donor_dir + "/checkpoints/")
            donor = load_checkpoint(path)
            for name, w in donor["params"].items():
                assert torch.equal(weights[name], w), name
            # The first record after the restart is restore_base + 1.
            after = [r for r in trial.results
                     if r["training_iteration"] == base + 1]
            assert after and after[-1]["epoch"] == base
    state = json.loads((root / "experiment_state.json").read_text())
    assert state["pbt"]["mode"] == "respawn"
    assert state["pbt"]["exploits"] == sum(map(len, restored.values()))


class _Store:
    def __init__(self):
        self.written = []

    def write_params(self, trial):
        pass

    def append_result(self, trial, metrics):
        self.written.append((trial.trial_id, metrics["training_iteration"]))

    def checkpoint_dir(self, trial):
        return f"/nowhere/{trial.trial_id}"


class _Searcher:
    def __init__(self):
        self.seen = []

    def suggest(self, i):
        return {"learning_rate": 1e-3 * (i + 1)}

    def on_trial_result(self, tid, config, metrics, metric, mode):
        self.seen.append((tid, dict(config)))

    def on_trial_complete(self, *args):
        pass


class _Requeue:
    def on_trial_add(self, trial):
        pass

    def on_trial_result(self, trial, metrics):
        trial.restore_path = "/donor/ckpt_000002.json"
        trial.restore_base = 2
        trial.config = {"learning_rate": 0.5}
        return "requeue"

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass


def test_lifecycle_requeues_on_completion_and_failure_keeps_the_donor():
    searcher = _Searcher()
    life = TrialLifecycle(searcher=searcher, scheduler=_Requeue(),
                          store=_Store(), metric=METRIC, mode="min",
                          num_samples=2, max_failures=1)
    trial = life.create_trial()
    life.pending.remove(trial)
    life.mark_running(trial)
    assert life.process_result(trial, {METRIC: 1.0}) == "stop"
    # The searcher saw the config that produced the metrics.
    assert searcher.seen == [("trial_00000", {"learning_rate": 1e-3})]
    assert life.complete_trial(trial) is True
    assert trial.status.value == "PENDING" and life.pending == [trial]
    assert trial.training_iteration == 2
    life.pending.remove(trial)
    life.mark_running(trial)
    assert life.complete_trial(trial) is False  # the flag was consumed
    assert trial.status.value == "TERMINATED"

    other = life.create_trial()
    life.pending.remove(other)
    life.mark_running(other)
    other.latest_checkpoint = "/own/ckpt_000001.json"
    other.latest_checkpoint_iteration = 1
    life.process_result(other, {METRIC: 1.0})
    assert life.fail_trial(other, "boom") is True
    # The failure consumed the pending requeue and kept the donor target.
    assert other.restore_path == "/donor/ckpt_000002.json"
    assert other.restore_base == 2
    assert not other._requeue_on_complete
    assert life.pending == [other]
