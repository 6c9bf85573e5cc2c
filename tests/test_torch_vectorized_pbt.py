"""Vectorized PBT in the port's ``run_vectorized`` against the JAX package's.

* The decision layer: the JAX ``_run_population`` and the port's, each
  driven by a scripted program that stands in for training (the rows'
  metrics are float32 functions of the lr each row trains with, its
  identity and its epoch, so exploits and explores show in what it
  reports), with PBT compiled and on the boundary path, NaN rows, two
  mutated keys in mode max, an interval that does not divide the epochs,
  ``train_loss`` as the metric, a ``stop=`` rule, list specs and PB2: the
  same generation log, records, donor notes, counters, configs and
  ``best_config``.  The port's compiled path runs its real device step
  (``_regression_program.make_pbt_generation_fn``) on the script.
* One real generation (dropout off, widely spaced lr per row) against the
  JAX ``make_pbt_generation_fn``: the same ``src`` and new lr, the
  parameters after the gather within the f32 tolerance stated below.
* A real sweep on a tiny transformer (dropout on): compiled and boundary
  decide the same in the port; the counters, the ``pbt`` block of
  ``experiment_state.json`` and the gather's identity rule.
* The refusals: ``quality_after_quant`` names A8, ``pbt_mode="compiled"``
  with PB2 or ``stop=`` raises, a mutation of a program key raises.

No JAX ``run_vectorized`` or ``tune.run`` is called; the JAX cache
variable points into ``tmp_path`` all the same (``restore_global_state``).
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tune_common import restore_global_state  # noqa: F401

torch = pytest.importorskip("torch")
# The first torch.func grad imports torch._dynamo, which sets
# TORCHINDUCTOR_CACHE_DIR: import it before restore_global_state takes its
# snapshot of the environment.
import torch._dynamo  # noqa: E402,F401

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.data import (  # noqa: E402
    dummy_regression_data as jax_dummy,
)
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    population_from_flax,
)
from distributed_machine_learning_tpu_torch.tune import vectorized as port_vec  # noqa: E402
from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (  # noqa: E402
    generation_draw_count,
    generation_draws,
)
from distributed_machine_learning_tpu_torch.tune.stoppers import (  # noqa: E402
    resolve_stop as port_resolve_stop,
)

jax_vec = importlib.import_module("distributed_machine_learning_tpu.tune.vectorized")
jax_trial = importlib.import_module("distributed_machine_learning_tpu.tune.trial")
jax_experiment = importlib.import_module(
    "distributed_machine_learning_tpu.tune.experiment")
jax_stoppers = importlib.import_module(
    "distributed_machine_learning_tpu.tune.stoppers")
jax_program = importlib.import_module(
    "distributed_machine_learning_tpu.tune._regression_program")

CPU = torch.device("cpu")
METRIC = "validation_mape"
ROWS, STEPS = 8, 3
C = np.float32(3e-3)
NAN_ROW = 3


# -- (a) the decision layer on a scripted program ------------------------------
#
# Row k's metrics after epoch e (0-based), trained with lr: float32
# divisions, sums and an abs only (no fusable multiply-add, no division by
# a constant XLA could turn into a multiply), so XLA and torch compute
# the same bits.

def _jax_metrics(lr, row, e, nan_row):
    ef = e.astype(jnp.float32)
    mape = (jnp.abs(lr - C) * jnp.float32(1024) / (ef + jnp.float32(1))
            + row / jnp.float32(16))
    if nan_row is not None:
        mape = jnp.where(row == jnp.float32(nan_row), jnp.float32(jnp.nan),
                         mape)
    tl = jnp.abs(lr - C) / (ef + jnp.float32(2)) + row / jnp.float32(8)
    return tl, mape


def _port_metrics(lr, row, e, nan_row):
    ef = e.to(torch.float32)
    mape = (torch.abs(lr - torch.tensor(C)) * torch.tensor(np.float32(1024))
            / (ef + 1) + row / 16)
    if nan_row is not None:
        mape = torch.where(row == nan_row, torch.tensor(float("nan")), mape)
    tl = torch.abs(lr - torch.tensor(C)) / (ef + 2) + row / 8
    return tl, mape


class _Opt(NamedTuple):
    hyperparams: dict


class _JaxScripted:
    """Stands in for the JAX ``_GroupProgram``: per-row state carries the
    row's identity (params), its epoch and the lr it last trained with
    (batch stats), so every gather carries them along."""

    data = SimpleNamespace(x_train=None, y_train=None, x_val=None,
                           y_val=None, val_mask=None)

    def __init__(self, num_epochs, nan_row=None):
        self.num_epochs = num_epochs
        self.steps_per_epoch = STEPS
        self.total_steps = num_epochs * STEPS
        self.dispatch_obs = []
        self.nan_row = nan_row

        def epoch_one(p, o, b, x, y, key):
            lr = o.hyperparams["learning_rate"]
            tl, _ = _jax_metrics(lr, p["row"], b["epoch"], self.nan_row)
            return p, o, {"epoch": b["epoch"] + 1, "lr": lr}, tl

        def eval_one(p, b, xv, yv, mask):
            _, mape = _jax_metrics(b["lr"], p["row"], b["epoch"] - 1,
                                   self.nan_row)
            return {METRIC: mape}

        self._epoch_one, self._eval_one = epoch_one, eval_one

    def shape_schedule(self, step):
        return 1.0 - step / self.total_steps

    def init_population(self, keys, lrs, wds):
        k = lrs.shape[0]
        return ({"row": jnp.arange(k, dtype=jnp.float32)},
                _Opt({"learning_rate": jnp.asarray(lrs, jnp.float32),
                      "weight_decay": jnp.asarray(wds, jnp.float32)}),
                {"epoch": jnp.zeros(k, jnp.int32),
                 "lr": jnp.asarray(lrs, jnp.float32)})

    def train_epoch(self, p, o, b, x, y, keys):
        return jax.vmap(self._epoch_one, in_axes=(0, 0, 0, None, None, 0))(
            p, o, b, x, y, keys)

    def eval_population(self, p, b, xv, yv, mask):
        return jax.vmap(self._eval_one, in_axes=(0, 0, None, None, None))(
            p, b, xv, yv, mask)

    def train_epochs(self, p, o, b, keys, x, y, xv, yv, mask, epoch_ids):
        tls, ms = [], []
        for _ in range(len(epoch_ids)):
            p, o, b, tl = self.train_epoch(p, o, b, x, y, keys)
            tls.append(tl)
            ms.append(self.eval_population(p, b, xv, yv, mask)[METRIC])
        return p, o, b, jnp.stack(tls, 1), {METRIC: jnp.stack(ms, 1)}

    def pbt_generation_program(self, spec, *, interval, n_gens, n_rows,
                               n_valid, metric, objective, log):
        run = jax.jit(jax_program.make_pbt_generation_fn(
            self._epoch_one, self._eval_one, spec, interval=interval,
            num_epochs_total=self.num_epochs, metric=metric, n_rows=n_rows,
            n_valid=n_valid))
        return run, "scripted"


class _PortScripted(port_vec._GroupProgram):
    """The same script behind the port's ``_GroupProgram``: its epoch and
    eval replace the model's, and the rest (permutations, the read back,
    the gather, the device generation step) is the real program's.  The
    scripted MAPE travels in the APE column of the eval sums; with 100
    validation rows ``100 * ape / 100`` gives back its float32 bits."""

    def __init__(self, num_epochs, nan_row=None):
        self.device = CPU
        self.loss_name = "mse"
        self.num_epochs = num_epochs
        self.steps_per_epoch = STEPS
        self.total_steps = num_epochs * STEPS
        self._n_val = 100
        self.data = SimpleNamespace(x_train=None, y_train=None, x_val=None,
                                    y_val=None, val_mask=None, n_train=4)
        self.dispatch_obs = []

        def epoch(params, opt_state, x, y, perms, stream_seeds, step0):
            lr = opt_state["hyperparams"]["learning_rate"]
            tl, _ = _port_metrics(lr, params["row"], params["epoch"],
                                  nan_row)
            params["epoch"] += 1
            params["lr"].copy_(lr)
            return tl

        def evaluate(params, x, y, mask):
            _, mape = _port_metrics(params["lr"], params["row"],
                                    params["epoch"] - 1, nan_row)
            zeros = torch.zeros_like(mape)
            return torch.stack([zeros, zeros, mape, zeros], dim=1)

        self._epoch, self._eval = epoch, evaluate

    def shape_schedule(self, step):
        return 1.0 - step / self.total_steps

    def init_population(self, seeds, lrs, wds):
        k = len(seeds)
        lrs = torch.as_tensor(np.asarray(lrs, np.float32))
        return port_vec.PopulationState(
            params={"row": torch.arange(k, dtype=torch.float32),
                    "epoch": torch.zeros(k, dtype=torch.int32),
                    "lr": lrs.clone()},
            opt_state={"count": 0, "hyperparams": {
                "learning_rate": lrs.clone(),
                "weight_decay": torch.as_tensor(np.asarray(wds,
                                                           np.float32))}},
            stream_seeds=torch.arange(k, dtype=torch.int64),
            seeds=[int(s) for s in seeds])

    def host_metrics(self, host):
        return host[..., 0].astype(np.float32), {
            METRIC: host[..., 3].astype(np.float64)}


class _NoCompiles:
    def thread_seconds(self):
        return 0.0

    def max_backend_compile_s(self):
        return 0.0


def _lr_space(mod):
    return {"learning_rate": mod.loguniform(1e-4, 1e-1)}


def _two_keys(mod):
    return {"learning_rate": mod.loguniform(1e-4, 1e-1),
            "weight_decay": mod.uniform(0.0, 1e-2)}


# name: (scheduler kind, mutations, pbt_mode, mode, metric, epochs,
#        interval, nan row, stop)
CASES = {
    "compiled": ("pbt", _lr_space, "auto", "min", METRIC, 8, 2, None, None),
    "boundary": ("pbt", _lr_space, "boundary", "min", METRIC, 8, 2, None,
                 None),
    "compiled_nan": ("pbt", _lr_space, "auto", "min", METRIC, 8, 2, NAN_ROW,
                     None),
    "boundary_nan": ("pbt", _lr_space, "boundary", "min", METRIC, 8, 2,
                     NAN_ROW, None),
    "two_keys_max": ("pbt", _two_keys, "compiled", "max", METRIC, 8, 2,
                     None, None),
    "ragged_interval": ("pbt", _two_keys, "auto", "min", METRIC, 8, 3, None,
                        None),
    "ragged_boundary": ("pbt", _two_keys, "boundary", "min", METRIC, 8, 3,
                        None, None),
    "train_loss": ("pbt", _lr_space, "auto", "min", "train_loss", 6, 2, None,
                   None),
    "stop_rule": ("pbt", _lr_space, "auto", "min", METRIC, 8, 2, None,
                  {"training_iteration": 6}),
    "list_spec": ("pbt", lambda mod: {"learning_rate": [1e-4, 1e-3, 1e-2,
                                                        1e-1]},
                  "auto", "min", METRIC, 8, 2, None, None),
    "pb2": ("pb2", _lr_space, "auto", "min", METRIC, 8, 2, None, None),
}


def _run_case(name, side, tmp_path):
    kind, mutations, pbt_mode, mode, metric, epochs, interval, nan_row, stop \
        = CASES[name]
    pkg = jax_tune if side == "jax" else tune
    cls = pkg.PB2 if kind == "pb2" else pkg.PopulationBasedTraining
    pbt = cls(metric=metric, perturbation_interval=interval,
              hyperparam_mutations=mutations(pkg), quantile_fraction=0.25,
              seed=9, **({"num_candidates": 32} if kind == "pb2" else {}))
    pbt.set_experiment(METRIC, mode)
    searcher = pkg.RandomSearch()
    searcher.set_search_space(pkg.SearchSpace({"learning_rate": 1e-3}), 0)
    store = pkg.ExperimentStore(str(tmp_path / side), name)
    lrs = np.geomspace(1e-4, 1e-1, ROWS)[[3, 7, 0, 5, 1, 6, 2, 4]]
    trial_cls = jax_trial.Trial if side == "jax" else tune.Trial
    batch = [trial_cls(trial_id=f"trial_{i:05d}",
                       config={"learning_rate": float(lr), "seed": i,
                               "weight_decay": 1e-3})
             for i, lr in enumerate(lrs)]
    for t in batch:
        pbt.on_trial_add(t)
    spec = pbt.device_mutation_spec()
    counters = {"generations": 0, "exploits": 0, "explores": 0,
                "host_dispatches": 0}
    compiled = pbt_mode != "boundary" and spec is not None and stop is None
    logs = []
    if side == "jax":
        stop_rules = jax_stoppers.resolve_stop(stop)
        jax_vec._run_population(
            _JaxScripted(epochs, nan_row), batch, pbt, searcher, store,
            METRIC, mode, logs.append, _NoCompiles(), "always", 1, None,
            None, pbt, "auto", 0, None, None, stop_rules=stop_rules,
            pbt_compiled=compiled, pbt_spec=spec, pbt_counters=counters)
        analysis = jax_experiment.ExperimentAnalysis(batch, METRIC, mode)
    else:
        port_compiled, port_spec, port_counters = port_vec._resolve_pbt_mode(
            pbt, pbt_mode, mode, stop)
        assert (port_compiled, port_spec, port_counters) == \
            (compiled, spec, counters)
        port_vec._run_population(
            _PortScripted(epochs, nan_row), batch, pbt, searcher, store,
            METRIC, mode, logs.append, "always",
            stop_rules=port_resolve_stop(stop), pbt=pbt,
            pbt_compiled=compiled, pbt_spec=spec, pbt_counters=counters,
            epochs_per_dispatch="auto")
        analysis = tune.ExperimentAnalysis(batch, METRIC, mode)
    store.close()
    return SimpleNamespace(
        batch=batch, counters=counters, log=pbt._generation_log,
        debug=pbt.debug_state(), best=analysis.best_config,
        pbt_lines=[m for m in logs if m.startswith("PBT epoch")
                   or "compacted" in m])


def _assert_same_log(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(np.asarray(g[k]), v, err_msg=k)
                if v.dtype.kind == "f":  # bit for bit (src: int32 or 64)
                    assert np.asarray(g[k]).dtype == v.dtype, k
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_population_pbt_decides_as_the_jax_runner(name, tmp_path):
    want = _run_case(name, "jax", tmp_path)
    got = _run_case(name, "port", tmp_path)
    assert got.counters == want.counters
    assert got.debug == want.debug
    assert got.best == want.best
    _assert_same_log(got.log, want.log)
    assert [m.replace(" (on the device)", " (in-device)")
            for m in got.pbt_lines] == want.pbt_lines
    for a, b in zip(got.batch, want.batch):
        assert a.config == b.config
        assert a.status.value == b.status.value == "TERMINATED"
        assert a.training_iteration == b.training_iteration
        assert len(a.results) == len(b.results)
        for ra, rb in zip(a.results, b.results):
            assert set(ra) == set(rb)
            for k, v in rb.items():
                if k in ("timestamp", "time_total_s"):
                    continue
                if isinstance(v, float) and np.isnan(v):
                    assert np.isnan(ra[k]), k
                else:
                    assert ra[k] == v, k
    assert want.counters["exploits"] > 0
    if name.startswith("compiled") or name in ("two_keys_max",
                                               "train_loss"):
        assert want.counters["host_dispatches"] == 1
    if name.endswith("nan"):
        # The NaN row never donates and is rescued at the first generation.
        first = want.log[0] if want.log else None
        if first is not None:
            assert first["exploited"][NAN_ROW]
            assert NAN_ROW not in set(first["src"][first["exploited"]])


def test_compiled_and_boundary_make_the_same_decisions_in_the_port(
        tmp_path):
    # (With an interval that does not divide the epochs the boundary path
    # rounds its dispatch down and perturbs late, as the JAX runner does.)
    for a, b in (("compiled", "boundary"), ("compiled_nan", "boundary_nan")):
        c = _run_case(a, "port", tmp_path / a)
        bd = _run_case(b, "port", tmp_path / b)
        fired = [e for e in c.log if e["fire"]]
        _assert_same_log(fired, bd.log)
        assert not any(e["exploited"].any() for e in c.log if not e["fire"])
        assert [t.config for t in c.batch] == [t.config for t in bd.batch]
        assert c.best == bd.best
        assert c.counters["exploits"] == bd.counters["exploits"] > 0
        assert c.counters["host_dispatches"] < bd.counters["host_dispatches"]


# -- (b) one real generation against the JAX generation step -------------------

DATA = dict(num_samples=40, seq_len=12, num_features=4)
MODEL = dict(model="transformer", d_model=16, num_heads=2, num_layers=1,
             dim_feedforward=32, dropout=0.0, max_seq_length=16,
             batch_size=8, num_epochs=3, lr_schedule="constant",
             loss_function="mse", attention_type="flash")
# Widely spaced lr per row, so the rows' scores sit far apart and the
# ranking cannot flip on f32 rounding.
GEN_LRS = np.geomspace(1e-4, 3e-2, 8).astype(np.float32)[[5, 0, 7, 2, 6, 1,
                                                           4, 3]]
# The parameters after one epoch and the gather: the batched products sum
# in other orders in XLA and torch (tests/test_torch_vectorized.py).
GEN_ATOL = 1e-4


def test_one_generation_matches_the_jax_generation_step():
    rows = len(GEN_LRS)
    wds = np.full(rows, 1e-4, np.float32)
    seeds = list(range(rows))
    pbt = tune.PopulationBasedTraining(
        perturbation_interval=1, quantile_fraction=0.25, seed=4,
        hyperparam_mutations={"learning_rate": tune.loguniform(1e-4, 3e-2)})
    pbt.set_experiment(METRIC, "min")
    spec = pbt.device_mutation_spec()
    cfg = dict(MODEL, learning_rate=float(GEN_LRS[0]), weight_decay=1e-4,
               seed=0)

    train, val = jax_dummy(**DATA)
    jprog = jax_vec._GroupProgram(cfg, train, val)
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    params, opt, bs = jprog.init_population(keys, jnp.asarray(GEN_LRS),
                                            jnp.asarray(wds))
    params0 = jax.tree.map(np.asarray, params)
    epoch_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(k)[0], jprog.data.n_train)) for k in epoch_keys])
    pbt_keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.key(pbt.seed), i))(jnp.arange(rows))
    run = jax.jit(jax_program.make_pbt_generation_fn(
        jprog._epoch_one, jprog._eval_one, spec, interval=1,
        num_epochs_total=3, metric=METRIC, n_rows=rows, n_valid=rows))
    d = jprog.data
    jparams, _, _, jlr, _, ys = run(
        params, opt, bs, keys, pbt_keys, jnp.asarray(GEN_LRS),
        jnp.asarray(wds), d.x_train, d.y_train, d.x_val, d.y_val,
        d.val_mask, jnp.arange(0, 1), jnp.float32(1.0))
    want_scores, want_src, want_lr, want_ex = (
        np.asarray(ys[i])[0] for i in (2, 3, 4, 6))

    ptrain, pval = dummy_regression_data(**DATA)
    program = port_vec._GroupProgram(cfg, ptrain, pval, CPU)
    state = program.init_population(seeds, GEN_LRS, wds)
    state.params.update(population_from_flax(params0))
    stream_seeds = state.stream_seeds.clone()
    run_state = program.pbt_generation_program(
        spec, interval=1, valid=np.ones(rows, bool), metric=METRIC)
    draws = generation_draws(pbt.seed, rows, 0, generation_draw_count(spec))
    state, outputs = run_state(
        state, torch.from_numpy(GEN_LRS), torch.from_numpy(wds),
        torch.from_numpy(perms).long()[None], torch.from_numpy(draws)[None],
        0, torch.tensor(np.float32(1.0)))
    (gen,) = port_vec._read_generations(outputs, program)

    order = np.sort(want_scores)
    assert np.min(np.diff(order) / np.abs(order[1:])) > 1e-3
    np.testing.assert_allclose(gen["scores"], want_scores, rtol=1e-5)
    np.testing.assert_array_equal(gen["src"], want_src)
    np.testing.assert_array_equal(gen["exploited"], want_ex)
    np.testing.assert_array_equal(gen["new_lr"].view(np.uint32),
                                  want_lr.view(np.uint32))
    assert want_ex.sum() == 2 and (want_src != np.arange(rows)).sum() == 2
    # The optimizer carries the new lr; the rows keep their own streams.
    np.testing.assert_array_equal(
        state.opt_state["hyperparams"]["learning_rate"].numpy(), want_lr)
    assert torch.equal(state.stream_seeds, stream_seeds)
    want = population_from_flax(jax.tree.map(np.asarray, jparams))
    for k, w in want.items():
        got = state.params[k]
        if k.endswith("attention.key.bias"):
            # Zero in exact arithmetic (tests/test_torch_train.py).
            bound = float(GEN_LRS.max()) * program.steps_per_epoch
            assert got.abs().max() <= bound and w.abs().max() <= bound
            continue
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=GEN_ATOL,
                                   err_msg=k)
    # The moments followed the same gather.
    for i, s in enumerate(want_src):
        for k, mu in state.opt_state["mu"].items():
            assert torch.equal(mu[i], mu[int(s)]), k


# -- (c) a real sweep ------------------------------------------------------------

def _sweep(tmp_path, name, scheduler, **extra):
    train, val = dummy_regression_data(**DATA)
    space = dict(MODEL, dropout=0.1, num_epochs=6,
                 lr_schedule="warmup_linear_decay", warmup_steps=2,
                 learning_rate=tune.loguniform(1e-4, 1e-1),
                 weight_decay=tune.loguniform(1e-6, 1e-3),
                 seed=tune.randint(0, 1000))
    analysis = tune.run_vectorized(
        space, train_data=train, val_data=val, metric=METRIC,
        num_samples=8, max_batch_trials=8, scheduler=scheduler,
        storage_path=str(tmp_path), name=name, seed=2, device="cpu",
        verbose=0, **extra)
    state = json.loads((tmp_path / name / "experiment_state.json")
                       .read_text())
    return analysis, state


def _pbt(interval=2):
    return tune.PopulationBasedTraining(
        perturbation_interval=interval, quantile_fraction=0.25, seed=3,
        hyperparam_mutations={
            "learning_rate": tune.loguniform(1e-4, 1e-1),
            "weight_decay": tune.loguniform(1e-6, 1e-3)})


def _notes(analysis):
    return sorted((t.trial_id, r["training_iteration"],
                   r["pbt_exploited_from"]) for t in analysis.trials
                  for r in t.results if "pbt_exploited_from" in r)


def test_a_real_sweep_decides_the_same_compiled_and_on_the_boundary(
        tmp_path):
    runs = {}
    for mode in ("auto", "boundary"):
        pbt = _pbt()
        analysis, state = _sweep(tmp_path, mode, pbt, pbt_mode=mode)
        runs[mode] = (analysis, state["pbt"], pbt._generation_log)
    (c, cb, clog), (b, bb, blog) = runs["auto"], runs["boundary"]
    assert cb["mode"] == "compiled" and bb["mode"] == "boundary"
    assert (cb["host_dispatches"], bb["host_dispatches"]) == (1, 3)
    assert (cb["generations"], bb["generations"]) == (3, 2)
    assert cb["exploits"] == bb["exploits"] == cb["num_perturbations"] > 0
    assert cb["explores"] == 2 * cb["exploits"]
    _assert_same_log([e for e in clog if e["fire"]], blog)
    assert _notes(c) == _notes(b) and len(_notes(c)) == cb["exploits"]
    assert c.best_config == b.best_config
    for tc, tb in zip(c.trials, b.trials):
        assert tc.config == tb.config
        assert [r["train_loss"] for r in tc.results] == \
            [r["train_loss"] for r in tb.results]
    # A lagger keeps its own seed; its config is the donor's, mutated.
    lagger = next(t for t in c.trials
                  if any("pbt_exploited_from" in r for r in t.results))
    assert lagger.config["seed"] == runs["boundary"][0].trials[
        c.trials.index(lagger)].config["seed"]


def test_pb2_and_list_specs_run_on_the_boundary_path(tmp_path):
    pb2 = tune.PB2(perturbation_interval=2, quantile_fraction=0.25, seed=6,
                   hyperparam_mutations={
                       "learning_rate": tune.loguniform(1e-4, 1e-1)})
    analysis, state = _sweep(tmp_path, "pb2", pb2)
    assert analysis.num_terminated() == 8
    assert state["pbt"]["mode"] == "boundary"
    assert state["pbt"]["num_observations"] > 0
    assert state["pbt"]["num_perturbations"] > 0
    for t in analysis.trials:
        assert 1e-4 <= t.config["learning_rate"] <= 1e-1 + 1e-12


def test_gather_rows_moves_state_but_not_identity():
    train, val = dummy_regression_data(**DATA)
    program = port_vec._GroupProgram(dict(MODEL, dropout=0.1), train, val,
                                     CPU)
    state = program.init_population([5, 6, 7, 8], [1e-3] * 4, [0.0] * 4)
    program.train_epoch(state, 0)
    src = [0, 0, 3, 3]
    new = program.gather_rows(state, src, [1e-3, 2e-3, 3e-3, 4e-3],
                              [0.0, 1e-4, 0.0, 1e-4])
    for k, v in state.params.items():
        assert torch.equal(new.params[k], v[src]), k
    for k, v in state.opt_state["nu"].items():
        assert torch.equal(new.opt_state["nu"][k], v[src]), k
    assert new.opt_state["count"] == state.opt_state["count"] > 0
    np.testing.assert_array_equal(
        new.opt_state["hyperparams"]["learning_rate"].numpy(),
        np.float32([1e-3, 2e-3, 3e-3, 4e-3]))
    assert torch.equal(new.stream_seeds, state.stream_seeds)
    assert new.seeds == state.seeds == [5, 6, 7, 8]


# -- (d) refusals ----------------------------------------------------------------

def test_refusals_name_their_reason(tmp_path):
    train, val = dummy_regression_data(**DATA)
    kwargs = dict(train_data=train, val_data=val, metric=METRIC,
                  device="cpu", storage_path=str(tmp_path), verbose=0,
                  num_samples=4)
    space = dict(MODEL, learning_rate=tune.loguniform(1e-4, 1e-1))
    quant = tune.PopulationBasedTraining(
        hyperparam_mutations=_lr_space(tune), objective="quality_after_quant")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8$"):
        tune.run_vectorized(space, scheduler=quant, **kwargs)
    pb2 = tune.PB2(hyperparam_mutations=_lr_space(tune))
    with pytest.raises(ValueError, match="compiled.*impossible.*PB2"):
        tune.run_vectorized(space, scheduler=pb2, pbt_mode="compiled",
                            **kwargs)
    with pytest.raises(ValueError, match="compiled.*impossible.*stop="):
        tune.run_vectorized(space, scheduler=_pbt(), pbt_mode="compiled",
                            stop={"training_iteration": 2}, **kwargs)
    program_key = tune.PopulationBasedTraining(
        hyperparam_mutations={"dropout": tune.uniform(0.0, 0.5)})
    with pytest.raises(ValueError, match="learning_rate/weight_decay"):
        tune.run_vectorized(space, scheduler=program_key, **kwargs)
    latency = tune.PopulationBasedTraining(
        hyperparam_mutations=_lr_space(tune), objective="quality_latency")
    with pytest.raises(ValueError, match="mode='min'"):
        tune.run_vectorized(space, scheduler=latency, mode="max", **kwargs)
    with pytest.raises(ValueError, match="pbt_mode must be"):
        tune.run_vectorized(space, scheduler=_pbt(), pbt_mode="eager",
                            **kwargs)
    assert not list(tmp_path.iterdir())


def test_multi_objective_scales_scores_and_records(tmp_path):
    """``quality_latency_params``: every row's score is its metric times
    one float32 factor (step time x parameter count, the same for every
    row), and each record carries that product as ``pbt_objective``."""
    pbt = tune.PopulationBasedTraining(
        perturbation_interval=2, quantile_fraction=0.25, seed=3,
        hyperparam_mutations=_lr_space(tune),
        objective="quality_latency_params")
    analysis, state = _sweep(tmp_path, "objective", pbt)
    assert state["pbt"]["objective"] == "quality_latency_params"
    first = analysis.trials[0].results[0]
    scale = np.float32(first["pbt_objective"]) / np.float32(first[METRIC])
    assert scale != 1
    for t in analysis.trials:
        for r in t.results:
            np.testing.assert_allclose(
                np.float32(r["pbt_objective"]),
                np.float32(r[METRIC]) * scale, rtol=1e-6)
    # Generation 0 ranked the records of epoch 1, scaled.
    e = pbt._generation_log[0]
    np.testing.assert_array_equal(
        e["scores"], np.float32([t.results[1]["pbt_objective"]
                                 for t in analysis.trials]))
