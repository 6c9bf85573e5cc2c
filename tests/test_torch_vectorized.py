"""The port's vectorized runner against the JAX package's.

* The population optimizer: row k against the one-trial optimizer fed row
  k's values, with and without clipping (rtol 1e-6).
* One population epoch (dropout 0) with the JAX program's own
  permutations fed in: each row against the JAX ``_GroupProgram``'s
  ``vmap``ped epoch on the same weights (``population_from_flax``), for
  ``scaled_dot_product`` and ``flash``; and each row of a whole
  ``run_vectorized`` sweep against the port's own ``train_regressor`` on
  that config (which tests/test_torch_train.py holds to the JAX trainable).
* The decision layer: ``_static_signature``, ``_stopper_epoch_fraction``
  and the JAX ``_run_population`` itself (records, ASHA stops, compaction
  points, ``best_config``) driven by a scripted program that stands in for
  training, against the port's ``_run_population`` with the same script.
* Row independence: the dropout masks bit-equal across population sizes
  and compaction, and a trial's trajectory the same alone, in a
  population and in one that compacted around it (f32, ``ROW_TOL``).
* Every refused knob raises by name; the JAX reader reads a port
  vectorized experiment.

Every JAX oracle runs with ``DML_TPU_COMPILE_CACHE`` in ``tmp_path``
(``restore_global_state``); no JAX ``run_vectorized`` is called.
"""

from __future__ import annotations

import importlib
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
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
    stack_rows,
    unstack_rows,
)
from distributed_machine_learning_tpu_torch.ops import optimizers as port_opt  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import rng as port_rng  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import schedules  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import vectorized as port_vec  # noqa: E402
from distributed_machine_learning_tpu_torch.tune.checkpoint import (  # noqa: E402
    load_checkpoint,
)

jax_vec = importlib.import_module("distributed_machine_learning_tpu.tune.vectorized")
jax_trial = importlib.import_module("distributed_machine_learning_tpu.tune.trial")
jax_experiment = importlib.import_module(
    "distributed_machine_learning_tpu.tune.experiment")

CPU = torch.device("cpu")
DATA = dict(num_samples=40, seq_len=12, num_features=4)
MODEL = dict(model="transformer", d_model=16, num_heads=2, num_layers=2,
             dim_feedforward=32, dropout=0.0, max_seq_length=16,
             batch_size=8, num_epochs=2, lr_schedule="warmup_linear_decay",
             warmup_steps=2, loss_function="mse")
LRS = (1e-3, 3e-3, 1e-2)
WDS = (0.0, 1e-4, 1e-3)
# A trial's f32 trajectory alone, in a population, and after compaction:
# the batched products sum in other orders, so the final parameters and
# metrics agree to this share of their largest entry.
ROW_TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- (b) the population optimizer --------------------------------------------

@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("name,momentum", [("adam", 0.0), ("adamw", 0.0),
                                           ("sgd", 0.9), ("rmsprop", 0.5)])
def test_population_optimizer_row_equals_the_one_trial_optimizer(
        name, momentum, clip):
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,), "s": ()}
    rows = len(LRS)
    sched = schedules.get_schedule("warmup_linear_decay", learning_rate=1.0,
                                   warmup_steps=1, total_steps=5)
    params = {k: torch.from_numpy(rng.normal(size=(rows, *s)).astype(
        np.float32)) for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.normal(size=(rows, *s)).astype(
        np.float32)) for k, s in shapes.items()} for _ in range(3)]
    pop = port_opt.PopulationOptimizer(name, sched, momentum, clip)
    pop_params = {k: v.clone() for k, v in params.items()}
    state = port_opt.set_injected_hyperparams(pop.init(pop_params),
                                              np.float32(LRS), np.float32(WDS))
    assert state["hyperparams"]["learning_rate"].shape == (rows,)
    for g in grads:
        port_opt.apply_updates(pop_params, pop.update(g, state, pop_params))
    assert state["count"] == 3
    for r in range(rows):
        one = port_opt.make_injected_optimizer(name, sched, momentum, clip)
        p = {k: v[r].clone() for k, v in params.items()}
        st = port_opt.set_injected_hyperparams(one.init(p), LRS[r], WDS[r])
        for g in grads:
            port_opt.apply_updates(p, one.update({k: v[r] for k, v in
                                                  g.items()}, st, p))
        for k in shapes:
            np.testing.assert_allclose(pop_params[k][r].numpy(), p[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_take_rows_cuts_every_stacked_leaf():
    pop = port_opt.PopulationOptimizer(
        "adam", schedules.get_schedule("constant", learning_rate=1.0))
    params = {"w": torch.arange(12.0).reshape(4, 3)}
    state = port_opt.set_injected_hyperparams(
        pop.init(params), np.float32([1, 2, 3, 4]), np.float32([5, 6, 7, 8]))
    state["mu"]["w"] += torch.arange(4.0)[:, None]
    cut = port_opt.take_rows(state, torch.tensor([1, 3]))
    assert cut["hyperparams"]["learning_rate"].tolist() == [2, 4]
    assert cut["hyperparams"]["weight_decay"].tolist() == [6, 8]
    assert cut["mu"]["w"][:, 0].tolist() == [1, 3]
    assert cut["nu"]["w"].shape == (2, 3) and cut["count"] == 0


# -- (c) one population epoch against the JAX program -------------------------

def _jax_population(cfg, seeds):
    train, val = jax_dummy(**DATA)
    program = jax_vec._GroupProgram(cfg, train, val)
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    params, opt, bs = program.init_population(
        keys, jnp.asarray(LRS, jnp.float32), jnp.asarray(WDS, jnp.float32))
    params0 = jax.tree.map(np.asarray, params)
    epoch_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(k)[0], program.data.n_train)) for k in epoch_keys])
    d = program.data
    params, opt, bs, tl = program.train_epoch(params, opt, bs, d.x_train,
                                              d.y_train, epoch_keys)
    metrics = program.eval_population(params, bs, d.x_val, d.y_val,
                                      d.val_mask)
    return (params0, perms, np.asarray(tl),
            {k: np.asarray(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("attention", ["scaled_dot_product", "flash"])
def test_population_epoch_matches_the_jax_group_program(attention):
    cfg = dict(MODEL, attention_type=attention, learning_rate=LRS[0],
               weight_decay=0.0, seed=0)
    params0, perms, want_tl, want_m, want_params = _jax_population(
        cfg, [0, 1, 2])
    train, val = dummy_regression_data(**DATA)
    program = port_vec._GroupProgram(cfg, train, val, CPU)
    state = program.init_population([0, 1, 2], LRS, WDS)
    state.params.update(population_from_flax(params0))
    tl = program.train_epoch(state, 0, perms=torch.from_numpy(perms).long())
    sums = program.eval_sums(state).numpy().astype(np.float64)
    np.testing.assert_allclose(tl.numpy(), want_tl, rtol=1e-5)
    n_val = len(val)
    for r in range(3):
        got = port_vec.eval_metrics_from_sums("mse", *sums[r], n_val)
        for k, v in got.items():
            np.testing.assert_allclose(v, want_m[k][r], rtol=1e-5,
                                       err_msg=f"row {r} {k}")
    want = population_from_flax(want_params)
    for k, w in want.items():
        got = state.params[k]
        if k.endswith("attention.key.bias"):
            # Zero in exact arithmetic (tests/test_torch_train.py): both
            # stay within the steps Adam can take.
            bound = max(LRS) * program.steps_per_epoch
            assert got.abs().max() <= bound and w.abs().max() <= bound
            continue
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-4,
                                   err_msg=k)


def test_rows_of_a_sweep_match_train_regressor(tmp_path):
    """Dropout 0: each row of a ``run_vectorized`` sweep trains as
    ``train_regressor`` trains that config alone (same init, shuffles and
    updates), to f32 rounding."""
    train, val = dummy_regression_data(**DATA)
    space = dict(MODEL, attention_type="flash",
                 learning_rate=tune.choice(list(LRS)),
                 weight_decay=tune.choice(list(WDS)),
                 seed=tune.randint(0, 1000))
    analysis = tune.run_vectorized(
        space, train_data=train, val_data=val, metric="validation_mape",
        num_samples=3, max_batch_trials=3, storage_path=str(tmp_path),
        name="rows", device="cpu", verbose=0)
    assert analysis.num_terminated() == 3
    for trial in analysis.trials:
        records = []
        trainable = tune.with_parameters(tune.train_regressor,
                                         train_data=train, val_data=val)
        with tune.session.standalone(
                devices=[CPU], report_fn=lambda m, c: records.append(m)):
            trainable(dict(trial.config, checkpoint_freq=0))
        assert len(records) == len(trial.results) == MODEL["num_epochs"]
        for got, want in zip(trial.results, records):
            for k in ("train_loss", "validation_mape", "validation_mse",
                      "lr", "steps"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)


# -- (d) the decision layer --------------------------------------------------

CONFIGS = [
    dict(MODEL, learning_rate=1e-3, seed=1),
    dict(MODEL, learning_rate=2e-3, seed=2, weight_decay=1e-4),
    dict(MODEL, learning_rate=1e-3, seed=3, d_model=32),
    dict(MODEL, learning_rate=1e-3, seed=4, head=[8, 4]),
    dict(MODEL, learning_rate=5e-3, seed=5, head=[8, 4]),
]


def test_static_signature_groups_as_the_jax_runner():
    assert [port_vec._static_signature(c) for c in CONFIGS] == \
        [jax_vec._static_signature(c) for c in CONFIGS]
    assert port_vec.VECTOR_KEYS == jax_vec.VECTOR_KEYS
    groups = {port_vec._static_signature(c) for c in CONFIGS}
    assert len(groups) == 3


@pytest.mark.parametrize("sched", [
    dict(max_t=20, grace_period=5, reduction_factor=2),
    dict(max_t=20, grace_period=1, reduction_factor=3),
    dict(max_t=9, grace_period=2, reduction_factor=4),
])
def test_stopper_epoch_fraction_matches(sched):
    for e in (1, 5, 9, 20):
        assert port_vec._stopper_epoch_fraction(tune.ASHAScheduler(**sched),
                                                e) == \
            jax_vec._stopper_epoch_fraction(jax_tune.ASHAScheduler(**sched), e)
    assert port_vec._stopper_epoch_fraction(tune.FIFOScheduler(), 20) == 0.5


EPOCHS, STEPS = 8, 3


def _scripted(lr, row, epoch):
    """A row's (train_loss, validation_mape) after ``epoch`` epochs (from
    0): a function of its lr, its identity and the epoch, in float32."""
    lr, row, e = (np.float32(x) for x in (lr, row, epoch))
    base = np.abs(np.log10(lr) + np.float32(3)) + np.float32(0.05) * row
    return (base + np.float32(1) / (e + np.float32(2)),
            np.float32(10) * base + np.float32(3) / (e + np.float32(1)))


class _JaxScripted:
    """Stands in for the JAX ``_GroupProgram``: population state that
    carries each row's identity, lr and epoch (so compaction's gathers
    carry them along), and scripted metrics."""

    num_epochs, steps_per_epoch, total_steps = EPOCHS, STEPS, EPOCHS * STEPS
    data = SimpleNamespace(x_train=None, y_train=None, x_val=None,
                           y_val=None, val_mask=None)

    def __init__(self):
        self.dispatch_obs = []

    def shape_schedule(self, step):
        return 1.0 - step / self.total_steps

    def init_population(self, keys, lrs, wds):
        k = lrs.shape[0]
        return ({"row": jnp.arange(k), "lr": lrs}, {},
                {"epoch": jnp.zeros(k, jnp.int32)})

    def _script(self, params, epoch):
        pairs = [_scripted(lr, row, e) for lr, row, e in zip(
            np.asarray(params["lr"]), np.asarray(params["row"]),
            np.asarray(epoch))]
        return [jnp.asarray(np.asarray(c, np.float32)) for c in zip(*pairs)]

    def train_epoch(self, params, opt, bs, x, y, keys):
        tl, _ = self._script(params, bs["epoch"])
        return params, opt, {"epoch": bs["epoch"] + 1}, tl

    def eval_population(self, params, bs, xv, yv, mask):
        _, mape = self._script(params, bs["epoch"] - 1)
        return {"validation_mape": mape}


class _PortScripted:
    """The same script behind the port's ``_GroupProgram`` interface."""

    num_epochs, steps_per_epoch, total_steps = EPOCHS, STEPS, EPOCHS * STEPS

    def shape_schedule(self, step):
        return 1.0 - step / self.total_steps

    def init_population(self, seeds, lrs, wds):
        return {"row": np.arange(len(seeds)), "lr": np.asarray(lrs)}

    def run_epochs(self, state, epoch0, n):
        assert n == 1  # without PBT the port dispatches epoch by epoch
        pairs = [_scripted(lr, row, epoch0)
                 for lr, row in zip(state["lr"], state["row"])]
        tl, mape = (np.asarray(c, np.float32)[:, None] for c in zip(*pairs))
        return tl, mape

    def read_epochs(self, tl, mape):
        return tl, {"validation_mape": mape}

    def select_rows(self, state, keep):
        return {k: v[keep] for k, v in state.items()}

    def row_params(self, state, i):
        return {"row": torch.tensor(float(state["row"][i]))}


class _NoCompiles:
    def thread_seconds(self):
        return 0.0

    def max_backend_compile_s(self):
        return 0.0


def _run_both(tmp_path, sched_kwargs):
    lrs = [1e-3, 2e-3, 4e-4, 8e-3, 1.5e-3, 3e-4, 6e-3, 1.1e-3]
    space = {"learning_rate": 1e-3}
    out = {}
    for side, pkg, trial_cls in (("jax", jax_tune, jax_trial.Trial),
                                 ("port", tune, tune.Trial)):
        sched = (pkg.ASHAScheduler(**sched_kwargs) if sched_kwargs
                 else pkg.FIFOScheduler())
        sched.set_experiment("validation_mape", "min")
        searcher = pkg.RandomSearch()
        searcher.set_search_space(pkg.SearchSpace(space), 0)
        store = pkg.ExperimentStore(str(tmp_path / side), "scripted")
        batch = [trial_cls(trial_id=f"trial_{i:05d}",
                           config={"learning_rate": lr, "seed": i})
                 for i, lr in enumerate(lrs)]
        for t in batch:
            sched.on_trial_add(t)
        logs = []
        if side == "jax":
            jax_vec._run_population(
                _JaxScripted(), batch, sched, searcher, store,
                "validation_mape", "min", logs.append, _NoCompiles(),
                "always", 1, None, None, None, 1)
            analysis = jax_experiment.ExperimentAnalysis(
                batch, "validation_mape", "min")
        else:
            rows, _, _ = port_vec._run_population(
                _PortScripted(), batch, sched, searcher, store,
                "validation_mape", "min", logs.append, "auto")
            analysis = tune.ExperimentAnalysis(batch, "validation_mape", "min")
        store.close()
        out[side] = (batch, [m for m in logs if m.startswith("compacted")],
                     analysis.best_config)
    return out


@pytest.mark.parametrize("sched", [None, dict(max_t=EPOCHS, grace_period=1,
                                              reduction_factor=2)])
def test_run_population_decides_as_the_jax_runner(sched, tmp_path):
    out = _run_both(tmp_path, sched)
    (jax_batch, jax_compacted, jax_best) = out["jax"]
    (port_batch, port_compacted, port_best) = out["port"]
    assert port_compacted == jax_compacted
    assert port_best == jax_best
    if sched:
        assert port_compacted, "the ASHA run never compacted"
        assert {t.training_iteration for t in port_batch} != {EPOCHS}
    for a, b in zip(port_batch, jax_batch):
        assert a.status.value == b.status.value == "TERMINATED"
        assert a.training_iteration == b.training_iteration
        assert len(a.results) == len(b.results)
        for ra, rb in zip(a.results, b.results):
            assert set(ra) == set(rb)
            for k, v in rb.items():
                if k in ("timestamp", "time_total_s"):
                    continue
                if isinstance(v, float):
                    np.testing.assert_allclose(ra[k], v, rtol=1e-6, err_msg=k)
                else:
                    assert ra[k] == v, k
        # Each port trial's one checkpoint is its row at its end.
        ck = load_checkpoint(a.latest_checkpoint)
        assert ck["epoch"] == a.training_iteration - 1
        assert int(ck["params"]["row"]) == int(a.trial_id[-5:])


def test_compaction_keeps_exactly_half():
    rows, active = list(range(8)), [True, False, False, True] + [False] * 4
    assert port_vec._compaction_keep(rows, active, 3, "auto") == [0, 1, 2, 3]
    assert port_vec._compaction_keep(rows, active, 0, "auto") is None
    assert port_vec._compaction_keep(rows, active, 3, "never") is None
    assert port_vec._compaction_keep(rows, [True] * 5 + [False] * 3, 3,
                                     "auto") is None


# -- (e) row independence ------------------------------------------------------

def test_masks_are_bit_equal_across_population_sizes_and_compaction():
    seeds = torch.tensor([port_rng.stream_seed(s) for s in (11, 22, 33, 44)])
    shape = (8, 12, 16)
    for step in (0, 5):
        whole = port_rng.uniform(seeds, step, 2, shape)
        alone = port_rng.uniform(seeds[2:3], step, 2, shape)
        compacted = port_rng.uniform(seeds[[1, 2]], step, 2, shape)
        assert torch.equal(whole[2], alone[0])
        assert torch.equal(whole[2], compacted[1])
        # The draws inside vmap, as the population's dropout makes them.
        inside = torch.func.vmap(
            lambda s: port_rng.RowStream(s, step).uniform(shape),
            randomness="error")(seeds)
        assert torch.equal(inside, port_rng.uniform(seeds, step, 0, shape))
    one = port_rng.uniform(seeds, 0, 0, (20000,))
    assert one.min() >= 0 and one.max() < 1
    assert abs(float(one.mean()) - 0.5) < 0.01
    assert float(torch.corrcoef(one)[0, 1:].abs().max()) < 0.05
    assert not torch.equal(port_rng.uniform(seeds, 0, 0, shape),
                           port_rng.uniform(seeds, 1, 0, shape))
    assert not torch.equal(port_rng.uniform(seeds, 0, 0, shape),
                           port_rng.uniform(seeds, 0, 1, shape))


def test_trajectory_is_the_same_alone_in_a_population_and_after_compaction(
        tmp_path):
    train, val = dummy_regression_data(**DATA)
    space = dict(MODEL, num_epochs=4, dropout=0.1, attention_type="flash",
                 learning_rate=tune.loguniform(1e-3, 1e-2),
                 seed=tune.randint(0, 1000))
    kwargs = dict(train_data=train, val_data=val, metric="validation_mape",
                  storage_path=str(tmp_path), device="cpu", verbose=0)
    fifo = tune.run_vectorized(space, num_samples=6, max_batch_trials=6,
                               name="fifo", **kwargs)
    asha = tune.run_vectorized(
        space, num_samples=6, max_batch_trials=6, name="asha",
        scheduler=tune.ASHAScheduler(max_t=4, grace_period=1,
                                     reduction_factor=2), **kwargs)
    state = json.loads((tmp_path / "asha" / "experiment_state.json")
                       .read_text())
    assert state["population_compactions"] >= 1
    assert state["row_epochs_computed"] < 6 * 4
    survivor = next(t for t in asha.trials if t.training_iteration == 4)
    row = next(t for t in fifo.trials if t.config == survivor.config)
    alone = tune.run_vectorized(dict(survivor.config), num_samples=1,
                                name="alone", **kwargs).trials[0]
    want = load_checkpoint(row.latest_checkpoint)["params"]
    for other in (alone, survivor):
        assert other.training_iteration == 4
        got = load_checkpoint(other.latest_checkpoint)["params"]
        for k, w in want.items():
            if k.endswith("attention.key.bias"):
                continue  # zero in exact arithmetic: rounding noise alone
            assert _rel(got[k], w) <= ROW_TOL, (k, _rel(got[k], w))
        for a, b in zip(other.results, row.results):
            assert _rel(a["validation_mape"], b["validation_mape"]) <= ROW_TOL
    # Dropout is on: the same config without it trains differently.
    nodrop = tune.run_vectorized(dict(survivor.config, dropout=0.0),
                                 num_samples=1, name="nodrop", **kwargs)
    assert nodrop.trials[0].results[-1]["train_loss"] != \
        row.results[-1]["train_loss"]


def test_stack_and_unstack_rows_round_trip():
    states = [{"a": torch.full((2,), float(i)), "b": torch.tensor(i)}
              for i in range(3)]
    stacked = stack_rows(states)
    assert stacked["a"].shape == (3, 2)
    assert all(torch.equal(x["a"], y["a"]) and torch.equal(x["b"], y["b"])
               for x, y in zip(unstack_rows(stacked), states))


# -- (f) refusals, and the knobs that change nothing --------------------------

def _tiny_space():
    return dict(MODEL, num_epochs=1, learning_rate=1e-3)


@pytest.mark.parametrize("knob,value,item", [
    ("checkpoint_format", "sharded", "A7"),
    ("devices", [CPU, CPU], "A9"),
    ("progress_deadline_s", 5.0, "A10"),
    ("progress_grace_s", 5.0, "A10"),
    ("compile_cache_dir", "/nonexistent/cache", "A8"),
])
def test_unported_knobs_raise_by_name(knob, value, item, tmp_path):
    train, val = dummy_regression_data(**DATA)
    if knob == "checkpoint_format":
        # Sharded population generations (A7) are ported: the knob runs,
        # and without checkpoint_every_epochs it writes no generation; a
        # format neither package has is a ValueError.
        analysis = tune.run_vectorized(
            _tiny_space(), train_data=train, val_data=val,
            metric="validation_mape", storage_path=str(tmp_path), verbose=0,
            device="cpu", num_samples=2, name="vexp", **{knob: value})
        assert analysis.num_terminated() == 2
        assert not (tmp_path / "vexp" / "population").exists()
        with pytest.raises(ValueError, match="checkpoint_format must be"):
            tune.run_vectorized(
                _tiny_space(), train_data=train, val_data=val,
                metric="validation_mape", storage_path=str(tmp_path),
                verbose=0, device="cpu", checkpoint_format="orbax")
        return
    with pytest.raises(NotImplementedError,
                       match=rf"run_vectorized\({knob}=.*ROADMAP.md {item}$"):
        kwargs = {knob: value} if knob == "devices" else {
            "device": "cpu", knob: value}
        tune.run_vectorized(_tiny_space(), train_data=train, val_data=val,
                            metric="validation_mape",
                            storage_path=str(tmp_path), verbose=0, **kwargs)
    assert not (tmp_path / "vexp").exists() and not list(tmp_path.iterdir())


def test_sharded_population_checkpoints_raise_by_name(tmp_path):
    # No longer refused (A7): the population is written as committed
    # generations under <experiment>/population/, the newest two kept,
    # and the run's checkpoint counters land in its state file
    # (tests/test_torch_durable_run.py resumes such a run).
    from distributed_machine_learning_tpu_torch import ckpt

    train, val = dummy_regression_data(**DATA)
    space = dict(_tiny_space(), num_epochs=6)
    analysis = tune.run_vectorized(
        space, train_data=train, val_data=val, metric="validation_mape",
        device="cpu", checkpoint_every_epochs=2, checkpoint_format="sharded",
        num_samples=2, storage_path=str(tmp_path), name="vexp", verbose=0)
    assert analysis.num_terminated() == 2
    pop = str(tmp_path / "vexp" / "population")
    gens = ckpt.list_generations(pop)
    # Saves at the start and after epochs 2 and 4 (none after the last);
    # keep-2 retention.
    assert [s for s, _p, _k in gens] == [2, 3]
    assert all(ckpt.is_committed(p) for _s, p, _k in gens)
    tree = ckpt.load_sharded(gens[-1][1])
    assert tree["epoch0"] == 4 and tree["trial_ids"] == {
        "0": "trial_00000", "1": "trial_00001"}
    with open(tmp_path / "vexp" / "experiment_state.json") as f:
        block = json.load(f)["checkpoint"]
    # Three population generations (async) and each trial's final
    # checkpoint.
    assert block["saves"] == 3 + 2 and block["async_saves"] == 3
    assert block["generations_pruned"] == 1


def test_unported_schedulers_configs_and_a_missing_card_raise(tmp_path,
                                                              monkeypatch):
    train, val = dummy_regression_data(**DATA)
    kwargs = dict(train_data=train, val_data=val, metric="validation_mape",
                  storage_path=str(tmp_path), verbose=0)
    # quality_after_quant is no longer refused: the sweep ends with one
    # int8 re-scoring record per live trial.
    pbt = tune.PopulationBasedTraining(
        hyperparam_mutations={"learning_rate": [1e-3, 1e-2]},
        objective="quality_after_quant")
    analysis = tune.run_vectorized(_tiny_space(), scheduler=pbt,
                                   device="cpu", num_samples=4,
                                   **dict(kwargs, storage_path=str(
                                       tmp_path / "quant")))
    assert all(t.results[-1]["quant_precision"] == "int8"
               for t in analysis.trials)
    with pytest.raises(NotImplementedError, match="rng_impl='rbg'"):
        tune.run_vectorized(dict(_tiny_space(), rng_impl="rbg"),
                            device="cpu", num_samples=1, **kwargs)
    with pytest.raises(ValueError, match="device or devices"):
        tune.run_vectorized(_tiny_space(), device="cpu", devices=[CPU],
                            **kwargs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.run_vectorized(_tiny_space(), num_samples=1, **kwargs)


def test_streaming_falls_back_and_dispatch_size_changes_nothing(tmp_path):
    train, val = dummy_regression_data(**DATA)
    space = dict(MODEL, dropout=0.1, learning_rate=tune.loguniform(1e-3, 1e-2),
                 seed=tune.randint(0, 1000))
    runs = {}
    for name, extra in (("auto", {}), ("one", {"epochs_per_dispatch": 1}),
                        ("streaming", {"input_mode": "streaming"})):
        analysis = tune.run_vectorized(
            space, train_data=train, val_data=val, metric="validation_mape",
            num_samples=2, max_batch_trials=2, storage_path=str(tmp_path),
            name=name, device="cpu", verbose=0, **extra)
        runs[name] = [[r["train_loss"] for r in t.results]
                      for t in analysis.trials]
    assert runs["auto"] == runs["one"] == runs["streaming"]
    state = json.loads((tmp_path / "streaming" / "experiment_state.json")
                       .read_text())
    # The JAX runner's block: every host_input counter's delta
    # (data/pipeline.py) and the mode asked for.
    block = state["host_input"]
    assert block["mode_fallbacks"] == 1
    assert block["input_mode_requested"] == "streaming"
    assert {k: v for k, v in block.items()
            if k not in ("mode_fallbacks", "input_mode_requested")
            and not k.startswith("dataset_cache_")} == dict.fromkeys(
        ("streams_engaged", "chunks_staged", "bytes_staged",
         "prefetch_hits", "consumer_waits", "consumer_wait_s",
         "producer_waits", "producer_wait_s", "consume_s",
         "producer_stalls", "producer_crashes"), 0)
    assert state["vectorized"] is True and state["compile_time_total_s"] == 0


# -- (g) the JAX reader reads a port vectorized experiment ---------------------

def test_jax_reader_reads_a_port_vectorized_experiment(tmp_path):
    train, val = dummy_regression_data(**DATA)
    space = dict(MODEL, learning_rate=tune.loguniform(1e-3, 1e-2),
                 seed=tune.randint(0, 1000))
    analysis = tune.run_vectorized(
        space, train_data=train, val_data=val, metric="validation_mape",
        num_samples=4, max_batch_trials=2, storage_path=str(tmp_path),
        name="vexp", device="cpu", verbose=0,
        scheduler=tune.ASHAScheduler(max_t=2, grace_period=1,
                                     reduction_factor=2))
    state = json.loads((tmp_path / "vexp" / "experiment_state.json")
                       .read_text())
    for key in ("device_utilization", "device_exec_s", "row_epochs_computed",
                "vectorized", "compile_time_total_s", "wall_clock_s"):
        assert key in state, key
    assert 0 < state["device_utilization"] <= 1
    theirs = jax_tune.ExperimentAnalysis.from_directory(
        str(tmp_path / "vexp"), "validation_mape", "min")
    ours = tune.ExperimentAnalysis.from_directory(
        str(tmp_path / "vexp"), "validation_mape", "min")
    assert theirs.best_config == ours.best_config == analysis.best_config
    assert [t.training_iteration for t in theirs.trials] == \
        [t.training_iteration for t in analysis.trials]
    assert theirs.num_terminated() == 4
    model = ours.best_model()
    with torch.no_grad():
        out = model(torch.from_numpy(val.x[:2]))
    assert not model.training and math.isfinite(float(out.sum()))
