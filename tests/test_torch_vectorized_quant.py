"""PBT's ``objective="quality_after_quant"`` in the port's
``run_vectorized`` against the JAX runner.

An mlp population (8 rows, full-batch epochs, dropout off) starts from
the JAX program's own initial rows (``population_from_flax``); a
full-batch epoch makes the shuffle irrelevant up to summation order.
Both runners must take the same PBT decisions, end with one
``quant_evals`` pass, give every live trial a final record whose
``quant_mape`` (= ``pbt_objective``) is within ``ROW_TOL`` of the JAX
one, and pick the same best trial by ``pbt_objective``.  The JAX runner
is called with ``compile_cache_dir=None`` and storage under
``tmp_path``.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch.func's first grad imports torch._dynamo, which sets
# TORCHINDUCTOR_CACHE_DIR: import it before the fixture copies os.environ.
import torch._dynamo  # noqa: E402,F401

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.data import Dataset as JaxDataset  # noqa: E402
from distributed_machine_learning_tpu.tune import (  # noqa: E402
    vectorized as jax_vec,
)
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import Dataset  # noqa: E402
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    population_from_flax,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    vectorized as port_vec,
)

from _torch_tune_common import restore_global_state  # noqa: E402,F401

# A trial alone against its population row (tests/test_torch_vectorized.py).
ROW_TOL = 1e-5
ROWS, N_TRAIN = 8, 64
SPACE = {"model": "mlp", "hidden_sizes": [16, 8], "weight_decay": 1e-6,
         "num_epochs": 6, "batch_size": N_TRAIN, "loss_function": "mse",
         "lr_schedule": "constant", "dropout": 0.0}
METRIC = "validation_mse"


def _data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(96, 8, 4)).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)
    y = (x.mean(axis=1) @ w)[:, None].astype(np.float32)
    return x, y


def _space(pkg):
    return dict(SPACE, learning_rate=pkg.loguniform(1e-3, 3e-1),
                seed=pkg.randint(0, 10_000))


def _pbt(pkg):
    return pkg.PopulationBasedTraining(
        perturbation_interval=2,
        hyperparam_mutations={"learning_rate": pkg.loguniform(1e-3, 3e-1)},
        quantile_fraction=0.25, seed=3, objective="quality_after_quant")


def _jax_init_rows(config, train, val, seeds, lrs, wds):
    program = jax_vec._GroupProgram(dict(config), train, val)
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    params, _, _ = program.init_population(
        keys, jnp.asarray(lrs, jnp.float32), jnp.asarray(wds, jnp.float32))
    return population_from_flax(jax.tree.map(np.asarray, params))


def test_quality_after_quant_matches_the_jax_runner(tmp_path, monkeypatch):
    x, y = _data()
    jtrain, jval = JaxDataset(x[:N_TRAIN], y[:N_TRAIN]), JaxDataset(
        x[N_TRAIN:], y[N_TRAIN:])
    jpbt = _pbt(jax_tune)
    want = jax_vec.run_vectorized(
        _space(jax_tune), train_data=jtrain, val_data=jval, metric=METRIC,
        mode="min", num_samples=ROWS, scheduler=jpbt, seed=2, verbose=0,
        storage_path=str(tmp_path / "jax"), name="exp",
        compile_cache_dir=None)

    real_init = port_vec._GroupProgram.init_population

    def jax_rows(self, seeds, lrs, wds):
        state = real_init(self, seeds, lrs, wds)
        rows = _jax_init_rows(self._static_cfg, jtrain, jval, seeds, lrs, wds)
        state.params.update({k: v.to(self.device) for k, v in rows.items()})
        return state

    monkeypatch.setattr(port_vec._GroupProgram, "init_population", jax_rows)
    ppbt = _pbt(tune)
    got = tune.run_vectorized(
        _space(tune), train_data=Dataset(x[:N_TRAIN], y[:N_TRAIN]),
        val_data=Dataset(x[N_TRAIN:], y[N_TRAIN:]), metric=METRIC,
        mode="min", num_samples=ROWS, scheduler=ppbt, seed=2, verbose=0,
        storage_path=str(tmp_path / "port"), name="exp", device="cpu")

    # The same PBT decisions, bit for bit.
    assert len(ppbt._generation_log) == len(jpbt._generation_log) > 0
    for g, w in zip(ppbt._generation_log, jpbt._generation_log):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k == "scores":  # the metric, up to f32 summation order
                np.testing.assert_allclose(g[k], v, rtol=ROW_TOL)
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(v), err_msg=k)
    assert ppbt.debug_state() == jpbt.debug_state()
    states = [json.load(open(os.path.join(a.root, "experiment_state.json")))
              for a in (got, want)]
    assert states[0]["pbt"]["quant_evals"] == \
        states[1]["pbt"]["quant_evals"] == 1
    assert states[0]["pbt"]["exploits"] == states[1]["pbt"]["exploits"] > 0
    for a, b in zip(got.trials, want.trials):
        assert a.config == b.config
        assert a.status.value == b.status.value == "TERMINATED"
        qa, qb = a.results[-1], b.results[-1]
        assert set(qa) == set(qb)
        assert qa["quant_precision"] == qb["quant_precision"] == "int8"
        assert qa["pbt_objective"] == qa["quant_mape"]
        assert qa["training_iteration"] == qb["training_iteration"]
        assert abs(qa["quant_mape"] - qb["quant_mape"]) <= \
            ROW_TOL * abs(qb["quant_mape"])
        # The pre-quantization score of the last epoch agrees too.
        np.testing.assert_allclose(a.results[-2][METRIC],
                                   b.results[-2][METRIC], rtol=ROW_TOL)
    best = tune.ExperimentAnalysis(got.trials, metric="pbt_objective",
                                   mode="min", root=got.root).best_trial
    jbest = jax_tune.ExperimentAnalysis(want.trials, metric="pbt_objective",
                                        mode="min", root=want.root).best_trial
    assert best.trial_id == jbest.trial_id
    assert best.results[-1]["quant_mape"] == min(
        t.results[-1]["quant_mape"] for t in got.trials)
