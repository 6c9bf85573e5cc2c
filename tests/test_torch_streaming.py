"""Out-of-core streaming in the port, against the JAX package's.

The JAX ``tests/test_streaming.py`` on the port (all but its sharded
test, which waits for ROADMAP.md A9), each held against the JAX
function or run where it is cheap:

* the engagement policy, the budget check (``Dataset.as_torch`` beside
  ``as_jax``), chunk geometry and ``chunked_program_key``: equal to the
  JAX package's on the same inputs;
* the prefetch ring: hits, waits and its end; a producer crash raised on
  the consumer; a silent producer counted as a stall and, past the hard
  timeout, raised; at most ``depth + 1`` chunks alive at once; the
  overlap efficiency;
* an over-budget dataset trains streaming while resident raises; a
  streamed trial is the resident one bit for bit (adam, lamb baked,
  accumulation 2, streamed validation, through ``tune.run`` too);
* the port's streamed trial against the JAX trainable's streamed trial,
  fed the JAX initial weights and batch order, dropout 0: losses and
  metrics within ``rtol=1e-5``, parameters within ``atol=1e-4``, the
  attention key biases within the steps adam can take;
* the producer faults through ``tune.run`` against the JAX runner's
  outcome (a crash retried once to the end), a slowed producer whose
  parameters do not move, the plan's calls against the JAX plan's;
* ``run_vectorized`` falls back to resident staging, counted;
* ``examples/streaming_large_dataset.py``'s four steps on the port.

Every test runs under ``no_cache_no_orphans`` (HOME in ``tmp_path``);
every JAX ``tune.run`` passes ``compile_cache_dir=None`` and a
``tmp_path`` storage.
"""

from __future__ import annotations

import importlib
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
from _torch_tune_common import (  # noqa: F401
    experiment_state,
    no_cache_no_orphans,
    restore_global_state,
)
from _torch_native_common import native_caches  # noqa: F401

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
# torch.func (run_vectorized) imports torch._dynamo, which sets
# TORCHINDUCTOR_CACHE_DIR: import it before restore_global_state takes its
# snapshot of the environment.
import torch._dynamo  # noqa: E402,F401

from distributed_machine_learning_tpu import chaos as jax_chaos  # noqa: E402
from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.compilecache import (  # noqa: E402
    chunked_program_key as jax_chunked_program_key,
)
from distributed_machine_learning_tpu.data import (  # noqa: E402
    dummy_regression_data as jax_dummy,
)
from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu.utils.seeding import (  # noqa: E402
    fold_seed,
    init_rngs_for,
)
from distributed_machine_learning_tpu_torch import chaos, tune  # noqa: E402
from distributed_machine_learning_tpu_torch.compilecache import (  # noqa: E402
    chunked_program_key,
)
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    Dataset,
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.data import pipeline  # noqa: E402
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    trainable as port_trainable,
)
from distributed_machine_learning_tpu_torch.tune.callbacks import (  # noqa: E402
    Callback,
)
from distributed_machine_learning_tpu_torch.tune.checkpoint import (  # noqa: E402
    find_latest_checkpoint,
    load_checkpoint,
)

jax_pipeline = importlib.import_module(
    "distributed_machine_learning_tpu.data.pipeline")

pytestmark = pytest.mark.usefixtures("no_cache_no_orphans")

CPU = torch.device("cpu")
BUDGET_ENV = "DML_CPU_DEVICE_BUDGET_BYTES"
SMALL = dict(num_samples=200, seq_len=8, num_features=6)
BIG = dict(num_samples=2000, seq_len=8, num_features=8)  # ~520 KB staged
MLP = {"model": "mlp", "hidden_sizes": (16,), "learning_rate": 1e-2,
       "batch_size": 32, "num_epochs": 2, "lr_schedule": "constant"}
# A transformer with dropout: its generator carries on across chunks.
TRANSFORMER = dict(model="transformer", d_model=16, num_heads=2,
                   num_layers=2, dim_feedforward=32, attention_type="flash",
                   dropout=0.1, max_seq_length=16, learning_rate=3e-3,
                   num_epochs=2, batch_size=8, seed=3)
DATA = dict(num_samples=44, seq_len=12, num_features=4)  # 35 train, 4 steps
# The trainable tolerances of tests/test_torch_train.py.
RTOL, PARAM_ATOL = 1e-5, 1e-4


def _standalone(config, data, checkpoint_freq=1):
    """The port's ``train_regressor`` outside a sweep, on the CPU:
    ``(records, checkpoints)``."""
    train, val = data
    records, ckpts = [], []
    with tune.session.standalone(
            devices=[CPU], report_fn=lambda m, c: (records.append(m),
                                                   ckpts.append(c))):
        tune.train_regressor(dict(config, checkpoint_freq=checkpoint_freq),
                             train_data=train, val_data=val)
    return records, ckpts


def _assert_bit_equal(a, b):
    (ra, ca), (rb, cb) = a, b
    keys = ("epoch", "train_loss", "lr", "steps", "validation_loss",
            "validation_mse", "validation_rmse", "validation_mae",
            "validation_mape")
    assert [[r[k] for k in keys] for r in ra] == \
        [[r[k] for k in keys] for r in rb]
    pa, pb = ca[-1]["params"], cb[-1]["params"]
    assert pa.keys() == pb.keys()
    for k, v in pb.items():
        assert torch.equal(pa[k], v), k


# -- engagement policy, budget, geometry, keys ---------------------------------

POLICY_CASES = [
    ({}, 100_000), ({}, 600_000), ({"streaming_engage_fraction": 0.05},
                                   100_000),
    ({"input_mode": "streaming"}, 10), ({"input_mode": "resident"}, 900_000),
    ({"input_mode": "AUTO"}, 700_000), ({"input_mode": None}, 200_000),
]


def test_resolve_input_mode_policy_is_the_jax_policy(monkeypatch):
    monkeypatch.setenv(BUDGET_ENV, str(1 << 20))
    for config, nbytes in POLICY_CASES:
        assert pipeline.resolve_input_mode(config, nbytes, CPU) == \
            jax_pipeline.resolve_input_mode(config, nbytes), config
    with pytest.raises(pipeline.ResidentOverBudgetError):
        pipeline.resolve_input_mode({"input_mode": "resident"}, 2 << 20, CPU)
    with pytest.raises(jax_pipeline.ResidentOverBudgetError):
        jax_pipeline.resolve_input_mode({"input_mode": "resident"}, 2 << 20)
    with pytest.raises(ValueError, match="input_mode must be one of"):
        pipeline.resolve_input_mode({"input_mode": "nope"}, 10, CPU)
    assert pipeline.INPUT_MODES == jax_pipeline.INPUT_MODES
    assert pipeline.device_budget_bytes(CPU) == 1 << 20


def test_as_torch_enforces_the_budget_before_allocating(monkeypatch):
    train, val = dummy_regression_data(**BIG)
    jtrain, _ = jax_dummy(**BIG)
    monkeypatch.setenv(BUDGET_ENV, str(64 << 10))
    with pytest.raises(jax_pipeline.ResidentOverBudgetError):
        jtrain.as_jax(enforce_budget=True)
    with pytest.raises(pipeline.ResidentOverBudgetError,
                       match="Dataset.as_torch"):
        train.as_torch(CPU, enforce_budget=True)
    small = Dataset(train.x[:4].copy(), train.y[:4].copy())
    x, y = small.as_torch(CPU, enforce_budget=True)
    assert torch.equal(x, torch.from_numpy(small.x)) and y.shape == (4, 1)
    assert pipeline.staged_nbytes(train, val, torch.float32) == \
        jax_pipeline.staged_nbytes(train, val, np.float32)
    assert pipeline.staged_nbytes(train, val, torch.bfloat16) == \
        jax_pipeline.staged_nbytes(train, val, jnp.bfloat16)


@pytest.mark.parametrize("args,config", [
    ((50, 32, 1024), None), ((10, 32, 1024), {"streaming_chunk_batches": 64}),
    ((7, 32, 10 << 20), None), ((128, 64, 65540), {
        "streaming_chunk_batches": 8}),
    ((33, 16, 4096), {"streaming_prefetch_depth": 4}),
])
def test_plan_chunks_geometry_is_the_jax_geometry(args, config, monkeypatch):
    monkeypatch.setenv(BUDGET_ENV, str(1 << 20))
    got = pipeline.plan_chunks(*args, device=CPU, config=config)
    want = jax_pipeline.plan_chunks(*args, config=config)
    assert vars(got) == vars(want)
    assert list(got.chunk_sizes()) == list(want.chunk_sizes())
    assert got.chunks_per_epoch == want.chunks_per_epoch
    assert sum(rows for _, rows in got.chunk_sizes()) == args[0]


def test_chunked_program_key_folds_rows_not_count():
    cfg = {"model": "mlp", "learning_rate": 1e-3, "batch_size": 32}
    shape = [[4, 32, 8, 6], [4, 32, 1]]
    kw = dict(dtype="float32", donation=(0, 1, 2, 4, 5),
              extra={"tail_rows": 3})
    k1 = chunked_program_key(cfg, chunk_rows=4, batch_shape=shape, **kw)
    # The JAX package's key, byte for byte.
    assert k1 == jax_chunked_program_key(cfg, chunk_rows=4,
                                         batch_shape=shape, **kw)
    k3 = chunked_program_key(cfg, chunk_rows=8,
                             batch_shape=[[8, 32, 8, 6], [8, 32, 1]], **kw)
    assert k3 != k1
    assert chunked_program_key(dict(cfg, learning_rate=0.5, seed=7),
                               chunk_rows=4, batch_shape=shape, **kw) == k1


# -- the prefetch ring -----------------------------------------------------------

def test_host_input_counters_carry_the_jax_names():
    assert pipeline.HostInputCounters._FIELDS == \
        jax_pipeline.HostInputCounters._FIELDS


def test_prefetch_ring_hits_waits_and_done():
    counters = pipeline.HostInputCounters()

    def source():
        for i in range(6):
            yield torch.full((4,), float(i))

    ring = pipeline.ChunkPrefetcher(source(), depth=2, deadline_s=5.0,
                                    counters=counters)
    got = []
    try:
        while True:
            try:
                got.append(ring.get())
            except StopIteration:
                break
    finally:
        ring.close()
    assert [int(a[0]) for a in got] == list(range(6))
    snap = counters.snapshot()
    assert snap["chunks_staged"] == 6 and snap["bytes_staged"] == 6 * 16
    # 6 chunks and the terminal get: each a hit or a wait.
    assert snap["prefetch_hits"] + snap["consumer_waits"] == 7


def test_prefetch_ring_raises_a_producer_crash_on_the_consumer():
    counters = pipeline.HostInputCounters()

    def source():
        yield torch.zeros(2)
        raise RuntimeError("producer exploded")

    ring = pipeline.ChunkPrefetcher(source(), depth=2, deadline_s=5.0,
                                    counters=counters)
    try:
        ring.get()
        with pytest.raises(RuntimeError, match="producer exploded"):
            ring.get()
            ring.get()
    finally:
        ring.close()
    assert counters.snapshot()["producer_crashes"] == 1


def test_prefetch_ring_counts_a_stall_and_raises_past_the_hard_timeout():
    counters = pipeline.HostInputCounters()
    release = threading.Event()

    def source():
        yield torch.zeros(2)
        release.wait(10.0)  # a silent producer: no beat, nothing staged
        yield torch.ones(2)

    ring = pipeline.ChunkPrefetcher(source(), depth=2, deadline_s=0.1,
                                    hard_timeout_s=0.6, counters=counters)
    try:
        ring.get()
        with pytest.raises(pipeline.ProducerStalled):
            ring.get()
    finally:
        release.set()
        ring.close()
    snap = counters.snapshot()
    assert snap["producer_stalls"] >= 1
    assert snap["consumer_waits"] >= 1 and snap["consumer_wait_s"] > 0


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_the_ring_holds_at_most_depth_plus_one_chunks(depth):
    """Staged, queued or in use: a chunk is alive from the source's yield
    until the consumer's next get."""
    counters = pipeline.HostInputCounters()
    seen = {"yielded": 0, "gets": 0, "most": 0}

    def source():
        for i in range(12):
            seen["yielded"] += 1
            alive = seen["yielded"] - max(seen["gets"] - 1, 0)
            seen["most"] = max(seen["most"], alive)
            yield torch.full((2,), float(i))

    ring = pipeline.ChunkPrefetcher(source(), depth=depth, deadline_s=5.0,
                                    counters=counters)
    try:
        for _ in range(12):
            seen["gets"] += 1
            ring.get()
            threading.Event().wait(0.02)  # the producer runs ahead
    finally:
        ring.close()
    assert seen["most"] == depth + 1
    assert counters.snapshot()["producer_waits"] > 0


def test_the_stream_bundle_cache_builds_once_per_key(monkeypatch):
    monkeypatch.setattr(pipeline, "_STREAM_CACHE_MAX", 2)
    pipeline.clear_stream_program_cache()
    built = []

    def build(key):
        def make():
            built.append(key)
            threading.Event().wait(0.05)  # the others wait on the key
            return key.upper()
        return make

    threads = [threading.Thread(
        target=lambda: pipeline.stream_bundle_for("a", build("a")))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads) and built == ["a"]
    assert pipeline.stream_bundle_for("b", build("b")) == "B"
    assert pipeline.stream_bundle_for("a", build("a")) == "A"  # touched
    pipeline.stream_bundle_for("c", build("c"))  # evicts "b", the oldest
    assert pipeline.stream_bundle_for("a", build("a")) == "A"
    pipeline.stream_bundle_for("b", build("b"))
    assert built == ["a", "b", "c", "b"]
    pipeline.clear_stream_program_cache()


def test_overlap_efficiency_is_the_jax_derivation():
    cases = [{}, {"consume_s": 9.0, "consumer_wait_s": 1.0},
             {"consume_s": 0.0, "consumer_wait_s": 2.0},
             {"consume_s": 3.25, "consumer_wait_s": 0.0}]
    for c in cases:
        assert pipeline.overlap_efficiency(c) == \
            jax_pipeline.overlap_efficiency(c)
    assert pipeline.overlap_efficiency(cases[1]) == pytest.approx(0.9)


def test_the_producer_faults_fire_as_the_jax_plan_fires():
    calls = [(0, "stream-trial_00000"), (1, "stream-trial_00001"),
             (3, "stream-trial_00000"), (4, "stream-trial_00001"),
             (5, None)]
    for kwargs in ({"producer_crash_at": 3},
                   {"slow_producer_ms": 1.0,
                    "slow_producer_match": ["trial_00001"]},
                   {"slow_producer_ms": 1.0}):
        port, ref = chaos.FaultPlan(**kwargs), jax_chaos.FaultPlan(**kwargs)
        for index, name in calls:
            outcomes = []
            for plan, exc in ((port, chaos.InjectedProducerCrash),
                              (ref, jax_chaos.InjectedProducerCrash)):
                try:
                    plan.maybe_producer_fault(index, name=name)
                    outcomes.append("ok")
                except exc:
                    outcomes.append("crash")
            assert outcomes[0] == outcomes[1], (kwargs, index)
        assert port.snapshot() == ref.snapshot()


# -- the trainable: budget, exactness ----------------------------------------------

def test_over_budget_dataset_trains_streaming_while_resident_raises(
        monkeypatch, tmp_path):
    train, val = dummy_regression_data(**BIG)
    monkeypatch.setenv(BUDGET_ENV, str(64 << 10))
    assert pipeline.staged_nbytes(train, val, torch.float32) > (64 << 10)
    with pytest.raises(pipeline.ResidentOverBudgetError):
        _standalone(dict(MLP, input_mode="resident", batch_size=64),
                    (train, val))
    base = pipeline.get_host_input_counters().snapshot()
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        dict(MLP, batch_size=64), metric="validation_loss", num_samples=1,
        devices=[CPU], storage_path=str(tmp_path), name="over_budget",
        verbose=0)
    trial = analysis.trials[0]
    assert trial.status.value == "TERMINATED"
    assert trial.training_iteration == 2
    assert trial.last_result["input_mode"] == "streaming"
    delta = pipeline.get_host_input_counters().delta_since(base)
    assert delta["streams_engaged"] == 1 and delta["chunks_staged"] > 0
    block = experiment_state(analysis)["host_input"]
    assert block["chunks_staged"] > 0 and block["bytes_staged"] > 0
    assert 0.0 <= block["overlap_efficiency"] <= 1.0


STREAM_CASES = {
    "adam": {},
    "lamb_baked": {"optimizer": "lamb"},
    "accumulation_2": {"optimizer": "adamw", "accumulate_grad_batches": 2},
    "streamed_validation": {"streaming_engage_fraction": 0.0},
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_trial_is_the_resident_trial_bit_for_bit(case):
    data = dummy_regression_data(**DATA)
    config = dict(TRANSFORMER, **STREAM_CASES[case])
    resident = _standalone(dict(config, input_mode="resident"), data)
    base = pipeline.get_host_input_counters().snapshot()
    streamed = _standalone(dict(config, input_mode="streaming",
                                streaming_chunk_batches=3), data)
    _assert_bit_equal(streamed, resident)
    assert all(r["input_mode"] == "streaming" for r in streamed[0])
    assert all("input_mode" not in r for r in resident[0])
    delta = pipeline.get_host_input_counters().delta_since(base)
    # 4 steps an epoch in chunks of 3: 2 chunks, and 1 more of validation
    # blocks when validation streams.
    per_epoch = 2 + (1 if case == "streamed_validation" else 0)
    assert delta["chunks_staged"] == 2 * per_epoch


def test_streaming_through_tune_run_is_resident_bit_for_bit(tmp_path):
    train, val = dummy_regression_data(**SMALL)
    space = dict(MLP, hidden_sizes=(32, 16),
                 learning_rate=tune.loguniform(1e-3, 1e-1), num_epochs=3,
                 streaming_chunk_batches=2)

    def sweep(mode):
        return tune.run(
            tune.with_parameters(tune.train_regressor, train_data=train,
                                 val_data=val),
            space, metric="validation_loss", num_samples=2, seed=11,
            input_mode=mode, devices=[CPU], storage_path=str(tmp_path),
            name=mode, verbose=0)

    res, stm = sweep("resident"), sweep("streaming")
    assert [t.config["input_mode"] for t in stm.trials] == ["streaming"] * 2
    assert res.best_trial.trial_id == stm.best_trial.trial_id
    for tr, ts in zip(res.trials, stm.trials):
        assert tr.config["learning_rate"] == ts.config["learning_rate"]
        assert tr.metric_history("validation_loss") == \
            ts.metric_history("validation_loss")
        cr = load_checkpoint(find_latest_checkpoint(
            os.path.join(res.root, tr.trial_id, "checkpoints"))[0])
        cs = load_checkpoint(find_latest_checkpoint(
            os.path.join(stm.root, ts.trial_id, "checkpoints"))[0])
        for k, v in cr["params"].items():
            assert torch.equal(cs["params"][k], v), k
    assert "host_input" not in experiment_state(res)
    assert experiment_state(stm)["host_input"]["streams_engaged"] == 2


def test_a_config_input_mode_wins_over_the_sweep_wide_one(tmp_path):
    train, val = dummy_regression_data(**SMALL)
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        dict(MLP, num_epochs=1, input_mode=tune.choice(["resident"])),
        metric="validation_loss", num_samples=1, input_mode="streaming",
        devices=[CPU], storage_path=str(tmp_path), name="wins", verbose=0)
    assert analysis.trials[0].config["input_mode"] == "resident"
    assert "input_mode" not in analysis.trials[0].last_result
    with pytest.raises(ValueError, match="input_mode must be one of"):
        tune.run(lambda config: None, {"x": 1}, metric="loss",
                 input_mode="bogus", devices=[CPU],
                 storage_path=str(tmp_path), verbose=0)
    assert not (tmp_path / "bogus").exists()


# -- against the JAX trainable -------------------------------------------------------

def _jax_perm(seed: int, epoch: int, n_train: int):
    key = jax.random.key(fold_seed(seed, "epoch", epoch))
    perm_key, _ = jax.random.split(key)  # the JAX epoch program's split
    return torch.from_numpy(np.array(
        jax.random.permutation(perm_key, n_train)))


def test_streamed_trial_matches_the_jax_streamed_trial(monkeypatch):
    """Flash attention (the JAX kernel in Pallas interpret mode, ~15 s
    here), adam.  A baked optimizer streams as the resident trial does in
    the port (above), and the resident trial under lamb is held to the
    JAX trainable in tests/test_torch_knobs_train.py."""
    config = dict(TRANSFORMER, dropout=0.0, input_mode="streaming",
                  streaming_chunk_batches=3)
    jtrain, jval = jax_dummy(**DATA)
    jrec, jck = [], []
    with jax_tune.standalone():
        jax_tune.session._get_session()._report_fn = (
            lambda m, c: (jrec.append(m), jck.append(c)) and "continue")
        jax_tune.with_parameters(jax_tune.train_regressor, train_data=jtrain,
                                 val_data=jval)(config)
    params0 = jax_build(config).init(
        init_rngs_for(int(config["seed"])), jnp.asarray(jtrain.x[:1]),
        deterministic=True)["params"]
    state0 = from_flax_params(jax.tree.map(np.asarray, params0))

    def load(model, generator):
        model.load_state_dict(state0)
        return model

    monkeypatch.setattr(port_trainable, "init_parameters", load)
    monkeypatch.setattr(port_trainable, "epoch_permutation", _jax_perm)
    rec, ck = _standalone(config, dummy_regression_data(**DATA))
    assert [r["input_mode"] for r in jrec] == \
        [r["input_mode"] for r in rec] == ["streaming"] * 2
    assert set(rec[0]) == set(jrec[0])
    assert [r["lr"] for r in rec] == [r["lr"] for r in jrec]
    for r, jr in zip(rec, jrec):
        for k in ("train_loss", "validation_loss", "validation_mape"):
            np.testing.assert_allclose(r[k], jr[k], rtol=RTOL, err_msg=k)
    bound = 2 * config["learning_rate"] * len(rec) * rec[0]["steps"]
    want = from_flax_params(jax.tree.map(np.asarray, jck[-1]["params"]))
    for k, w in want.items():
        got = ck[-1]["params"][k]
        if k.endswith("attention.key.bias"):
            assert got.abs().max() <= bound and w.abs().max() <= bound, k
            continue
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=PARAM_ATOL,
                                   err_msg=k)


# -- faults through tune.run -----------------------------------------------------------

def test_a_producer_crash_is_retried_as_the_jax_runner_retries(tmp_path):
    train, val = dummy_regression_data(**SMALL)
    jtrain, jval = jax_dummy(**SMALL)
    config = dict(MLP, num_epochs=4, input_mode="streaming",
                  streaming_chunk_batches=2)

    def port_run(plan, name):
        with chaos.active(plan):
            return tune.run(
                tune.with_parameters(tune.train_regressor, train_data=train,
                                     val_data=val),
                config, metric="validation_loss", num_samples=1,
                max_failures=1, devices=[CPU], storage_path=str(tmp_path),
                name=name, verbose=0)

    plan = chaos.FaultPlan(seed=3, producer_crash_at=4)
    analysis = port_run(plan, "crash")
    control = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        config, metric="validation_loss", num_samples=1, devices=[CPU],
        storage_path=str(tmp_path), name="control", verbose=0)
    jplan = jax_chaos.FaultPlan(seed=3, producer_crash_at=4)
    with jax_chaos.active(jplan):
        jax_analysis = jax_tune.run(
            jax_tune.with_parameters(jax_tune.train_regressor,
                                     train_data=jtrain, val_data=jval),
            config, metric="validation_loss", num_samples=1,
            max_failures=1, storage_path=str(tmp_path), name="jax_crash",
            compile_cache_dir=None, verbose=0)
    trial, jtrial = analysis.trials[0], jax_analysis.trials[0]
    for t in (trial, jtrial):
        assert t.status.value == "TERMINATED"
        assert t.training_iteration == 4 and t.num_failures == 1
    assert plan.snapshot() == jplan.snapshot() == {"producer_crashes": 1}
    assert experiment_state(analysis)["injected_faults"] == \
        experiment_state(jax_analysis)["injected_faults"]
    assert experiment_state(analysis)["host_input"]["producer_crashes"] == 1
    # Retried from its checkpoint, it ends as the uncrashed trial.
    assert trial.metric_history("validation_loss") == \
        control.trials[0].metric_history("validation_loss")


def test_a_slow_producer_moves_the_counters_not_the_parameters():
    data = dummy_regression_data(**SMALL)
    config = dict(MLP, input_mode="streaming", streaming_chunk_batches=1)
    clean = _standalone(config, data)
    base = pipeline.get_host_input_counters().snapshot()
    plan = chaos.FaultPlan(seed=5, slow_producer_ms=20)
    with chaos.active(plan):
        slowed = _standalone(config, data)
    delta = pipeline.get_host_input_counters().delta_since(base)
    # A sleep before each chunk and before the pull that ends the source
    # (as the JAX producer sleeps).
    assert plan.snapshot()["producer_slowdowns"] - 1 == \
        delta["chunks_staged"] == 2 * (160 // 32)
    assert delta["consumer_waits"] > 0 and delta["consumer_wait_s"] > 0
    _assert_bit_equal(slowed, clean)


# -- the runners: vectorized fallback, counters ------------------------------------------

class _Counters(Callback):
    def __init__(self):
        self.seen = {}

    def on_experiment_counters(self, counters):
        self.seen.update(counters)


def test_vectorized_streaming_falls_back_counted(tmp_path):
    train, val = dummy_regression_data(**SMALL)
    base = pipeline.get_host_input_counters().snapshot()
    seen = _Counters()
    analysis = tune.run_vectorized(
        dict(MLP, learning_rate=tune.loguniform(1e-3, 1e-2)),
        train_data=train, val_data=val, metric="validation_loss",
        num_samples=2, input_mode="streaming", storage_path=str(tmp_path),
        name="vec", device="cpu", verbose=0, callbacks=[seen])
    assert analysis.num_terminated() == 2
    delta = pipeline.get_host_input_counters().delta_since(base)
    assert delta["mode_fallbacks"] == 1
    block = experiment_state(analysis)["host_input"]
    assert set(block) == {*jax_pipeline.HostInputCounters._FIELDS,
                          "input_mode_requested"}
    assert block["mode_fallbacks"] == 1
    assert block["input_mode_requested"] == "streaming"
    assert seen.seen["host_input/mode_fallbacks"] == 1
    with pytest.raises(ValueError, match="input_mode must be one of"):
        tune.run_vectorized(
            {"model": "mlp", "learning_rate": 1e-3}, train_data=train,
            val_data=val, metric="validation_loss", input_mode="bogus",
            storage_path=str(tmp_path), device="cpu", verbose=0)


def test_a_streamed_sweep_publishes_the_host_input_scalars(tmp_path):
    train, val = dummy_regression_data(**SMALL)
    seen = _Counters()
    tune.run(tune.with_parameters(tune.train_regressor, train_data=train,
                                  val_data=val),
             dict(MLP, num_epochs=1), metric="validation_loss",
             num_samples=1, input_mode="streaming", devices=[CPU],
             storage_path=str(tmp_path), name="scalars", verbose=0,
             callbacks=[seen])
    names = {k for k in seen.seen if k.startswith("host_input/")}
    assert names == {f"host_input/{k}" for k in
                     (*jax_pipeline.HostInputCounters._FIELDS,
                      "overlap_efficiency")}
    assert seen.seen["host_input/streams_engaged"] == 1


# -- examples/streaming_large_dataset.py on the port ----------------------------------------

def test_the_streaming_example_on_the_port(monkeypatch, tmp_path):
    """Its four steps: resident refused over a 512 KiB budget; the same
    trial streamed ("auto"); the resident control (budget raised) bit for
    bit; the host_input block from experiment_state.json."""
    budget = 512 << 10
    monkeypatch.setenv(BUDGET_ENV, str(budget))
    train, val = dummy_regression_data(num_samples=4000, seq_len=8,
                                       num_features=8)
    assert pipeline.staged_nbytes(train, val, torch.float32) > budget
    with pytest.raises(pipeline.ResidentOverBudgetError):
        train.as_torch(CPU, enforce_budget=True)

    def sweep(name):
        config = dict(MLP, hidden_sizes=(32,), batch_size=64, num_epochs=3,
                      checkpoint_freq=3)
        return tune.run(
            tune.with_parameters(tune.train_regressor, train_data=train,
                                 val_data=val),
            config, metric="validation_loss", num_samples=1, seed=0,
            devices=[CPU], storage_path=str(tmp_path), name=name, verbose=0)

    streamed = sweep("streaming_demo")
    trial = streamed.trials[0]
    assert trial.training_iteration == 3
    assert trial.last_result["input_mode"] == "streaming"
    monkeypatch.setenv(BUDGET_ENV, str(1 << 30))
    resident = sweep("resident_control")
    assert "input_mode" not in resident.trials[0].last_result

    def final_params(analysis):
        path, _ = find_latest_checkpoint(os.path.join(
            analysis.root, analysis.trials[0].trial_id, "checkpoints"))
        return load_checkpoint(path)["params"]

    a, b = final_params(streamed), final_params(resident)
    assert all(torch.equal(a[k], v) for k, v in b.items())
    state = json.loads(open(os.path.join(
        streamed.root, "experiment_state.json")).read())
    assert state["host_input"]["chunks_staged"] > 0
