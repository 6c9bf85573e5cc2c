"""The port's ``tune.run`` against the JAX package's.

A pure-Python scripted trainable (its metric a function of the config and
the epoch) runs through both drivers with ``max_concurrent=1`` and the
same seed, so both see the same result stream: they must sample the same
configs, stop the same trials at the same iterations and pick the same
``best_config``.  The JAX experiment reader must read the port's
experiment directory.  Then the README quickstart's spelling on the CPU
at a small size, retries from checkpoints, concurrency invariants, the
refused knobs, and a run that raises midway.

Every JAX ``tune.run`` here passes ``compile_cache_dir=None`` and a
``storage_path`` under ``tmp_path``, and ``DML_TPU_COMPILE_CACHE`` points
into ``tmp_path`` (``restore_global_state``), so nothing is written under
HOME.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from _torch_tune_common import restore_global_state, scripted_metric  # noqa: F401

torch = pytest.importorskip("torch")

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.ops import _build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
)
from distributed_machine_learning_tpu_torch.tune import runner as port_runner  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import session as port_session  # noqa: E402
from distributed_machine_learning_tpu_torch.tune.checkpoint import (  # noqa: E402
    list_checkpoints,
    load_checkpoint,
)

CPU = torch.device("cpu")
METRIC = "validation_mape"


def _scripted(mod, epochs: int, checkpoint: bool = False):
    """A trainable of package ``mod`` reporting ``scripted_metric``."""
    def trainable(config):
        for it in range(1, epochs + 1):
            ckpt = None
            if checkpoint:
                w = np.full((2, 3), float(it), np.float32)
                ckpt = {"w": torch.from_numpy(w) if mod is tune else w,
                        "epoch": it}
            mod.report({METRIC: scripted_metric(config, it), "epoch": it - 1},
                       checkpoint=ckpt)
    return trainable


def _space(mod):
    return {
        "model": "transformer",
        "d_model": mod.choice([16, 32, 64]),
        "learning_rate": mod.loguniform(1e-5, 1e-1),
        "weight_decay": mod.loguniform(1e-6, 1e-2),
        "attention_type": mod.choice(["scaled_dot_product", "flash"]),
    }


SETUPS = {
    "bayesopt_asha": dict(
        search=lambda mod: mod.BayesOptSearch(random_search_steps=3,
                                              num_candidates=64),
        scheduler=lambda mod: mod.ASHAScheduler(max_t=6, grace_period=1,
                                                reduction_factor=2),
        kwargs=dict(num_samples=9, mode="min",
                    points_to_evaluate=[{"attention_type": "flash"}])),
    "random_asha_max": dict(
        search=lambda mod: mod.RandomSearch(),
        scheduler=lambda mod: mod.ASHAScheduler(max_t=6, grace_period=2,
                                                reduction_factor=3),
        kwargs=dict(num_samples=7, mode="max")),
    "grid_fifo_stop": dict(
        search=lambda mod: mod.GridSearch(),
        scheduler=lambda mod: mod.FIFOScheduler(),
        kwargs=dict(num_samples=20, mode="min",
                    stop={"training_iteration": 4}, keep_checkpoints_num=2)),
}


def _run(mod, setup, tmp_path, **extra):
    kwargs = dict(SETUPS[setup]["kwargs"], **extra)
    if mod is jax_tune:
        kwargs.update(compile_cache_dir=None)
    else:
        kwargs.update(devices=[CPU])
    return mod.run(
        _scripted(mod, 6, checkpoint=True), _space(mod), metric=METRIC,
        scheduler=SETUPS[setup]["scheduler"](mod),
        search_alg=SETUPS[setup]["search"](mod),
        max_concurrent=1, seed=5, verbose=0, name="exp",
        storage_path=str(tmp_path / ("jax" if mod is jax_tune else "port")),
        **kwargs)


def _summary(analysis):
    return [(t.trial_id, t.config, t.status.value, t.training_iteration,
             [r[METRIC] for r in t.results]) for t in analysis.trials]


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_run_decides_like_the_reference(setup, tmp_path):
    want = _run(jax_tune, setup, tmp_path)
    got = _run(tune, setup, tmp_path)
    assert _summary(got) == _summary(want)
    assert got.best_config == want.best_config
    assert got.best_result[METRIC] == want.best_result[METRIC]
    assert got.num_terminated() == len(got.trials) > 0
    iters = {t.training_iteration for t in got.trials}
    if setup != "grid_fifo_stop":
        assert len(iters) > 1, "ASHA stopped no trial early"


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_reference_reads_the_port_experiment_directory(setup, tmp_path):
    port = _run(tune, setup, tmp_path)
    read = jax_tune.ExperimentAnalysis.from_directory(
        port.root, metric=METRIC, mode=port.mode)
    assert read.best_config == port.best_config
    assert ({t.trial_id: t.training_iteration for t in read.trials}
            == {t.trial_id: t.training_iteration for t in port.trials})
    assert [t.status.value for t in read.trials] == [
        t.status.value for t in port.trials]
    again = tune.ExperimentAnalysis.from_directory(port.root, METRIC,
                                                   port.mode)
    assert again.best_config == port.best_config
    keep = SETUPS[setup]["kwargs"].get("keep_checkpoints_num", 0)
    for trial in port.trials:
        saved = list_checkpoints(f"{port.root}/{trial.trial_id}/checkpoints")
        assert len(saved) == (min(keep, trial.training_iteration) if keep
                              else trial.training_iteration)
        assert saved[-1][1] == trial.latest_checkpoint
        assert load_checkpoint(trial.latest_checkpoint)["epoch"] == \
            trial.training_iteration


QUICKSTART_ROWS, QUICKSTART_SEQ = 200, 12


def _quickstart(tmp_path, **overrides):
    """The README quickstart's spelling, cut to a CPU size."""
    train, val = dummy_regression_data(num_samples=QUICKSTART_ROWS,
                                       seq_len=QUICKSTART_SEQ,
                                       num_features=10)
    kwargs = dict(
        metric="validation_mape",
        mode="min",
        num_samples=4,
        scheduler=tune.ASHAScheduler(max_t=3, grace_period=1,
                                     reduction_factor=3),
        search_alg=tune.BayesOptSearch(random_search_steps=2),
        points_to_evaluate=[{"attention_type": "flash"}],
        devices=[CPU],
        storage_path=str(tmp_path),
        verbose=0,
    )
    kwargs.update(overrides)
    return tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        {
            "model": "transformer",
            "d_model": tune.choice([16, 32]),
            "num_heads": tune.choice([2, 4]),
            "num_layers": tune.choice([1, 2]),
            "attention_type": tune.choice(
                ["scaled_dot_product", "linear_attention", "flash"]),
            "learning_rate": tune.loguniform(1e-5, 1e-2),
            "weight_decay": tune.loguniform(1e-6, 1e-2),
            "num_epochs": 3,
            "batch_size": 32,
        },
        **kwargs,
    )


def test_quickstart_runs_on_the_cpu_through_the_plain_kernels(tmp_path,
                                                              monkeypatch):
    plain = {"flash_attention_reference": 0, "flash_bwd_dkdv_reference": 0,
             "flash_bwd_dq_reference": 0}
    for name in plain:
        fn = getattr(fa, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            plain[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(fa, name, counted)
    counters = (fa.launches, fa.dkdv_launches, fa.dq_launches)
    before = [c.count for c in counters]
    analysis = _quickstart(tmp_path)
    assert [t.status.value for t in analysis.trials] == ["TERMINATED"] * 4
    assert analysis.best_config in [t.config for t in analysis.trials]
    assert any(t.config["attention_type"] == "flash" for t in analysis.trials)
    assert all(v > 0 for v in plain.values()), plain
    assert [c.count for c in counters] == before
    model = analysis.best_model()
    assert isinstance(model, torch.nn.Module) and not model.training
    best = analysis.best_trial
    ckpt = load_checkpoint(best.latest_checkpoint)
    assert ckpt["epoch"] == best.training_iteration - 1
    for name, p in model.named_parameters():
        assert torch.equal(p, ckpt["params"][name])


def _final_params(trial):
    return load_checkpoint(trial.latest_checkpoint)["params"]


def test_retry_from_checkpoint_ends_like_an_unbroken_trial(tmp_path):
    train, val = dummy_regression_data(num_samples=96, seq_len=8,
                                       num_features=4)
    config = {"model": "transformer", "d_model": 16, "num_heads": 2,
              "num_layers": 1, "attention_type": "flash", "dropout": 0.1,
              "learning_rate": 3e-3, "num_epochs": 4, "batch_size": 16,
              "seed": 3}
    raised = []

    def flaky(cfg):
        sess = port_session._get_session()
        inner = sess._report_fn

        def report_fn(metrics, checkpoint):
            decision = inner(metrics, checkpoint)
            if not raised and metrics["epoch"] == 1:
                raised.append(sess.trial.incarnation)
                raise RuntimeError("injected fault after epoch 1")
            return decision

        sess._report_fn = report_fn
        tune.train_regressor(cfg, train_data=train, val_data=val)

    def run(trainable, name, **kw):
        return tune.run(trainable, dict(config), metric=METRIC,
                        num_samples=1, devices=[CPU], verbose=0, name=name,
                        storage_path=str(tmp_path), **kw)

    broken = run(flaky, "broken", max_failures=1)
    unbroken = run(tune.with_parameters(tune.train_regressor,
                                        train_data=train, val_data=val),
                   "unbroken")
    (b,), (u,) = broken.trials, unbroken.trials
    assert raised == [1]
    assert b.num_failures == 1 and b.status.value == "TERMINATED"
    assert b.training_iteration == u.training_iteration == 4
    assert [r["epoch"] for r in b.results] == [0, 1, 2, 3]
    assert ([r[METRIC] for r in b.results] == [r[METRIC] for r in u.results])
    got, want = _final_params(b), _final_params(u)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name

    raised.clear()
    no_retry = run(flaky, "no_retry")
    (t,) = no_retry.trials
    assert t.status.value == "ERROR" and "injected fault" in t.error


def test_concurrent_trials_never_share_a_lease(tmp_path):
    spans, lock = [], threading.Lock()

    def trainable(config):
        sess = port_session._get_session()
        (slot,) = [i for i, _ in sess.trial.assigned_devices]
        assert tune.get_devices() == [CPU]
        for it in range(1, 4):
            t0 = time.monotonic()
            time.sleep(0.01)
            with lock:
                spans.append((slot, t0, time.monotonic()))
            tune.report({METRIC: scripted_metric(config, it)})

    analysis = tune.run(trainable, _space(tune), metric=METRIC,
                        num_samples=8, devices=[CPU, CPU], verbose=0,
                        scheduler=tune.ASHAScheduler(max_t=3),
                        storage_path=str(tmp_path))
    assert {t.status.value for t in analysis.trials} == {"TERMINATED"}
    assert {s for s, _, _ in spans} == {0, 1}
    for slot in (0, 1):
        mine = sorted((a, b) for s, a, b in spans if s == slot)
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(mine, mine[1:]))


def test_kernel_build_is_serialised_across_trials(tmp_path, monkeypatch):
    """Two trials on two lease slots reach the kernel build at once; the
    build lock lets one nvcc phase run at a time (nvcc itself is replaced
    by a no-op here: this machine has none)."""
    active, peak, calls = [0], [0], []
    guard = threading.Lock()

    def fake_start(name):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            calls.append(name)
        time.sleep(0.05)
        with guard:
            active[0] -= 1

    monkeypatch.setattr(_build, "_start_build", fake_start)

    def trainable(config):
        _build.build([fa.KERNEL_NAME, fa.BACKWARD_SOURCE])
        tune.report({METRIC: 1.0})

    analysis = tune.run(trainable, {"x": tune.choice([1, 2])}, metric=METRIC,
                        num_samples=2, devices=[CPU, CPU], verbose=0,
                        storage_path=str(tmp_path))
    assert analysis.num_terminated() == 2
    assert peak[0] == 1 and len(calls) == 4


def test_run_without_a_card_or_devices_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.run(_scripted(tune, 1), _space(tune), metric=METRIC,
                 storage_path=str(tmp_path), verbose=0)
    assert not (tmp_path / "exp").exists()


@pytest.mark.parametrize("knob,value", [
    ("trial_executor", "process"), ("prewarm_runners", 2), ("resume", "auto"),
    ("mesh_shape", {"dp": 2}), ("input_mode", "resident"),
    ("trace", True), ("trace_profile_trials", 1), ("progress_deadline_s", 5.0),
    ("progress_grace_s", 5.0), ("time_limit_per_trial_s", 10.0),
    ("checkpoint_storage", "gs://bucket/exp"),
])
def test_unported_knobs_raise(knob, value, tmp_path):
    # Each refusal names the ROADMAP.md item that will lift it.
    item = {"checkpoint_storage": "A3f"}.get(
        knob, port_runner.UNPORTED_KNOB_ITEMS.get(knob))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}$"):
        tune.run(_scripted(tune, 1), _space(tune), metric=METRIC,
                 devices=[CPU], storage_path=str(tmp_path), verbose=0,
                 **{knob: value})


def test_unported_schedulers_searchers_and_arguments_raise(tmp_path):
    kwargs = dict(metric=METRIC, devices=[CPU], storage_path=str(tmp_path),
                  verbose=0)
    repeater = jax_tune.Repeater(tune.RandomSearch(), repeat=2)
    with pytest.raises(NotImplementedError, match="Repeater"):
        tune.run(_scripted(tune, 1), _space(tune), search_alg=repeater,
                 **kwargs)
    for name, value in (("compile_cache_dir", None),
                        ("checkpoint_format", "msgpack")):
        with pytest.raises(TypeError):
            tune.run(_scripted(tune, 1), _space(tune), **{name: value},
                     **kwargs)
    with pytest.raises(ValueError):
        tune.run(_scripted(tune, 1), _space(tune), trial_executor="fork",
                 **kwargs)


def test_a_raising_trainable_errors_without_wedging_the_loop(tmp_path):
    def trainable(config):
        tune.report({METRIC: 1.0})
        if config["d_model"] == 32:
            raise ValueError("bad width")
        tune.report({METRIC: 0.5})

    analysis = tune.run(trainable, _space(tune), metric=METRIC,
                        num_samples=6, devices=[CPU, CPU], verbose=0,
                        storage_path=str(tmp_path), seed=1)
    by_width = {t.config["d_model"]: t.status.value for t in analysis.trials}
    assert by_width[32] == "ERROR" and "ERROR" not in {
        s for w, s in by_width.items() if w != 32}
    assert all("bad width" in t.error for t in analysis.trials
               if t.status.value == "ERROR")


def test_a_run_that_raises_midway_joins_its_trial_threads(tmp_path):
    """The searcher raises while a trial is running: run() re-raises and
    every trial thread has ended by then (restore_global_state checks)."""
    started = threading.Event()

    class Broken(tune.RandomSearch):
        def suggest(self, trial_index):
            if trial_index >= 3:
                started.wait(5)
                raise RuntimeError("searcher broke")
            return super().suggest(trial_index)

    def trainable(config):
        for it in range(1, 200):
            started.set()
            time.sleep(0.005)
            tune.report({METRIC: scripted_metric(config, it)})

    with pytest.raises(RuntimeError, match="searcher broke"):
        tune.run(trainable, _space(tune), metric=METRIC, num_samples=10,
                 search_alg=Broken(), devices=[CPU], max_concurrent=1,
                 verbose=0, storage_path=str(tmp_path))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("trial-")]
