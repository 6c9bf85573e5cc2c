"""The port's TensorBoard writer and callbacks against the JAX package's,
and ``examples/training_knobs.py``'s sweep through the port's ``tune.run``.

Event files written by either package read back through the other's
``read_events``; the CRC-32C is held to its published check value.  The
training-knobs sweep (lion/adamw, accumulation 4, RoPE, GQA, a plateau
stopper, a warm-start point, ASHA, ``TensorBoardCallback``) runs at a cut
depth twice: with a scripted trainable in both packages, whose decisions
and event runs must agree, and with the port's own ``train_regressor`` on
the CPU.  The JAX oracle runs with ``compile_cache_dir=None`` and a
``tmp_path`` storage, its cache variable in ``tmp_path``
(``restore_global_state``).
"""

from __future__ import annotations

import glob
import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
# torch.profiler imports torch._dynamo, which sets TORCHINDUCTOR_CACHE_DIR
# in os.environ; import it before restore_global_state copies the
# environment.
import torch._dynamo  # noqa: E402,F401

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.tune.trial import Trial  # noqa: E402
from distributed_machine_learning_tpu_torch.utils import (  # noqa: E402
    tensorboard as tb,
)

from _torch_tune_common import restore_global_state  # noqa: E402,F401

jax_tb = importlib.import_module("distributed_machine_learning_tpu.utils.tensorboard")

CPU = torch.device("cpu")


@pytest.mark.parametrize("data,crc", [
    (b"", 0x00000000),
    (b"123456789", 0xE3069283),  # the CRC-32C check value
    (bytes(32), 0x8A9136AA),  # RFC 3720, B.4: 32 bytes of zeros
    (bytes(range(32)), 0x46DD794E),  # RFC 3720, B.4: 0x00..0x1f
])
def test_crc32c_matches_the_published_vectors(data, crc):
    assert tb.crc32c(data) == crc == jax_tb.crc32c(data)


def test_events_encode_to_the_jax_bytes():
    scalars = [("loss", 0.25), ("config/lr", 1e-3)]
    for kw in (dict(file_version="brain.Event:2"),
               dict(step=7, scalars=scalars), dict(step=0)):
        assert tb._encode_event(1.5, **kw) == jax_tb._encode_event(1.5, **kw)
        assert tb._tfrecord(tb._encode_event(2.0, **kw)) == \
            jax_tb._tfrecord(jax_tb._encode_event(2.0, **kw))


@pytest.mark.parametrize("writer,reader", [(tb, jax_tb), (jax_tb, tb)])
def test_each_package_reads_the_others_event_files(writer, reader, tmp_path):
    w = writer.SummaryWriter(str(tmp_path / "run"))
    w.add_scalar("a", 1.5, step=1)
    w.add_scalars([("b", -2.0), ("c", 3.25)], step=2)
    w.close()
    w.add_scalar("late", 1.0, step=3)  # ignored once closed
    (path,) = glob.glob(str(tmp_path / "run" / "events.out.tfevents.*"))
    got = reader.read_events(path)
    assert got == writer.read_events(path)
    assert got[0]["file_version"] == "brain.Event:2"
    assert [(r["step"], r["scalars"]) for r in got[1:]] == [
        (1, {"a": 1.5}), (2, {"b": -2.0, "c": 3.25})]
    with open(path, "r+b") as f:  # a flipped payload byte fails its CRC
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC mismatch"):
        reader.read_events(path)


def _runs(root, skip=()):
    """{run name: [(step, sorted tags)]} of every event run under
    ``root/tensorboard``, without the tags that start with ``skip``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(
            root, "tensorboard", "*", "events.out.tfevents.*"))):
        run = os.path.basename(os.path.dirname(path))
        out.setdefault(run, []).extend(
            (r["step"], sorted(t for t in r["scalars"]
                               if not t.startswith(skip)))
            for r in tb.read_events(path)[1:])
    return out


def test_tensorboard_callback_writes_one_run_per_trial(tmp_path):
    cb = tune.TensorBoardCallback()
    cb.setup(str(tmp_path), "loss", "min")
    a = Trial(trial_id="trial_a", config={"lr": 0.1, "opt": "lion",
                                          "flag": True, "width": 16})
    b = Trial(trial_id="trial_b", config={"lr": 0.2})
    cb.on_trial_result(a, {"loss": 1.0, "training_iteration": 1,
                           "trial_id": "trial_a", "done": False})
    cb.on_trial_result(b, {"loss": 2.0, "training_iteration": 1})
    cb.on_trial_error(b, "boom")
    cb.on_trial_result(a, {"loss": 0.5, "training_iteration": 2})
    cb.on_trial_complete(a)
    cb.on_experiment_counters({"pbt/exploits": 3})
    cb.on_experiment_end([a, b], 1.0)
    runs = _runs(str(tmp_path))
    assert runs == {
        "_experiment": [(0, ["pbt/exploits"])],
        "trial_a": [(0, ["config/lr"]), (0, ["config/width"]),
                    (1, ["loss", "training_iteration"]),
                    (2, ["loss", "training_iteration"])],
        "trial_b": [(0, ["config/lr"]), (1, ["loss", "training_iteration"])],
    }
    assert not cb._writers


def test_profiler_callback_captures_a_trace_and_stops_on_time(tmp_path):
    cb = tune.ProfilerCallback(duration_s=0.0)
    cb.setup(str(tmp_path), "loss", "min")
    assert cb.active
    torch.ones(8).sum()
    cb.on_heartbeat()  # past duration_s: the capture ends here
    assert not cb.active
    cb.on_experiment_end([], 1.0)
    traces = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0


class _Counters(tune.Callback):
    def __init__(self):
        self.seen = []

    def on_experiment_counters(self, counters):
        self.seen.append(dict(counters))

    def on_experiment_end(self, trials, wall_clock_s):
        self.seen.append("end")


def test_counters_come_before_the_end_only_when_a_family_is_active(tmp_path):
    train, val = dummy_regression_data(num_samples=40, seq_len=12,
                                       num_features=4)
    space = dict(model="transformer", d_model=16, num_heads=2, num_layers=1,
                 dim_feedforward=32, dropout=0.0, num_epochs=1,
                 batch_size=8, learning_rate=1e-3)
    seen = _Counters()
    tune.run_vectorized(space, train_data=train, val_data=val,
                        metric="validation_loss", device="cpu",
                        input_mode="streaming",
                        num_samples=2, storage_path=str(tmp_path),
                        name="vec", verbose=0, callbacks=[seen])
    assert seen.seen == [{"host_input/mode_fallbacks": 1}, "end"]
    quiet = _Counters()
    tune.run(lambda config: tune.report({"loss": 1.0}), {"x": 1},
             metric="loss", num_samples=1, devices=[CPU], verbose=0,
             storage_path=str(tmp_path), name="run", callbacks=[quiet])
    assert quiet.seen == ["end"]


# -- examples/training_knobs.py ------------------------------------------------

EPOCHS, SAMPLES = 6, 5


def _knobs_space(mod, epochs=EPOCHS):
    """examples/training_knobs.py's space, ``num_epochs`` cut."""
    return {
        "model": "transformer",
        "d_model": mod.choice([16, 32]),
        "num_heads": 4,
        "num_kv_heads": mod.choice([1, 2, 4]),
        "num_layers": 2,
        "dim_feedforward": mod.sample_from(lambda cfg: cfg["d_model"] * 2),
        "position_encoding": "rope",
        "optimizer": mod.choice(["adamw", "lion"]),
        "learning_rate": mod.loguniform(1e-4, 1e-2),
        "accumulate_grad_batches": 4,
        "num_epochs": epochs,
        "batch_size": 16,
    }


def _knobs_kwargs(mod, epochs=EPOCHS):
    """examples/training_knobs.py's ``tune.run`` arguments, cut."""
    return dict(
        metric="validation_loss", mode="min", num_samples=SAMPLES,
        points_to_evaluate=[{"d_model": 32, "num_kv_heads": 4,
                             "optimizer": "adamw", "learning_rate": 3e-3}],
        stop=mod.TrialPlateauStopper("validation_loss", std=1e-3,
                                     num_results=3, grace_period=3),
        scheduler=mod.ASHAScheduler(max_t=epochs, grace_period=2,
                                    reduction_factor=2),
        callbacks=[mod.TensorBoardCallback()],
        max_concurrent=1, seed=11, verbose=0)


def _knobs_metric(config, it: int) -> float:
    """A scripted validation loss: lion configs flatten out (the plateau
    stopper's case), adamw ones keep falling."""
    base = abs(math.log10(config["learning_rate"]) + 3.0) \
        + 32.0 / config["d_model"] + 0.1 * config["num_kv_heads"]
    tail = 0.1 ** it if config["optimizer"] == "lion" else 1.0 / (it + 1)
    return base + tail


def _scripted(mod):
    def trainable(config):
        for it in range(1, config["num_epochs"] + 1):
            mod.report({"validation_loss": _knobs_metric(config, it),
                        "train_loss": 2.0 * _knobs_metric(config, it),
                        "lr": config["learning_rate"], "epoch": it - 1,
                        "steps": 25 * it})
    return trainable


def test_knobs_sweep_decides_and_logs_like_the_reference(tmp_path):
    got = tune.run(_scripted(tune), _knobs_space(tune), devices=[CPU],
                   storage_path=str(tmp_path / "port"), name="knobs",
                   **_knobs_kwargs(tune))
    want = jax_tune.run(_scripted(jax_tune), _knobs_space(jax_tune),
                        compile_cache_dir=None,
                        storage_path=str(tmp_path / "jax"), name="knobs",
                        **_knobs_kwargs(jax_tune))
    assert [t.config for t in got.trials] == [t.config for t in want.trials]
    # No decision may hang on rounding: no two trials' losses at an
    # iteration, and no plateau window's std and the stopper's 1e-3, lie
    # within 1e-9 of each other.
    by_iter = {}
    for t in got.trials:
        losses = [r["validation_loss"] for r in t.results]
        for it, v in enumerate(losses, 1):
            by_iter.setdefault(it, []).append(v)
        for end in range(3, len(losses) + 1):
            assert abs(np.std(losses[end - 3:end]) - 1e-3) > 1e-9
    for values in by_iter.values():
        gaps = np.diff(np.sort(values))
        assert not len(gaps) or gaps.min() > 1e-9
    assert ([(t.status.value, t.training_iteration) for t in got.trials]
            == [(t.status.value, t.training_iteration) for t in want.trials])
    assert got.best_config == want.best_config
    stops = {t.training_iteration for t in got.trials}
    assert len(stops) > 1 and min(stops) < EPOCHS
    # The JAX runner adds its compile cache's fields to every result; the
    # port has no compile cache (ROADMAP.md A8).
    port_runs = _runs(got.root)
    jax_runs = _runs(want.root, skip=("compile_cache_hits", "compile_time_s"))
    trial_runs = sorted(t.trial_id for t in got.trials)
    assert sorted(r for r in port_runs if r != "_experiment") == trial_runs
    assert all(port_runs[r] == jax_runs[r] for r in trial_runs)


def test_knobs_sweep_trains_on_the_cpu_through_the_port(tmp_path):
    """examples/training_knobs.py spelled for the port (its data and
    widths, 3 samples of at most 3 epochs), through ``train_regressor``."""
    train, val = dummy_regression_data(num_samples=512, seq_len=24,
                                       num_features=8)
    kwargs = dict(_knobs_kwargs(tune, epochs=3), num_samples=3)
    kwargs.update(scheduler=tune.ASHAScheduler(max_t=3, grace_period=2,
                                               reduction_factor=2))
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        _knobs_space(tune, epochs=3), devices=[CPU],
        storage_path=str(tmp_path), name="training_knobs", **kwargs)
    assert [t.status.value for t in analysis.trials] == ["TERMINATED"] * 3
    runs = _runs(analysis.root)
    for t in analysis.trials:
        assert t.results and all(r["steps"] == 25 * (i + 1)
                                 for i, r in enumerate(t.results))
        logged = [(s, tags) for s, tags in runs[t.trial_id] if s > 0]
        assert logged == [
            (r["training_iteration"],
             sorted(k for k, v in r.items() if isinstance(v, (int, float))
                    and not isinstance(v, bool)))
            for r in t.results]
    model = analysis.best_model()
    preds = model(torch.from_numpy(val.x[:4]))
    assert preds.shape == (4, 1) and bool(torch.isfinite(preds).all())
