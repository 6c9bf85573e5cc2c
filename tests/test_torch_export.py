"""Deploying a sweep's winner: the port's ``export_bundle`` against the
JAX package's, JAX experiments and checkpoints read by the port, and the
``export-bundle`` command line.

A tiny JAX ``tune.run`` over the mlp (``compile_cache_dir=None``, storage
under ``tmp_path``) is the shared experiment.  Its port twin is the same
directory with every ``ckpt_NNNNNN.msgpack`` rewritten as the port's
checkpoint of the same weights, so both packages export the same
winner: their ``params.msgpack`` must be the same bytes in f32, bf16 and
int8, and their manifests equal up to times, paths and the calibration
floats.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.data import (  # noqa: E402
    dummy_regression_data as jax_dummy,
)
from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu.serve import export as jax_export  # noqa: E402
from distributed_machine_learning_tpu.tune import (  # noqa: E402
    checkpoint as jax_ckpt,
)
from distributed_machine_learning_tpu_torch import serve, tune  # noqa: E402
from distributed_machine_learning_tpu_torch.__main__ import main as cli  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params,
)
from distributed_machine_learning_tpu_torch.serve import (  # noqa: E402
    export as export_lib,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    checkpoint as ckpt_lib,
)

from _torch_tune_common import restore_global_state  # noqa: E402,F401

CPU = torch.device("cpu")
DATA = dict(num_samples=64, seq_len=6, num_features=3, seed=3)
SPACE = {"model": "mlp", "hidden_sizes": [8], "num_epochs": 2,
         "batch_size": 16, "seed": 0}
LRS = [3e-3, 1e-2]
METRIC = "validation_loss"


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """(JAX experiment root, its port twin, validation rows)."""
    base = tmp_path_factory.mktemp("experiments")
    train, val = jax_dummy(**DATA)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DML_TPU_COMPILE_CACHE", str(base / "jax_cache"))
        analysis = jax_tune.run(
            jax_tune.with_parameters(jax_tune.train_regressor,
                                     train_data=train, val_data=val),
            dict(SPACE, learning_rate=jax_tune.choice(LRS)), num_samples=2,
            metric=METRIC, mode="min", storage_path=str(base / "jax"),
            name="exp", verbose=0, compile_cache_dir=None,
        )
    jax_root = analysis.root
    port_root = str(base / "port" / "exp")
    shutil.copytree(jax_root, port_root)
    for trial in os.listdir(port_root):
        ck_dir = os.path.join(port_root, trial, "checkpoints")
        if not os.path.isdir(ck_dir):
            continue
        for name in os.listdir(ck_dir):
            if not name.endswith(".msgpack"):
                continue
            path = os.path.join(ck_dir, name)
            tree = ckpt_lib.load_checkpoint(path)
            ckpt_lib.save_checkpoint(
                ckpt_lib.checkpoint_path(ck_dir, ckpt_lib.step_of_path(path)),
                {"params": dict(from_flax_params(tree["params"])),
                 "epoch": int(tree["epoch"])})
            os.remove(path)
            os.remove(path + ".manifest.json")
    return jax_root, port_root, np.asarray(val.x[:8], np.float32)


def _strip(manifest):
    """A manifest without its times, paths and calibration floats."""
    m = json.loads(json.dumps(manifest))
    m.pop("created_at")
    src = m["source"]
    for k in ("experiment", "checkpoint", "checkpoint_load_s"):
        src.pop(k)
    calibration = (m.get("quant") or {}).pop("calibration", None)
    if calibration is not None:
        m["quant"].pop("quality_delta_mape")
    return m, calibration


def _params_bytes(bundle_dir):
    with open(os.path.join(bundle_dir, "params.msgpack"), "rb") as f:
        return f.read()


def test_port_reads_a_jax_experiment_and_its_checkpoints(experiments):
    jax_root, _, x = experiments
    analysis = tune.ExperimentAnalysis.from_directory(jax_root, METRIC)
    jax_analysis = jax_tune.ExperimentAnalysis.from_directory(jax_root,
                                                              METRIC)
    assert analysis.best_config == jax_analysis.best_config
    trial = analysis.best_trial
    path = trial.latest_checkpoint
    assert path.endswith("ckpt_000002.msgpack")
    assert ckpt_lib.is_flax_checkpoint(path)
    steps = ckpt_lib.list_checkpoints(os.path.dirname(path))
    assert [s for s, _ in steps] == [1, 2]
    model = analysis.best_model()
    tree = jax_ckpt.load_checkpoint(path)
    want = np.asarray(jax_build(trial.config).apply(
        {"params": tree["params"]}, x))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_a_corrupt_jax_checkpoint_falls_back_to_the_previous(experiments,
                                                             tmp_path):
    jax_root, _, _ = experiments
    trial = tune.ExperimentAnalysis.from_directory(
        jax_root, METRIC).best_trial
    ck_dir = str(tmp_path / "checkpoints")
    shutil.copytree(os.path.dirname(trial.latest_checkpoint), ck_dir)
    newest = os.path.join(ck_dir, "ckpt_000002.msgpack")
    with open(newest, "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff")
    with pytest.raises(ckpt_lib.CheckpointCorruptionError, match="checksum"):
        ckpt_lib.load_checkpoint(newest)
    logs = []
    tree, used, step = ckpt_lib.load_checkpoint_with_fallback(
        newest, ck_dir, log=logs.append)
    assert step == 1 and used.endswith("ckpt_000001.msgpack")
    assert int(tree["epoch"]) == 0 and "Dense_0" in tree["params"]
    path, latest = ckpt_lib.find_latest_checkpoint(ck_dir)
    assert latest == 2 and path == newest
    assert ckpt_lib.prune_checkpoints(ck_dir, keep=1) == 1
    assert sorted(os.listdir(ck_dir)) == [
        "ckpt_000002.msgpack", "ckpt_000002.msgpack.manifest.json"]


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_export_is_byte_equal_to_the_jax_export(experiments, precision,
                                                tmp_path):
    jax_root, port_root, x = experiments
    calibration = None if precision == "f32" else x
    want_dir = jax_export.export_bundle(
        jax_root, str(tmp_path / "jax"), precision=precision,
        calibration_batch=calibration)
    got_dir = serve.export_bundle(
        port_root, str(tmp_path / "port"), precision=precision,
        calibration_batch=calibration, device="cpu")
    # The JAX experiment exported by the port: the same bytes again.
    direct = serve.export_bundle(
        jax_root, str(tmp_path / "direct"), precision=precision,
        calibration_batch=calibration, device="cpu")
    assert _params_bytes(got_dir) == _params_bytes(want_dir) \
        == _params_bytes(direct)
    want, want_cal = _strip(jax_export.load_bundle(want_dir).manifest)
    for d in (got_dir, direct):
        got, got_cal = _strip(serve.load_bundle(d).manifest)
        assert got == want
        if precision == "f32":
            assert got_cal is None and want_cal is None
            continue
        assert list(got_cal["activation_ranges"]) == \
            list(want_cal["activation_ranges"])
        for k, v in want_cal.items():
            if k == "activation_ranges":
                for name, r in v.items():
                    assert abs(got_cal[k][name] - r) <= 1e-4 * max(r, 1e-6)
            elif isinstance(v, float):
                assert abs(got_cal[k] - v) <= 1e-4 * max(abs(v), 1e-6), k
            else:
                assert got_cal[k] == v, k
    assert want["source"]["topology"]["rules_fingerprint"].startswith("pr_")


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_bundles_load_in_the_other_package(experiments, precision, tmp_path):
    jax_root, port_root, x = experiments
    calibration = None if precision == "f32" else x
    port_dir = serve.export_bundle(port_root, str(tmp_path / "port"),
                                   precision=precision,
                                   calibration_batch=calibration,
                                   device="cpu")
    jax_dir = jax_export.export_bundle(jax_root, str(tmp_path / "jax"),
                                       precision=precision,
                                       calibration_batch=calibration)
    for d in (port_dir, jax_dir):
        theirs = jax_export.load_bundle(d)
        ours = serve.load_bundle(d)
        assert ours.precision == theirs.precision == precision
        assert ours.quality_delta_mape == theirs.quality_delta_mape
        assert ours.feature_names == theirs.feature_names
        assert len(ours.feature_names) == 76
        assert ours.source_topology == theirs.source_topology
        assert ours.source_topology["process_count"] == 1
        for a, b in zip(jax.tree.leaves(ours.variables),
                        jax.tree.leaves(theirs.variables)):
            if isinstance(a, torch.Tensor):
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                              np.asarray(b).view(np.int16))
            else:
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, np.asarray(b))


def test_feature_names_match_the_jax_lists():
    from distributed_machine_learning_tpu.data import features as jax_f
    from distributed_machine_learning_tpu_torch.data import features as f

    for name in ("features", "features_1", "reference_features",
                 "reference_features_1", "temporal_features",
                 "reference_temporal_features", "SENSOR_CHANNELS",
                 "LABEL_COLUMN", "ROLLING_WINDOWS_MIN",
                 "REFERENCE_WINDOWS_MIN"):
        assert getattr(f, name) == getattr(jax_f, name), name
    for ch in f.SENSOR_CHANNELS:
        assert f.reference_rolling_features(ch) == \
            jax_f.reference_rolling_features(ch)
        assert f.sensor_features(ch) == jax_f.sensor_features(ch)
    for schema in ("canonical", "reference"):
        assert export_lib._feature_block(schema) == \
            jax_export._feature_block(schema)


@pytest.mark.parametrize("family", ["transformer", "simple_transformer",
                                    "mlp"])
def test_rules_fingerprint_is_the_jax_value(family):
    from distributed_machine_learning_tpu.models.partition_rules import (
        rules_fingerprint_for,
    )

    config = {"model": family}
    assert export_lib.rules_fingerprint_for(config) == \
        rules_fingerprint_for(config)


def test_a_live_port_sweep_exports_through_its_analysis(tmp_path):
    train, val = dummy_regression_data(**DATA)
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        dict(SPACE, learning_rate=tune.choice(LRS)), num_samples=2,
        metric=METRIC, mode="min", storage_path=str(tmp_path), name="exp",
        verbose=0, devices=[CPU])
    x = np.asarray(val.x[:8], np.float32)
    out = analysis.export_bundle(str(tmp_path / "b8"), precision="int8",
                                 calibration_batch=x, device="cpu")
    bundle = serve.load_bundle(out)
    assert bundle.precision == "int8" and bundle.quality_delta_mape >= 0
    assert bundle.manifest["source"]["trial_id"] == \
        analysis.best_trial.trial_id
    f32 = serve.load_bundle(analysis.export_bundle(str(tmp_path / "b32")))
    want = analysis.best_model()(torch.from_numpy(x)).detach().numpy()
    got = serve.InferenceEngine(f32, max_bucket=8, device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # A quantized answer stays within the manifest's measured delta.
    served = serve.InferenceEngine(bundle, max_bucket=8,
                                   device="cpu").predict(x)
    mape = float(np.mean(np.abs(served - got) / (np.abs(got) + 1e-8)))
    assert mape <= bundle.quality_delta_mape * 1.5 + 1e-3


def test_export_refusals(experiments, tmp_path):
    jax_root, port_root, x = experiments
    with pytest.raises(ValueError, match="requires a calibration_batch"):
        serve.export_bundle(port_root, str(tmp_path / "a"), precision="int8")
    with pytest.raises(ValueError, match="no trial 'nope'"):
        serve.export_bundle(port_root, str(tmp_path / "a"), trial_id="nope")
    root = str(tmp_path / "sharded")
    shutil.copytree(port_root, root)
    best = tune.ExperimentAnalysis.from_directory(root, METRIC).best_trial
    os.makedirs(os.path.join(root, best.trial_id, "checkpoints",
                             "gen_000009"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A7\)$"):
        serve.export_bundle(root, str(tmp_path / "a"))
    os.remove(os.path.join(root, "experiment_state.json"))
    with pytest.raises(ValueError, match="pass metric= explicitly"):
        serve.export_bundle(root, str(tmp_path / "a"))
    # A family the port does not build is refused by name.
    params = os.path.join(port_root, best.trial_id, "params.json")
    root = str(tmp_path / "cnn")
    shutil.copytree(port_root, root)
    with open(params) as f:
        config = dict(json.load(f), model="cnn1d")
    with open(os.path.join(root, best.trial_id, "params.json"), "w") as f:
        json.dump(config, f)
    with pytest.raises(NotImplementedError, match=r"'cnn1d'.*A4\)$"):
        serve.export_bundle(root, str(tmp_path / "a"),
                            trial_id=best.trial_id)


def test_export_bundle_cli(experiments, tmp_path, capsys):
    jax_root, port_root, x = experiments
    out = str(tmp_path / "cli")
    cli(["export-bundle", jax_root, out])
    assert "exported best trial" in capsys.readouterr().out
    assert serve.load_bundle(out).precision == "f32"
    cal = str(tmp_path / "cal.npy")
    np.save(cal, x)
    cli(["export-bundle", port_root, out + "8", "--precision", "int8",
         "--calibration", cal, "--metric", METRIC, "--mode", "min",
         "--device", "cpu"])
    assert "[int8]" in capsys.readouterr().out
    assert serve.load_bundle(out + "8").precision == "int8"
    sharded = str(tmp_path / "sharded")
    shutil.copytree(port_root, sharded)
    for trial in os.listdir(sharded):
        if os.path.isdir(os.path.join(sharded, trial, "checkpoints")):
            os.makedirs(os.path.join(sharded, trial, "checkpoints",
                                     "gen_000003"))
    cases = [
        ([str(tmp_path / "missing"), out + "x"], "pass metric="),
        ([port_root, out + "x", "--precision", "int8"], "calibration_batch"),
        ([port_root, out + "x", "--trial", "nope"], "no trial"),
        ([port_root, out + "x", "--precision", "bf16", "--calibration",
          str(tmp_path / "none.npy")], "none.npy"),
        ([port_root, out + "x", "--precision", "bf16", "--calibration",
          cal, "--device", "tpu"], "tpu"),
        ([sharded, out + "x"], "ROADMAP.md A7"),
    ]
    for args, words in cases:
        with pytest.raises(SystemExit) as exc:
            cli(["export-bundle", *args])
        err = capsys.readouterr().err
        assert exc.value.code == 1, args
        assert err.startswith("error: ") and words in err, (args, err)
        assert err.count("\n") == 1, err
    with pytest.raises(SystemExit) as exc:
        cli(["export-bundle"])
    assert exc.value.code == 2
    capsys.readouterr()
