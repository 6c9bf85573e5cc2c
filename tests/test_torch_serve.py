"""The port's serving plane on the CPU: bundles in both directions between
the packages, the msgpack codec, engine padding, batchers, replicas, the
HTTP server, the CLI, and the import guard (no JAX in the port)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
torch.set_num_threads(1)

from flax import serialization  # noqa: E402

from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu.serve import export as jax_export  # noqa: E402
from distributed_machine_learning_tpu_torch import serve  # noqa: E402
from distributed_machine_learning_tpu_torch.serve import _msgpack, export  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(model="transformer", d_model=16, num_heads=4, num_kv_heads=2,
              num_layers=2, dim_feedforward=32, dropout=0.0,
              attention_type="flash", position_encoding="rope",
              max_seq_length=16)
SEQ, FEATURES = 12, 5


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """A bundle written by the JAX package, and its flax model + variables."""
    x = np.zeros((1, SEQ, FEATURES), np.float32)
    model = jax_build(CONFIG)
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.asarray(x),
    )
    out = str(tmp_path_factory.mktemp("bundle"))
    jax_export.write_bundle(
        out, {"bundle_version": jax_export.BUNDLE_VERSION, "config": CONFIG,
              "precision": "f32"},
        {"params": variables["params"]},
    )
    return out, model, variables


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, SEQ, FEATURES)).astype(np.float32)


def _jax_apply(model, variables, x):
    return np.asarray(model.apply(variables, jnp.asarray(x),
                                  deterministic=True), np.float32)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


# -- msgpack -------------------------------------------------------------------


def test_msgpack_round_trip_matches_flax_bytes():
    tree = {
        "params": {
            "a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "bias": np.zeros((4,), np.float32)},
            "b": np.array(7, np.int32),
        },
        "step": 3, "neg": -300, "big": 2 ** 40, "lr": 0.5, "name": "x" * 40,
        "flag": True, "none": None,
        "scalar": np.float32(1.25), "ints": np.arange(70000, dtype=np.int8),
    }
    # The bytes flax writes for a params tree (tune.checkpoint's writer).
    ours = _msgpack.packb(tree)
    assert ours == serialization.to_bytes(tree)
    back = _msgpack.unpackb(ours)
    np.testing.assert_array_equal(back["params"]["a"]["kernel"],
                                  tree["params"]["a"]["kernel"])
    assert back["params"]["a"]["kernel"].dtype == np.float32
    assert back["step"] == 3 and back["neg"] == -300 and back["big"] == 2 ** 40
    assert back["name"] == "x" * 40
    assert back["flag"] is True and back["none"] is None
    assert back["scalar"] == np.float32(1.25)
    np.testing.assert_array_equal(back["ints"], tree["ints"])
    assert _msgpack.unpackb(_msgpack.packb([1, 2.5, "s", b"\x00"])) == [
        1, 2.5, "s", b"\x00"]
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(ours[:-3])


def test_msgpack_decodes_flax_bfloat16_leaves_as_exact_float32():
    vals = jnp.asarray([1.5, -2.25, 3e-3, 65504.0], jnp.bfloat16)
    back = _msgpack.unpackb(serialization.to_bytes({"w": vals}))
    # A bf16 leaf stays bf16 (a torch.bfloat16 tensor); its widening to
    # float32 is exact.
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  np.asarray(vals, np.float32))


# -- bundles -------------------------------------------------------------------


def test_jax_bundle_serves_over_http_on_the_port(jax_bundle):
    path, model, variables = jax_bundle
    bundle = serve.load_bundle(path)
    assert bundle.config == CONFIG and bundle.input_features == FEATURES
    server = serve.PredictionServer(bundle, port=0, num_replicas=2,
                                    device="cpu", max_bucket=4,
                                    max_batch_size=4)
    try:
        stats = server.warmup(_rows(1, 0))
        assert stats["programs"] == 2 * 3  # buckets 1, 2, 4 per replica
        host, port = server.start()
        url = f"http://{host}:{port}"
        requests = [_rows(n, seed) for seed, n in enumerate((1, 3, 2, 4, 3))]
        answers = [None] * len(requests)

        def worker(i):
            answers[i] = _post(f"{url}/predict",
                               {"instances": requests[i].tolist()})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for x, (status, body) in zip(requests, answers):
            assert status == 200
            np.testing.assert_allclose(
                np.asarray(body["predictions"], np.float32),
                _jax_apply(model, variables, x), rtol=1e-4, atol=1e-4,
            )
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and len(health["replicas"]) == 2
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
            metrics = json.loads(resp.read())
        assert metrics["requests_total"] == len(requests)
        assert metrics["rows_total"] == 13
        assert metrics["compile"]["new_programs_since_warmup"] == 0
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/predict", {"rows": []})
        assert err.value.code == 400
    finally:
        server.close()


def test_padding_rows_do_not_change_real_rows(jax_bundle):
    path, model, variables = jax_bundle
    engine = serve.InferenceEngine(serve.load_bundle(path), max_bucket=4,
                                   device="cpu")
    x = _rows(3, 7)
    padded = engine.predict(x)  # 3 rows in the bucket of 4
    assert padded.shape == (3, 1)
    alone = np.concatenate([engine.predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(padded, alone, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(padded, _jax_apply(model, variables, x),
                               rtol=1e-4, atol=1e-4)
    # Over the top bucket: answered in top-bucket chunks.
    big = _rows(6, 8)
    np.testing.assert_allclose(engine.predict(big),
                               _jax_apply(model, variables, big),
                               rtol=1e-4, atol=1e-4)
    assert engine.program_stats()["programs"] == 3  # buckets 4, 1, 2


def test_port_bundle_loads_in_the_jax_package(tmp_path):
    from distributed_machine_learning_tpu_torch.models import build_model
    from distributed_machine_learning_tpu_torch.models.convert import (
        to_flax_params,
    )

    torch.manual_seed(0)
    model = build_model(CONFIG, FEATURES).eval()
    params = to_flax_params(model.state_dict())
    export.write_bundle(str(tmp_path), {"bundle_version": 1,
                                        "config": CONFIG}, {"params": params})
    loaded = jax_export.load_bundle(str(tmp_path))
    for a, b in zip(jax.tree.leaves(loaded.variables["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = _rows(2, 9)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        ours, _jax_apply(loaded.build_model(), loaded.variables, x),
        rtol=1e-4, atol=1e-4,
    )


def test_bad_bundles_raise(jax_bundle, tmp_path):
    path, _, _ = jax_bundle
    with pytest.raises(FileNotFoundError, match="bundle.json"):
        serve.load_bundle(str(tmp_path))
    manifest = json.load(open(os.path.join(path, "bundle.json")))
    params = open(os.path.join(path, "params.msgpack"), "rb").read()
    for name, data in (("version", dict(manifest, bundle_version=2)),
                       ("cas", dict(manifest, params_file="params.cas")),
                       ("corrupt", manifest)):
        d = tmp_path / name
        d.mkdir()
        json.dump(data, open(d / "bundle.json", "w"))
        blob = params[:-1] + bytes([params[-1] ^ 0xFF]) if name == "corrupt" \
            else params
        (d / "params.msgpack").write_bytes(blob)
        sidecar = os.path.join(path, "params.msgpack.manifest.json")
        (d / "params.msgpack.manifest.json").write_text(open(sidecar).read())
    with pytest.raises(ValueError, match="version"):
        serve.load_bundle(str(tmp_path / "version"))
    with pytest.raises(NotImplementedError, match="ref-copied"):
        serve.load_bundle(str(tmp_path / "cas"))
    with pytest.raises(export.BundleCorruptionError, match="checksum"):
        serve.load_bundle(str(tmp_path / "corrupt"))


def test_cuda_entry_points_raise_without_a_card(jax_bundle):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bundle = serve.load_bundle(jax_bundle[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.InferenceEngine(bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.PredictionServer(bundle, port=0)


# -- batchers and replicas -------------------------------------------------------


def test_continuous_batcher_bounds_its_queue():
    gate, started = threading.Event(), threading.Event()

    def infer(x):
        started.set()
        gate.wait(10)
        return x.sum(axis=1)

    batcher = serve.ContinuousBatcher(infer, max_batch_size=4, max_queue=2)
    try:
        first = batcher.submit(np.ones((1, 3)))
        assert started.wait(10)  # the first flush is in flight
        queued = [batcher.submit(np.full((1, 3), i)) for i in range(2)]
        with pytest.raises(serve.QueueFull) as exc:
            batcher.submit(np.ones((1, 3)))
        assert exc.value.retry_after_s > 0
        gate.set()
        assert first.result(10).tolist() == [3.0]
        assert [f.result(10).tolist() for f in queued] == [[0.0], [3.0]]
    finally:
        gate.set()
        batcher.stop()


def test_micro_batcher_coalesces_and_splits_results():
    sizes = []

    def infer(x):
        sizes.append(x.shape[0])
        return x[:, 0] * 2

    batcher = serve.MicroBatcher(infer, max_batch_size=4, max_latency_ms=50)
    try:
        futs = [batcher.submit(np.full((2, 1), i, np.float32))
                for i in range(2)]
        assert [f.result(10).tolist() for f in futs] == [[0, 0], [2, 2]]
        assert sum(sizes) == 4
    finally:
        batcher.stop()


def test_replica_set_redispatches_off_a_dead_replica(jax_bundle):
    path, model, variables = jax_bundle
    replicas = serve.ReplicaSet(serve.load_bundle(path), num_replicas=2,
                                device="cpu", max_bucket=2, restart=False)
    try:
        replicas.kill(0)
        x = _rows(2, 11)
        for _ in range(3):  # round-robin lands on the dead slot too
            np.testing.assert_allclose(replicas.predict(x, timeout=30),
                                       _jax_apply(model, variables, x),
                                       rtol=1e-4, atol=1e-4)
        assert replicas.num_healthy() == 1
    finally:
        replicas.close()


def test_circuit_breaker_opens_and_recovers():
    breaker = serve.CircuitBreaker(failure_threshold=2, recovery_s=0.0)
    breaker.record_failure()
    assert breaker.state == breaker.CLOSED
    breaker.record_failure()
    assert breaker.allow()  # recovery 0 s: straight to a half-open probe
    assert not breaker.allow()  # one probe at a time
    breaker.record_success()
    assert breaker.state == breaker.CLOSED
    assert breaker.stats()["opens_total"] == 1


# -- process-level checks -----------------------------------------------------------


PORT_MODULES = [
    "distributed_machine_learning_tpu_torch",
    "distributed_machine_learning_tpu_torch.__main__",
    "distributed_machine_learning_tpu_torch.chaos",
    "distributed_machine_learning_tpu_torch.ckpt",
    "distributed_machine_learning_tpu_torch.ckpt.format",
    "distributed_machine_learning_tpu_torch.ckpt.manager",
    "distributed_machine_learning_tpu_torch.ckpt.metrics",
    "distributed_machine_learning_tpu_torch.ckpt.writer",
    "distributed_machine_learning_tpu_torch.store",
    "distributed_machine_learning_tpu_torch.store.chunker",
    "distributed_machine_learning_tpu_torch.store.core",
    "distributed_machine_learning_tpu_torch.store.metrics",
    "distributed_machine_learning_tpu_torch.liveness",
    "distributed_machine_learning_tpu_torch.compilecache",
    "distributed_machine_learning_tpu_torch.compilecache.keys",
    "distributed_machine_learning_tpu_torch.models",
    "distributed_machine_learning_tpu_torch.models.convert",
    "distributed_machine_learning_tpu_torch.models.layers",
    "distributed_machine_learning_tpu_torch.models.mlp",
    "distributed_machine_learning_tpu_torch.models.resnet",
    "distributed_machine_learning_tpu_torch.models.transformer",
    "distributed_machine_learning_tpu_torch.ops.attention",
    "distributed_machine_learning_tpu_torch.ops.flash_attention",
    "distributed_machine_learning_tpu_torch.ops._build",
    "distributed_machine_learning_tpu_torch.ops.flops",
    "distributed_machine_learning_tpu_torch.ops.losses",
    "distributed_machine_learning_tpu_torch.ops.optimizers",
    "distributed_machine_learning_tpu_torch.ops.rng",
    "distributed_machine_learning_tpu_torch.ops.schedules",
    "distributed_machine_learning_tpu_torch.data",
    "distributed_machine_learning_tpu_torch.data.loader",
    "distributed_machine_learning_tpu_torch.data.native",
    "distributed_machine_learning_tpu_torch.data.pipeline",
    "distributed_machine_learning_tpu_torch.data.synthetic",
    "distributed_machine_learning_tpu_torch.data.features",
    "distributed_machine_learning_tpu_torch.perf.costmodel",
    "distributed_machine_learning_tpu_torch.serve",
    "distributed_machine_learning_tpu_torch.serve.export",
    "distributed_machine_learning_tpu_torch.serve.swap",
    "distributed_machine_learning_tpu_torch.quant",
    "distributed_machine_learning_tpu_torch.quant.core",
    "distributed_machine_learning_tpu_torch.quant.calibrate",
    "distributed_machine_learning_tpu_torch.quant.api",
    "distributed_machine_learning_tpu_torch.tune",
    "distributed_machine_learning_tpu_torch.tune.session",
    "distributed_machine_learning_tpu_torch.tune._driver",
    "distributed_machine_learning_tpu_torch.tune.runner",
    "distributed_machine_learning_tpu_torch.tune.callbacks",
    "distributed_machine_learning_tpu_torch.tune._process_child",
    "distributed_machine_learning_tpu_torch.tune.journal",
    "distributed_machine_learning_tpu_torch.tune.crashsim",
    "distributed_machine_learning_tpu_torch.tune.executor",
    "distributed_machine_learning_tpu_torch.tune.trainable",
    "distributed_machine_learning_tpu_torch.tune._regression_program",
    "distributed_machine_learning_tpu_torch.tune.vectorized",
    "distributed_machine_learning_tpu_torch.tune.schedulers.pbt",
    "distributed_machine_learning_tpu_torch.tune.schedulers.pb2",
    "distributed_machine_learning_tpu_torch.utils.device",
    "distributed_machine_learning_tpu_torch.utils.registry",
    "distributed_machine_learning_tpu_torch.utils.seeding",
    "chip_smoke",
    "chip_quickstart",
    "chip_vectorized",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'msgpack', "
        "'distributed_machine_learning_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_serve_cli_usage_and_missing_bundle(tmp_path):
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch"]
    proc = subprocess.run(cmd + ["serve", "--bundle", str(tmp_path),
                                 "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "not a bundle directory" in proc.stderr
    proc = subprocess.run(cmd + ["bogus"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2 and "serve" in proc.stderr
