"""Hot swap and rollback on the port's serving plane (CPU).

``serve/swap.py`` against the JAX module's contract: a swap under
concurrent request threads drops nothing and builds no bucket on the
serving path; rollback re-promotes the retired bundle, raises
``LookupError`` with nothing retained and keeps at most
``HISTORY_DEPTH`` bundles; and the admin routes and the swap block of
``/metrics`` over HTTP.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu.serve import swap as jax_swap  # noqa: E402
from distributed_machine_learning_tpu_torch import quant, serve  # noqa: E402
from distributed_machine_learning_tpu_torch.models import (  # noqa: E402
    build_model,
    init_parameters,
)
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    to_flax_params,
)

CONFIG = dict(model="mlp", hidden_sizes=[16, 8])
SEQ, FEATURES = 4, 3


def _rows(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, SEQ, FEATURES)).astype(np.float32)


def _bundle_dir(root, seed):
    model = init_parameters(build_model(CONFIG, SEQ * FEATURES),
                            torch.Generator().manual_seed(seed))
    return serve.write_bundle(
        str(root), {"bundle_version": serve.BUNDLE_VERSION,
                    "config": CONFIG, "precision": "f32"},
        {"params": to_flax_params(model.state_dict())})


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """f32 bundles of seeds 0..5 and the int8 sibling of seed 0."""
    root = tmp_path_factory.mktemp("bundles")
    dirs = [_bundle_dir(root / f"f32_{s}", s) for s in range(6)]
    int8 = quant.quantize_bundle(dirs[0], str(root / "int8"), "int8",
                                 _rows(8, 9), device="cpu")
    return dirs, int8


def _answer(bundle_dir, x):
    engine = serve.InferenceEngine(serve.load_bundle(bundle_dir),
                                   max_bucket=8, device="cpu")
    return engine.predict(x)


def test_history_depth_matches_the_jax_module():
    assert serve.HISTORY_DEPTH == jax_swap.HISTORY_DEPTH == 4


def test_hot_swap_under_concurrent_requests_drops_nothing(bundles):
    dirs, int8 = bundles
    rs = serve.ReplicaSet(serve.load_bundle(dirs[1]), num_replicas=2,
                          device="cpu", max_bucket=8, max_batch_size=8)
    x = _rows(3, 1)
    old, new = _answer(dirs[1], x), _answer(int8, x)
    answers, errors = [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                answers.append(rs.predict(x, timeout=30))
            except Exception as exc:  # noqa: BLE001 - counted below
                errors.append(exc)

    try:
        rs.warmup(_rows(1, 0))
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        while len(answers) < 20:
            pass
        event = rs.hot_swap(serve.load_bundle(int8))
        after = len(answers)
        while len(answers) < after + 20:
            pass
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        assert event["replicas_swapped"] == 2 and event["duration_s"] >= 0
        # Every answer is one model's whole answer, the old or the new.
        for a in answers:
            assert (np.array_equal(a, old) or np.array_equal(a, new)), a
        assert np.array_equal(answers[-1], new)
        stats = rs.program_stats()
        assert stats["new_programs_since_warmup"] == 0
        assert {p["precision"] for p in stats["per_replica"]} == {"int8"}
        assert rs.swaps == 1 and rs.bundle.precision == "int8"
        assert rs.swap_history[-1]["programs_after"] == stats["programs"]
    finally:
        stop.set()
        rs.close()


def test_rollback_repromotes_and_history_is_bounded(bundles):
    dirs, _ = bundles
    rs = serve.ReplicaSet(serve.load_bundle(dirs[0]), num_replicas=1,
                          device="cpu", max_bucket=4, max_batch_size=4)
    x = _rows(2, 3)
    try:
        with pytest.raises(LookupError, match="nothing to roll back to"):
            serve.rollback(rs)
        rs.warmup(_rows(1, 0))
        for d in dirs[1:]:
            serve.warm_swap_bundle(rs, d)
        assert rs.swaps == 5
        # Six bundles served, the newest live: four retained, oldest gone.
        assert [e["path"] for e in rs.bundle_history] == dirs[1:5]
        event = serve.rollback(rs, reason="probe")
        assert event["rollback"] and event["rolled_back_to"] == dirs[4]
        assert event["reason"] == "probe" and rs.rollbacks == 1
        assert rs.swap_history[-1] is event
        assert rs.bundle.path == dirs[4]
        np.testing.assert_array_equal(rs.predict(x), _answer(dirs[4], x))
        # The rollback retired dirs[5], so it is retained in turn.
        assert [e["path"] for e in rs.bundle_history] == \
            dirs[1:4] + [dirs[5]]
        # A second rollback undoes the first.
        assert serve.rollback(rs)["rolled_back_to"] == dirs[5]
        assert len(rs.bundle_history) == serve.HISTORY_DEPTH
        assert rs.program_stats()["new_programs_since_warmup"] == 0
    finally:
        rs.close()


def _request(url, payload=None, method="POST"):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_admin_routes_and_metrics_over_http(bundles, tmp_path):
    dirs, int8 = bundles
    server = serve.PredictionServer(serve.load_bundle(dirs[0]), port=0,
                                    num_replicas=2, device="cpu",
                                    max_bucket=4, max_batch_size=4)
    x = _rows(3, 5)
    try:
        server.warmup(_rows(1, 0))
        host, port = server.start()
        url = f"http://{host}:{port}"
        status, body = _request(f"{url}/admin/rollback", {})
        assert status == 409 and "nothing to roll back" in body["error"]
        status, metrics = _request(f"{url}/metrics", method="GET")
        assert metrics["precision"] == "f32"
        assert metrics["quality_delta_mape"] is None
        assert metrics["swap"]["swaps_total"] == 0
        status, body = _request(f"{url}/admin/swap", {})
        assert status == 400 and "bundle" in body["error"]
        status, body = _request(f"{url}/admin/swap",
                                {"bundle": str(tmp_path / "nope")})
        assert status == 400 and "not a bundle directory" in body["error"]
        status, body = _request(f"{url}/admin/swap", {"bundle": int8})
        assert status == 200 and body["swapped"] and \
            body["replicas_swapped"] == 2
        status, body = _request(f"{url}/predict", {"instances": x.tolist()})
        np.testing.assert_array_equal(
            np.asarray(body["predictions"], np.float32), _answer(int8, x))
        status, metrics = _request(f"{url}/metrics", method="GET")
        delta = serve.load_bundle(int8).quality_delta_mape
        assert metrics["precision"] == "int8"
        assert metrics["quality_delta_mape"] == delta > 0
        assert metrics["swap"]["swaps_total"] == 1
        assert metrics["swap"]["retained"] == [dirs[0]]
        assert metrics["compile"]["new_programs_since_warmup"] == 0
        status, health = _request(f"{url}/healthz", method="GET")
        assert health["precision"] == "int8"
        status, body = _request(f"{url}/admin/rollback", {"reason": "test"})
        assert status == 200 and body["rolled_back"]
        assert body["rolled_back_to"] == dirs[0] and body["reason"] == "test"
        status, metrics = _request(f"{url}/metrics", method="GET")
        assert metrics["precision"] == "f32"
        assert metrics["swap"]["rollbacks_total"] == 1
        assert metrics["swap"]["swaps_total"] == 2
        assert metrics["swap"]["history"][-1]["rollback"] is True
        status, body = _request(f"{url}/predict", {"instances": x.tolist()})
        np.testing.assert_array_equal(
            np.asarray(body["predictions"], np.float32), _answer(dirs[0], x))
    finally:
        server.close()
