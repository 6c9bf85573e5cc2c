"""The port's storage layer and storage faults against the JAX package's.

* ``FsspecStorage`` on fsspec's ``memory://`` gives the JAX backend's
  write/read/exists/list/delete results, and ``get_storage`` composes the
  same wrappers (fault layer inside the retry layer).
* One ``FaultPlan(seed=...)`` over one sequence of storage calls decides
  as the JAX plan does: the same raise/no-raise sequence and exception
  classes, the same corrupted bytes and ``corrupted_paths``, the same
  ``snapshot()`` counters.  ``_hash_fraction`` is the JAX function bit for
  bit.
* Through ``get_storage`` with the plan active: transient faults are
  absorbed by the retries, a COMMIT kill is not, stalls fire once.
* The JAX plan's other faults are refused by name (ROADMAP.md A10).

Every fsspec ``memory://`` root is the test's own and is removed after
it (``memory://`` is one namespace per process, and not the port's
``mem://``).  All comparisons are exact.
"""

from __future__ import annotations

import json
import uuid

import numpy as np
import pytest

from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
from _torch_tune_common import no_cache_no_orphans  # noqa: E402,F401
from _torch_tune_common import restore_global_state  # noqa: E402,F401

torch = pytest.importorskip("torch")

from distributed_machine_learning_tpu import chaos as jax_chaos  # noqa: E402
from distributed_machine_learning_tpu.tune import storage as jax_storage  # noqa: E402
from distributed_machine_learning_tpu_torch import chaos  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import storage  # noqa: E402

pytestmark = pytest.mark.usefixtures("no_cache_no_orphans")


def _fs_rm(root: str) -> None:
    import fsspec

    fs = fsspec.filesystem("memory")
    path = root.split("://", 1)[1]
    if fs.exists(path):
        fs.rm(path, recursive=True)


@pytest.fixture
def memroot():
    """A fresh fsspec ``memory://`` root per package, removed after."""
    tag = uuid.uuid4().hex[:10]
    roots = (f"memory://port-{tag}", f"memory://jax-{tag}")
    yield roots
    for root in roots:
        _fs_rm(root)


@pytest.fixture
def fast_retries():
    """Both packages' retry policy with no sleeps (restored after)."""
    saved = (storage._default_retry_policy, jax_storage._default_retry_policy)
    storage.set_default_retry_policy(storage.RetryPolicy(
        attempts=6, base_delay_s=0.0, max_delay_s=0.0, jitter=0.0))
    jax_storage.set_default_retry_policy(jax_storage.RetryPolicy(
        attempts=6, base_delay_s=0.0, max_delay_s=0.0, jitter=0.0))
    yield
    storage.set_default_retry_policy(saved[0])
    jax_storage.set_default_retry_policy(saved[1])


def _backend_script(get, root):
    """One sequence of byte operations; every result, paths relative."""
    backend, base = get(root)
    out = []
    for name, data in (("a/x.bin", b"\x00\x01"), ("a/y.bin", b"yy"),
                       ("b/z/w.bin", b"w" * 300), ("top.json", b"{}")):
        backend.write_bytes(backend.join(base, name), data)
    out.append(backend.read_bytes(backend.join(base, "a/x.bin")))
    out.append(backend.read_bytes(backend.join(base, "missing")))
    out.append(backend.exists(backend.join(base, "b/z/w.bin")))
    out.append(backend.exists(backend.join(base, "b/q")))
    out.append(backend.listdir(base))
    out.append(backend.listdir(backend.join(base, "a")))
    out.append(backend.listdir(backend.join(base, "nope")))
    backend.delete(backend.join(base, "a/x.bin"))
    backend.delete(backend.join(base, "a/never"))
    out.append(backend.listdir(backend.join(base, "a")))
    out.append(backend.read_bytes(backend.join(base, "a/x.bin")))
    backend.write_bytes(backend.join(base, "a/y.bin"), b"overwritten")
    out.append(backend.read_bytes(backend.join(base, "a/y.bin")))
    return out


def test_fsspec_memory_backend_matches_the_jax_backend(memroot):
    port_root, jax_root = memroot
    got = _backend_script(storage.get_storage, port_root)
    want = _backend_script(jax_storage.get_storage, jax_root)
    assert got == want
    assert got[4] == ["a", "b", "top.json"]
    # fsspec's memory:// is not the port's mem:// namespace.
    assert storage.get_storage(port_root.replace("memory://", "mem://"))[
        0].read_bytes(port_root.replace("memory://", "mem://") + "/top.json"
                      ) is None


@pytest.mark.parametrize("path,kind", [
    ("/tmp/x", "LocalStorage"), ("file:///tmp/x", "LocalStorage"),
    ("mem://x", "MemoryStorage"), ("memory://x", "FsspecStorage"),
])
def test_get_storage_dispatches_and_wraps_as_the_jax_package(path, kind):
    for lib in (storage, jax_storage):
        backend, p = lib.get_storage(path)
        assert type(backend).__name__ == "RetryingStorage"
        assert type(backend.inner).__name__ == kind
        raw_backend, raw_p = lib._raw_storage(path)
        assert raw_backend is backend.inner and raw_p == p
    assert storage.get_storage(path)[1] == jax_storage.get_storage(path)[1]
    # One fsspec backend per scheme, cached.
    if kind == "FsspecStorage":
        assert storage._raw_storage(path)[0] is storage._raw_storage(
            "memory://other")[0]


def test_fault_wrapper_sits_inside_the_retry_layer():
    plan = chaos.FaultPlan(seed=1)
    with chaos.active(plan):
        backend, _ = storage.get_storage("mem://w")
        assert type(backend).__name__ == "RetryingStorage"
        assert isinstance(backend.inner, chaos.FaultyStorage)
        assert backend.inner.plan is plan
        assert type(backend.inner.inner).__name__ == "MemoryStorage"
    backend, _ = storage.get_storage("mem://w")
    assert not isinstance(backend.inner, chaos.FaultyStorage)
    saved = storage._default_retry_policy
    storage.set_default_retry_policy(None)
    try:
        backend, _ = storage.get_storage("mem://w")
        assert type(backend).__name__ == "MemoryStorage"
        assert storage.retry_call(lambda: 5) == 5
    finally:
        storage.set_default_retry_policy(saved)


@pytest.mark.parametrize("parts", [
    (0, "write", "/a/b", 0), (11, "chunk_write", "/e/L0.0-0.chunk", 7),
    ("seed", "slow", "read:/x", 123456789), (3, "drift_dim", 2),
    (2**40, "", "", -1),
])
def test_hash_fraction_is_the_jax_function(parts):
    assert chaos._hash_fraction(*parts) == jax_chaos._hash_fraction(*parts)


PLAN = dict(
    write_error_rate=0.2,
    read_error_rate=0.15,
    slow_rate=0.1,
    slow_s=0.0,
    chunk_write_error_rate=0.3,
    kill_before_commit=["trial_00001/checkpoints/gen_000003"],
    corrupt_path_substrings=["ckpt_000002", "index.json"],
    blob_corrupt_on_publish=2,
    kill_during_ref_flip=["refs/ckpt-"],
    stall_storage_paths=["gen_000002/index.json"],
    stall_storage_ms=1.0,
)

PATHS = [
    "/e/trial_00000/checkpoints/ckpt_000001.json",
    "/e/trial_00000/checkpoints/ckpt_000002.tensors",
    "/e/trial_00001/checkpoints/gen_000003/COMMIT",
    "/e/trial_00001/checkpoints/gen_000002/index.json",
    "/e/trial_00001/checkpoints/gen_000002/L0.0-0.chunk",
    "/e/trial_00001/checkpoints/.cas/blobs/ab/" + "ab" * 32,
    "/e/trial_00002/checkpoints/.cas/refs/ckpt-0123",
]


def _calls(seed: int):
    """A seeded stream of storage calls over checkpoint-shaped paths."""
    rng = np.random.RandomState(seed)
    ops = ["write", "read", "exists", "listdir", "delete"]
    return [(ops[rng.randint(len(ops))], PATHS[rng.randint(len(PATHS))])
            for _ in range(300)]


def _drive(lib, seed: int, calls):
    plan = lib.FaultPlan(seed, **PLAN)
    out = []
    for op, path in calls:
        try:
            plan.on_storage_op(op, path)
            out.append("ok")
        except lib.InjectedFault as exc:
            out.append(type(exc).__name__)
        if op == "write":
            out.append(plan.corrupt_write(path, b"payload-" + path.encode()))
    for i in range(3):
        out.append(plan.corrupt_blob_publish(f"/s/blobs/{i}",
                                             bytes(range(200))))
    for path in ("/s/refs/ckpt-1", "/s/refs/ckpt-2", "/s/refs/dataset-w"):
        try:
            plan.maybe_kill_ref_flip(path)
            out.append("ok")
        except lib.InjectedFault as exc:
            out.append(type(exc).__name__)
    return out, plan.snapshot(), list(plan.corrupted_paths)


@pytest.mark.parametrize("seed", [0, 7, 11, 2026])
def test_the_same_seed_fires_the_same_faults(seed):
    calls = _calls(seed)
    got, got_counters, got_paths = _drive(chaos, seed, calls)
    want, want_counters, want_paths = _drive(jax_chaos, seed, calls)
    assert got == want
    assert got_counters == want_counters
    assert got_paths == want_paths
    # The stream is long enough for every kind of fault to fire.
    for name in ("storage_write_errors", "storage_read_errors",
                 "chunk_write_errors", "commit_kills", "storage_corruptions",
                 "blob_corruptions", "ref_flip_kills", "storage_slow",
                 "storage_stalls"):
        assert got_counters.get(name, 0) >= 1, (name, got_counters)


def test_corrupt_bytes_is_the_jax_function():
    data = bytes(range(256)) * 3
    assert chaos.corrupt_bytes(data) == jax_chaos.corrupt_bytes(data)
    assert chaos.corrupt_bytes(data, 5) == jax_chaos.corrupt_bytes(data, 5)
    assert chaos.corrupt_bytes(chaos.corrupt_bytes(data)) == data


def _write_many(lib, get, root, n=40):
    """``n`` writes and reads through get_storage; the values read."""
    backend, base = get(root)
    out = []
    for i in range(n):
        path = backend.join(base, f"t/ckpt_{i:06d}.json")
        backend.write_bytes(path, f"v{i}".encode())
        out.append(backend.read_bytes(path))
    return out


def test_retries_absorb_transient_faults_as_in_the_jax_package(
        memroot, fast_retries):
    port_root, jax_root = memroot
    kwargs = dict(write_error_rate=0.3, read_error_rate=0.3)
    with chaos.active(chaos.FaultPlan(5, **kwargs)) as plan:
        got = _write_many(chaos, storage.get_storage, port_root)
    with jax_chaos.active(jax_chaos.FaultPlan(5, **kwargs)) as jax_plan:
        want = _write_many(jax_chaos, jax_storage.get_storage, jax_root)
    assert got == want == [f"v{i}".encode() for i in range(40)]
    # The paths differ by root, so the rolls do too; each package's
    # faults fired and were all absorbed.
    assert plan.snapshot()["storage_write_errors"] >= 1
    assert plan.snapshot()["storage_read_errors"] >= 1
    assert jax_plan.snapshot()["storage_write_errors"] >= 1
    # On equal paths the two plans fire identically.
    with chaos.active(chaos.FaultPlan(5, **kwargs)) as a:
        _write_many(chaos, storage.get_storage, "mem://same")
    with jax_chaos.active(jax_chaos.FaultPlan(5, **kwargs)) as b:
        _write_many(jax_chaos, jax_storage.get_storage, "mem://same")
    assert a.snapshot() == b.snapshot()
    storage.MemoryStorage.clear()
    jax_storage.MemoryStorage.clear()


def test_a_commit_kill_is_not_retried_and_fires_once(fast_retries):
    plan = chaos.FaultPlan(kill_before_commit=["gen_000003"],
                           stall_storage_paths=["gen_000003"],
                           stall_storage_ms=1.0)
    with chaos.active(plan):
        backend, base = storage.get_storage("mem://kill")
        backend.write_bytes(base + "/gen_000003/index.json", b"{}")
        with pytest.raises(chaos.InjectedCommitKill):
            backend.write_bytes(base + "/gen_000003/COMMIT", b"{}")
        assert backend.read_bytes(base + "/gen_000003/COMMIT") is None
        backend.write_bytes(base + "/gen_000003/COMMIT", b"{}")
    assert plan.snapshot() == {"commit_kills": 1, "storage_stalls": 1}
    assert not isinstance(chaos.InjectedCommitKill("x"), OSError)
    assert isinstance(chaos.InjectedIOError("x"), OSError)
    storage.MemoryStorage.clear()


@pytest.mark.parametrize("knob,value", [
    ("trial_crashes", [("trial_00000", 1)]), ("replica_kills", [(1, 0)]),
    ("hang_dispatch_at", [("trial_00000", 1)]), ("hot_swaps", [3]),
    ("partition_worker", [(1, 0, 1.0)]), ("corrupt_bundle_on_export", 1),
    ("artifact_fetch_error_rate", 0.5), ("mid_swap_crash", [2]),
])
def test_the_other_faults_stay_refused_by_name(knob, value):
    jax_chaos.FaultPlan(**{knob: value})  # a JAX argument
    with pytest.raises(NotImplementedError,
                       match=rf"FaultPlan\({knob}=\.\.\.\).*ROADMAP.md A10$"):
        chaos.FaultPlan(seed=1, **{knob: value})


def test_a_storage_plan_reaches_a_process_through_the_environment(
        monkeypatch):
    spec = dict(PLAN, seed=9)
    monkeypatch.setenv(chaos.PLAN_ENV_VAR, json.dumps(spec))
    monkeypatch.setenv(jax_chaos.PLAN_ENV_VAR, json.dumps(spec))
    try:
        plan = chaos.activate_from_env()
        assert chaos.active_plan() is plan and plan.seed == 9
        backend, _ = storage.get_storage("mem://env")
        assert isinstance(backend.inner, chaos.FaultyStorage)
    finally:
        chaos.deactivate()
    calls = _calls(9)
    got = _drive(chaos, 9, calls)
    want = _drive(jax_chaos, 9, calls)
    assert got == want
