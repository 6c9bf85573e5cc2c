"""Deterministic fault injection: storage, head and producer faults.

Port of the storage, head-crash and streaming-input faults of
``distributed_machine_learning_tpu/chaos.py`` and of its process-wide
activation (``activate``, ``deactivate``, ``active_plan``, ``active``,
``DML_CHAOS_PLAN``).

**Storage** — ``FaultyStorage`` wraps any ``StorageBackend``;
:func:`activate` installs it through ``tune.storage.set_fault_wrapper``,
INSIDE the retry layer, so injected transient errors are absorbed by the
same retries real ones are.  Probabilistic decisions are a pure hash of
``(seed, op, key, n)`` (:func:`_hash_fraction`, the JAX package's bit for
bit), where ``n`` counts the calls per ``(op, key)``: each path's fault
sequence is fixed by the seed however threads interleave, and the same
plan fires the same faults on the same paths in either package.

* ``write_error_rate`` / ``read_error_rate`` — raise
  :class:`InjectedIOError` before the backend runs (transient: the retry's
  next attempt re-rolls).
* ``slow_rate`` / ``slow_s`` — sleep ``slow_s`` before the operation.
* ``chunk_write_error_rate`` — like ``write_error_rate`` but only for
  checkpoint chunk payloads: ``*.chunk`` files (``ckpt/format.py``) and
  content-store blob publishes (``blobs/<hh>/<sha256>``, ``store/core.py``).
* ``corrupt_path_substrings`` — the first write whose path contains each
  substring has its payload bit-flipped ON DISK (checksums computed
  upstream catch it on restore).
* ``kill_before_commit`` — path substrings; the first write of a
  ``COMMIT`` marker whose path contains each raises
  :class:`InjectedCommitKill` instead of landing (a preempted save).
* ``blob_corrupt_on_publish`` — this many content-store blob publishes
  land bit-flipped (``store verify`` catches them).
* ``kill_during_ref_flip`` — path substrings; the first content-store ref
  update whose path contains each raises :class:`InjectedRefFlipKill`
  before the atomic replace lands (the old ref survives).
* ``stall_storage_paths`` / ``stall_storage_ms`` — the first storage op
  whose path contains each substring sleeps ``stall_storage_ms``.

**Head kills** — the experiment journal (``tune/journal.py``) polls the
active plan around every decision append:

* ``kill_head_at`` — a decision number N; the head process hard-exits
  (``os._exit(86)``) right after the Nth decision record lands durably
  in the journal and before its effect happens — the
  journaled-but-not-acted crash window ``resume="auto"`` replays
  through.
* ``kill_head_during_journal_write`` — a decision number N; the head
  dies MID-append of the Nth decision record: half the JSON line is
  written and fsync'd, then ``os._exit(87)`` — the torn tail the journal
  parser treats as "decision never happened".

Both fire once, and only on head incarnation 1: the resumed head
activates the same plan from ``DML_CHAOS_PLAN`` and must pass the same
decision unharmed.

**Streaming input** — the prefetch ring's producer thread
(``data/pipeline.py``) polls the active plan before it stages each chunk:

* ``slow_producer_ms`` — the producer sleeps this long before every
  chunk (slow storage, a starved gather): the overlap efficiency drops,
  the parameters do not change.  ``slow_producer_match`` — ring-name
  substrings (rings are named ``stream-<trial_id>``): only matching
  producers sleep.
* ``producer_crash_at`` — a chunk index (0-based, across the trial's
  whole chunk stream); the producer raises
  :class:`InjectedProducerCrash` before staging it.  Fires once: the
  retried incarnation's producer passes the same index.

Every injection increments a named counter (:meth:`FaultPlan.snapshot`).
The JAX plan's other faults (trial crashes, process and replica kills,
hot swaps, hangs, partitions, drift and export faults) and its
``injected_faults`` metrics family belong to the chaos and observability
planes, ROADMAP.md A10: any of those ``FaultPlan`` arguments raises
``NotImplementedError`` naming that item.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from distributed_machine_learning_tpu_torch.tune import storage as storage_lib

#: Exit codes of an injected head death (the JAX package's).
HEAD_KILL_EXIT = 86
TORN_JOURNAL_EXIT = 87


class InjectedFault(Exception):
    """Base class for every chaos-injected failure (marker for tests)."""


class InjectedIOError(InjectedFault, IOError):
    """Transient storage fault.  Subclasses IOError/OSError so the retry
    policy and existing error handling treat it exactly like the real
    thing."""


class InjectedProducerCrash(InjectedFault, RuntimeError):
    """The host-input producer thread killed at a scheduled chunk index
    (``data/pipeline.py``).  Raised inside the producer; the prefetch ring
    raises it again on the consumer (trial) thread, so it takes the
    ordinary trial error path: the retry budget, the checkpoint restore,
    the device's release."""


class InjectedCommitKill(InjectedFault, RuntimeError):
    """A process killed between a sharded checkpoint's chunk writes and its
    COMMIT marker.  Deliberately NOT an OSError: the storage retry policy
    must not absorb it — a real SIGKILL doesn't retry either.  The save
    fails with the generation left uncommitted, exercising the ckpt/
    commit protocol (readers skip it; the manager deletes it on start)."""


class InjectedRefFlipKill(InjectedFault, RuntimeError):
    """A process killed between preparing a content-store ref update and
    landing it (``store/core.set_ref``).  NOT an OSError — the storage
    retry policy must not absorb it.  The atomic-ref contract means the
    OLD ref value survives intact; the in-flight publish's blobs stay
    unreferenced until GC collects them."""


def _hash_fraction(*parts) -> float:
    """Uniform [0, 1) value from a stable hash of the parts."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") / 2**64


class FaultPlan:
    """A seeded schedule of storage faults, head kills and producer faults
    (see the module docstring)."""

    def __init__(
        self,
        seed: int = 0,
        *,
        write_error_rate: float = 0.0,
        read_error_rate: float = 0.0,
        slow_rate: float = 0.0,
        slow_s: float = 0.02,
        chunk_write_error_rate: float = 0.0,
        kill_before_commit: Sequence[str] = (),
        corrupt_path_substrings: Sequence[str] = (),
        blob_corrupt_on_publish: int = 0,
        kill_during_ref_flip: Sequence[str] = (),
        kill_head_at: Optional[int] = None,
        kill_head_during_journal_write: Optional[int] = None,
        stall_storage_paths: Sequence[str] = (),
        stall_storage_ms: float = 0.0,
        slow_producer_ms: float = 0.0,
        slow_producer_match: Sequence[str] = (),
        producer_crash_at: Optional[int] = None,
        **unported,
    ):
        if unported:
            raise NotImplementedError(
                f"FaultPlan({', '.join(sorted(unported))}=...) is not "
                f"ported yet; see ROADMAP.md A10"
            )
        self.seed = seed
        self.write_error_rate = float(write_error_rate)
        self.read_error_rate = float(read_error_rate)
        self.slow_rate = float(slow_rate)
        self.slow_s = float(slow_s)
        self.chunk_write_error_rate = float(chunk_write_error_rate)
        self._commit_kill_pending: List[str] = list(kill_before_commit)
        self._corrupt_pending: List[str] = list(corrupt_path_substrings)
        self._blob_corruptions_pending = int(blob_corrupt_on_publish)
        self._ref_flip_kill_pending: List[str] = list(kill_during_ref_flip)
        self._kill_head_at = (
            int(kill_head_at) if kill_head_at is not None else None
        )
        self._torn_journal_at = (
            int(kill_head_during_journal_write)
            if kill_head_during_journal_write is not None else None
        )
        self._stall_pending: List[str] = list(stall_storage_paths)
        self.stall_storage_ms = float(stall_storage_ms)
        self.slow_producer_ms = float(slow_producer_ms)
        self.slow_producer_match = tuple(
            str(s) for s in slow_producer_match
        )
        self._producer_crash_at = (
            int(producer_crash_at) if producer_crash_at is not None else None
        )
        self._lock = threading.Lock()
        self._op_counts: Dict[Tuple[str, str], int] = {}
        self._counters: Dict[str, int] = {}
        self.corrupted_paths: List[str] = []

    # -- bookkeeping ---------------------------------------------------------

    def _next_index(self, op: str, key: str) -> int:
        with self._lock:
            n = self._op_counts.get((op, key), 0)
            self._op_counts[(op, key)] = n + 1
            return n

    def _count(self, name: str) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        """Copy of the injected-fault counters (what actually fired)."""
        with self._lock:
            return dict(self._counters)

    # -- storage faults ------------------------------------------------------

    def _roll(self, op: str, key: str, rate: float) -> bool:
        if rate <= 0.0:
            return False
        n = self._next_index(op, key)
        return _hash_fraction(self.seed, op, key, n) < rate

    def on_storage_op(self, op: str, path: str) -> None:
        """Called by FaultyStorage before the real backend op; may sleep
        and/or raise InjectedIOError."""
        if self.stall_storage_ms > 0:
            with self._lock:
                hit = next(
                    (s for s in self._stall_pending if s in path), None
                )
                if hit is not None:
                    self._stall_pending.remove(hit)
                    self._counters["storage_stalls"] = (
                        self._counters.get("storage_stalls", 0) + 1
                    )
            if hit is not None:
                time.sleep(self.stall_storage_ms / 1000.0)
        if self._roll("slow", f"{op}:{path}", self.slow_rate):
            self._count("storage_slow")
            time.sleep(self.slow_s)
        if op == "write" and path.rstrip("/").endswith("/COMMIT"):
            # Kill-between-chunks-and-COMMIT: the generation's data is all
            # on storage, its marker never lands — a preempted save.
            with self._lock:
                hit = next(
                    (s for s in self._commit_kill_pending if s in path), None
                )
                if hit is not None:
                    self._commit_kill_pending.remove(hit)
                    self._counters["commit_kills"] = (
                        self._counters.get("commit_kills", 0) + 1
                    )
            if hit is not None:
                raise InjectedCommitKill(
                    f"injected kill before COMMIT of {path}"
                )
        if (
            op == "write"
            and (path.endswith(".chunk") or "/blobs/" in path)
            and self._roll("chunk_write", path, self.chunk_write_error_rate)
        ):
            self._count("chunk_write_errors")
            raise InjectedIOError(
                f"injected transient chunk write fault on {path}"
            )
        rate = (self.write_error_rate if op == "write"
                else self.read_error_rate if op == "read" else 0.0)
        if self._roll(op, path, rate):
            self._count(f"storage_{op}_errors")
            raise InjectedIOError(
                f"injected transient {op} fault on {path}"
            )

    def corrupt_write(self, path: str, data: bytes) -> bytes:
        """Return ``data``, bit-flipped once per scheduled path substring."""
        with self._lock:
            hit = next(
                (s for s in self._corrupt_pending if s in path), None
            )
            if hit is None:
                return data
            self._corrupt_pending.remove(hit)
            self.corrupted_paths.append(path)
            self._counters["storage_corruptions"] = (
                self._counters.get("storage_corruptions", 0) + 1
            )
        return corrupt_bytes(data)

    # -- content-store faults ------------------------------------------------

    def corrupt_blob_publish(self, path: str, data: bytes) -> bytes:
        """Called by ``store/core.put_blob`` with the blob payload about
        to land; returns it bit-flipped while scheduled corruptions
        remain (``blob_corrupt_on_publish``) — the stored bytes then no
        longer hash to the blob's name, which only ``store verify`` (or
        a verifying read) detects.  Counts ``blob_corruptions``."""
        with self._lock:
            if self._blob_corruptions_pending <= 0:
                return data
            self._blob_corruptions_pending -= 1
            self.corrupted_paths.append(path)
            self._counters["blob_corruptions"] = (
                self._counters.get("blob_corruptions", 0) + 1
            )
        return corrupt_bytes(data)

    def maybe_kill_ref_flip(self, path: str) -> None:
        """Raise :class:`InjectedRefFlipKill` before a content-store ref
        update whose path contains a scheduled substring lands (fires
        once per entry; counts ``ref_flip_kills``) — the writer dies mid
        ref flip, the OLD ref value survives."""
        with self._lock:
            hit = next(
                (s for s in self._ref_flip_kill_pending if s in path), None
            )
            if hit is not None:
                self._ref_flip_kill_pending.remove(hit)
                self._counters["ref_flip_kills"] = (
                    self._counters.get("ref_flip_kills", 0) + 1
                )
        if hit is not None:
            raise InjectedRefFlipKill(
                f"injected kill during ref flip of {path}"
            )

    # -- streaming-input faults ----------------------------------------------

    def maybe_producer_fault(
        self, chunk_index: int, name: Optional[str] = None
    ) -> None:
        """Called by the prefetch ring's producer thread before it stages
        each chunk: sleeps ``slow_producer_ms`` (every chunk) and raises
        :class:`InjectedProducerCrash` at the scheduled index (once).

        With ``slow_producer_match`` set, only rings whose ``name``
        contains one of the substrings sleep (a ring is named
        ``stream-<trial_id>``): one trial of a sweep degrades while its
        peers run clean."""
        if self.slow_producer_ms > 0 and (
            not self.slow_producer_match
            or (name is not None and any(
                s in name for s in self.slow_producer_match
            ))
        ):
            self._count("producer_slowdowns")
            time.sleep(self.slow_producer_ms / 1000.0)
        crash = False
        with self._lock:
            if self._producer_crash_at is not None \
                    and int(chunk_index) >= self._producer_crash_at:
                self._producer_crash_at = None
                self._counters["producer_crashes"] = (
                    self._counters.get("producer_crashes", 0) + 1
                )
                crash = True
        if crash:
            raise InjectedProducerCrash(
                f"injected producer crash at chunk {chunk_index}"
            )

    # -- head faults ---------------------------------------------------------

    def maybe_kill_head(self, decision_n: int, incarnation: int = 1) -> None:
        """Hard-exit the HEAD process if the scheduled decision number has
        been reached — called by ``tune/journal.py`` right after a
        decision record lands durably (fsync'd) and BEFORE its effect
        happens, so resume must replay a journaled-but-unacted decision.
        ``os._exit`` (no unwinding): a SIGKILLed head doesn't flush
        either.  Fires only on head incarnation 1."""
        # Lock-free fast path: a stale read costs one extra lock round
        # trip at most — the check re-runs under the lock before firing.
        if int(incarnation) > 1 or self._kill_head_at is None:
            return
        with self._lock:
            if (self._kill_head_at is None
                    or int(decision_n) < self._kill_head_at):
                return
            self._kill_head_at = None
            self._counters["head_kills"] = (
                self._counters.get("head_kills", 0) + 1
            )
        os._exit(HEAD_KILL_EXIT)

    def poll_torn_journal_write(
        self, decision_n: int, incarnation: int = 1
    ) -> bool:
        """True when the journal should tear THIS decision's append —
        the caller writes half the line, fsyncs, and ``os._exit``s, so
        the journal's tail is a torn record resume must drop.  Fires
        once, first head incarnation only."""
        if int(incarnation) > 1 or self._torn_journal_at is None:
            return False
        with self._lock:
            if (self._torn_journal_at is None
                    or int(decision_n) < self._torn_journal_at):
                return False
            self._torn_journal_at = None
            self._counters["torn_journal_writes"] = (
                self._counters.get("torn_journal_writes", 0) + 1
            )
        return True


def corrupt_bytes(data: bytes, flip_every: int = 97) -> bytes:
    """Deterministically damage a payload (bit-flip a stride of bytes) —
    shared by the plan and by tests that corrupt stored files directly."""
    buf = bytearray(data)
    for i in range(0, len(buf), flip_every):
        buf[i] ^= 0xFF
    return bytes(buf)


class FaultyStorage(storage_lib.StorageBackend):
    """Wraps a real backend; consults the plan before every operation."""

    def __init__(self, inner: storage_lib.StorageBackend, plan: FaultPlan):
        self.inner = inner
        self.plan = plan

    def write_bytes(self, path: str, data: bytes) -> str:
        self.plan.on_storage_op("write", path)
        return self.inner.write_bytes(path, self.plan.corrupt_write(path, data))

    def read_bytes(self, path: str) -> Optional[bytes]:
        self.plan.on_storage_op("read", path)
        return self.inner.read_bytes(path)

    def exists(self, path: str) -> bool:
        self.plan.on_storage_op("exists", path)
        return self.inner.exists(path)

    def listdir(self, path: str) -> List[str]:
        self.plan.on_storage_op("listdir", path)
        return self.inner.listdir(path)

    def delete(self, path: str) -> None:
        self.plan.on_storage_op("delete", path)
        return self.inner.delete(path)

    def join(self, *parts: str) -> str:
        return self.inner.join(*parts)


# -- process-wide activation --------------------------------------------------

_active_plan: Optional[FaultPlan] = None


def activate(plan: FaultPlan) -> None:
    """Install ``plan`` process-wide: storage faults via the get_storage
    fault wrapper, the head faults via :func:`active_plan` polling."""
    global _active_plan
    _active_plan = plan
    storage_lib.set_fault_wrapper(lambda backend: FaultyStorage(backend, plan))


def deactivate() -> None:
    global _active_plan
    _active_plan = None
    storage_lib.set_fault_wrapper(None)


def active_plan() -> Optional[FaultPlan]:
    return _active_plan


@contextlib.contextmanager
def active(plan: FaultPlan):
    """``with chaos.active(FaultPlan(...)):`` — scoped activation."""
    activate(plan)
    try:
        yield plan
    finally:
        deactivate()


PLAN_ENV_VAR = "DML_CHAOS_PLAN"


def plan_from_env() -> Optional[FaultPlan]:
    """Build a FaultPlan from the ``DML_CHAOS_PLAN`` env var (JSON kwargs
    for :class:`FaultPlan`), or None when it is unset.

    This is how faults reach a head in another process: the crash
    harness (``tune/crashsim.py``) sets the variable in the child's
    environment and the child activates the plan at startup.  A plan
    that does not parse raises (the JAX package prints and ignores it,
    which would run a crash test without its crash)."""
    raw = os.environ.get(PLAN_ENV_VAR)
    if not raw:
        return None
    kwargs = json.loads(raw)
    if not isinstance(kwargs, dict):
        raise ValueError(f"{PLAN_ENV_VAR} must hold a JSON object, got "
                         f"{raw!r}")
    return FaultPlan(**kwargs)


def activate_from_env() -> Optional[FaultPlan]:
    """``plan_from_env()`` + ``activate`` in one call (process entry
    points)."""
    plan = plan_from_env()
    if plan is not None:
        activate(plan)
    return plan
