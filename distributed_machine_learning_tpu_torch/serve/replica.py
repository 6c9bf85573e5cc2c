"""Device-pinned inference replicas with round-robin dispatch + failover.

Port of ``distributed_machine_learning_tpu/serve/replica.py``.  Each
replica pins its engine to one ``torch.device`` (``cuda:i`` round-robin
over the visible cards, or the CPU); a monitor thread restarts a replica
whose worker died while traffic flows on the survivors.

Each slot carries a :class:`CircuitBreaker` (closed -> open after N
consecutive failures -> half-open probe after a cool-down -> closed on
success).  Admission control sheds when every replica's bounded queue is
full (:class:`Overloaded`, HTTP 429), a missed deadline is charged to
the serving slot (:class:`ReplicaTimeout`, HTTP 504), and a request whose
replica died before flushing it is redispatched to a survivor.

Not yet ported: the shed watermark, the autoscaler (elastic add/remove),
hot swap, gang replicas and chaos fault plans (ROADMAP.md queue A).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, List, Optional

import numpy as np

from distributed_machine_learning_tpu_torch.serve.batcher import (
    BatcherStopped,
    ContinuousBatcher,
    MicroBatcher,
    QueueFull,
)
from distributed_machine_learning_tpu_torch.serve.engine import InferenceEngine
from distributed_machine_learning_tpu_torch.serve.export import ServableBundle
from distributed_machine_learning_tpu_torch.utils.device import (
    DeviceLike,
    replica_devices,
)

MONITOR_INTERVAL_S = 0.25


class AllReplicasOpen(RuntimeError):
    """Every dispatchable replica's breaker is open — back off and retry."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"all replicas quarantined by circuit breaker; retry in "
            f"{retry_after_s:.2f}s"
        )
        self.retry_after_s = retry_after_s


class Overloaded(RuntimeError):
    """Admission control refused the request: every live replica's bounded
    queue is full."""

    def __init__(self, retry_after_s: float, depth: int):
        super().__init__(
            f"shedding load: every replica queue is full ({depth} pending); "
            f"retry in {retry_after_s:.2f}s"
        )
        self.retry_after_s = retry_after_s
        self.depth = depth


class ReplicaTimeout(RuntimeError):
    """A dispatched request missed its deadline — the replica may be hung."""

    def __init__(self, timeout_s: float, replica_idx: int):
        super().__init__(
            f"replica {replica_idx} did not answer within {timeout_s:.1f}s"
        )
        self.timeout_s = timeout_s
        self.replica_idx = replica_idx


class _RequestOutcome:
    """One-shot breaker recorder shared by the done-callback and the
    deadline path: whichever fires first is the request's fate."""

    __slots__ = ("_breaker", "_lock", "_recorded")

    def __init__(self, breaker: "CircuitBreaker"):
        self._breaker = breaker
        self._lock = threading.Lock()
        self._recorded = False

    def record(self, failed: bool) -> None:
        with self._lock:
            if self._recorded:
                return
            self._recorded = True
        if failed:
            self._breaker.record_failure()
        else:
            self._breaker.record_success()

    def from_future(self, fut) -> None:
        try:
            failed = fut.exception() is not None
        except BaseException:  # noqa: BLE001 - cancelled counts too
            failed = True
        self.record(failed)


class CircuitBreaker:
    """Per-replica closed/open/half-open breaker (thread-safe)."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3, recovery_s: float = 1.0,
                 half_open_probes: int = 1):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1: {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.half_open_probes = int(half_open_probes)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.failures_total = 0
        self.successes_total = 0
        self.opens_total = 0
        self.probes_total = 0

    def _trip(self, now: float):
        self._state = self.OPEN
        self._opened_at = now
        self._probes_in_flight = 0
        self.opens_total += 1

    def allow(self) -> bool:
        """May a request be dispatched now?  In half-open, a True answer
        consumes a probe slot (released by the request's outcome)."""
        now = time.monotonic()
        with self._lock:
            if self._state == self.OPEN:
                if now - self._opened_at < self.recovery_s:
                    return False
                self._state = self.HALF_OPEN
                self._probes_in_flight = 0
            if self._state == self.HALF_OPEN:
                if self._probes_in_flight >= self.half_open_probes:
                    return False
                self._probes_in_flight += 1
                self.probes_total += 1
            return True

    def record_success(self):
        with self._lock:
            self.successes_total += 1
            self._consecutive_failures = 0
            if self._state == self.HALF_OPEN:
                self._probes_in_flight = max(self._probes_in_flight - 1, 0)
                self._state = self.CLOSED

    def record_failure(self):
        now = time.monotonic()
        with self._lock:
            self.failures_total += 1
            self._consecutive_failures += 1
            if self._state == self.HALF_OPEN or (
                self._state == self.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._trip(now)

    @property
    def state(self) -> str:
        with self._lock:
            if (
                self._state == self.OPEN
                and time.monotonic() - self._opened_at >= self.recovery_s
            ):
                return self.HALF_OPEN
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until this breaker would admit a probe (0 if it would)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(
                self.recovery_s - (time.monotonic() - self._opened_at), 0.0
            )

    def stats(self) -> Dict[str, Any]:
        state = self.state
        with self._lock:
            return {
                "state": state,
                "failures_total": self.failures_total,
                "successes_total": self.successes_total,
                "opens_total": self.opens_total,
                "probes_total": self.probes_total,
            }


class Replica:
    """One engine + one batcher pinned to one device."""

    def __init__(
        self,
        idx: int,
        bundle: ServableBundle,
        device: DeviceLike,
        max_batch_size: int = 64,
        max_latency_ms: float = 5.0,
        max_bucket: int = 256,
        batcher: str = "continuous",
        max_queue: int = 1024,
    ):
        self.idx = idx
        self.engine = InferenceEngine(bundle, max_bucket=max_bucket,
                                      device=device)
        self.device = self.engine.device
        self.processed_batches = 0
        self.last_beat = time.monotonic()
        if batcher == "continuous":
            self.batcher = ContinuousBatcher(
                self._infer,
                max_batch_size=max_batch_size,
                max_queue=max_queue,
                name=f"replica-{idx}",
            )
        elif batcher == "micro":
            self.batcher = MicroBatcher(
                self._infer,
                max_batch_size=max_batch_size,
                max_latency_ms=max_latency_ms,
                name=f"replica-{idx}",
            )
        else:
            raise ValueError(
                f"batcher must be 'continuous' or 'micro': {batcher!r}"
            )

    def _infer(self, x: np.ndarray) -> np.ndarray:
        out = self.engine.predict(x)
        self.processed_batches += 1
        self.last_beat = time.monotonic()
        return out

    def submit(self, x):
        return self.batcher.submit(x)

    def alive(self) -> bool:
        return self.batcher.is_alive()

    def kill(self):
        """Hard-stop this replica's worker: queued requests fail fast."""
        self.batcher.stop(drain=False, timeout=2.0)

    def health(self) -> Dict[str, Any]:
        return {
            "replica": self.idx,
            "device": str(self.device),
            "alive": self.alive(),
            "queue_depth": self.batcher.queue_depth,
            "processed_batches": self.processed_batches,
            "last_beat_age_s": round(time.monotonic() - self.last_beat, 3),
        }


class ReplicaSet:
    """N replicas behind one ``submit()`` — round-robin over the healthy.

    ``device`` places the replicas: ``"cuda"`` spreads them round-robin
    over the visible cards, ``"cuda:i"`` or ``"cpu"`` pins them all."""

    def __init__(
        self,
        bundle: ServableBundle,
        num_replicas: int = 1,
        device: DeviceLike = "cuda",
        max_batch_size: int = 64,
        max_latency_ms: float = 5.0,
        max_bucket: int = 256,
        batcher: str = "continuous",
        max_queue: int = 1024,
        restart: bool = True,
    ):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1: {num_replicas}")
        self.bundle = bundle
        self._kwargs = dict(
            max_batch_size=max_batch_size,
            max_latency_ms=max_latency_ms,
            max_bucket=max_bucket,
            batcher=batcher,
            max_queue=max_queue,
        )
        # One breaker per SLOT, surviving monitor restarts: a crash-looping
        # replica re-earns traffic through a half-open probe.
        self._breakers = [CircuitBreaker() for _ in range(num_replicas)]
        self._lock = threading.Lock()
        self._rr = 0
        self.restarts = 0
        self.timeouts = 0
        self.sheds = 0
        self.redispatches = 0
        self._closing = False
        self._warmup_programs: Optional[int] = None
        self.replicas: List[Replica] = [
            Replica(r, bundle, dev, **self._kwargs)
            for r, dev in enumerate(replica_devices(device, num_replicas))
        ]
        self._monitor: Optional[threading.Thread] = None
        if restart:
            self._monitor = threading.Thread(
                target=self._monitor_loop,
                args=(MONITOR_INTERVAL_S,),
                name="replica-monitor",
                daemon=True,
            )
            self._monitor.start()

    # -- dispatch ------------------------------------------------------------

    def queue_depth_total(self) -> int:
        """Unanswered requests across every replica (queued + in flight)."""
        with self._lock:
            replicas = list(self.replicas)
        return sum(
            getattr(r.batcher, "pending", r.batcher.queue_depth)
            for r in replicas
        )

    def _shed_retry_after_s(self, depth: int) -> float:
        with self._lock:
            replicas = list(self.replicas)
        waits = [
            r.batcher.retry_after_s() for r in replicas
            if hasattr(r.batcher, "retry_after_s")
        ]
        return max(waits) if waits else min(0.05 * max(depth, 1), 5.0)

    def submit(self, x):
        """Round-robin to the next healthy replica whose breaker admits the
        request.  Raises :class:`Overloaded` when every live replica's
        queue is full, :class:`AllReplicasOpen` when only breakers stand in
        the way, and RuntimeError when every replica is dead."""
        with self._lock:
            pairs = list(zip(self.replicas, self._breakers))
            start = self._rr
            self._rr = (self._rr + 1) % max(len(pairs), 1)
        any_alive = False
        any_full = False
        for off in range(len(pairs)):
            i = (start + off) % len(pairs)
            r, breaker = pairs[i]
            if not r.alive():
                continue
            any_alive = True
            if not breaker.allow():
                continue
            try:
                fut = r.submit(x)
            except QueueFull:
                any_full = True
                continue
            outcome = _RequestOutcome(breaker)
            fut._dml_outcome = outcome
            fut._dml_replica_idx = i
            fut.add_done_callback(outcome.from_future)
            return fut
        if any_full:
            depth = self.queue_depth_total()
            self.sheds += 1
            raise Overloaded(self._shed_retry_after_s(depth), depth)
        if any_alive:
            raise AllReplicasOpen(self.min_retry_after_s())
        raise RuntimeError("no healthy replicas")

    def min_retry_after_s(self) -> float:
        with self._lock:
            breakers = list(self._breakers)
        waits = [b.retry_after_s() for b in breakers]
        return min(waits) if waits else 0.0

    def predict(self, x, timeout: Optional[float] = 30.0,
                redispatch: int = 2) -> np.ndarray:
        """Submit + wait; a deadline miss counts as a failure of the
        serving slot, a replica death is redispatched to a survivor."""
        attempts = max(int(redispatch), 0) + 1
        for attempt in range(attempts):
            fut = self.submit(x)
            try:
                return fut.result(timeout=timeout)
            except FuturesTimeoutError:
                self.timeouts += 1
                fut._dml_outcome.record(failed=True)
                raise ReplicaTimeout(
                    timeout if timeout is not None else float("inf"),
                    fut._dml_replica_idx,
                ) from None
            except BatcherStopped:
                if attempt + 1 >= attempts:
                    raise
                self.redispatches += 1
        raise AssertionError("unreachable")

    # -- lifecycle -----------------------------------------------------------

    def _monitor_loop(self, interval_s: float):
        while not self._closing:
            time.sleep(interval_s)
            if self._closing:
                return
            with self._lock:
                dead = [r for r in self.replicas if not r.alive()]
            for old in dead:
                if self._closing:
                    return
                fresh = Replica(old.idx, self.bundle, old.device,
                                **self._kwargs)
                with self._lock:
                    try:
                        i = self.replicas.index(old)
                    except ValueError:
                        i = -1
                    if i >= 0:
                        self.replicas[i] = fresh
                        self.restarts += 1
                if i < 0:
                    fresh.kill()

    def kill(self, idx: int):
        with self._lock:
            replica = self.replicas[idx % len(self.replicas)]
        replica.kill()

    def warmup(self, sample) -> Dict[str, Any]:
        """Build every replica's bucket grid for ``sample``'s row shape."""
        with self._lock:
            replicas = list(self.replicas)
        for r in replicas:
            r.engine.warmup(sample)
        stats = self.program_stats()
        self._warmup_programs = stats["programs"]
        return stats

    def program_stats(self) -> Dict[str, Any]:
        with self._lock:
            replicas = list(self.replicas)
        per = [r.engine.program_stats() for r in replicas]
        programs = sum(p["programs"] for p in per)
        out = {"programs": programs, "per_replica": per}
        if self._warmup_programs is not None:
            out["programs_after_warmup"] = self._warmup_programs
            out["new_programs_since_warmup"] = max(
                programs - self._warmup_programs, 0
            )
        return out

    def health(self) -> List[Dict[str, Any]]:
        with self._lock:
            pairs = list(zip(self.replicas, self._breakers))
        return [{**r.health(), "breaker": b.state} for r, b in pairs]

    def breaker_stats(self) -> Dict[str, Any]:
        with self._lock:
            breakers = list(self._breakers)
        per = [b.stats() for b in breakers]
        return {
            "per_replica": per,
            "open_replicas": sum(
                1 for s in per if s["state"] == CircuitBreaker.OPEN
            ),
            "opens_total": sum(s["opens_total"] for s in per),
            "request_failures_total": sum(s["failures_total"] for s in per),
        }

    def num_healthy(self) -> int:
        return sum(1 for h in self.health() if h["alive"])

    def batcher_stats(self) -> Dict[str, Any]:
        with self._lock:
            replicas = list(self.replicas)
        agg = {"batches": 0, "rows": 0, "size_flushes": 0,
               "latency_flushes": 0}
        for r in replicas:
            d = r.batcher.stats.to_dict(r.batcher.max_batch_size)
            for k in agg:
                agg[k] += d[k]
        agg["batch_fill_ratio"] = round(
            agg["rows"] / (agg["batches"] * self._kwargs["max_batch_size"]),
            4,
        ) if agg["batches"] else 0.0
        agg["queue_depth"] = sum(r.batcher.queue_depth for r in replicas)
        return agg

    def close(self):
        self._closing = True
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        with self._lock:
            replicas = list(self.replicas)
        for r in replicas:
            r.batcher.stop(drain=False, timeout=2.0)
