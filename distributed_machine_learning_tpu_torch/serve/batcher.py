"""Request batching in front of an inference engine.

Port of ``distributed_machine_learning_tpu/serve/batcher.py``.  Two
batchers share one contract (``submit`` returns a
``concurrent.futures.Future`` resolving to the caller's own rows of the
batched result; arrival order is preserved within a flush):

* :class:`ContinuousBatcher` (the default) — inflight batching: while one
  flush runs on the device, arrivals coalesce; the moment the engine frees
  up the next flush takes everything queued, up to ``max_batch_size``
  rows.  Its queue is bounded: past ``max_queue`` pending requests
  ``submit`` raises :class:`QueueFull` (HTTP 429 + Retry-After upstream).
* :class:`MicroBatcher` — flush at ``max_batch_size`` rows or when the
  oldest request has waited ``max_latency_ms``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class BatcherStopped(RuntimeError):
    """The batcher's worker is gone (kill/drain) — the request was never
    flushed.  ``ReplicaSet.predict`` treats this as a replica death and
    redispatches to a survivor instead of failing the client."""


class QueueFull(RuntimeError):
    """Admission refused: the bounded request queue is at capacity.

    ``retry_after_s`` estimates when capacity frees up (queue depth x
    measured step time over the batch cap) — the HTTP layer forwards it
    as a 429 Retry-After header instead of letting the queue grow."""

    def __init__(self, depth: int, max_queue: int, retry_after_s: float):
        super().__init__(
            f"request queue full ({depth}/{max_queue}); retry in "
            f"{retry_after_s:.2f}s"
        )
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


@dataclass
class _Pending:
    x: np.ndarray
    future: Future
    # Monotonic: feeds the max_latency flush deadline.
    enqueued_at: float = field(default_factory=time.monotonic)


class BatcherStats:
    """Thread-safe flush accounting (fill ratio, trigger mix, depth)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0
        self.rows = 0
        self.size_flushes = 0
        self.latency_flushes = 0

    def record(self, rows: int, trigger: str):
        with self._lock:
            self.batches += 1
            self.rows += rows
            if trigger == "size":
                self.size_flushes += 1
            else:
                self.latency_flushes += 1

    def to_dict(self, max_batch_size: int) -> Dict[str, Any]:
        with self._lock:
            fill = (
                self.rows / (self.batches * max_batch_size)
                if self.batches
                else 0.0
            )
            return {
                "batches": self.batches,
                "rows": self.rows,
                "batch_fill_ratio": round(fill, 4),
                "size_flushes": self.size_flushes,
                "latency_flushes": self.latency_flushes,
            }


class MicroBatcher:
    """Background flush loop feeding ``infer_fn`` coalesced batches.

    ``infer_fn(batch) -> predictions`` is called on the batcher's worker
    thread, one flush at a time; an exception fails every request in that
    flush (each future gets it) and the loop keeps serving — one poisoned
    batch must not take the replica down.
    """

    def __init__(
        self,
        infer_fn: Callable[[np.ndarray], np.ndarray],
        max_batch_size: int = 64,
        max_latency_ms: float = 5.0,
        name: str = "batcher",
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1: {max_batch_size}")
        self.infer_fn = infer_fn
        self.max_batch_size = int(max_batch_size)
        self.max_latency_s = float(max_latency_ms) / 1000.0
        self.stats = BatcherStats()
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def submit(self, x) -> Future:
        """Enqueue one request; resolves to its rows of the batched output."""
        x = np.asarray(x)
        fut: Future = Future()
        with self._wake:
            if self._stop:
                fut.set_exception(BatcherStopped("batcher is stopped"))
                return fut
            self._queue.append(_Pending(x, fut))
            self._wake.notify()
        return fut

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def is_alive(self) -> bool:
        # Lock-free on purpose: a bool load is atomic, and a stale answer
        # only delays failover by one round-robin pass.
        return self._thread.is_alive() and not self._stop

    # -- worker side ---------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until a flush trigger fires (or stop); returns the drained
        requests for one batch."""
        with self._wake:
            while True:
                if self._stop and not self._queue:
                    return None
                if self._queue:
                    rows = sum(p.x.shape[0] for p in self._queue)
                    oldest = self._queue[0].enqueued_at
                    now = time.monotonic()
                    if self._stop or rows >= self.max_batch_size:
                        return self._drain("size")
                    remaining = self.max_latency_s - (now - oldest)
                    if remaining <= 0:
                        return self._drain("latency")
                    self._wake.wait(timeout=remaining)
                else:
                    self._wake.wait(timeout=0.1)

    def _drain(self, trigger: str) -> List[_Pending]:
        # Called under the lock. Take whole requests up to the size cap —
        # never split one request across flushes (its future maps 1:1 to a
        # contiguous slice of ONE engine call); a single over-cap request
        # flushes alone and the engine chunks it internally.
        batch: List[_Pending] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            n = nxt.x.shape[0]
            if batch and rows + n > self.max_batch_size:
                break
            batch.append(self._queue.pop(0))
            rows += n
        self.stats.record(rows, trigger)
        return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                xs = np.concatenate([p.x for p in batch], axis=0)
                preds = np.asarray(self.infer_fn(xs))
                off = 0
                for p in batch:
                    n = p.x.shape[0]
                    p.future.set_result(preds[off: off + n])
                    off += n
            except BaseException as exc:  # noqa: BLE001 - fail the batch only
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def stop(self, drain: bool = True, timeout: float = 5.0):
        """Stop the worker; with ``drain`` the queue is flushed first,
        otherwise queued futures fail fast."""
        with self._wake:
            self._stop = True
            if not drain:
                for p in self._queue:
                    if not p.future.done():
                        p.future.set_exception(
                            BatcherStopped("batcher stopped before flush")
                        )
                self._queue.clear()
            self._wake.notify_all()
        self._thread.join(timeout=timeout)


# ---------------------------------------------------------------------------
# continuous (inflight) batching
# ---------------------------------------------------------------------------


def _bucket_grid(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-two flush sizes 1, 2, ... max_batch_size (mirrors
    ``engine.bucket_sizes`` so a flush size IS a compiled-program bucket —
    adaptive sizing never invents a new shape)."""
    sizes = []
    b = 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return tuple(sizes)


class ContinuousBatcherStats:
    """Thread-safe accounting for the continuous flush loop.

    Alongside the MicroBatcher-compatible aggregates (``batches``,
    ``rows``, ``size_flushes``/``latency_flushes``) it tracks the signals
    the adaptive cap runs on: an EWMA of engine step time per flush
    bucket, and how often the cap (rather than the queue simply running
    dry) bounded a flush.
    """

    EWMA_ALPHA = 0.3

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0
        self.rows = 0
        self.capped_flushes = 0   # the adaptive cap bounded the flush
        self.drain_flushes = 0    # the flush took the whole queue
        self._step_ms_ewma: Dict[int, float] = {}

    def record(self, rows: int, capped: bool):
        with self._lock:
            self.batches += 1
            self.rows += rows
            if capped:
                self.capped_flushes += 1
            else:
                self.drain_flushes += 1

    def record_step(self, bucket: int, step_ms: float):
        with self._lock:
            old = self._step_ms_ewma.get(bucket)
            self._step_ms_ewma[bucket] = (
                step_ms if old is None
                else self.EWMA_ALPHA * step_ms + (1 - self.EWMA_ALPHA) * old
            )

    def step_ms(self, bucket: int) -> Optional[float]:
        with self._lock:
            return self._step_ms_ewma.get(bucket)

    def step_ewma_ms(self) -> Dict[int, float]:
        with self._lock:
            return {b: round(v, 3) for b, v in self._step_ms_ewma.items()}

    def to_dict(self, max_batch_size: int) -> Dict[str, Any]:
        with self._lock:
            fill = (
                self.rows / (self.batches * max_batch_size)
                if self.batches
                else 0.0
            )
            return {
                "batches": self.batches,
                "rows": self.rows,
                "batch_fill_ratio": round(fill, 4),
                # MicroBatcher-compatible keys so ReplicaSet aggregation
                # works over mixed batcher kinds: a capped flush is the
                # size trigger's analogue; nothing here is timer-driven.
                "size_flushes": self.capped_flushes,
                "latency_flushes": 0,
                "drain_flushes": self.drain_flushes,
                "step_ms_ewma": {
                    str(b): round(v, 3)
                    for b, v in sorted(self._step_ms_ewma.items())
                },
            }


class ContinuousBatcher:
    """Inflight batcher: flush whatever is queued, up to
    ``max_batch_size`` rows, the moment the engine frees up.  The measured
    per-bucket step time sizes the ``Retry-After`` of a refused request.

    The queue is bounded (``max_queue`` pending requests, enforced at
    submit AND by the deque's own maxlen): overload is
    refused at admission with :class:`QueueFull`, never absorbed into an
    unbounded backlog.
    """

    def __init__(
        self,
        infer_fn: Callable[[np.ndarray], np.ndarray],
        max_batch_size: int = 64,
        max_queue: int = 1024,
        name: str = "cbatcher",
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1: {max_batch_size}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1: {max_queue}")
        self.infer_fn = infer_fn
        self.max_batch_size = int(max_batch_size)
        self.max_queue = int(max_queue)
        self._grid = _bucket_grid(self.max_batch_size)
        self.stats = ContinuousBatcherStats()
        self._queue: deque = deque(maxlen=self.max_queue)
        self._inflight = 0  # requests inside the current engine flush
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def submit(self, x) -> Future:
        """Enqueue one request; raises :class:`QueueFull` past the bound."""
        x = np.asarray(x)
        fut: Future = Future()
        with self._wake:
            if self._stop:
                fut.set_exception(BatcherStopped("batcher is stopped"))
                return fut
            if len(self._queue) >= self.max_queue:
                # NB: the estimate must not re-take self._lock — the
                # condition already holds it (the lock is not reentrant).
                raise QueueFull(
                    len(self._queue), self.max_queue,
                    self._retry_estimate(len(self._queue) + self._inflight),
                )
            self._queue.append(_Pending(x, fut))
            self._wake.notify()
        return fut

    def _retry_estimate(self, depth: int) -> float:
        """Backlog-clearing estimate from the measured step time; lock-free
        (reads only the stats EWMA, which has its own lock)."""
        step = self.stats.step_ms(self._grid[-1])
        step_s = (step or 10.0) / 1000.0
        est = (depth / self.max_batch_size + 1.0) * step_s
        return min(max(est, 0.05), 5.0)

    def retry_after_s(self) -> float:
        """Rough time for the current backlog to clear: depth x measured
        step time / batch cap, clamped to a sane Retry-After range."""
        with self._lock:
            depth = len(self._queue) + self._inflight
        return self._retry_estimate(depth)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def pending(self) -> int:
        """Unanswered requests: queued AND inside the current flush.  The
        autoscaler/admission depth signal — a continuous batcher drains
        its queue into the in-flight batch immediately, so the queue
        alone under-reports load by up to one full flush."""
        with self._lock:
            return len(self._queue) + self._inflight

    def is_alive(self) -> bool:
        # Lock-free on purpose: a bool load is atomic, and a stale answer
        # only delays failover by one round-robin pass.
        return self._thread.is_alive() and not self._stop

    # -- adaptive cap --------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self._grid:
            if b >= n:
                return b
        return self._grid[-1]

    # -- worker side ---------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until work exists (or stop); drain immediately up to the
        batch cap — no flush timer, the engine going idle IS the
        trigger."""
        with self._wake:
            while True:
                if self._stop and not self._queue:
                    return None
                if self._queue:
                    cap = self.max_batch_size
                    batch: List[_Pending] = []
                    rows = 0
                    while self._queue:
                        nxt = self._queue[0]
                        n = nxt.x.shape[0]
                        # Whole requests only (same contract as the
                        # MicroBatcher: one future = one contiguous slice
                        # of ONE engine call); a lone over-cap request
                        # flushes alone and the engine chunks it.
                        if batch and rows + n > cap:
                            break
                        batch.append(self._queue.popleft())
                        rows += n
                    self._inflight = len(batch)
                    self.stats.record(rows, capped=bool(self._queue))
                    return batch
                self._wake.wait(timeout=0.1)

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            rows = sum(p.x.shape[0] for p in batch)
            try:
                xs = np.concatenate([p.x for p in batch], axis=0)
                t0 = time.monotonic()
                preds = np.asarray(self.infer_fn(xs))
                step_ms = (time.monotonic() - t0) * 1000.0
                self.stats.record_step(self.bucket_for(rows), step_ms)
                off = 0
                for p in batch:
                    n = p.x.shape[0]
                    p.future.set_result(preds[off: off + n])
                    off += n
            except BaseException as exc:  # noqa: BLE001 - fail the batch only
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)
            finally:
                with self._lock:
                    self._inflight = 0

    def stop(self, drain: bool = True, timeout: float = 5.0):
        """Stop the worker; with ``drain`` the queue is flushed first,
        otherwise queued futures fail fast (``BatcherStopped`` — the
        redispatch signal)."""
        with self._wake:
            self._stop = True
            if not drain:
                for p in self._queue:
                    if not p.future.done():
                        p.future.set_exception(
                            BatcherStopped("batcher stopped before flush")
                        )
                self._queue.clear()
            self._wake.notify_all()
        self._thread.join(timeout=timeout)
