"""Out-of-core training: the double-buffered host -> device prefetch ring.

Port of ``distributed_machine_learning_tpu/data/pipeline.py``.  Resident
staging puts both splits on the trial's device once
(``tune/_regression_program.py::stage_data``); a dataset bigger than the
card's budget cannot train that way.  This module is the loader under
``input_mode="streaming"``:

* a **bounded ring** (:class:`ChunkPrefetcher`) fed by a background
  **producer thread**: the producer gathers the next chunk of the epoch's
  shuffled batches on the host (the native gather, ``data/native.py``)
  and stages it while the trainable consumes the chunk before it.  On a
  card staging goes through :class:`PinnedStager`: ``depth + 1`` pinned
  host slabs and a copy stream of its own; each chunk's copy goes
  ``non_blocking`` onto that stream and is recorded as an event, the compute
  stream waits on the event, and the device slab is released when the
  trainable drops it after the chunk's last step.  The ring holds at
  most ``depth + 1`` chunks at once (staged, queued or in use), so at
  most ``depth + 1`` device slabs exist: JAX gets this bound from
  donation, the port from the ring's permits.  On the CPU the slabs are
  plain tensors and there is no stream;
* the **engagement policy** (:func:`resolve_input_mode`): an explicit
  ``input_mode="resident"|"streaming"`` wins; ``"auto"`` streams when the
  staged dataset would exceed ``streaming_engage_fraction`` (default 0.5)
  of the device budget (:func:`device_budget_bytes`: the card's memory,
  or ``DML_CPU_DEVICE_BUDGET_BYTES`` on the CPU, which makes the
  out-of-core path testable there).  Explicit ``"resident"`` over budget
  raises :class:`ResidentOverBudgetError` before anything is allocated;
* the **determinism contract**: a streaming trial sees the batches a
  resident trial of the same seed sees, in the same order, and ends with
  bit-equal parameters: the producer replays the resident epoch's
  permutation (``tune/trainable.py::epoch_permutation``), the chunk
  program's step is the resident epoch's own, and the dropout generator
  carries on across chunk boundaries
  (``tune/_regression_program.py::make_chunk_epoch_fn``);
* the **host_input counters** (:class:`HostInputCounters`, the JAX
  names): prefetch hits, producer and consumer waits (counts and
  seconds), chunks and bytes staged, producer stalls and crashes, the
  window cache's hits, misses and bytes (``data/loader.py``), and
  :func:`overlap_efficiency` ``= 1 - consumer_wait_s / step time``,
  published into ``experiment_state.json["host_input"]`` and the
  ``host_input/*`` TensorBoard scalars by ``tune.run`` and
  ``run_vectorized``;
* **failures**: the producer is watched by a ``liveness.DispatchWatchdog``
  (silence past the deadline counts ``producer_stalls`` while the
  consumer keeps waiting; past the hard timeout the consumer raises
  :class:`ProducerStalled`, a trial error the retry budget handles), and
  a producer's exception, ``chaos.FaultPlan(producer_crash_at=...)``'s
  among them, is raised on the consumer.  Nothing falls back: a ring
  whose pinned allocation or copy stream fails raises, it does not stage
  the whole dataset instead.

The JAX module's trace spans (``obs``) belong to the observability plane,
ROADMAP.md A10.  Its sharded streaming path (``shards=`` and the indexed
chunk program) waits for A9.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

INPUT_MODES = ("auto", "resident", "streaming")

# "auto" streams when the staged bytes exceed this fraction of the device
# budget (parameters, optimizer state and activations need the rest);
# config["streaming_engage_fraction"] overrides.
DEFAULT_ENGAGE_FRACTION = 0.5
# Fraction of the device budget the ring's slabs may take together.
RING_BUDGET_FRACTION = 0.25
# 2 = double buffering: chunk k+1 stages while chunk k trains.
# config["streaming_prefetch_depth"] overrides.
DEFAULT_PREFETCH_DEPTH = 2
# Producer silence past this is a counted stall;
# config["streaming_producer_deadline_s"] overrides.
DEFAULT_PRODUCER_DEADLINE_S = 60.0


class ResidentOverBudgetError(RuntimeError):
    """``input_mode="resident"`` asked to stage more bytes than the device
    budget holds.  Raised before anything is allocated; ``"auto"`` would
    have streamed."""


class ProducerStalled(RuntimeError):
    """The producer thread went silent past the hard timeout.  Raised on
    the consumer (trial) thread, so a wedged producer takes the ordinary
    trial error path: the retry budget, the checkpoint restore."""


# ---------------------------------------------------------------------------
# host_input counters
# ---------------------------------------------------------------------------


class HostInputCounters:
    """Process-wide counters of the streaming input path and the window
    cache; ``tune.run`` and ``run_vectorized`` snapshot them at start
    and publish :meth:`delta_since` at teardown."""

    _FIELDS = (
        "streams_engaged",       # trainables that ran input_mode=streaming
        "mode_fallbacks",        # streaming asked for, resident staged
        "chunks_staged",
        "bytes_staged",
        "prefetch_hits",         # the consumer asked, a chunk was staged
        "consumer_waits",        # the consumer waited on the producer
        "consumer_wait_s",
        "producer_waits",        # the producer waited on a full ring
        "producer_wait_s",
        "consume_s",             # consumer seconds spent training chunks
        "producer_stalls",       # watchdog expiries on the producer
        "producer_crashes",
        # The window cache (data/loader.py): windowed arrays reopened
        # instead of windowed again.
        "dataset_cache_hits",
        "dataset_cache_misses",
        "dataset_cache_bytes",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, float] = {k: 0 for k in self._FIELDS}

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + value

    def get(self, name: str) -> float:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self._c.items()
            }

    def delta_since(self, baseline: Dict[str, float]) -> Dict[str, float]:
        snap = self.snapshot()
        return {k: round(v - baseline.get(k, 0), 4) for k, v in snap.items()}

    def reset(self) -> None:
        """Test hook: zero every counter."""
        with self._lock:
            self._c = {k: 0 for k in self._FIELDS}


_counters = HostInputCounters()


def get_host_input_counters() -> HostInputCounters:
    """The process-wide registry (one per process)."""
    return _counters


def overlap_efficiency(counters: Dict[str, float]) -> Optional[float]:
    """``1 - consumer_wait_s / (consume_s + consumer_wait_s)``: the share
    of the consumer's time not spent waiting on host input (1.0: it never
    waited); None when nothing streamed."""
    step_s = float(counters.get("consume_s", 0) or 0)
    wait_s = float(counters.get("consumer_wait_s", 0) or 0)
    if step_s <= 0 and wait_s <= 0:
        return None
    return round(max(0.0, 1.0 - wait_s / max(step_s + wait_s, 1e-9)), 4)


def host_input_block(baseline: Dict[str, float]) -> Optional[Dict[str, Any]]:
    """The ``experiment_state.json["host_input"]`` block of one run: the
    counter deltas and the overlap efficiency; None when the run neither
    streamed nor touched the window cache."""
    delta = _counters.delta_since(baseline)
    if not any(delta.values()):
        return None
    eff = overlap_efficiency(delta)
    if eff is not None:
        delta["overlap_efficiency"] = eff
    return delta


# ---------------------------------------------------------------------------
# engagement policy and budget check
# ---------------------------------------------------------------------------


def itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype (4 for None)."""
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


def staged_nbytes(train_data, val_data, compute_dtype) -> int:
    """Bytes resident staging would put on one device: the x splits in
    the compute dtype, the y splits in float32 (``stage_data``'s
    layout)."""
    x_item = itemsize(compute_dtype)
    total = 0
    for ds in (train_data, val_data):
        if ds is None:
            continue
        total += int(ds.x.size) * x_item + int(ds.y.size) * 4
    return total


def device_budget_bytes(device=None) -> int:
    """One device's memory budget: the card's total memory
    (``torch.cuda.mem_get_info``), or the CPU's virtual
    ``DML_CPU_DEVICE_BUDGET_BYTES`` (``models/flagship.py``)."""
    from distributed_machine_learning_tpu_torch.models.flagship import (
        single_chip_hbm_bytes,
    )

    return single_chip_hbm_bytes("cuda" if device is None else device)


def check_resident_budget(nbytes: int, device=None, what: str = "dataset"):
    """Raise :class:`ResidentOverBudgetError` when ``nbytes`` exceed the
    device budget; return the budget otherwise."""
    budget = device_budget_bytes(device)
    if nbytes > budget:
        kind = "cuda" if device is None else torch.device(device).type
        raise ResidentOverBudgetError(
            f"resident staging of {what} needs {nbytes} bytes but the "
            f"device budget is {budget} bytes ({kind}; on CPU the virtual "
            f"DML_CPU_DEVICE_BUDGET_BYTES budget applies) — use "
            f'input_mode="streaming" (or "auto") to train out-of-core'
        )
    return budget


def resolve_input_mode(config: Dict[str, Any], nbytes: int,
                       device=None) -> str:
    """``config["input_mode"]`` resolved to ``"resident"`` or
    ``"streaming"``.  Explicit ``"resident"`` over budget raises;
    ``"auto"`` streams past ``streaming_engage_fraction`` of the budget;
    explicit ``"streaming"`` always streams."""
    mode = str(config.get("input_mode", "auto") or "auto").lower()
    if mode not in INPUT_MODES:
        raise ValueError(
            f"input_mode must be one of {INPUT_MODES}, got {mode!r}"
        )
    nbytes = int(nbytes)
    if mode == "streaming":
        return "streaming"
    if mode == "resident":
        check_resident_budget(nbytes, device, what="the dataset")
        return "resident"
    fraction = float(
        config.get("streaming_engage_fraction", DEFAULT_ENGAGE_FRACTION)
    )
    if nbytes > fraction * device_budget_bytes(device):
        return "streaming"
    return "resident"


# ---------------------------------------------------------------------------
# chunk planning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkPlan:
    """How one epoch's batches split into staged chunks: ``num_chunks``
    full chunks of ``chunk_batches`` batches, then a tail of
    ``tail_batches`` (0: none)."""

    batch_size: int
    num_batches: int       # batches per epoch (= steps per epoch)
    chunk_batches: int     # batches per full chunk
    num_chunks: int        # full chunks per epoch
    tail_batches: int      # 0, or the last chunk's (smaller) batch count

    @property
    def chunks_per_epoch(self) -> int:
        return self.num_chunks + (1 if self.tail_batches else 0)

    def chunk_sizes(self) -> Iterator[Tuple[int, int]]:
        """Yield ``(start_batch, rows)`` per chunk, in epoch order."""
        for c in range(self.num_chunks):
            yield c * self.chunk_batches, self.chunk_batches
        if self.tail_batches:
            yield self.num_chunks * self.chunk_batches, self.tail_batches


def plan_chunks(
    num_batches: int,
    batch_size: int,
    row_nbytes: int,
    *,
    device=None,
    config: Optional[Dict[str, Any]] = None,
) -> ChunkPlan:
    """Size chunks so the ring's ``depth + 1`` slabs fit
    ``RING_BUDGET_FRACTION`` of the device budget;
    ``config["streaming_chunk_batches"]`` overrides."""
    config = config or {}
    depth = int(config.get("streaming_prefetch_depth", DEFAULT_PREFETCH_DEPTH))
    override = config.get("streaming_chunk_batches")
    if override:
        chunk_batches = max(1, min(int(override), num_batches))
    else:
        bytes_per_batch = max(int(batch_size) * int(row_nbytes), 1)
        ring_budget = RING_BUDGET_FRACTION * device_budget_bytes(device)
        per_slab = ring_budget / (depth + 1)
        chunk_batches = int(
            max(1, min(per_slab // bytes_per_batch, num_batches))
        )
    return ChunkPlan(
        batch_size=int(batch_size),
        num_batches=int(num_batches),
        chunk_batches=chunk_batches,
        num_chunks=int(num_batches) // chunk_batches,
        tail_batches=int(num_batches) % chunk_batches,
    )


def prefetch_depth(config: Optional[Dict[str, Any]] = None) -> int:
    return int(
        (config or {}).get(
            "streaming_prefetch_depth", DEFAULT_PREFETCH_DEPTH
        )
    )


def gather_batches(
    x: np.ndarray, y: np.ndarray, idx: np.ndarray, rows: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``x[idx]``, ``y[idx]`` as ``[rows, batch_size, ...]`` slabs: the
    native gather when both splits are float32 (the one
    ``Dataset.batches`` uses), fancy indexing otherwise."""
    from distributed_machine_learning_tpu_torch.data import native

    if x.dtype == np.float32 and y.dtype == np.float32:
        xg, yg = native.gather(x, idx), native.gather(y, idx)
    else:
        xg, yg = x[idx], y[idx]
    return (
        xg.reshape(rows, batch_size, *x.shape[1:]),
        yg.reshape(rows, batch_size, *y.shape[1:]),
    )


# ---------------------------------------------------------------------------
# host -> device staging
# ---------------------------------------------------------------------------


class StagedChunk:
    """One chunk on its device: its tensors and, on a card, the event its
    copy was recorded with.  :meth:`take` hands the tensors to the
    current stream."""

    __slots__ = ("tensors", "event", "nbytes")

    def __init__(self, tensors: Tuple[torch.Tensor, ...],
                 event: Optional["torch.cuda.Event"]):
        self.tensors = tensors
        self.event = event
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors)

    def take(self) -> Tuple[torch.Tensor, ...]:
        """The chunk's tensors, usable on the current stream: it waits on
        the copy's event, and each tensor is recorded as used by it, so
        its memory is reused only after the stream's work on it."""
        tensors, self.tensors = self.tensors, ()
        if self.event is not None:
            stream = torch.cuda.current_stream(tensors[0].device)
            stream.wait_event(self.event)
            for t in tensors:
                t.record_stream(stream)
        return tensors


class PinnedStager:
    """Stages host arrays onto ``device`` as :class:`StagedChunk`\\ s.

    On a card: ``slots`` pinned host slabs per field used round robin
    (a slab is refilled only after its last copy's event has completed)
    and one copy stream; each array is cast to its dtype on the host, in
    torch (round to nearest even, as resident staging casts), into the
    pinned slab, then copied with ``non_blocking=True`` on the copy
    stream into a fresh device tensor, and an event is recorded after
    the copies.  On the CPU the cast tensors are the chunk."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self.slots = max(int(slots), 1)
        self._n = 0
        self._cuda = self.device.type == "cuda"
        self._host: List[Optional[List[torch.Tensor]]] = [None] * self.slots
        self._events: List[Optional["torch.cuda.Event"]] = \
            [None] * self.slots
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)

    def _slabs(self, slot: int, fields) -> List[torch.Tensor]:
        """The slot's pinned slabs, views of at least each field's size
        (the tail chunk is a prefix of a full one's)."""
        host = self._host[slot]
        shapes = [(tuple(a.shape), dt) for a, dt in fields]
        if host is None or len(host) != len(shapes) or any(
                h.dtype != dt or h.shape[1:] != s[1:] or h.shape[0] < s[0]
                for h, (s, dt) in zip(host, shapes)):
            host = [torch.empty(s, dtype=dt, pin_memory=True)
                    for s, dt in shapes]
            self._host[slot] = host
        return [h[: s[0]] for h, (s, _) in zip(host, shapes)]

    def stage(self, fields: Sequence[Tuple[np.ndarray, torch.dtype]]
              ) -> StagedChunk:
        """``fields``: ``(host array, dtype on the device)`` pairs."""
        if not self._cuda:
            return StagedChunk(tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dt)
                for a, dt in fields), None)
        slot = self._n % self.slots
        self._n += 1
        last = self._events[slot]
        if last is not None:
            last.synchronize()
        slabs = self._slabs(slot, fields)
        for slab, (a, _) in zip(slabs, fields):
            slab.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        with torch.cuda.stream(self._stream):
            dev = tuple(torch.empty(s.shape, dtype=s.dtype, device=self.device)
                        for s in slabs)
            for d, s in zip(dev, slabs):
                d.copy_(s, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        return StagedChunk(dev, event)

    def close(self) -> None:
        """Wait for the copies in flight, then let the pinned slabs go."""
        for event in self._events:
            if event is not None:
                event.synchronize()
        self._events = [None] * self.slots
        self._host = [None] * self.slots


# ---------------------------------------------------------------------------
# the prefetch ring
# ---------------------------------------------------------------------------

_DONE = object()


class _Crash:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class ChunkPrefetcher:
    """A bounded ring of staged chunks fed by a producer thread.

    ``source`` is an iterator whose ``next()`` does the host work AND the
    staging of one chunk and returns the staged item (items with an
    ``nbytes`` attribute, or tuples, lists and dicts of them, count as
    staged bytes).  The producer pulls from it into a queue of ``depth``
    items; the consumer (the trial's thread) calls :meth:`get` per chunk.
    A chunk already staged is a ``prefetch_hit``; an empty ring a counted
    consumer wait, which :func:`overlap_efficiency` reads.  The ring
    holds ``depth + 1`` permits: the producer takes one before it stages
    a chunk and the consumer gives one back at its next :meth:`get` (its
    previous chunk is done with), so at most ``depth + 1`` chunks exist
    at once, the one in use included.

    A ``liveness.DispatchWatchdog`` watches the producer: one beat per
    staged chunk; its expiry counts ``producer_stalls`` while the
    consumer keeps waiting; past ``hard_timeout_s`` (default ``max(8 x
    deadline, 30 s)``) the consumer raises :class:`ProducerStalled`.  An
    exception of the producer (the chaos plan's crash among them) is
    raised on the consumer.
    """

    def __init__(
        self,
        source: Iterator[Any],
        *,
        depth: int = DEFAULT_PREFETCH_DEPTH,
        deadline_s: float = DEFAULT_PRODUCER_DEADLINE_S,
        hard_timeout_s: Optional[float] = None,
        name: str = "host-input",
        counters: Optional[HostInputCounters] = None,
    ):
        from distributed_machine_learning_tpu_torch.liveness import (
            DispatchWatchdog,
        )

        self._source = source
        self._depth = max(int(depth), 1)
        self._ring: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._permits = threading.Semaphore(self._depth + 1)
        self._holding = False
        self._stop = threading.Event()
        self._counters = counters or get_host_input_counters()
        self._deadline_s = float(deadline_s)
        self._hard_timeout_s = (
            float(hard_timeout_s)
            if hard_timeout_s is not None
            else max(8.0 * self._deadline_s, 30.0)
        )
        # Polled from the consumer's wait loop: no monitor thread.
        self._watchdog = DispatchWatchdog(self._deadline_s)
        self._watchdog.track("producer", info=name)
        self._name = name
        self._producer = threading.Thread(
            target=self._produce, name=f"{name}-producer", daemon=True
        )
        self._chunk_index = 0
        # This ring's own consumer wait seconds (the registry is shared by
        # the process's concurrent trials).
        self.wait_s = 0.0
        self._producer.start()

    # -- producer side -------------------------------------------------------

    def _wait_for(self, attempt: Callable[[float], bool]) -> bool:
        """``attempt(timeout)`` at once, then every 50 ms until it
        succeeds, counting one producer wait and its seconds if it did
        not succeed at once; False when closing."""
        t0 = time.monotonic()
        if attempt(0.0):
            return True
        self._counters.add("producer_waits")
        while not self._stop.is_set():
            if attempt(0.05):
                self._counters.add("producer_wait_s", time.monotonic() - t0)
                return True
        return False

    def _put(self, item) -> bool:
        def attempt(timeout):
            try:
                self._ring.put(item, timeout=timeout)
                return True
            except queue.Full:
                return False
        return self._wait_for(attempt)

    def _produce(self) -> None:
        from distributed_machine_learning_tpu_torch import chaos

        try:
            while not self._stop.is_set():
                if not self._wait_for(
                        lambda timeout: self._permits.acquire(
                            timeout=timeout)):
                    return
                plan = chaos.active_plan()
                if plan is not None:
                    # Deterministic degradation or death: a sleep per
                    # chunk (only rings whose name matches, when the plan
                    # names some) and a crash at a scheduled chunk.
                    plan.maybe_producer_fault(
                        self._chunk_index, name=self._name
                    )
                try:
                    item = next(self._source)
                except StopIteration:
                    self._put(_DONE)
                    return
                self._chunk_index += 1
                self._counters.add("chunks_staged")
                self._counters.add("bytes_staged", _item_nbytes(item))
                if not self._put(item):
                    return
                self._watchdog.beat("producer")
        except BaseException as exc:  # noqa: BLE001 - raised on the consumer
            self._counters.add("producer_crashes")
            self._put(_Crash(exc))

    # -- consumer side -------------------------------------------------------

    def get(self):
        """The next staged chunk.  Raises the producer's exception on a
        crash, :class:`ProducerStalled` past the hard timeout and
        ``StopIteration`` once the source is exhausted.  The chunk
        returned before is done with from here on."""
        if self._holding:
            self._holding = False
            self._permits.release()
        try:
            item = self._ring.get_nowait()
            self._counters.add("prefetch_hits")
        except queue.Empty:
            self._counters.add("consumer_waits")
            t0 = time.monotonic()
            item = None
            while item is None:
                waited = time.monotonic() - t0
                if waited > self._hard_timeout_s:
                    self._counters.add("consumer_wait_s", waited)
                    self.wait_s += waited
                    raise ProducerStalled(
                        f"host-input producer silent for {waited:.1f}s "
                        f"(hard timeout {self._hard_timeout_s:.1f}s, "
                        f"stall deadline {self._deadline_s:.1f}s)"
                    )
                # Silence past the deadline is counted once per episode.
                for _ in self._watchdog.expired():
                    self._counters.add("producer_stalls")
                try:
                    item = self._ring.get(timeout=0.05)
                except queue.Empty:
                    continue
            waited = time.monotonic() - t0
            self._counters.add("consumer_wait_s", waited)
            self.wait_s += waited
        if isinstance(item, _Crash):
            raise item.exc
        if item is _DONE:
            raise StopIteration
        self._holding = True
        return item

    def note_consume(self, seconds: float) -> None:
        """Record consumer seconds spent training chunks (the overlap
        efficiency's denominator)."""
        self._counters.add("consume_s", float(seconds))

    def close(self) -> None:
        """Stop the producer and drain the ring (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._ring.get_nowait()
        except queue.Empty:
            pass
        if self._producer.is_alive():
            self._producer.join(timeout=2.0)
        self._watchdog.untrack("producer")

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _item_nbytes(item) -> int:
    """The bytes of a staged item's tensors or arrays (tuples, lists and
    dicts of them; anything without ``nbytes`` counts 0)."""
    if isinstance(item, (tuple, list)):
        return sum(_item_nbytes(v) for v in item)
    if isinstance(item, dict):
        return sum(_item_nbytes(v) for v in item.values())
    if isinstance(item, torch.Tensor):
        return item.numel() * item.element_size()
    return int(getattr(item, "nbytes", 0) or 0)


# ---------------------------------------------------------------------------
# streaming program cache
# ---------------------------------------------------------------------------

# One built program set per chunked program key, as in the JAX module;
# the port builds nothing that a cohort could share (it runs eagerly), so
# its trainable does not call this, but the cache keeps the JAX surface.
_STREAM_CACHE: Dict[str, Any] = {}
_STREAM_LOCKS: Dict[str, Any] = {}
_STREAM_CACHE_MAX = 8
_STREAM_GUARD = threading.Lock()


def clear_stream_program_cache() -> None:
    with _STREAM_GUARD:
        _STREAM_CACHE.clear()
        _STREAM_LOCKS.clear()


def stream_bundle_for(key: str, build: Callable[[], Any]):
    """Exactly-once build of a streaming bundle per key (the others wait
    on the key's lock and reuse it); at most ``_STREAM_CACHE_MAX``
    entries, least recently used first out."""
    with _STREAM_GUARD:
        bundle = _STREAM_CACHE.pop(key, None)
        if bundle is not None:
            _STREAM_CACHE[key] = bundle  # LRU touch
            return bundle
        lock = _STREAM_LOCKS.setdefault(key, threading.Lock())
    with lock:
        with _STREAM_GUARD:
            bundle = _STREAM_CACHE.get(key)
            if bundle is not None:
                return bundle
        bundle = build()
        with _STREAM_GUARD:
            _STREAM_CACHE[key] = bundle
            while len(_STREAM_CACHE) > _STREAM_CACHE_MAX:
                evicted = next(iter(_STREAM_CACHE))
                _STREAM_CACHE.pop(evicted)
                _STREAM_LOCKS.pop(evicted, None)
        return bundle
