"""Serving metrics: windowed latency quantiles and request counters.

Port of ``distributed_machine_learning_tpu/serve/metrics.py`` (the
``/metrics`` JSON keys are the same).  Not yet ported: the drift hooks and
the TensorBoard emitter.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (0 if empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q / 100.0 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class LatencyWindow:
    """Fixed-capacity ring buffer of latency samples (milliseconds); the
    newest ``capacity`` samples win.  Not thread-safe on its own —
    :class:`ServeMetrics` holds the lock."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._buf = [0.0] * self.capacity
        self._next = 0
        self._count = 0

    def add(self, value: float) -> None:
        self._buf[self._next] = float(value)
        self._next = (self._next + 1) % self.capacity
        if self._count < self.capacity:
            self._count += 1

    def __len__(self) -> int:
        return self._count

    def values(self) -> List[float]:
        """Window contents, oldest first."""
        if self._count < self.capacity:
            return self._buf[: self._count]
        return self._buf[self._next:] + self._buf[: self._next]


class ServeMetrics:
    """Thread-safe request accounting for one serving process: lifetime
    counters, windowed latency quantiles."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._latencies_ms = LatencyWindow(window)
        self._started_at = time.monotonic()
        self.requests = 0
        self.rows = 0
        self.errors = 0
        self.rejected = 0
        self.timeouts = 0
        self.sheds = 0

    def observe(self, latency_s: float, rows: int):
        with self._lock:
            self.requests += 1
            self.rows += rows
            self._latencies_ms.add(latency_s * 1000.0)

    def observe_error(self):
        with self._lock:
            self.errors += 1

    def observe_rejected(self):
        """A breaker 503 (every replica quarantined)."""
        with self._lock:
            self.rejected += 1

    def observe_shed(self):
        """An admission-control 429."""
        with self._lock:
            self.sheds += 1

    def observe_timeout(self):
        """A request that missed its deadline (504)."""
        with self._lock:
            self.timeouts += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self._latencies_ms.values())
            uptime = max(time.monotonic() - self._started_at, 1e-9)
            return {
                "uptime_s": round(uptime, 1),
                "requests_total": self.requests,
                "rows_total": self.rows,
                "errors_total": self.errors,
                "rejected_total": self.rejected,
                "shed_total": self.sheds,
                "timeouts_total": self.timeouts,
                "requests_per_s": round(self.requests / uptime, 2),
                "rows_per_s": round(self.rows / uptime, 2),
                "latency_ms_p50": round(percentile(lat, 50.0), 3),
                "latency_ms_p99": round(percentile(lat, 99.0), 3),
                "latency_window": len(lat),
                "latency_window_capacity": self._latencies_ms.capacity,
            }
