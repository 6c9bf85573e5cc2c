"""Stdlib HTTP front end: /predict, /healthz, /metrics.

Port of ``distributed_machine_learning_tpu/serve/server.py``::

    POST /predict  {"instances": [[...], ...]}
                   -> {"predictions": [...], "latency_ms": ...}
                   429 + Retry-After when admission control sheds,
                   503 + Retry-After when every breaker is open,
                   504 on a per-request deadline miss
    GET  /healthz  {"status": "ok"|"degraded"|"down", "replicas": [...]}
    GET  /metrics  windowed latency p50/p99, throughput, queue depth,
                   batch fill, breaker and admission counters, buckets built

The admin routes (hot swap, rollback) wait for the swap module.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from distributed_machine_learning_tpu_torch.serve.export import ServableBundle
from distributed_machine_learning_tpu_torch.serve.metrics import ServeMetrics
from distributed_machine_learning_tpu_torch.serve.replica import (
    AllReplicasOpen,
    Overloaded,
    ReplicaSet,
    ReplicaTimeout,
)
from distributed_machine_learning_tpu_torch.utils.device import DeviceLike


class PredictionServer:
    """Owns a :class:`ReplicaSet` and serves it over HTTP.

    ``port=0`` binds an ephemeral port; ``start()`` returns the bound
    ``(host, port)``.  Handler threads only do JSON work — the device path
    stays inside the replicas' batcher workers."""

    def __init__(
        self,
        bundle: ServableBundle,
        host: str = "127.0.0.1",
        port: int = 8000,
        num_replicas: int = 1,
        device: DeviceLike = "cuda",
        max_batch_size: int = 64,
        max_latency_ms: float = 5.0,
        max_bucket: int = 256,
        batcher: str = "continuous",
        max_queue: int = 1024,
        request_timeout_s: float = 30.0,
    ):
        self.bundle = bundle
        self.replicas = ReplicaSet(
            bundle,
            num_replicas=num_replicas,
            device=device,
            max_batch_size=max_batch_size,
            max_latency_ms=max_latency_ms,
            max_bucket=max_bucket,
            batcher=batcher,
            max_queue=max_queue,
        )
        self.metrics = ServeMetrics()
        self._timeout_s = request_timeout_s
        self._host, self._port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- request handling (called from handler threads) ----------------------

    def handle_predict(self, body: Dict[str, Any]) -> Dict[str, Any]:
        instances = body.get("instances")
        if instances is None:
            raise ValueError('request body needs an "instances" array')
        x = np.asarray(instances, dtype=np.float32)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError("instances must be a non-empty array")
        t0 = time.monotonic()
        preds = self.replicas.predict(x, timeout=self._timeout_s)
        latency = time.monotonic() - t0
        self.metrics.observe(latency, rows=x.shape[0])
        return {
            "predictions": np.asarray(preds).tolist(),
            "latency_ms": round(latency * 1000.0, 3),
        }

    def handle_healthz(self) -> Dict[str, Any]:
        health = self.replicas.health()
        alive = sum(1 for h in health if h["alive"])
        return {
            "status": "ok" if alive == len(health) else
            ("degraded" if alive else "down"),
            "replicas": health,
            "restarts": self.replicas.restarts,
            "model_family": self.bundle.model_family,
            "precision": self.bundle.precision,
        }

    def handle_metrics(self) -> Dict[str, Any]:
        batcher = self.replicas.batcher_stats()
        return {
            **self.metrics.snapshot(),
            **{f"batcher_{k}": v for k, v in batcher.items()},
            "compile": self.replicas.program_stats(),
            "num_replicas": len(self.replicas.replicas),
            "num_healthy": self.replicas.num_healthy(),
            "breakers": self.replicas.breaker_stats(),
            "restarts": self.replicas.restarts,
            "admission": {
                "max_queue": self.replicas._kwargs.get("max_queue"),
                "sheds_total": self.replicas.sheds,
                "queue_depth": batcher.get("queue_depth", 0),
                "redispatches": self.replicas.redispatches,
            },
            "checkpoint_load_s": round(self.bundle.checkpoint_load_s, 4),
            "precision": self.bundle.precision,
        }

    # -- lifecycle -----------------------------------------------------------

    def warmup(self, sample) -> Dict[str, Any]:
        return self.replicas.warmup(sample)

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 - metrics carry it
                pass

            def _reply(self, code: int, payload: Dict[str, Any],
                       headers: Optional[Dict[str, str]] = None):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        self._reply(200, server.handle_healthz())
                    elif self.path == "/metrics":
                        self._reply(200, server.handle_metrics())
                    else:
                        self._reply(404, {"error": f"no route {self.path}"})
                except Exception as exc:  # noqa: BLE001 - surface as 500
                    self._reply(500, {"error": repr(exc)})

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    self._reply(200, server.handle_predict(body))
                except ValueError as exc:
                    server.metrics.observe_error()
                    self._reply(400, {"error": str(exc)})
                except Overloaded as exc:
                    server.metrics.observe_shed()
                    retry_after = max(int(math.ceil(exc.retry_after_s)), 1)
                    self._reply(
                        429,
                        {"error": str(exc),
                         "retry_after_s": round(exc.retry_after_s, 3),
                         "queue_depth": exc.depth},
                        headers={"Retry-After": str(retry_after)},
                    )
                except ReplicaTimeout as exc:
                    server.metrics.observe_timeout()
                    self._reply(
                        504,
                        {"error": str(exc), "timeout_s": exc.timeout_s,
                         "replica": exc.replica_idx},
                    )
                except AllReplicasOpen as exc:
                    server.metrics.observe_rejected()
                    retry_after = max(int(math.ceil(exc.retry_after_s)), 1)
                    self._reply(
                        503,
                        {"error": str(exc),
                         "retry_after_s": round(exc.retry_after_s, 3)},
                        headers={"Retry-After": str(retry_after)},
                    )
                except Exception as exc:  # noqa: BLE001 - surface as 503
                    server.metrics.observe_error()
                    self._reply(503, {"error": repr(exc)})

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._host, self._port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()
        return self._host, self._port

    @property
    def address(self):
        return self._host, self._port

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.replicas.close()
