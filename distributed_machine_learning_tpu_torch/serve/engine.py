"""The inference engine: a bundle's model on one device, bucketed by batch.

Port of ``distributed_machine_learning_tpu/serve/engine.py``.  Serving
traffic arrives at arbitrary batch sizes; the engine pads every batch up
to a power-of-two bucket, so the device only ever sees a handful of
shapes and padded rows never change a real row's answer (every layer is
row-independent).  The forward runs under ``torch.inference_mode()`` on
the engine's device — on a card, on a stream of the engine's own, so
replicas sharing a card do not serialize on the default stream — and
returns host numpy float32.

``program_stats()`` counts the buckets built (the first forward at each
bucket shape) and the forwards run.  The JAX engine's AOT executable and
persistent XLA cache tiers have no counterpart yet: PyTorch runs eagerly.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Set, Tuple

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.serve.export import ServableBundle
from distributed_machine_learning_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

DEFAULT_MAX_BUCKET = 1024


def bucket_sizes(max_bucket: int = DEFAULT_MAX_BUCKET) -> Tuple[int, ...]:
    """The power-of-two padding grid: 1, 2, 4, ... max_bucket."""
    sizes = []
    b = 1
    while b < max_bucket:
        sizes.append(b)
        b *= 2
    sizes.append(max_bucket)
    return tuple(sizes)


class InferenceEngine:
    """A bundle's forward pass on one device, bucketed by batch size.

    Thread-safe: forwards are serialized by the engine's lock."""

    def __init__(
        self,
        bundle: ServableBundle,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.bundle = bundle
        self.model = bundle.build_model().to(self.device)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The weights were copied on the device's current stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._buckets = bucket_sizes(max_bucket)
        self._lock = threading.Lock()
        self._built: Set[Tuple] = set()
        self._forwards = 0

    @property
    def precision(self) -> str:
        return self.bundle.precision

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest bucket for oversize chunks —
        ``predict`` splits those)."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def program_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "precision": self.precision,
                "device": str(self.device),
                "programs": len(self._built),
                "forwards": self._forwards,
            }

    def _forward(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        out = self.model(xt)
        return out.float().cpu().numpy()

    def _run_bucket(self, x: np.ndarray) -> np.ndarray:
        """One padded chunk: pad the batch dim to its bucket, run, slice."""
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        key = (bucket, x.shape[1:], str(x.dtype))
        with self._lock, torch.inference_mode():
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    out = self._forward(x)
            else:
                out = self._forward(x)
            self._built.add(key)
            self._forwards += 1
        return out[:n]

    def predict(self, x) -> np.ndarray:
        """Batched forward pass; axis 0 is the batch dimension.  Requests
        larger than the top bucket are answered in top-bucket chunks."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 0:
            raise ValueError("predict() needs at least a batch dimension")
        n = x.shape[0]
        if n == 0:
            return np.zeros((0,), dtype=np.float32)
        top = self._buckets[-1]
        if n <= top:
            return self._run_bucket(x)
        outs = [self._run_bucket(x[i: i + top]) for i in range(0, n, top)]
        return np.concatenate(outs, axis=0)

    def warmup(self, sample: Any) -> Dict[str, Any]:
        """Run the bucket grid once for ``sample``'s row shape (the kernels
        build and load on the first forward) and return ``program_stats()``."""
        sample = np.asarray(sample, dtype=np.float32)
        trailing = sample.shape[1:] if sample.ndim > 1 else ()
        for b in self._buckets:
            self._run_bucket(np.zeros((b, *trailing), dtype=np.float32))
        return self.program_stats()
