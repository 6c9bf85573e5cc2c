"""The inference engine: a bundle's model on one device, bucketed by batch.

Port of ``distributed_machine_learning_tpu/serve/engine.py``.  Serving
traffic arrives at arbitrary batch sizes; the engine pads every batch up
to a power-of-two bucket, so the device only ever sees a handful of
shapes and padded rows never change a real row's answer (every layer is
row-independent).  The forward runs under ``torch.inference_mode()`` on
the engine's device — on a card, on a stream of the engine's own, so
replicas sharing a card do not serialize on the default stream — and
returns host numpy float32.

A quantized bundle (``precision`` bf16 or int8, ``quant/``) keeps its
stored tree on the device as it is: int8 codes with their scales, or bf16
leaves.  Each forward dequantizes it to bf16 (``quant.dequantize_
variables``), maps the tree onto the model through ``models/convert.py``
and ``torch.func.functional_call``, casts the input to bf16 and returns
f32, as the JAX engine's quantized program does; the model's own
parameters never leave the CPU.

``program_stats()`` counts the buckets built (the first forward at each
bucket shape and precision) and the forwards run.  The JAX engine's AOT
executable and persistent XLA cache tiers have no counterpart yet:
PyTorch runs eagerly.
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


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _to_device_tree(tree, device: torch.device):
    """A bundle's stored tree as tensors on ``device``, dtypes kept."""
    from distributed_machine_learning_tpu_torch.quant.core import as_tensor

    if isinstance(tree, dict):
        return {k: _to_device_tree(v, device) for k, v in tree.items()}
    return as_tensor(tree).to(device)


def _to_device_buffers(model: torch.nn.Module, device: torch.device):
    """Move ``model``'s buffers (position tables) to ``device`` and leave
    its parameters where they are: a quantized engine brings its weights
    to every forward."""
    for module in model.modules():
        for name, buf in list(module._buffers.items()):
            if buf is not None:
                module._buffers[name] = buf.to(device)
    return model


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
        self._precision = bundle.precision
        self._variables = None
        if self._precision == "f32":
            self.model = bundle.build_model().to(self.device)
        else:
            self.model = _to_device_buffers(
                bundle.build_model(load_weights=False), self.device)
            self._variables = _to_device_tree(
                {k: v for k, v in bundle.variables.items()
                 if k in ("params", "quant_scales")}, self.device)
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
        return self._precision

    def resident_bytes(self) -> int:
        """Bytes of the weights this engine keeps on its device."""
        if self._variables is None:
            tensors = list(self.model.parameters())
        else:
            tensors = _leaves(self._variables)
        return sum(int(t.numel() * t.element_size()) for t in tensors)

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
        if self._variables is None:
            return self.model(xt).float().cpu().numpy()
        from torch.func import functional_call

        from distributed_machine_learning_tpu_torch import quant
        from distributed_machine_learning_tpu_torch.models.convert import (
            from_flax_tensors,
        )

        fvars = quant.dequantize_variables(self._variables, self._precision)
        out = functional_call(self.model, from_flax_tensors(fvars["params"]),
                              (quant.cast_input(xt, self._precision),))
        return quant.dequantize_output(out).cpu().numpy()

    def _run_bucket(self, x: np.ndarray) -> np.ndarray:
        """One padded chunk: pad the batch dim to its bucket, run, slice."""
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        # Precision is part of the key: an int8 forward never counts as
        # an f32 bucket's.
        key = (bucket, x.shape[1:], str(x.dtype), self._precision)
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
