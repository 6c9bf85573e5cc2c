"""Post-training weight quantization: symmetric per-channel int8 + bf16.

Port of ``distributed_machine_learning_tpu/quant/core.py``, with the same
names, scheme, manifest statistics and bytes.  Everything works on the
flax layout of a params tree (what a bundle holds): per-channel means the
flax kernel's LAST axis, so a q/k/v ``DenseGeneral`` kernel
``(d_model, heads, head_dim)`` gets ``head_dim`` scales shared across
heads, exactly as the JAX package quantizes it.

Quantization scheme (int8):

* per-channel symmetric: one scale per output channel (the last axis of
  a >=2-d weight), ``scale = max|w| / 127`` reduced over every other
  axis; values round to nearest into ``[-127, 127]``;
* sub-2-d leaves (biases, layer-norm gains, scalars) stay f32;
* scales ride next to the weights under the ``quant_scales`` collection,
  mirroring the params tree for the quantized leaves only.

The host side is numpy, as in JAX; a bf16 leaf is a ``torch.bfloat16``
tensor on the CPU (numpy has no bfloat16; ``serve/_msgpack.py`` writes
its bits as ``ml_dtypes`` would).  The dequantize helpers run in torch on
whatever device the leaves live on (the serving card): int8 codes and
scales widen to bf16 and multiply in bf16, the compute dtype of a
quantized forward, and the one f32 cast is on the way out.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.serve._msgpack import to_bfloat16

PRECISIONS = ("f32", "bf16", "int8")

# Symmetric int8 grid: [-127, 127], -128 unused.
_QMAX = 127.0

# Per-leaf scale summaries in the manifest are bounded.
_SCALE_SUMMARY_MAX = 16


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    return precision


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return int(leaf.numel() * leaf.element_size())
    return int(np.asarray(leaf).nbytes)


def quantize_leaf(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One >=2-d weight -> ``(q_int8, scale_f32)`` with a per-out-channel
    scale (reduced over all axes but the last, keepdims so the dequant
    multiply broadcasts with no reshape)."""
    w = np.asarray(w)
    axes = tuple(range(w.ndim - 1))
    amax = np.max(np.abs(w), axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax, 1.0) / _QMAX
    scale = np.asarray(scale, dtype=w.dtype)
    q = np.clip(np.rint(w / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, scale


def quantizable(leaf: Any) -> bool:
    """int8 targets: >=2-d floating leaves (matmul weights / embeddings)."""
    arr = np.asarray(leaf)
    return arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)


def quantize_params(
    params: Dict[str, Any], precision: str
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Quantize a (host, flax-layout) params tree -> ``(qparams, scales,
    stats)``.

    ``scales`` mirrors the tree structure for quantized leaves only (int8;
    empty for bf16).  ``stats`` is the manifest-ready summary: leaf
    counts, byte budgets, and a bounded per-leaf scale digest."""
    check_precision(precision)
    stats: Dict[str, Any] = {
        "method": (
            "symmetric-per-channel" if precision == "int8" else "cast"
        ),
        "quantized_leaves": 0,
        "total_leaves": 0,
        "bytes_f32": 0,
        "bytes_quant": 0,
        "scales": {},
    }
    if precision == "f32":
        return params, {}, stats

    def walk(node, path):
        if isinstance(node, Mapping):
            q, s = {}, {}
            for k, v in node.items():
                qk, sk = walk(v, path + (k,))
                q[k] = qk
                if sk is not None:
                    s[k] = sk
            return q, (s or None)
        leaf = np.asarray(node)
        stats["total_leaves"] += 1
        stats["bytes_f32"] += int(leaf.nbytes)
        if precision == "bf16":
            if np.issubdtype(leaf.dtype, np.floating):
                out = to_bfloat16(leaf)
                stats["quantized_leaves"] += 1
                stats["bytes_quant"] += _nbytes(out)
                return out, None
            stats["bytes_quant"] += int(leaf.nbytes)
            return leaf, None
        if not quantizable(leaf):
            stats["bytes_quant"] += int(leaf.nbytes)
            return leaf, None
        q, scale = quantize_leaf(leaf)
        stats["quantized_leaves"] += 1
        stats["bytes_quant"] += int(q.nbytes) + int(scale.nbytes)
        if len(stats["scales"]) < _SCALE_SUMMARY_MAX:
            stats["scales"]["/".join(path)] = {
                "shape": list(leaf.shape),
                "scale_min": float(scale.min()),
                "scale_max": float(scale.max()),
                "scale_mean": float(scale.mean()),
            }
        return q, scale

    qparams, scales = walk(params, ())
    if stats["bytes_f32"]:
        stats["compression"] = round(
            stats["bytes_f32"] / max(stats["bytes_quant"], 1), 3
        )
    return qparams, (scales or {}), stats


def quantize_variables(
    variables: Dict[str, Any], precision: str
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize a full variables dict ``{"params": .., ["batch_stats": ..]}``
    -> ``(qvariables, stats)``; the tree gains a ``quant_scales``
    collection (int8 only), ``batch_stats`` stay f32."""
    check_precision(precision)
    qparams, scales, stats = quantize_params(variables["params"], precision)
    out = dict(variables)
    out["params"] = qparams
    if scales:
        out["quant_scales"] = scales
    return out, stats


# -- dequantize (torch, on the leaves' device) -------------------------------


def as_tensor(leaf) -> torch.Tensor:
    """A tree leaf (numpy, or already a tensor) as a tensor, sharing its
    memory where it can."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.ascontiguousarray(leaf)
    # A leaf decoded from bytes is read-only; torch wants to own it.
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def dequantize_leaf(q, scale) -> torch.Tensor:
    """int8 codes * per-channel scale -> bf16 weight: both widen to bf16
    and multiply in bf16, the compute dtype of a quantized forward."""
    return as_tensor(q).to(torch.bfloat16) * as_tensor(scale).to(torch.bfloat16)


def dequantize_params(params, scales):
    """Rebuild a compute-ready (bf16) params tree from quantized leaves;
    unquantized leaves downcast to the same compute dtype."""

    def walk(node, snode):
        if isinstance(node, Mapping):
            return {
                k: walk(v, (snode or {}).get(k)) for k, v in node.items()
            }
        leaf = as_tensor(node)
        if leaf.dtype == torch.int8:
            if snode is None:
                raise ValueError(
                    "int8 leaf with no matching entry in quant_scales — "
                    "bundle params and scales are out of sync"
                )
            return dequantize_leaf(leaf, snode)
        return leaf.to(torch.bfloat16)

    return walk(params, scales)


def dequantize_variables(variables, precision: str):
    """The single entry a quantized forward calls: quantized storage tree
    -> compute-dtype variables (``quant_scales`` consumed, not forwarded
    to the model)."""
    check_precision(precision)
    if precision == "f32":
        return {k: v for k, v in variables.items() if k != "quant_scales"}
    out = {
        "params": dequantize_params(
            variables["params"], variables.get("quant_scales") or {}
        )
    }
    for coll, tree in variables.items():
        if coll in ("params", "quant_scales"):
            continue
        out[coll] = _tree_astype(tree, torch.bfloat16)
    return out


def dequantize_output(y: torch.Tensor) -> torch.Tensor:
    """The one f32 upcast on the serving path: bf16 output -> f32 answer."""
    return y.to(torch.float32)


def cast_input(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Inputs join the compute dtype (bf16) for quantized forwards."""
    if precision == "f32":
        return x
    return x.to(torch.bfloat16)


def _tree_astype(tree, dtype):
    if isinstance(tree, Mapping):
        return {k: _tree_astype(v, dtype) for k, v in tree.items()}
    return as_tensor(tree).to(dtype)


# -- fake-quant (quantize -> dequantize round trip, f32 in / f32 out) --------


def fake_quant_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Host-side int8 round trip of a single-model (flax-layout) params
    tree: the f32 weights a model would effectively serve with after int8
    export."""

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        leaf = np.asarray(node)
        if not quantizable(leaf):
            return leaf
        q, scale = quantize_leaf(leaf)
        return (q.astype(leaf.dtype) * scale).astype(leaf.dtype)

    return walk(params)


def fake_quant_population(params: Dict[str, Any]) -> Dict[str, Any]:
    """``fake_quant_tree`` for population-stacked flax-layout trees
    (leading axis = population row): per-(row, out-channel) scales, so
    each row is quantized exactly as its own int8 export would be.  Used
    by the PBT ``quality_after_quant`` objective."""

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        leaf = np.asarray(node)
        # Row axis + a >=2-d weight => ndim >= 3; row-wise biases stay f32.
        if leaf.ndim < 3 or not np.issubdtype(leaf.dtype, np.floating):
            return leaf
        axes = tuple(range(1, leaf.ndim - 1))
        amax = np.max(np.abs(leaf), axis=axes, keepdims=True)
        scale = np.asarray(
            np.where(amax > 0, amax, 1.0) / _QMAX, dtype=leaf.dtype
        )
        q = np.clip(np.rint(leaf / scale), -_QMAX, _QMAX)
        return (q * scale).astype(leaf.dtype)

    return walk(params)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def tree_precision(variables: Dict[str, Any]) -> str:
    """Infer the storage precision of a loaded variables tree (the
    manifest is authoritative; this is the cross-check)."""
    dtypes = set()

    def walk(node):
        if isinstance(node, Mapping):
            for v in node.values():
                walk(v)
            return
        dtypes.add(_dtype_name(node))

    walk(variables.get("params", {}))
    if "int8" in dtypes:
        return "int8"
    if "bfloat16" in dtypes:
        return "bf16"
    return "f32"


def leaf_count(tree: Any) -> int:
    if isinstance(tree, Mapping):
        return sum(leaf_count(v) for v in tree.values())
    return 1


__all__ = [
    "PRECISIONS",
    "check_precision",
    "quantize_leaf",
    "quantize_params",
    "quantize_variables",
    "quantizable",
    "dequantize_leaf",
    "dequantize_params",
    "dequantize_variables",
    "dequantize_output",
    "cast_input",
    "fake_quant_tree",
    "fake_quant_population",
    "tree_precision",
    "leaf_count",
]
