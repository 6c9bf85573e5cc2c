"""Calibration: measure what quantization costs before promoting it.

Port of ``distributed_machine_learning_tpu/quant/calibrate.py``.  A
quantized bundle's manifest carries evidence measured at export time on a
held-out calibration batch:

* f32 predictions and quantized predictions over the same batch -> MAPE
  and MAE of the quantized answers against the f32 parent's;
* per-layer activation ranges (max |activation|), keyed by the flax
  module path: the saturation diagnostic.

A model here is the port's ``nn.Module``; its weights come from a flax-
layout variables tree (what a bundle holds) through
``models/convert.py::from_flax_tensors`` and ``torch.func.functional_call``
(:func:`apply_variables`, the port's ``model.apply``).  flax's
``capture_intermediates`` becomes a forward hook on every submodule.
Everything runs eagerly on the model's device; the forward is the same
one the serving engine runs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.quant.core import (
    as_tensor,
    cast_input,
    check_precision,
    dequantize_output,
    dequantize_variables,
)

# Activation-range tables in the manifest are bounded like scale digests.
_RANGE_SUMMARY_MAX = 32

_MAPE_EPS = 1e-8

# Port module names whose flax counterparts carry flax's auto names (the
# parameter-free modules, which ``models/convert.py`` never needs).
_FLAX_NAMES = {
    "dropout": "Dropout_0",
    "ff_dropout": "Dropout_0",
    "attn_depth": "StochasticDepth_0",
    "ff_depth": "StochasticDepth_1",
}


def _device_of(model: torch.nn.Module) -> torch.device:
    for t in list(model.parameters()) + list(model.buffers()):
        return t.device
    return torch.device("cpu")


def apply_variables(model: torch.nn.Module, variables: Dict[str, Any],
                    x) -> torch.Tensor:
    """``model``'s evaluation forward with the weights of a flax-layout
    ``variables`` tree (numpy or tensors of any dtype; moved to the
    model's device), on ``x``: the port's ``model.apply``."""
    from torch.func import functional_call

    from distributed_machine_learning_tpu_torch.models.convert import (
        from_flax_tensors,
    )

    device = _device_of(model)

    def to_device(node):
        if isinstance(node, dict):
            return {k: to_device(v) for k, v in node.items()}
        return as_tensor(node).to(device)

    state = from_flax_tensors(to_device(variables["params"]))
    x = as_tensor(x).to(device)
    model.eval()
    with torch.no_grad():
        return functional_call(model, state, (x,))


def predict_f32(model, variables, x) -> np.ndarray:
    """Reference predictions with the unquantized variables."""
    x = np.asarray(x, np.float32)
    return apply_variables(model, variables, x).float().cpu().numpy()


def predict_quantized(model, qvariables, x, precision: str) -> np.ndarray:
    """Predictions through the same path the serving engine runs (storage
    tree -> bf16 compute -> f32 out)."""
    check_precision(precision)
    fvars = dequantize_variables(qvariables, precision)
    xt = cast_input(torch.from_numpy(np.asarray(x, np.float32)), precision)
    y = apply_variables(model, fvars, xt)
    return dequantize_output(y).cpu().numpy()


def quality_delta(f32_pred, quant_pred) -> Dict[str, float]:
    """MAPE/MAE of quantized predictions against the f32 parent's."""
    f = np.asarray(f32_pred, dtype=np.float64).ravel()
    q = np.asarray(quant_pred, dtype=np.float64).ravel()
    if f.shape != q.shape:
        raise ValueError(
            f"prediction shapes diverge: f32 {f.shape} vs quant {q.shape}"
        )
    err = np.abs(q - f)
    return {
        "mape": float(np.mean(err / (np.abs(f) + _MAPE_EPS))),
        "mae": float(np.mean(err)),
        "max_abs_err": float(np.max(err)) if err.size else 0.0,
    }


def _flax_module_path(model: torch.nn.Module, name: str) -> str:
    """The flax module path of the port submodule ``name`` (``"output"``
    for the model itself), as ``capture_intermediates`` keys it."""
    if not name:
        return "output"
    parts = name.split(".")
    out = []
    for i, part in enumerate(parts):
        if i == 0 and part == "position":
            kind = type(model.get_submodule("position")).__name__
            out.append("PositionalEncoding_0" if kind == "PositionalEncoding"
                       else "Dropout_0")
        else:
            out.append(_FLAX_NAMES.get(part, part))
    return "/".join(out)


def activation_ranges(model, variables, x) -> Dict[str, float]:
    """Per-layer max |activation| over the calibration batch, in the order
    the modules finish (as flax sows them), bounded to the first
    ``_RANGE_SUMMARY_MAX`` paths.  Best-effort: a failure yields an empty
    table, never a failed export."""
    ranges: Dict[str, float] = {}
    handles = []

    def hook_for(key):
        def hook(_module, _inputs, output):
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for out in outs:
                if isinstance(out, torch.Tensor) and out.numel():
                    top = float(out.detach().abs().max().float())
                    ranges[key] = max(ranges.get(key, 0.0), top)
        return hook

    try:
        for name, module in model.named_modules():
            handles.append(module.register_forward_hook(
                hook_for(_flax_module_path(model, name))))
        apply_variables(model, variables, np.asarray(x, np.float32))
    except Exception:  # noqa: BLE001 - diagnostics must not block export
        return {}
    finally:
        for h in handles:
            h.remove()
    return dict(list(ranges.items())[:_RANGE_SUMMARY_MAX])


def calibrate(
    model,
    f32_variables: Dict[str, Any],
    qvariables: Dict[str, Any],
    batch,
    precision: str,
) -> Dict[str, Any]:
    """The manifest's ``calibration`` block: batch identity, activation
    ranges, and the measured quality delta vs the f32 parent."""
    check_precision(precision)
    x = np.asarray(batch)
    if x.ndim < 2 or x.shape[0] == 0:
        raise ValueError(
            f"calibration batch needs shape (n, features...), got {x.shape}"
        )
    f_pred = predict_f32(model, f32_variables, x)
    q_pred = predict_quantized(model, qvariables, x, precision)
    delta = quality_delta(f_pred, q_pred)
    return {
        "batch_size": int(x.shape[0]),
        "batch_shape": list(x.shape),
        "activation_ranges": activation_ranges(model, f32_variables, x),
        "quality_delta_mape": delta["mape"],
        "quality_delta_mae": delta["mae"],
        "max_abs_err": delta["max_abs_err"],
    }


__all__ = [
    "apply_variables",
    "predict_f32",
    "predict_quantized",
    "quality_delta",
    "activation_ranges",
    "calibrate",
]
