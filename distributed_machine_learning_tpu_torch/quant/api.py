"""Bundle-level quantization: f32 servable bundle -> quantized sibling.

Port of ``distributed_machine_learning_tpu/quant/api.py``.
``export_bundle(precision=...)`` quantizes at export time; this module is
the second entry point: re-quantizing a bundle that already shipped (the
f32 parent keeps serving while its int8 sibling is exported, calibrated
and ``hot_swap``-promoted)."""

from __future__ import annotations

from typing import Any, Dict

from distributed_machine_learning_tpu_torch.quant import calibrate as _cal
from distributed_machine_learning_tpu_torch.quant.core import (
    check_precision,
    quantize_variables,
)
from distributed_machine_learning_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


def quantize_bundle(
    bundle_dir: str,
    out_dir: str,
    precision: str,
    calibration_batch,
    device: DeviceLike = "cuda",
) -> str:
    """Load the f32 bundle at ``bundle_dir``, quantize to ``precision``,
    calibrate on ``calibration_batch`` (the forwards run on ``device``),
    and write a sibling bundle to ``out_dir`` (``precision`` and the
    ``quant`` block updated, ``source.parent_bundle`` recording
    provenance).  Returns ``out_dir``."""
    from distributed_machine_learning_tpu_torch.serve import export as _export

    check_precision(precision)
    if precision == "f32":
        raise ValueError(
            "quantize_bundle targets bf16/int8; the f32 parent already "
            "exists"
        )
    bundle = _export.load_bundle(bundle_dir)
    parent_precision = bundle.precision
    if parent_precision != "f32":
        raise ValueError(
            f"bundle at {bundle_dir!r} is already {parent_precision} — "
            f"quantize from the f32 parent, not a quantized sibling"
        )
    require_calibration(precision, calibration_batch)
    model = bundle.build_model(load_weights=False).to(
        resolve_device(device))
    quant_block = build_quant_block(
        model, bundle.variables, precision, calibration_batch
    )
    qvariables = quant_block.pop("_variables")
    manifest = dict(bundle.manifest)
    manifest["precision"] = precision
    manifest["quant"] = quant_block
    source = dict(manifest.get("source") or {})
    source["parent_bundle"] = bundle_dir
    manifest["source"] = source
    _export.write_bundle(out_dir, manifest, qvariables)
    return out_dir


def require_calibration(precision: str, calibration_batch) -> None:
    if calibration_batch is None:
        raise ValueError(
            f"precision={precision!r} requires a calibration_batch — the "
            f"manifest's quality delta is measured, never assumed"
        )


def build_quant_block(
    model,
    f32_variables: Dict[str, Any],
    precision: str,
    calibration_batch,
) -> Dict[str, Any]:
    """Quantize + calibrate: returns the manifest ``quant`` block with the
    quantized variables tree riding under the private ``_variables`` key
    (popped by the caller before the block is serialized).  ``model``
    gives the structure; the calibration forwards run on its device."""
    require_calibration(precision, calibration_batch)
    qvariables, stats = quantize_variables(f32_variables, precision)
    calibration = _cal.calibrate(
        model, f32_variables, qvariables, calibration_batch, precision
    )
    block: Dict[str, Any] = {
        "method": stats["method"],
        "parent_precision": "f32",
        "quantized_leaves": stats["quantized_leaves"],
        "total_leaves": stats["total_leaves"],
        "bytes_f32": stats["bytes_f32"],
        "bytes_quant": stats["bytes_quant"],
        "scales": stats["scales"],
        "calibration": calibration,
        "quality_delta_mape": calibration["quality_delta_mape"],
        "_variables": qvariables,
    }
    if "compression" in stats:
        block["compression"] = stats["compression"]
    return block


__all__ = ["quantize_bundle", "build_quant_block"]
