"""Post-training quantization for the serving plane.

Port of ``distributed_machine_learning_tpu/quant/``: the same names, the
same manifest blocks and the same ``PRECISIONS``.

* :mod:`.core` — symmetric per-channel int8 and bf16 weight quantization
  (numpy, on the flax layout a bundle holds) and the dequantize helpers a
  quantized forward calls (torch, on the serving device);
* :mod:`.calibrate` — the export-time calibration pass: activation
  ranges and the quality delta (MAPE vs the f32 parent) on a held-out
  batch, recorded in the manifest;
* :mod:`.api` — quantize an already-exported bundle.
"""

from distributed_machine_learning_tpu_torch.quant.api import (
    build_quant_block,
    quantize_bundle,
)
from distributed_machine_learning_tpu_torch.quant.calibrate import (
    activation_ranges,
    apply_variables,
    calibrate,
    predict_f32,
    predict_quantized,
    quality_delta,
)
from distributed_machine_learning_tpu_torch.quant.core import (
    PRECISIONS,
    cast_input,
    check_precision,
    dequantize_leaf,
    dequantize_output,
    dequantize_params,
    dequantize_variables,
    fake_quant_population,
    fake_quant_tree,
    quantizable,
    quantize_leaf,
    quantize_params,
    quantize_variables,
    tree_precision,
)

__all__ = [
    "PRECISIONS",
    "activation_ranges",
    "apply_variables",
    "build_quant_block",
    "calibrate",
    "cast_input",
    "check_precision",
    "dequantize_leaf",
    "dequantize_output",
    "dequantize_params",
    "dequantize_variables",
    "fake_quant_population",
    "fake_quant_tree",
    "predict_f32",
    "predict_quantized",
    "quality_delta",
    "quantizable",
    "quantize_bundle",
    "quantize_leaf",
    "quantize_params",
    "quantize_variables",
    "tree_precision",
]
