"""Model zoo of the port + config -> model factory.

``build_model(config, input_features)`` builds a model from the same
trial-config keys and defaults as ``distributed_machine_learning_tpu.
models.build_model``.  Ported so far: ``mlp``, ``transformer`` and
``simple_transformer`` (the other families are in ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.models.mlp import MLPRegressor
from distributed_machine_learning_tpu_torch.models.transformer import (
    SimpleTransformerRegressor,
    TransformerRegressor,
)
from distributed_machine_learning_tpu_torch.utils.registry import Registry

models: Registry = Registry("model")

_DTYPE_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def compute_dtype_of(config: Dict[str, Any]) -> Optional[torch.dtype]:
    """Resolve ``config["compute_dtype"]`` to a torch dtype (None = f32
    promotion)."""
    cd = config.get("compute_dtype")
    if cd is None or not isinstance(cd, str):
        return cd
    try:
        return _DTYPE_NAMES[cd]
    except KeyError:
        raise ValueError(
            f"Unknown compute_dtype {cd!r}; expected one of "
            f"{sorted(_DTYPE_NAMES)}"
        ) from None


@models.register("mlp")
def _build_mlp(config: Dict[str, Any], input_features: int):
    return MLPRegressor(
        input_features=input_features,
        hidden_sizes=tuple(config.get("hidden_sizes", (128, 64))),
        dropout_rate=config.get("dropout", 0.0),
        out_features=config.get("out_features", 1),
        dtype=compute_dtype_of(config),
    )


@models.register("transformer")
def _build_transformer(config: Dict[str, Any], input_features: int):
    d_model = config.get("d_model", 64)
    return TransformerRegressor(
        input_features=input_features,
        d_model=d_model,
        num_heads=config.get("num_heads", 4),
        num_layers=config.get("num_encoder_layers", config.get("num_layers", 2)),
        dim_feedforward=config.get("dim_feedforward", d_model * 2),
        dropout_rate=config.get("dropout", 0.1),
        attention_type=config.get("attention_type", "scaled_dot_product"),
        key_dim_scaling=config.get("key_dim_scaling", 0.5),
        depthwise_separable_conv=config.get("depthwise_separable_conv", False),
        attn_kernel_size=config.get("attn_kernel_size", 3),
        stochastic_depth_rate=config.get("stochastic_depth_rate", 0.0),
        feedforward_type=config.get("feedforward_type"),
        shared_weights=config.get("shared_weights", False),
        max_seq_length=config.get("max_seq_length", 2000),
        out_features=config.get("out_features", 1),
        seq_axis=config.get("seq_axis"),
        dtype=compute_dtype_of(config),
        position_encoding=config.get("position_encoding", "sincos"),
        num_kv_heads=config.get("num_kv_heads"),
        block_size=config.get("block_size"),
        remat=config.get("remat", False),
        remat_policy=config.get("remat_policy"),
    )


@models.register("simple_transformer")
def _build_simple_transformer(config: Dict[str, Any], input_features: int):
    return SimpleTransformerRegressor(
        input_features=input_features,
        d_model=config.get("d_model", 64),
        num_heads=config.get("num_heads", 4),
        num_layers=config.get("num_layers", 2),
        dim_feedforward=config.get("dim_feedforward", 256),
        dropout_rate=config.get("dropout", 0.1),
        max_seq_length=config.get("max_seq_length", 2000),
        dtype=compute_dtype_of(config),
    )


# Families whose first layer reads a whole flattened row.
FLATTENING_FAMILIES = ("mlp",)


def input_width(config: Dict[str, Any], row_shape: Sequence[int]) -> int:
    """The ``input_features`` that :func:`build_model` takes for rows of
    ``row_shape`` (one example's shape, without the batch axis): the mlp
    flattens a row, as flax sizes its first layer from the flattened row
    at init; the sequence families read the last axis."""
    if str(config.get("model", "transformer")) in FLATTENING_FAMILIES:
        return int(np.prod(row_shape))
    return int(row_shape[-1])


def build_model(config: Dict[str, Any], input_features: int):
    """Construct a model from a trial config; ``config['model']`` picks the
    family, ``input_features`` is the width its first layer reads
    (:func:`input_width` of a row's shape)."""
    return models.get(config.get("model", "transformer"))(
        config, int(input_features)
    )


def init_parameters(model: torch.nn.Module,
                    generator: torch.Generator) -> torch.nn.Module:
    """Draw every parameter of ``model`` anew from ``generator``, module
    by module in registration order (the seeded init of a trial)."""
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model


__all__ = [
    "models",
    "build_model",
    "compute_dtype_of",
    "init_parameters",
    "input_width",
    "MLPRegressor",
    "TransformerRegressor",
    "SimpleTransformerRegressor",
]
