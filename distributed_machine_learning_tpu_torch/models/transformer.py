"""Transformer regressors, in PyTorch.

Port of ``distributed_machine_learning_tpu/models/transformer.py``:

* :class:`TransformerRegressor` — input projection, positional encoding
  (sincos table, RoPE inside every block, or none), N post-LN encoder
  blocks (``shared_weights`` applies ONE block N times, ALBERT-style),
  last-token pooling and the ReLU MLP regression head.
* :class:`SimpleTransformerRegressor` — the smoke-test model.

The input width is an explicit ``input_features`` (flax infers it from the
first batch; ``models.build_model`` reads it off the weights).  ``remat``
runs each encoder block (or each application of the shared one), the
MoE ones included, under ``layers.remat_call`` in training with
gradients on, as flax's ``nn.remat`` does, with ``remat_policy`` naming
what a block keeps: one trial's blocks through ``torch.utils.checkpoint``,
a population's (its row streams, under ``torch.func``) through
``layers.population_remat``.  It changes nothing in evaluation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_machine_learning_tpu_torch.models.layers import (
    Dense,
    Dropout,
    EncoderLayer,
    PositionalEncoding,
    Rng,
    remat_call,
    resolve_remat_policy,
)


class RegressionHead(nn.Module):
    """ReLU MLP head; default widths 128-64-32-16-1."""

    def __init__(self, in_features: int,
                 hidden_sizes: Sequence[int] = (128, 64, 32, 16),
                 out_features: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        widths = [in_features, *hidden_sizes, out_features]
        self.num_dense = len(widths) - 1
        for i in range(self.num_dense):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1], dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_dense):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_dense - 1:
                x = F.relu(x)
        return x


class _SharedLayer(nn.Module):
    """Holder mirroring flax's ``shared_layer/layer`` scan path."""

    def __init__(self, **layer_kwargs):
        super().__init__()
        self.layer = EncoderLayer(**layer_kwargs)


class TransformerRegressor(nn.Module):
    def __init__(
        self,
        input_features: int,
        d_model: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        dim_feedforward: int = 128,
        dropout_rate: float = 0.1,
        attention_type: str = "scaled_dot_product",
        key_dim_scaling: float = 0.5,
        depthwise_separable_conv: bool = False,
        attn_kernel_size: int = 3,
        stochastic_depth_rate: float = 0.0,
        feedforward_type: Optional[str] = None,
        num_experts: int = 8,
        expert_top_k: int = 2,
        capacity_factor: float = 1.25,
        moe_aux_coef: float = 1e-2,
        shared_weights: bool = False,
        max_seq_length: int = 2000,
        head_hidden_sizes: Sequence[int] = (128, 64, 32, 16),
        out_features: int = 1,
        seq_axis: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        position_encoding: str = "sincos",
        num_kv_heads: Optional[int] = None,
        block_size: Optional[int] = None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
    ):
        super().__init__()
        if position_encoding not in ("sincos", "rope", "none"):
            raise ValueError(
                f"Unknown position_encoding {position_encoding!r}; "
                f"expected 'sincos', 'rope', or 'none'"
            )
        layer_kwargs = dict(
            d_model=d_model,
            num_heads=num_heads,
            dim_feedforward=dim_feedforward,
            dropout_rate=dropout_rate,
            attention_type=attention_type,
            key_dim_scaling=key_dim_scaling,
            depthwise_separable_conv=depthwise_separable_conv,
            attn_kernel_size=attn_kernel_size,
            stochastic_depth_rate=stochastic_depth_rate,
            feedforward_type=feedforward_type,
            num_experts=num_experts,
            expert_top_k=expert_top_k,
            capacity_factor=capacity_factor,
            moe_aux_coef=moe_aux_coef,
            seq_axis=seq_axis,
            dtype=dtype,
            rope=position_encoding == "rope",
            num_kv_heads=num_kv_heads,
            block_size=block_size,
        )
        self.num_layers = num_layers
        self.shared_weights = shared_weights
        # Its blocks return an aux term for the training objective.
        self.collects_aux = feedforward_type == "moe"
        self.remat = bool(remat)
        self.remat_policy = (resolve_remat_policy(remat_policy)
                             if self.remat and remat_policy else None)
        self.input_projection = Dense(input_features, d_model, dtype)
        if position_encoding == "sincos":
            self.position = PositionalEncoding(
                d_model, dropout_rate, max_len=max_seq_length
            )
        else:
            self.position = Dropout(dropout_rate)
        if shared_weights:
            self.shared_layer = _SharedLayer(**layer_kwargs)
        else:
            for i in range(num_layers):
                self.add_module(f"layer_{i}", EncoderLayer(**layer_kwargs))
        self.head = RegressionHead(
            d_model, tuple(head_hidden_sizes), out_features, dtype
        )

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """x: [batch, seq, input_features] -> [batch, out_features].

        ``rng`` draws the dropout masks in training mode; ``aux`` collects
        each MoE block's load-balance term (``models/moe.py``)."""
        x = self.position(self.input_projection(x), rng)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = (self.shared_layer.layer if self.shared_weights
                     else getattr(self, f"layer_{i}"))
            if remat:
                x = remat_call(layer, x, rng, self.remat_policy,
                               aux if self.collects_aux else None)
            elif self.collects_aux:
                x = layer(x, rng, aux=aux)
            else:
                x = layer(x, rng)
        return self.head(x[:, -1, :])


class SimpleTransformerRegressor(nn.Module):
    """Smoke-test model: encoder stack + last-token + one Linear head."""

    def __init__(
        self,
        input_features: int,
        d_model: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        dim_feedforward: int = 256,
        dropout_rate: float = 0.1,
        max_seq_length: int = 2000,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.input_projection = Dense(input_features, d_model, dtype)
        self.position = PositionalEncoding(
            d_model, dropout_rate, max_len=max_seq_length
        )
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model=d_model,
                num_heads=num_heads,
                dim_feedforward=dim_feedforward,
                dropout_rate=dropout_rate,
                dtype=dtype,
            ))
        self.head = Dense(d_model, 1, dtype)

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        x = self.position(self.input_projection(x), rng)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, rng)
        return self.head(x[:, -1, :])
