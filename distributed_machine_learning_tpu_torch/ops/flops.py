"""Analytic FLOP estimates + device peaks -> per-epoch MFU.

Port of ``distributed_machine_learning_tpu/ops/flops.py``: the formulas
are the JAX package's as they are (matmul terms only; forward + backward
= 3x forward, 4x with remat).  Only the peaks differ: the H100's, named by
``torch.cuda.get_device_name``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

# Dense peaks of one H100 SXM by compute dtype, from NVIDIA's H100 data
# sheet: bf16 on the tensor cores (989 TFLOP/s without sparsity), float32
# on the CUDA cores (67 TFLOP/s; the port runs f32 matmuls without TF32).
_PEAKS_BY_NAME = (
    ("H100", {"bfloat16": 989e12, "float32": 67e12}),
)
_DTYPE_ALIASES = {"bf16": "bfloat16", "f32": "float32"}


def device_peak_flops(device, compute_dtype: str = "float32") -> Optional[float]:
    """Peak matmul FLOP/s of ``device`` for the given compute dtype (None
    for the CPU and for a card without a known peak)."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    dtype = str(compute_dtype or "float32")
    dtype = _DTYPE_ALIASES.get(dtype, dtype)
    for key, peaks in _PEAKS_BY_NAME:
        if key in name:
            return peaks.get(dtype)
    return None


def _mlp_forward_flops(hidden_sizes, batch: int, seq: int, features: int) -> float:
    # models.mlp flattens (seq, features) then stacks Dense layers + scalar out.
    dims = [seq * features] + [int(h) for h in hidden_sizes] + [1]
    return sum(2.0 * batch * a * b for a, b in zip(dims, dims[1:]))


def _transformer_forward_flops(
    cfg: Dict[str, Any], batch: int, seq: int, features: int
) -> float:
    # Key resolution MUST mirror models/__init__.py's builders exactly
    # (num_encoder_layers alias, dim_feedforward defaulting to d_model*2 for
    # 'transformer' and 256 for 'simple_transformer') or the reported MFU is
    # silently wrong for non-default configs.
    family = str(cfg.get("model", "transformer"))
    d = int(cfg.get("d_model", 64))
    layers = int(
        cfg.get("num_encoder_layers", cfg.get("num_layers", 2))
        if family == "transformer"
        else cfg.get("num_layers", 2)
    )
    dff = int(cfg.get("dim_feedforward",
                      d * 2 if family == "transformer" else 256))
    # GQA (models/layers.py MultiHeadSelfAttention): K/V project to
    # kv_heads*head_dim = d * (kv_heads/heads), not full d — scale those two
    # projection terms or GQA configs report inflated MFU (advisor r3).
    heads = int(cfg.get("num_heads", 4))
    kv_heads = cfg.get("num_kv_heads")
    kv_ratio = (int(kv_heads) / heads) if kv_heads else 1.0
    f = 2.0 * batch * seq * features * d  # input projection
    per_layer = (
        (2 + 2 * kv_ratio) * 2.0 * batch * seq * d * d  # Q, O full; K, V @ kv_ratio
        + 2 * 2.0 * batch * seq * seq * d  # scores + apply (softmax attn)
        + 2 * 2.0 * batch * seq * d * dff  # FF in + out
    )
    f += layers * per_layer
    if family == "transformer":  # reference fc1..fc5 MLP head
        head = [d] + [int(h) for h in cfg.get("head_hidden_sizes",
                                              (128, 64, 32, 16))] + [1]
    else:  # simple_transformer: single Linear head (reference C12)
        head = [d, 1]
    f += sum(2.0 * batch * a * b for a, b in zip(head, head[1:]))
    return f


def forward_flops(
    config: Dict[str, Any], batch: int, seq: int, features: int
) -> Optional[float]:
    """Analytic forward matmul FLOPs for one batch, or None for model
    families without an estimate (cnn1d, resnet18)."""
    family = str(config.get("model", "transformer"))
    if family in ("transformer", "simple_transformer"):
        return _transformer_forward_flops(config, batch, seq, features)
    if family == "mlp":
        return _mlp_forward_flops(
            config.get("hidden_sizes", (128, 64)), batch, seq, features
        )
    return None


def train_step_flops(
    config: Dict[str, Any], batch: int, seq: int, features: int
) -> Optional[float]:
    """Forward + backward ~= 3x forward (the standard estimate); with
    ``remat`` each encoder block's forward re-runs during the backward
    pass, so the step is ~4x forward (advisor r3 — keeping the 3x there
    understated the work and overstated step-time-implied MFU headroom)."""
    fwd = forward_flops(config, batch, seq, features)
    if fwd is None:
        return None
    return (4.0 if config.get("remat") else 3.0) * fwd


def epoch_flops(
    config: Dict[str, Any],
    batch: int,
    seq: int,
    features: int,
    steps_per_epoch: int,
    eval_rows: int = 0,
) -> Optional[float]:
    """One epoch's analytic FLOPs: train steps + the full-set eval pass —
    the derivation both trainables used to inline (now owned here so the
    MFU numerator cannot drift between the resident, streaming, and
    sharded paths; consumed via ``perf.EpochPerfAccounting``)."""
    step = train_step_flops(config, batch, seq, features)
    if step is None:
        return None
    ev = (
        forward_flops(config, int(eval_rows), seq, features)
        if eval_rows
        else None
    )
    return step * int(steps_per_epoch) + (ev or 0.0)
