"""Building-block layers of the transformer family, in PyTorch.

Port of ``distributed_machine_learning_tpu/models/layers.py``.  Module and
parameter names mirror the flax tree (``query``/``key``/``value``/``out``,
``norm1``, ``ff/Dense_0``, ...) so ``models/convert.py`` maps weights by
path.  Parameters stay float32; ``dtype`` is the compute dtype, applied as
flax applies it: a dense layer casts its input, kernel and bias to it, a
layer norm computes its statistics in f32 and returns ``dtype``.

Randomness is explicit: parameters are drawn by ``reset_parameters`` from
a ``torch.Generator`` when one is given (``models.init_parameters``), and
dropout and stochastic depth draw their training masks from the generator
passed to ``forward(x, rng)``; nothing reads torch's global RNG in
training.  Evaluation draws nothing.

Sequence parallelism (``seq_axis``, ring/Ulysses) and the mixture-of-
experts feed-forward are not ported yet (ROADMAP.md queue A); asking for
either raises.  The TPU-only softmax->flash auto-route is deliberately
not carried over: "flash" runs only where the config names it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_machine_learning_tpu_torch.ops.attention import (
    blockwise_attention,
    dot_product_attention,
    largest_divisor_block,
    linear_attention,
)
from distributed_machine_learning_tpu_torch.ops.flash_attention import (
    flash_attention,
)

ATTENTION_TYPES = (
    "scaled_dot_product",
    "multi_head_attention",
    "linear_attention",
    "blockwise",
    "flash",
)


def _compute_dtype(dtype: Optional[torch.dtype], *tensors) -> torch.dtype:
    """flax's rule: the layer's dtype when set, else the promotion of its
    input and parameter dtypes."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``nn.DenseGeneral``: weight ``[out..., in...]``.

    ``in_shape``/``out_shape`` keep DenseGeneral's multi-axis features
    (attention q/k/v map d_model -> (heads, head_dim); its output maps
    (heads, head_dim) -> d_model), so the parameters keep the flax shapes
    up to a transpose."""

    def __init__(self, in_shape, out_shape, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_shape = tuple(np.atleast_1d(in_shape).tolist())
        self.out_shape = tuple(np.atleast_1d(out_shape).tolist())
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(*self.out_shape, *self.in_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = int(np.prod(self.in_shape)) ** -0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        dt = _compute_dtype(self.dtype, x, self.weight)
        w = self.weight.to(dt).reshape(-1, int(np.prod(self.in_shape)))
        y = F.linear(x.to(dt).reshape(*lead, -1), w, self.bias.to(dt).reshape(-1))
        return y.reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: epsilon 1e-6, statistics in f32."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = _compute_dtype(self.dtype, x, self.weight)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(out_dtype)


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over ``[B, S, C]`` with "SAME" padding.

    The weight is torch's ``[out, in/groups, window]``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 groups: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.groups = groups
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = int(np.prod(self.weight.shape[1:])) ** -0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        total = self.kernel_size - 1
        xc = F.pad(x.to(dt).transpose(1, 2), (total // 2, total - total // 2))
        y = F.conv1d(xc, self.weight.to(dt), self.bias.to(dt),
                     groups=self.groups)
        return y.transpose(1, 2)


def _rng_for_training(rng: Optional[torch.Generator]) -> torch.Generator:
    if rng is None:
        raise ValueError(
            "a dropout mask in training needs an explicit torch.Generator: "
            "call the model as model(x, rng=generator)"
        )
    return rng


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask is
    drawn from the generator handed to ``forward``.  The identity in
    evaluation or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=_rng_for_training(rng),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def sincos_position_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic transformer sin/cos positional table, shape [max_len, d_model]."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term[: d_model // 2])
    return table


class PositionalEncoding(nn.Module):
    """Adds the fixed sin/cos table (in x's dtype), then dropout."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_len: int = 5000):
        super().__init__()
        self.register_buffer(
            "table", torch.from_numpy(sincos_position_table(max_len, d_model)),
            persistent=False,
        )
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.table[None, : x.shape[1], :].to(x.dtype)
        return self.dropout(x, rng)


def apply_rope(x: torch.Tensor, base: float = 10000.0,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary position embedding over the head dim of [B, S, H, D].

    Rotate-half convention, math in f32, cast back to x's dtype."""
    B, S, H, D = x.shape
    if D % 2:
        raise ValueError(f"RoPE needs an even head dim, got {D}")
    half = D // 2
    pos = (torch.arange(S, dtype=torch.float32, device=x.device)
           if positions is None else positions.float())
    freqs = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    angles = pos[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


class StochasticDepth(nn.Module):
    """Drops a whole residual branch per sample with prob ``rate`` in
    training; the mask comes from the generator handed to ``forward``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask_shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(mask_shape, generator=_rng_for_training(rng),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    """Self-attention with a selectable scoring kernel.

    ``attention_type`` is one of :data:`ATTENTION_TYPES`; "flash" runs the
    CUDA kernel on the card (``ops/flash_attention.py``) and its plain
    version on the CPU.  ``key_dim_scaling`` sets the logit scale to
    head_dim ** -key_dim_scaling.  ``num_kv_heads`` < ``num_heads`` is
    grouped-query attention."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        attention_type: str = "scaled_dot_product",
        key_dim_scaling: float = 0.5,
        dropout_rate: float = 0.0,
        causal: bool = False,
        block_size: Optional[int] = None,
        seq_axis: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        rope: bool = False,
        num_kv_heads: Optional[int] = None,
    ):
        super().__init__()
        if attention_type not in ATTENTION_TYPES:
            raise ValueError(
                f"Unknown attention_type {attention_type!r}; "
                f"expected one of {ATTENTION_TYPES}"
            )
        if d_model % num_heads != 0:
            raise ValueError(
                f"d_model={d_model} not divisible by num_heads={num_heads}"
            )
        kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        if kv_heads <= 0 or num_heads % kv_heads != 0:
            raise ValueError(
                f"num_kv_heads={kv_heads} must be a positive divisor of "
                f"num_heads={num_heads}"
            )
        if seq_axis is not None:
            raise NotImplementedError(
                "sequence-parallel attention (seq_axis: ring/Ulysses) is not "
                "ported yet; see ROADMAP.md queue A"
            )
        self.num_heads = num_heads
        self.kv_heads = kv_heads
        self.head_dim = d_model // num_heads
        self.attention_type = attention_type
        self.key_dim_scaling = key_dim_scaling
        self.causal = causal
        self.block_size = block_size
        self.rope = rope
        hd = self.head_dim
        self.query = Dense(d_model, (num_heads, hd), dtype)
        self.key = Dense(d_model, (kv_heads, hd), dtype)
        self.value = Dense(d_model, (kv_heads, hd), dtype)
        self.out = Dense((num_heads, hd), d_model, dtype)
        self.dropout = Dropout(dropout_rate)

    def _full_kv(self, k, v):
        if self.kv_heads != self.num_heads:
            group = self.num_heads // self.kv_heads
            return (k.repeat_interleave(group, dim=2),
                    v.repeat_interleave(group, dim=2))
        return k, v

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        S = x.shape[1]
        q, k, v = self.query(x), self.key(x), self.value(x)
        if self.rope:
            q, k = apply_rope(q), apply_rope(k)
        scale = float(self.head_dim) ** (-self.key_dim_scaling)
        if self.attention_type == "linear_attention":
            out = linear_attention(q, k, v, causal=self.causal)
        elif self.attention_type == "flash":
            # The kernel takes the scale directly and kv at kv_heads.
            out = flash_attention(q, k, v, scale=scale, causal=self.causal)
        elif self.attention_type == "blockwise":
            bs = largest_divisor_block(S, self.block_size or 128)
            out = blockwise_attention(q, k, v, block_size=bs, causal=self.causal)
        else:
            k, v = self._full_kv(k, v)
            mask = None
            if self.causal:
                mask = torch.ones(S, S, dtype=torch.bool,
                                  device=x.device).tril()[None, None]
            out = dot_product_attention(q, k, v, mask=mask, scale=scale)
        return self.dropout(self.out(out), rng)


class LinearFF(nn.Module):
    """Linear -> ReLU -> Linear feed-forward."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(d_model, dim_feedforward, dtype)
        self.Dense_1 = Dense(dim_feedforward, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


class DepthwiseSeparableFF(nn.Module):
    """Depthwise (k=3) + pointwise conv feed-forward, projected to d_model."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 kernel_size: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depthwise = Conv1d(d_model, d_model, kernel_size,
                                groups=d_model, dtype=dtype)
        self.pointwise = Conv1d(d_model, dim_feedforward, 1, dtype=dtype)
        self.out_proj = Dense(dim_feedforward, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(F.relu(self.pointwise(self.depthwise(x))))


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder block: attention -> residual -> LN, then
    FF -> dropout -> residual -> LN, with stochastic depth on both
    branches."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        dim_feedforward: int,
        dropout_rate: float = 0.1,
        attention_type: str = "scaled_dot_product",
        key_dim_scaling: float = 0.5,
        depthwise_separable_conv: bool = False,
        attn_kernel_size: int = 3,
        stochastic_depth_rate: float = 0.0,
        feedforward_type: Optional[str] = None,
        seq_axis: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        rope: bool = False,
        num_kv_heads: Optional[int] = None,
        block_size: Optional[int] = None,
    ):
        super().__init__()
        self.attention = MultiHeadAttention(
            d_model=d_model,
            num_heads=num_heads,
            attention_type=attention_type,
            key_dim_scaling=key_dim_scaling,
            dropout_rate=dropout_rate,
            block_size=block_size,
            seq_axis=seq_axis,
            dtype=dtype,
            rope=rope,
            num_kv_heads=num_kv_heads,
        )
        self.attn_depth = StochasticDepth(stochastic_depth_rate)
        self.norm1 = LayerNorm(d_model, dtype)
        ff_type = feedforward_type or (
            "depthwise_separable" if depthwise_separable_conv else "linear"
        )
        if ff_type == "depthwise_separable":
            self.ff = DepthwiseSeparableFF(
                d_model, dim_feedforward, attn_kernel_size, dtype
            )
        elif ff_type == "linear":
            self.ff = LinearFF(d_model, dim_feedforward, dtype)
        elif ff_type == "moe":
            raise NotImplementedError(
                "feedforward_type='moe' is not ported yet; see ROADMAP.md "
                "queue A (models/moe.py)"
            )
        else:
            raise ValueError(
                f"Unknown feedforward_type {ff_type!r}; expected "
                f"'linear', 'depthwise_separable', or 'moe'"
            )
        self.ff_dropout = Dropout(dropout_rate)
        self.ff_depth = StochasticDepth(stochastic_depth_rate)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x + self.attn_depth(self.attention(x, rng), rng))
        ff = self.ff_depth(self.ff_dropout(self.ff(x), rng), rng)
        return self.norm2(x + ff)
