"""Building-block layers of the transformer family, in PyTorch.

Port of ``distributed_machine_learning_tpu/models/layers.py``.  Module and
parameter names mirror the flax tree (``query``/``key``/``value``/``out``,
``norm1``, ``ff/Dense_0``, ...) so ``models/convert.py`` maps weights by
path.  Parameters stay float32; ``dtype`` is the compute dtype, applied as
flax applies it: a dense layer casts its input, kernel and bias to it, a
layer norm computes its statistics in f32 and returns ``dtype``.

Randomness is explicit: parameters are drawn by ``reset_parameters`` from
a ``torch.Generator`` when one is given (``models.init_parameters``), and
dropout and stochastic depth draw their training masks from the ``rng``
passed to ``forward(x, rng)``: a ``torch.Generator`` (one trial), or a
per-row stream (``ops/rng.py``: a population under ``torch.func.vmap``);
nothing reads torch's global RNG in training.  Evaluation draws nothing.

Rematerialization (:func:`remat_call`) runs one trial's block under a
non-reentrant ``torch.utils.checkpoint``, with the
``jax.checkpoint_policies`` names mapped onto selective-checkpoint
policies (:func:`resolve_remat_policy`; ``everything_saveable`` runs the
block without a checkpoint), and replays the block's dropout generator in
the recompute.  A population's block (its masks drawn from a row stream,
under ``torch.func``'s ``vmap(grad(...))``, where ``torch.utils.checkpoint``
raises) runs as :class:`_PopulationRemat`, an ``autograd.Function`` whose
backward reruns the block from its saved inputs and takes its
vector-Jacobian product; a dots policy keeps the block's products from
the forward and hands them back to the rerun (:class:`_DotsTape`).

The mixture-of-experts feed-forward (``feedforward_type="moe"``,
``models/moe.py``) returns its load-balance term beside its output; an
:class:`EncoderLayer` appends it to the ``aux`` list its caller passes
(the training epochs sum it onto the loss, as the JAX package sums what
the model sowed into ``"moe"``).  Sequence parallelism (``seq_axis``,
ring/Ulysses) is not ported yet (ROADMAP.md queue A); asking for it
raises.  The TPU-only softmax->flash auto-route is deliberately
not carried over: "flash" runs only where the config names it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_machine_learning_tpu_torch.ops.attention import (
    blockwise_attention,
    dot_product_attention,
    largest_divisor_block,
    linear_attention,
)
from distributed_machine_learning_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from distributed_machine_learning_tpu_torch.ops.rng import RowStream

# Where training masks come from: one trial's generator, or a row stream.
Rng = Union[torch.Generator, RowStream]

ATTENTION_TYPES = (
    "scaled_dot_product",
    "multi_head_attention",
    "linear_attention",
    "blockwise",
    "flash",
)


_aten = torch.ops.aten
# The products a "dots" policy keeps: what a dense layer, an einsum or a
# matmul becomes below autograd.  Without batch dimensions: mm and addmm.
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default})
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})


def _saving(ops: frozenset) -> Callable:
    """A selective-checkpoint policy that saves the outputs of ``ops`` and
    recomputes the rest."""

    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    # What a population's rerun takes from the forward (_DotsTape).
    policy.saved_ops = ops
    return policy


# ``everything_saveable`` keeps every residual and recomputes nothing, as
# in JAX: no checkpoint at all, so plain autograd keeps what each backward
# reads.  A selective policy cannot stand in for it, because the flash
# kernels launch inside an ``autograd.Function`` whose outputs no policy
# can save (the recompute would rerun them).
SAVE_EVERYTHING = "everything_saveable"

# jax.checkpoint_policies names -> torch policies; None recomputes all.
REMAT_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": SAVE_EVERYTHING,
    "dots_saveable": _saving(_DOTS),
    "checkpoint_dots": _saving(_DOTS),
    "dots_with_no_batch_dims_saveable": _saving(_DOTS_NO_BATCH),
}


def resolve_remat_policy(name) -> Optional[Callable]:
    """The selective-checkpoint policy of a ``jax.checkpoint_policies``
    name: None/""/"none" (no policy: the whole block is recomputed) or
    one of :data:`REMAT_POLICIES`."""
    if name is None or name in ("", "none", False):
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"Unknown remat policy {name!r}; expected one of "
            f"{sorted(REMAT_POLICIES)}"
        )
    return REMAT_POLICIES[name]


def remat_call(block: Callable, x: torch.Tensor, rng, policy=None,
               aux: Optional[list] = None) -> torch.Tensor:
    """``block(x, rng)`` (with ``aux=aux`` when ``aux`` is a list) under a
    non-reentrant ``torch.utils.checkpoint``:
    its activations are recomputed in the backward, but for what
    ``policy`` (from :func:`resolve_remat_policy`) saves;
    :data:`SAVE_EVERYTHING` runs the block plainly.

    ``torch.utils.checkpoint`` replays only the default generators'
    state, and the masks here come from the explicit ``rng``; a plain
    checkpoint would draw new masks in the recompute (wrong gradients)
    and advance ``rng`` twice.  So the generator's state is taken before
    the block, set back for the recompute, and restored after it.

    With a row stream (a population, under ``torch.func``) ``block``
    must be an ``nn.Module`` and the call goes to
    :func:`population_remat`."""
    if isinstance(rng, RowStream) and policy != SAVE_EVERYTHING:
        return population_remat(block, x, rng, policy, aux)
    if aux is not None:
        block = functools.partial(block, aux=aux)
    if policy == SAVE_EVERYTHING:
        return block(x, rng)
    before = None if rng is None else rng.get_state()
    calls = [0]

    def run(h):
        calls[0] += 1
        if before is None or calls[0] == 1:
            return block(h, rng)
        now = rng.get_state()
        rng.set_state(before)
        try:
            return block(h, rng)
        finally:
            rng.set_state(now)

    kwargs = {}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    # The default generators draw nothing here: no need to stash them.
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kwargs)


class _DotsTape(TorchDispatchMode):
    """Keeps the outputs of a dots policy's products (``ops``) in call
    order, or, with ``replay``, hands them back in the same order instead
    of computing them again.  It sits below ``torch.func``'s transforms,
    so it sees the physical products of a vmapped block (the batched
    ``bmm`` a row's ``mm`` becomes); autograd above it records each
    product as computed, and its derivative reads the product's inputs,
    not its output."""

    def __init__(self, ops: frozenset, tape: List[torch.Tensor],
                 replay: bool = False):
        super().__init__()
        self.ops = ops
        self.tape = tape
        self.replay = replay
        self.next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if self.replay:
            out = self.tape[self.next]
            self.next += 1
            return out
        out = func(*args, **(kwargs or {}))
        self.tape.append(out)
        return out


class _RematPlan:
    """What :class:`_PopulationRemat` needs beside its tensors: the block,
    its parameter names, the row stream's step and first site, the
    policy's saved products and, after the forward, the site the block
    left the stream at."""

    def __init__(self, block: nn.Module, names, step: int, site: int,
                 saved_ops: Optional[frozenset], with_aux: bool):
        self.block = block
        self.names = names
        self.step = step
        self.site = site
        self.saved_ops = saved_ops
        self.with_aux = with_aux
        self.tape: List[torch.Tensor] = []
        self.site_end = site

    def run(self, x, seed, params):
        """The block on ``x`` with ``params``, its masks drawn from the
        row stream at the block's first site: ``(y,)`` or ``(y, aux)``."""
        from torch.func import functional_call

        rng = RowStream(seed, self.step)
        rng.site = self.site
        aux = [] if self.with_aux else None
        kwargs = {"aux": aux} if self.with_aux else {}
        y = functional_call(self.block, dict(zip(self.names, params)),
                            (x, rng), kwargs)
        self.site_end = rng.site
        if self.with_aux:
            (term,) = aux
            return y, term
        return (y,)

    def tape_mode(self, replay: bool):
        if self.saved_ops is None:
            return contextlib.nullcontext()
        return _DotsTape(self.saved_ops, self.tape, replay=replay)


class _PopulationRemat(torch.autograd.Function):
    """One block of a population, rematerialized: the forward keeps no
    activation of the block (but a dots policy's products), the backward
    reruns the block from its inputs and takes its vector-Jacobian
    product.

    Both the forward and the rerun run the block under a
    ``torch.func.vjp``, so the block's operators see their inputs
    requiring gradients as a plain step's do (``matmul`` picks its
    products by that): the forward's values are the plain forward's bit
    for bit; the forward then drops its graph.  The block's parameters
    and the row stream's seed (a batched tensor under ``vmap``) are
    inputs of the Function, not values it closes over.  The recompute
    draws its masks from the stream at the block's first site, so it
    draws the forward's masks.  A nested ``autograd.Function`` (flash
    attention) runs inside both; its own ``vmap`` rule folds the rows
    into one launch.  ``generate_vmap_rule`` lets ``torch.func`` vmap the
    forward and the backward.

    ``torch.func.grad`` takes its gradient with ``create_graph=True``,
    which keeps every saved tensor to the end of the backward and records
    the backward's own operations.  So the rerun starts from detached
    inputs and its pullback keeps no graph: each block's recomputed
    activations are freed as soon as its gradients exist, and a remat
    block has no second derivative.  Without that, the reruns of all the
    blocks would live together and remat would save nothing."""

    generate_vmap_rule = True

    @staticmethod
    def forward(plan: _RematPlan, x, seed, *params):
        from torch.func import vjp

        del plan.tape[:]
        with torch.enable_grad(), plan.tape_mode(replay=False):
            out, _ = vjp(lambda h, *ps: plan.run(h, seed, ps), x, *params)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, x, seed, *params = inputs
        ctx.plan = plan
        ctx.save_for_backward(x, seed, *params)

    @staticmethod
    def backward(ctx, *grads):
        from torch.func import vjp

        plan = ctx.plan
        x, seed, *params = (t.detach() for t in ctx.saved_tensors)
        with torch.enable_grad(), plan.tape_mode(replay=True):
            out, pullback = vjp(lambda h, *ps: plan.run(h, seed, ps),
                                x, *params)
        grads = tuple(torch.zeros_like(o) if g is None else g.detach()
                      for o, g in zip(out, grads))
        dx, *dparams = pullback(grads, retain_graph=False,
                                create_graph=False)
        return (None, dx, None, *dparams)


def population_remat(block: nn.Module, x: torch.Tensor, rng: RowStream,
                     policy=None, aux: Optional[list] = None
                     ) -> torch.Tensor:
    """``block(x, rng)`` (``aux=aux`` too when ``aux`` is a list) through
    :class:`_PopulationRemat`, for a population's row stream: the
    block's activations are recomputed in the backward, but for the
    products a dots ``policy`` (:func:`resolve_remat_policy`) keeps.
    The stream's site counter ends where a plain forward leaves it."""
    if not isinstance(block, nn.Module):
        raise TypeError(
            "a population's remat reruns an nn.Module block with its "
            f"parameters as inputs; got {type(block).__name__}")
    names, params = zip(*block.named_parameters())
    plan = _RematPlan(block, names, rng.step, rng.site,
                      getattr(policy, "saved_ops", None), aux is not None)
    out = _PopulationRemat.apply(plan, x, rng.seed, *params)
    rng.site = plan.site_end
    if aux is not None:
        aux.append(out[1])
    return out[0]


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

    def __init__(self, in_shape, out_shape, dtype: Optional[torch.dtype] = None,
                 use_bias: bool = True):
        super().__init__()
        self.in_shape = tuple(np.atleast_1d(in_shape).tolist())
        self.out_shape = tuple(np.atleast_1d(out_shape).tolist())
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(*self.out_shape, *self.in_shape))
        # flax's use_bias=False (the LSTM's input gates) has no bias leaf.
        self.bias = (nn.Parameter(torch.zeros(*self.out_shape)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = int(np.prod(self.in_shape)) ** -0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        dt = _compute_dtype(self.dtype, x, self.weight)
        w = self.weight.to(dt).reshape(-1, int(np.prod(self.in_shape)))
        x = x.to(dt).reshape(*lead, -1)
        if self.bias is None:
            y = F.linear(x, w)
            return y.reshape(*lead, *self.out_shape)
        b = self.bias.to(dt).reshape(-1)
        if dt == torch.float32 or torch.is_grad_enabled():
            y = F.linear(x, w, b)
        else:
            # flax rounds the product to the compute dtype, then adds the
            # bias: two roundings, where the fused addmm rounds once.  An
            # inference forward (serving, calibration, evaluation) rounds
            # as flax does, so its bf16 answers are the JAX package's; a
            # training step keeps the fused addmm (one launch less per
            # layer, 8 % of a bf16 flagship step on an H100).
            y = F.linear(x, w) + b
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


def _draw(rng, shape, device) -> torch.Tensor:
    """Uniform [0, 1) draws for a training mask, from ``rng``: a
    ``torch.Generator``, or a per-row stream with a ``uniform(shape,
    device)`` method (``ops.rng.RowStream``, which also works under
    ``torch.func.vmap``)."""
    if rng is None:
        raise ValueError(
            "a dropout mask in training needs an explicit torch.Generator "
            "or row stream: call the model as model(x, rng=...)"
        )
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device)
    return rng.uniform(shape, device)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask is
    drawn from the generator or row stream handed to ``forward``.  The
    identity in evaluation or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = _draw(rng, x.shape, x.device) < keep
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
                rng: Optional[Rng] = None) -> torch.Tensor:
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
    training; the mask comes from the generator or row stream handed to
    ``forward``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask_shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = _draw(rng, mask_shape, x.device) < keep
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
                rng: Optional[Rng] = None) -> torch.Tensor:
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
        num_experts: int = 8,
        expert_top_k: int = 2,
        capacity_factor: float = 1.25,
        moe_aux_coef: float = 1e-2,
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
        self.moe = ff_type == "moe"
        if ff_type == "depthwise_separable":
            self.ff = DepthwiseSeparableFF(
                d_model, dim_feedforward, attn_kernel_size, dtype
            )
        elif ff_type == "linear":
            self.ff = LinearFF(d_model, dim_feedforward, dtype)
        elif ff_type == "moe":
            from distributed_machine_learning_tpu_torch.models.moe import MoEFF

            # MoEFF follows its input's dtype (router pinned f32 inside).
            self.ff = MoEFF(
                d_model, dim_feedforward, num_experts=num_experts,
                top_k=expert_top_k, capacity_factor=capacity_factor,
                aux_loss_coef=moe_aux_coef,
            )
        else:
            raise ValueError(
                f"Unknown feedforward_type {ff_type!r}; expected "
                f"'linear', 'depthwise_separable', or 'moe'"
            )
        self.ff_dropout = Dropout(dropout_rate)
        self.ff_depth = StochasticDepth(stochastic_depth_rate)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """``aux``: a list the MoE feed-forward's load-balance term is
        appended to (flax sows it into ``"moe"``); None drops it."""
        x = self.norm1(x + self.attn_depth(self.attention(x, rng), rng))
        ff = self.ff(x)
        if self.moe:
            ff, aux_loss = ff
            if aux is not None:
                aux.append(aux_loss)
        ff = self.ff_depth(self.ff_dropout(ff, rng), rng)
        return self.norm2(x + ff)
