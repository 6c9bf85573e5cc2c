"""Per-row dropout streams: a counter-based generator in plain tensor ops.

Counterpart of ``distributed_machine_learning_tpu/ops/rng.py``.  There a
trial's dropout masks come from its own ``jax.random`` key, which
``jax.vmap`` carries per row, so a population of K trials draws K
independent mask streams in one program.  A ``torch.Generator`` cannot do
that: ``torch.func.vmap`` refuses one under ``randomness="error"``, and
under ``"different"`` every row draws from the one shared generator, so a
row's masks would depend on how many rows share it.

:func:`uniform` is instead a pure function of (the row's 64-bit seed, the
training step, the dropout site's index, the element's index): an integer
hash of the four, taken in int64 tensor ops with every intermediate kept
below 2**63 (32-bit lanes, multipliers below 2**31), so it is exact and
the same on the CPU and the card.  The seed is a tensor: a ``[K]`` seed
gives ``[K, *shape]`` draws, and under ``vmap`` the row's 0-d seed gives
that row's ``shape``, so a population draws all its masks with a constant
number of launches and a row's bits do not depend on its neighbours.

The bits cannot match JAX's threefry and need not: parity tests run with
dropout off.  ``rng_impl`` (the JAX package's choice between threefry and
the TPU's hardware generator) has one value here, ``"auto"``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Mapping, Optional, Sequence

import torch

_MASK32 = 0xFFFFFFFF
# The multiplier of a well-known 32-bit integer hash; below 2**31, so a
# product with a 32-bit lane stays below 2**63 in int64.
_MUL = 0x45D9F3B
_GOLDEN = 0x9E3779B9


def resolve_rng_impl(config: Optional[Mapping[str, Any]]) -> None:
    """Accept ``rng_impl`` unset or ``"auto"``; refuse the JAX package's
    other impls by name (they name ``jax.random`` key types)."""
    val = (config or {}).get("rng_impl", "auto")
    if val not in (None, "auto"):
        raise NotImplementedError(
            f"rng_impl={val!r} names a jax.random impl; the port has one "
            f"dropout stream (ops/rng.py), rng_impl='auto'"
        )


def stream_seed(seed: int) -> int:
    """A trial's 63-bit dropout-stream seed from its config ``seed``."""
    h = hashlib.sha256(f"{int(seed)}/dropout_stream".encode()).digest()
    return int.from_bytes(h[:8], "little") & 0x7FFFFFFFFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash on int64 lanes in [0, 2**32)."""
    x = ((x >> 16) ^ x) * _MUL & _MASK32
    x = ((x >> 16) ^ x) * _MUL & _MASK32
    return (x >> 16) ^ x


def _row_keys(seed: torch.Tensor, step: int, site: int):
    """Two 32-bit keys per row from (seed, step, site)."""
    lo, hi = seed & _MASK32, (seed >> 32) & _MASK32
    k0 = _mix(lo ^ _mix(hi + (int(step) & _MASK32)))
    k1 = _mix((k0 + _GOLDEN * (int(site) + 1)) & _MASK32)
    return k0, k1


def uniform(seed: torch.Tensor, step: int, site: int,
            shape: Sequence[int]) -> torch.Tensor:
    """f32 draws in [0, 1) of shape ``[*seed.shape, *shape]``, on seed's
    device: element i is hash(seed, step, site, i) with 24 bits kept."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    k0, k1 = _row_keys(seed.to(torch.int64), step, site)
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    h = _mix((_mix(idx ^ k0[..., None]) + k1[..., None]) & _MASK32)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(*k0.shape, *shape)


class RowStream:
    """The dropout stream of one training step: ``uniform(shape)`` draws
    the next site's values.  Sites are numbered in call order, so a model
    that calls its dropout layers in a fixed order gives each layer the
    same site at every step.  ``seed`` is a 0-d (one row, or one row under
    ``vmap``) or ``[K]`` int64 tensor."""

    def __init__(self, seed: torch.Tensor, step: int):
        self.seed = seed
        self.step = int(step)
        self.site = 0

    def uniform(self, shape: Sequence[int], device=None) -> torch.Tensor:
        site, self.site = self.site, self.site + 1
        return uniform(self.seed, self.step, site, shape)
