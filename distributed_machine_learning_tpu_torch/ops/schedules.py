"""Learning-rate schedules as host functions ``step -> float``.

Port of ``distributed_machine_learning_tpu/ops/schedules.py``.  The JAX
package builds them from optax; here they are the same formulas evaluated
in float32 on the host, with optax's rules kept exactly: ``join_schedules``
switches to the next piece at ``step >= boundary`` and hands it
``step - boundary``; a linear piece clips its count to ``[0, steps]``; the
warmup length is ``max(warmup_steps, 1)`` while the boundary stays
``warmup_steps`` (so ``warmup_steps=0`` gives 1.0 x lr at step 0).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from distributed_machine_learning_tpu_torch.utils.registry import Registry

schedules: Registry = Registry("schedule")

Schedule = Callable[[int], float]
_f32 = np.float32


def _linear(init_value: float, end_value: float, steps: int) -> Schedule:
    """``optax.linear_schedule`` (polynomial of power 1)."""
    if steps <= 0:
        return lambda count: float(_f32(init_value))

    def schedule(count: int) -> float:
        c = _f32(min(max(int(count), 0), steps))
        frac = _f32(1) - c / _f32(steps)
        return float((_f32(init_value) - _f32(end_value)) * frac
                     + _f32(end_value))

    return schedule


def _cosine_decay(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` with alpha 0 and exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = _f32(min(float(count), float(decay_steps)))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c
                                               / _f32(decay_steps)))
        return float(_f32(init_value) * cosine)

    return schedule


def _join(pieces: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``."""

    def schedule(step: int) -> float:
        out = pieces[0](step)
        for boundary, piece in zip(boundaries, pieces[1:]):
            if step >= boundary:
                out = piece(step - boundary)
        return out

    return schedule


@schedules.register("constant")
def constant_schedule(learning_rate: float, **_) -> Schedule:
    value = float(_f32(learning_rate))
    return lambda step: value


@schedules.register("warmup_linear_decay")
def warmup_linear_decay(learning_rate: float, warmup_steps: int = 0,
                        total_steps: int = 10_000, **_) -> Schedule:
    """Linear 0 -> lr over ``warmup_steps``, then lr -> 0 at ``total_steps``."""
    warmup_steps = max(int(warmup_steps), 0)
    decay_steps = max(int(total_steps) - warmup_steps, 1)
    return _join(
        [_linear(0.0, learning_rate, max(warmup_steps, 1)),
         _linear(learning_rate, 0.0, decay_steps)],
        [warmup_steps],
    )


@schedules.register("warmup_cosine")
def warmup_cosine(learning_rate: float, warmup_steps: int = 0,
                  total_steps: int = 10_000, **_) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, 2))``."""
    warmup = max(int(warmup_steps), 1)
    decay_steps = max(int(total_steps), 2)
    return _join(
        [_linear(0.0, learning_rate, warmup),
         _cosine_decay(learning_rate, decay_steps - warmup)],
        [warmup],
    )


def get_schedule(name: str, **kwargs) -> Schedule:
    return schedules.get(name)(**kwargs)
