"""Optimizers as optax chains written on tensors.

Port of ``distributed_machine_learning_tpu/ops/optimizers.py``: adam,
adamw, sgd and rmsprop in the ``make_injected_optimizer`` form the JAX
trainable uses, where the learning rate and weight decay are *state*
(device scalars) and the schedule contributes a peak-1.0 shape.  Each
transformation is optax's own, with optax's defaults (``scale_by_adam``:
b1 0.9, b2 0.999, eps 1e-8; ``scale_by_rms``: decay 0.9, eps 1e-8 inside
the square root; ``trace``: ``t = g + decay * t``) -- ``torch.optim`` is not
used, since its defaults differ (RMSprop's alpha is 0.99).

Chain order, as in the JAX package: optional global-norm clipping, then
weight decay added to the gradient (L2-style) for adam, sgd and rmsprop
or after the Adam scaling (decoupled) for adamw; sgd's momentum comes
before the schedule and lr, rmsprop's after them.  The schedule is read
at the update count, which starts at 0 on the first update.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name.  The moments are updated in place (they are the optimizer's own
buffers), which keeps one copy of each in device memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]

INJECTABLE_OPTIMIZERS = frozenset({"adam", "adamw", "sgd", "rmsprop"})
# Registered by the JAX package and not ported yet (ROADMAP.md queue A).
UNPORTED_OPTIMIZERS = frozenset({"lamb", "adafactor", "lion"})

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-8


def check_supported(name: str, accumulate_grad_batches: int = 1) -> str:
    """The optimizer's name in lower case; raises for what is not ported."""
    name = str(name).lower()
    if name in UNPORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; see ROADMAP.md queue A"
        )
    if name not in INJECTABLE_OPTIMIZERS:
        raise ValueError(
            f"Unknown optimizer {name!r}; expected one of "
            f"{sorted(INJECTABLE_OPTIMIZERS | UNPORTED_OPTIMIZERS)}"
        )
    if int(accumulate_grad_batches) > 1:
        raise NotImplementedError(
            "accumulate_grad_batches > 1 (optax.MultiSteps) is not ported "
            "yet; see ROADMAP.md queue A"
        )
    return name


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every element squared."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors.values()))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class InjectedOptimizer:
    """``make_injected_optimizer``'s chain: ``init(params) -> state`` and
    ``update(grads, state, params) -> updates`` (the state is updated in
    place).  State keys: ``count`` (updates so far), ``hyperparams``
    (``learning_rate``, ``weight_decay``: 0-d f32 tensors), and ``mu``/
    ``nu`` (adam, adamw), ``nu`` (rmsprop) or ``trace`` (momentum)."""

    def __init__(self, name: str, shape_schedule: Callable[[int], float],
                 momentum: float = 0.0, gradient_clipping: float = 0.0):
        self.name = check_supported(name)
        self.shape_schedule = shape_schedule
        self.momentum = float(momentum or 0.0)
        self.gradient_clipping = float(gradient_clipping or 0.0)

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        device = next(iter(params.values())).device
        state: Dict[str, Any] = {
            "count": 0,
            "hyperparams": {
                "learning_rate": torch.zeros((), device=device),
                "weight_decay": torch.zeros((), device=device),
            },
        }
        if self.name in ("adam", "adamw"):
            state["mu"], state["nu"] = zeros(), zeros()
        elif self.name == "rmsprop":
            state["nu"] = zeros()
        if self.momentum and self.name in ("sgd", "rmsprop"):
            state["trace"] = zeros()
        return state

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor]) -> Tensors:
        with torch.no_grad():
            return self._update(grads, state, params)

    def _update(self, grads, state, params) -> Tensors:
        lr = state["hyperparams"]["learning_rate"]
        wd = state["hyperparams"]["weight_decay"]
        count = int(state["count"])
        u = dict(grads)
        if self.gradient_clipping > 0:
            g_norm = global_norm(u)
            keep = g_norm < self.gradient_clipping
            u = {k: torch.where(keep, t, (t / g_norm) * self.gradient_clipping)
                 for k, t in u.items()}
        if self.name != "adamw":
            u = {k: t + wd * params[k] for k, t in u.items()}
        if self.name in ("adam", "adamw"):
            bc1 = _bias_correction(ADAM_B1, count + 1)
            bc2 = _bias_correction(ADAM_B2, count + 1)
            for k, t in u.items():
                mu, nu = state["mu"][k], state["nu"][k]
                mu.mul_(ADAM_B1).add_((1 - ADAM_B1) * t)
                nu.mul_(ADAM_B2).add_((1 - ADAM_B2) * (t * t))
                u[k] = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            if self.name == "adamw":
                u = {k: t + wd * params[k] for k, t in u.items()}
        elif self.name == "rmsprop":
            for k, t in u.items():
                nu = state["nu"][k]
                nu.mul_(RMS_DECAY).add_((1 - RMS_DECAY) * (t * t))
                u[k] = torch.rsqrt(nu + RMS_EPS) * t
        if self.momentum and self.name == "sgd":
            u = self._trace(u, state)
        step = self.shape_schedule(count)
        scale = -1.0 * lr
        u = {k: (step * t) * scale for k, t in u.items()}
        if self.momentum and self.name == "rmsprop":
            u = self._trace(u, state)
        state["count"] = count + 1
        return u

    def _trace(self, u: Tensors, state: Dict[str, Any]) -> Tensors:
        """``optax.trace``: the new trace is the update."""
        for k, t in u.items():
            state["trace"][k].mul_(self.momentum).add_(t)
        return dict(state["trace"])


def make_injected_optimizer(name: str, shape_schedule,
                            momentum: float = 0.0,
                            gradient_clipping: float = 0.0) -> InjectedOptimizer:
    """The optimizer whose lr/wd are state; set them with
    :func:`set_injected_hyperparams` after ``init``."""
    return InjectedOptimizer(name, shape_schedule, momentum, gradient_clipping)


def set_injected_hyperparams(opt_state: Dict[str, Any], lr: float,
                             wd: float) -> Dict[str, Any]:
    """Write lr/wd into the state's hyperparameter slots (in place)."""
    hp = opt_state["hyperparams"]
    hp["learning_rate"].fill_(float(lr))
    hp["weight_decay"].fill_(float(wd))
    return opt_state


def apply_updates(params: Mapping[str, torch.Tensor],
                  updates: Mapping[str, torch.Tensor]) -> None:
    """``optax.apply_updates`` in place: ``p += u``."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k].to(p.dtype))


def state_to(opt_state: Dict[str, Any], device) -> Dict[str, Any]:
    """A copy of the state with every tensor on ``device`` (a checkpoint
    on the host, or a restore onto the card)."""

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        if isinstance(x, Mapping):
            return {k: move(v) for k, v in x.items()}
        return x

    return move(opt_state)

