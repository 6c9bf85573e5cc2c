"""Optimizers as optax chains written on tensors.

Port of ``distributed_machine_learning_tpu/ops/optimizers.py``.  Two
forms, as in the JAX package:

* the registry form, :func:`make_optimizer`: the optimizer's learning
  rate (a number or the whole schedule) and weight decay baked in, for
  all seven names (adam, adamw, sgd, rmsprop, lamb, adafactor, lion),
  wrapped in :class:`MultiSteps` when gradients are accumulated;
* the injected form, :func:`make_injected_optimizer`: adam, adamw, sgd
  and rmsprop with the learning rate and weight decay as *state* (device
  scalars) and the schedule contributing a peak-1.0 shape.

Each transformation is optax 0.2.6's own, with its defaults
(``scale_by_adam``: b1 0.9, b2 0.999, eps 1e-8, lamb's eps 1e-6;
``scale_by_rms``: decay 0.9, eps 1e-8 inside the square root; ``trace``:
``t = g + decay * t``; ``scale_by_lion``: b1 0.9, b2 0.99;
``scale_by_factored_rms``: decay 0.8, factored when the second largest
axis is at least 128) -- ``torch.optim`` is not used, since its defaults
differ (RMSprop's alpha is 0.99).

Chain order, as in the JAX package: optional global-norm clipping, then
weight decay added to the gradient (L2-style) for adam, sgd and rmsprop
or after the scaling (decoupled) for adamw, lamb and lion; lamb scales by
each leaf's trust ratio ``|p| / |u|``; sgd's momentum comes before the
learning rate, rmsprop's after it.  Adafactor is optax's chain: factored
second moments, block-RMS clipping at 1.0, the learning rate, the
parameter's RMS (at least 1e-3), decoupled weight decay, the sign flip.
The schedule is read at the update count, which starts at 0 on the first
update.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name.  The port stores a dense kernel ``[out..., in...]`` where flax stores
``[in..., out...]``; adafactor picks the axes it factors by size, ties
broken by index, so it runs on each leaf in the flax order
(``leaf_axes``, from ``models.convert.flax_leaf_axes``) and keeps its
statistics in that order.  :class:`PopulationOptimizer` is the population
form the vectorized runner steps: K trials' leaves stacked on a leading
axis, one lr and wd per row.  The moments are updated in place (they are
the optimizer's own buffers), which keeps one copy of each in device
memory.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.utils.registry import Registry

Tensors = Dict[str, torch.Tensor]
ScalarOrSchedule = Union[float, Callable[[int], float]]

ALL_OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop", "lamb", "adafactor",
                  "lion")
INJECTABLE_OPTIMIZERS = frozenset({"adam", "adamw", "sgd", "rmsprop"})

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LAMB_EPS = 1e-6
RMS_DECAY, RMS_EPS = 0.9, 1e-8
LION_B1, LION_B2 = 0.9, 0.99
# optax.adafactor's defaults.
FACTOR_MIN_DIM, FACTOR_DECAY, FACTOR_EPS = 128, 0.8, 1e-30
FACTOR_CLIP, FACTOR_MIN_SCALE = 1.0, 1e-3


def check_supported(name: str) -> str:
    """The optimizer's name in lower case; raises for an unknown one."""
    name = str(name).lower()
    if name not in ALL_OPTIMIZERS:
        raise ValueError(
            f"Unknown optimizer {name!r}; expected one of "
            f"{sorted(ALL_OPTIMIZERS)}"
        )
    return name


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every element squared."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors.values()))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _scale_by_adam(u: Tensors, state: Dict[str, Any], count: int,
                   eps: float = ADAM_EPS) -> Tensors:
    """``optax.scale_by_adam`` (b1 0.9, b2 0.999) with the moments
    ``state["mu"]``/``state["nu"]`` updated in place."""
    bc1 = _bias_correction(ADAM_B1, count + 1)
    bc2 = _bias_correction(ADAM_B2, count + 1)
    out = {}
    for k, t in u.items():
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(ADAM_B1).add_((1 - ADAM_B1) * t)
        nu.mul_(ADAM_B2).add_((1 - ADAM_B2) * (t * t))
        out[k] = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return out


def _scale_by_rms(u: Tensors, state: Dict[str, Any]) -> Tensors:
    """``optax.scale_by_rms`` (decay 0.9, eps 1e-8 inside the root)."""
    out = {}
    for k, t in u.items():
        nu = state["nu"][k]
        nu.mul_(RMS_DECAY).add_((1 - RMS_DECAY) * (t * t))
        out[k] = torch.rsqrt(nu + RMS_EPS) * t
    return out


def _trace(u: Tensors, state: Dict[str, Any], momentum: float) -> Tensors:
    """``optax.trace``: the new trace is the update."""
    for k, t in u.items():
        state["trace"][k].mul_(momentum).add_(t)
    return dict(state["trace"])


class InjectedOptimizer:
    """``make_injected_optimizer``'s chain: ``init(params) -> state`` and
    ``update(grads, state, params) -> updates`` (the state is updated in
    place).  State keys: ``count`` (updates so far), ``hyperparams``
    (``learning_rate``, ``weight_decay``: 0-d f32 tensors), and ``mu``/
    ``nu`` (adam, adamw), ``nu`` (rmsprop) or ``trace`` (momentum)."""

    def __init__(self, name: str, shape_schedule: Callable[[int], float],
                 momentum: float = 0.0, gradient_clipping: float = 0.0):
        name = str(name).lower()
        if name not in INJECTABLE_OPTIMIZERS:
            raise ValueError(
                f"injected mode supports {sorted(INJECTABLE_OPTIMIZERS)}, "
                f"got {name!r}"
            )
        self.name = name
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

    def _row(self, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``h`` (a hyperparameter, or one value per row) as it multiplies
        leaf ``t``; one trial's are 0-d and broadcast as they are."""
        return h

    def _norm(self, u: Tensors) -> torch.Tensor:
        return global_norm(u)

    def _update(self, grads, state, params) -> Tensors:
        lr = state["hyperparams"]["learning_rate"]
        wd = state["hyperparams"]["weight_decay"]
        count = int(state["count"])
        row = self._row
        u = dict(grads)
        if self.gradient_clipping > 0:
            g_norm = self._norm(u)
            keep = g_norm < self.gradient_clipping
            u = {k: torch.where(row(keep, t), t,
                                (t / row(g_norm, t)) * self.gradient_clipping)
                 for k, t in u.items()}
        if self.name != "adamw":
            u = {k: t + row(wd, t) * params[k] for k, t in u.items()}
        if self.name in ("adam", "adamw"):
            u = _scale_by_adam(u, state, count)
            if self.name == "adamw":
                u = {k: t + row(wd, t) * params[k] for k, t in u.items()}
        elif self.name == "rmsprop":
            u = _scale_by_rms(u, state)
        if self.momentum and self.name == "sgd":
            u = _trace(u, state, self.momentum)
        step = self.shape_schedule(count)
        scale = -1.0 * lr
        u = {k: (step * t) * row(scale, t) for k, t in u.items()}
        if self.momentum and self.name == "rmsprop":
            u = _trace(u, state, self.momentum)
        state["count"] = count + 1
        return u


class PopulationOptimizer(InjectedOptimizer):
    """The same chain over a population of K trials stepping in lockstep:
    every leaf (parameter, gradient, moment) is stacked ``[K, ...]``, the
    hyperparameter slots are ``[K]`` (one learning rate and weight decay
    per row, broadcast over that row's leaves), the clipping norm is taken
    per row, and ``count`` is shared; set the rows' lr/wd with
    :func:`set_injected_hyperparams` after ``init``.  Row k updates as
    :class:`InjectedOptimizer` fed row k's values does."""

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        state = super().init(params)
        rows = next(iter(params.values())).shape[0]
        for name, h in state["hyperparams"].items():
            state["hyperparams"][name] = h.new_zeros(rows)
        return state

    def _row(self, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return h.reshape(-1, *([1] * (t.dim() - 1)))

    def _norm(self, u: Tensors) -> torch.Tensor:
        return torch.sqrt(sum(torch.sum((t * t).reshape(t.shape[0], -1), dim=1)
                              for t in u.values()))


def _factored_dims(shape: Sequence[int]):
    """optax's ``_factored_dims``: ``(d1, d0)``, the second largest and
    the largest axis (``np.argsort``, ties by index), or None when the
    leaf has fewer than two axes or its second largest is under 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


class Optimizer:
    """The registry form: ``init(params) -> state`` and
    ``update(grads, state, params) -> updates`` (the state is updated in
    place), with ``learning_rate`` (a number, or a schedule ``count ->
    float`` read at the update count) and ``weight_decay`` baked in.

    State keys: ``count`` (updates so far), and ``mu``/``nu`` (adam,
    adamw, lamb), ``mu`` (lion), ``nu`` and ``trace`` (rmsprop),
    ``trace`` (sgd with momentum),
    or adafactor's ``v_row``/``v_col`` (factored leaves) and ``v`` (the
    others), each in the leaf's flax order.  ``leaf_axes`` maps a
    parameter name to the permutation of its axes that gives the flax
    layout (adafactor only; a name it lacks keeps its own order)."""

    def __init__(self, name: str, learning_rate: ScalarOrSchedule,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 gradient_clipping: Optional[float] = None,
                 leaf_axes: Optional[Mapping[str, Sequence[int]]] = None):
        self.name = check_supported(name)
        self.schedule = (learning_rate if callable(learning_rate)
                         else lambda count, v=float(learning_rate): v)
        self.weight_decay = float(weight_decay or 0.0)
        self.momentum = float(momentum or 0.0)
        self.gradient_clipping = float(gradient_clipping or 0.0)
        self.leaf_axes = dict(leaf_axes or {})

    def _flax(self, k: str, t: torch.Tensor) -> torch.Tensor:
        axes = self.leaf_axes.get(k)
        return t if axes is None else t.permute(*axes)

    def _unflax(self, k: str, t: torch.Tensor) -> torch.Tensor:
        axes = self.leaf_axes.get(k)
        return t if axes is None else t.permute(*np.argsort(axes).tolist())

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        state: Dict[str, Any] = {"count": 0}
        if self.name in ("adam", "adamw", "lamb"):
            state["mu"], state["nu"] = zeros(), zeros()
        elif self.name == "lion":
            state["mu"] = zeros()
        elif self.name == "rmsprop":
            state["nu"] = zeros()
        elif self.name == "adafactor":
            state["v_row"], state["v_col"], state["v"] = {}, {}, {}
            for k, p in params.items():
                shape = tuple(self._flax(k, p).shape)
                dims = _factored_dims(shape)
                if dims is None:
                    state["v"][k] = p.new_zeros(shape)
                    continue
                d1, d0 = dims
                state["v_row"][k] = p.new_zeros(np.delete(shape, d0).tolist())
                state["v_col"][k] = p.new_zeros(np.delete(shape, d1).tolist())
        # The JAX registry hands optax.rmsprop momentum=0.0, not None, so
        # its chain keeps a trace (of decay 0) as well.
        if (self.momentum and self.name == "sgd") or self.name == "rmsprop":
            state["trace"] = zeros()
        return state

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor]) -> Tensors:
        with torch.no_grad():
            return self._update(grads, state, params)

    def _decay(self, u: Tensors, params) -> Tensors:
        wd = self.weight_decay
        return {k: t + wd * params[k] for k, t in u.items()} if wd else u

    def _update(self, grads, state, params) -> Tensors:
        count = int(state["count"])
        u = dict(grads)
        if self.gradient_clipping > 0:
            g_norm = global_norm(u)
            keep = g_norm < self.gradient_clipping
            u = {k: torch.where(keep, t, (t / g_norm) * self.gradient_clipping)
                 for k, t in u.items()}
        name = self.name
        if name == "adafactor":
            u = self._adafactor(u, state, params, count)
            state["count"] = count + 1
            return u
        if name in ("adam", "sgd", "rmsprop"):
            u = self._decay(u, params)  # L2-style: into the gradient
        if name in ("adam", "adamw", "lamb"):
            u = _scale_by_adam(u, state, count,
                               LAMB_EPS if name == "lamb" else ADAM_EPS)
        elif name == "rmsprop":
            u = _scale_by_rms(u, state)
        elif name == "lion":
            u = self._scale_by_lion(u, state)
        if name in ("adamw", "lamb", "lion"):
            u = self._decay(u, params)  # decoupled
        if name == "lamb":
            u = {k: t * self._trust_ratio(t, params[k]) for k, t in u.items()}
        if self.momentum and name == "sgd":
            u = _trace(u, state, self.momentum)
        # optax.scale_by_learning_rate: the f32 value of -lr(count).
        step = -float(np.float32(self.schedule(count)))
        u = {k: t * step for k, t in u.items()}
        if name == "rmsprop":
            u = _trace(u, state, self.momentum)
        state["count"] = count + 1
        return u

    @staticmethod
    def _trust_ratio(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """``optax.scale_by_trust_ratio``: ``|p| / |u|``, 1 where either
        norm is 0."""
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(u)
        zero = (p_norm == 0.0) | (u_norm == 0.0)
        return torch.where(zero, torch.ones_like(p_norm), p_norm / u_norm)

    @staticmethod
    def _scale_by_lion(u: Tensors, state: Dict[str, Any]) -> Tensors:
        """``optax.scale_by_lion``: the sign of the interpolated momentum,
        then the moment's own update (in place)."""
        out = {}
        for k, g in u.items():
            mu = state["mu"][k]
            out[k] = torch.sign((1.0 - LION_B1) * g + LION_B1 * mu)
            mu.mul_(LION_B2).add_((1.0 - LION_B2) * g)
        return out

    def _adafactor(self, u: Tensors, state: Dict[str, Any], params,
                   count: int) -> Tensors:
        """optax.adafactor's chain after clipping; ends with the sign
        flip, so the caller scales by nothing more."""
        decay = np.float32(1) - np.float32(count + 1) ** np.float32(
            -FACTOR_DECAY)
        keep, fresh = float(decay), float(np.float32(1) - decay)
        lr = float(np.float32(self.schedule(count)))
        out = {}
        for k, g in u.items():
            gf = self._flax(k, g)
            g_sq = gf * gf + FACTOR_EPS
            dims = _factored_dims(tuple(gf.shape))
            if dims is None:
                v = state["v"][k]
                v.mul_(keep).add_(fresh * g_sq)
                uf = gf * v ** -0.5
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][k], state["v_col"][k]
                v_row.mul_(keep).add_(fresh * g_sq.mean(dim=d0))
                v_col.mul_(keep).add_(fresh * g_sq.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean) ** -0.5
                col_factor = v_col ** -0.5
                uf = gf * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            t = self._unflax(k, uf)
            # clip_by_block_rms, the learning rate, scale_by_param_block_rms.
            t = t / torch.clamp(_rms(t) / FACTOR_CLIP, min=1.0)
            t = t * lr
            p_rms = _rms(params[k])
            t = t * torch.where(p_rms <= FACTOR_MIN_SCALE,
                                torch.full_like(p_rms, FACTOR_MIN_SCALE),
                                p_rms)
            out[k] = t
        return {k: -t for k, t in self._decay(out, params).items()}


class MultiSteps:
    """``optax.MultiSteps`` with ``use_grad_mean``: every micro-step's
    gradient goes into a running mean; on every ``every_k``-th micro-step
    the inner optimizer updates on that mean (so its clipping acts on the
    accumulated gradient and its count, and the schedule, advance once per
    real update) and the mean restarts at 0.  On the other micro-steps
    ``update`` returns no update (``{}``: optax returns zeros).  State
    keys: ``mini_step``, ``gradient_step``, ``inner_opt_state``,
    ``acc_grads``; ``mini_step`` carries across epochs."""

    def __init__(self, inner: Optimizer, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"mini_step": 0, "gradient_step": 0,
                "inner_opt_state": self.inner.init(params),
                "acc_grads": {k: torch.zeros_like(p)
                              for k, p in params.items()}}

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor]) -> Tensors:
        with torch.no_grad():
            n = int(state["mini_step"])
            acc = state["acc_grads"]
            for k, g in grads.items():
                acc[k].add_((g - acc[k]) / (n + 1))
            if n < self.every_k - 1:
                state["mini_step"] = n + 1
                return {}
            updates = self.inner.update(acc, state["inner_opt_state"], params)
            for t in acc.values():
                t.zero_()
            state["mini_step"] = 0
            state["gradient_step"] = int(state["gradient_step"]) + 1
            return updates


optimizers: Registry = Registry("optimizer")
for _name in ALL_OPTIMIZERS:
    optimizers.register(_name, functools.partial(Optimizer, _name))


def make_optimizer(
    name: str,
    learning_rate: ScalarOrSchedule,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    gradient_clipping: Optional[float] = None,
    accumulate_grad_batches: int = 1,
    *,
    leaf_axes: Optional[Mapping[str, Sequence[int]]] = None,
):
    """The optimizer of ``name`` from config values, the JAX package's
    ``make_optimizer``: ``gradient_clipping`` > 0 clips by global norm
    first; ``accumulate_grad_batches`` > 1 wraps the whole chain in
    :class:`MultiSteps`, so clipping acts on the accumulated gradient.
    ``leaf_axes``: see :class:`Optimizer`."""
    tx = optimizers.get(name)(learning_rate, weight_decay=weight_decay,
                              momentum=momentum,
                              gradient_clipping=gradient_clipping,
                              leaf_axes=leaf_axes)
    if accumulate_grad_batches and int(accumulate_grad_batches) > 1:
        return MultiSteps(tx, int(accumulate_grad_batches))
    return tx


def make_injected_optimizer(name: str, shape_schedule,
                            momentum: float = 0.0,
                            gradient_clipping: float = 0.0) -> InjectedOptimizer:
    """The optimizer whose lr/wd are state; set them with
    :func:`set_injected_hyperparams` after ``init``."""
    return InjectedOptimizer(name, shape_schedule, momentum, gradient_clipping)


def set_injected_hyperparams(opt_state: Dict[str, Any], lr, wd
                             ) -> Dict[str, Any]:
    """Write lr/wd into the state's hyperparameter slots (in place): two
    numbers, or for a population one per row."""
    hp = opt_state["hyperparams"]
    for name, value in (("learning_rate", lr), ("weight_decay", wd)):
        hp[name].copy_(torch.as_tensor(value, dtype=torch.float32))
    return opt_state


def take_rows(opt_state: Dict[str, Any], index: torch.Tensor
              ) -> Dict[str, Any]:
    """A population state cut to the rows ``index`` (every stacked
    tensor indexed on its leading axis; ``count`` kept)."""

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[index]
        if isinstance(x, Mapping):
            return {k: take(v) for k, v in x.items()}
        return x

    return take(opt_state)


def apply_updates(params: Mapping[str, torch.Tensor],
                  updates: Mapping[str, torch.Tensor]) -> None:
    """``optax.apply_updates`` in place: ``p += u`` for every leaf that
    ``updates`` holds (none on a :class:`MultiSteps` micro-step)."""
    with torch.no_grad():
        for k, u in updates.items():
            params[k].add_(u.to(params[k].dtype))


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

