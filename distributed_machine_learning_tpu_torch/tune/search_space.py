"""Search-space DSL: distribution domains + conditional resolution.

Port of ``distributed_machine_learning_tpu/tune/search_space.py`` (the
whole file): the same domains draw the same samples from the same seed
parts, through the port's copy of ``rng_from``.

Capability parity with the reference's Ray Tune search spaces
(`/root/reference/ray-tune-hpo-regression.py:379-400`,
`/root/reference/ray-tune-hpo-regression-sample.py:140-147`):
``choice`` / ``uniform`` / ``loguniform`` / ``quniform`` / ``randint`` /
``sample_from``.

Two deliberate fixes over the reference (SURVEY.md §2 C19):

* ``sample_from`` lambdas receive a *resolved* config view, so
  ``sample_from(lambda cfg: cfg["d_model"] * choice([2,3,4]).sample(rng))`` —
  or simply returning another Domain, which we resolve recursively — yields a
  concrete value rather than a sampler object (the reference's
  ``tune.choice(...)``-inside-``sample_from`` bug at `:383`).
* ``Constraint`` predicates allow rejecting invalid joint samples (e.g.
  ``d_model % num_heads == 0``), which the reference never checks.

Resolution order is dependency-driven: plain domains are sampled first, then
``sample_from`` entries are resolved iteratively until a fixpoint, so they may
reference each other in any declaration order (cycles raise).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from distributed_machine_learning_tpu_torch.utils.seeding import rng_from


class Domain:
    """Base class for a single hyperparameter's sampling domain."""

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    # Lazy arithmetic, so the reference's `cfg["d_model"] * choice([2,3,4])`
    # idiom inside sample_from yields a resolvable expression rather than a
    # sampler object (the C19 bug made concrete and fixed).
    def __mul__(self, other):
        return _BinOp(self, other, "*")

    __rmul__ = __mul__

    def __add__(self, other):
        return _BinOp(self, other, "+")

    __radd__ = __add__

    def __sub__(self, other):
        return _BinOp(self, other, "-")

    def __rsub__(self, other):
        return _BinOp(other, self, "-")

    def __truediv__(self, other):
        return _BinOp(self, other, "/")

    def __rtruediv__(self, other):
        return _BinOp(other, self, "/")

    # --- introspection used by model-based search (BayesOpt / BOHB) ---
    @property
    def is_continuous(self) -> bool:
        return False

    def to_unit(self, value) -> float:
        """Map a value into [0, 1] (continuous domains only)."""
        raise NotImplementedError

    def from_unit(self, u: float):
        """Map a [0, 1] coordinate back to the domain (continuous only)."""
        raise NotImplementedError


@dataclass(frozen=True)
class _BinOp(Domain):
    """Arithmetic combination of domains/literals, sampled lazily."""

    left: Any
    right: Any
    op: str

    def sample(self, rng):
        lv = self.left.sample(rng) if isinstance(self.left, Domain) else self.left
        rv = self.right.sample(rng) if isinstance(self.right, Domain) else self.right
        if self.op == "*":
            return lv * rv
        if self.op == "+":
            return lv + rv
        if self.op == "-":
            return lv - rv
        if self.op == "/":
            return lv / rv
        raise ValueError(f"unknown op {self.op}")


@dataclass(frozen=True)
class Choice(Domain):
    categories: Sequence[Any]

    def __post_init__(self):
        if len(self.categories) == 0:
            raise ValueError("choice() needs at least one category")

    def sample(self, rng):
        # rng.choice coerces mixed-type lists to numpy scalars; index instead.
        return self.categories[int(rng.integers(len(self.categories)))]


@dataclass(frozen=True)
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    @property
    def is_continuous(self):
        return True

    def to_unit(self, value):
        return (float(value) - self.low) / (self.high - self.low)

    def from_unit(self, u):
        return self.low + float(np.clip(u, 0.0, 1.0)) * (self.high - self.low)


@dataclass(frozen=True)
class LogUniform(Domain):
    low: float
    high: float

    def __post_init__(self):
        if self.low <= 0:
            raise ValueError("loguniform() requires low > 0")

    def sample(self, rng):
        return float(np.exp(rng.uniform(math.log(self.low), math.log(self.high))))

    @property
    def is_continuous(self):
        return True

    def to_unit(self, value):
        lo, hi = math.log(self.low), math.log(self.high)
        return (math.log(float(value)) - lo) / (hi - lo)

    def from_unit(self, u):
        lo, hi = math.log(self.low), math.log(self.high)
        return float(math.exp(lo + float(np.clip(u, 0.0, 1.0)) * (hi - lo)))


def _q_bounds(low: float, high: float, q: float):
    """The smallest/largest multiples of q inside [low, high]; raises when
    no multiple fits (a quantized domain must be able to honor its
    contract — clipping to a raw bound would silently emit non-multiples,
    e.g. qrandint(8, 60, 8) yielding 60).

    Float noise is absorbed RELATIVELY (rounding the low/q ratio), so a
    tiny positive low under a much larger q still maps to the first
    positive multiple instead of collapsing to 0 (qloguniform must never
    emit 0 from a low > 0 domain)."""
    lo = math.ceil(round(low / q, 9)) * q
    hi = math.floor(round(high / q, 9)) * q
    if lo > hi:
        raise ValueError(
            f"no multiple of q={q} inside [{low}, {high}]"
        )
    return lo, hi


@dataclass(frozen=True)
class QUniform(Domain):
    low: float
    high: float
    q: float

    def __post_init__(self):
        lo, hi = _q_bounds(self.low, self.high, self.q)
        object.__setattr__(self, "_lo", lo)
        object.__setattr__(self, "_hi", hi)

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return float(np.clip(np.round(v / self.q) * self.q,
                             self._lo, self._hi))


@dataclass(frozen=True)
class QLogUniform(Domain):
    low: float
    high: float
    q: float

    def __post_init__(self):
        if self.low <= 0:
            raise ValueError("qloguniform() requires low > 0")
        lo, hi = _q_bounds(self.low, self.high, self.q)
        object.__setattr__(self, "_lo", max(lo, self.q))  # never 0 from log
        object.__setattr__(self, "_hi", hi)

    def sample(self, rng):
        v = np.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        return float(np.clip(np.round(v / self.q) * self.q,
                             self._lo, self._hi))


@dataclass(frozen=True)
class Randn(Domain):
    mean: float = 0.0
    sd: float = 1.0

    def sample(self, rng):
        return float(rng.normal(self.mean, self.sd))


@dataclass(frozen=True)
class RandInt(Domain):
    low: int
    high: int  # exclusive, numpy convention

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


@dataclass(frozen=True)
class QRandInt(Domain):
    low: int
    high: int  # INCLUSIVE (Ray's convention for qrandint)
    q: int

    def __post_init__(self):
        lo, hi = _q_bounds(self.low, self.high, self.q)
        object.__setattr__(self, "_lo", int(lo))
        object.__setattr__(self, "_hi", int(hi))

    def sample(self, rng):
        v = rng.integers(self.low, self.high + 1)
        return int(np.clip(int(round(v / self.q)) * self.q,
                           self._lo, self._hi))


@dataclass(frozen=True)
class LogRandInt(Domain):
    low: int
    high: int  # exclusive, matching randint

    def __post_init__(self):
        if self.low <= 0:
            raise ValueError("lograndint() requires low > 0")
        if self.high <= self.low:  # same contract as randint/rng.integers
            raise ValueError("lograndint() requires high > low")

    def sample(self, rng):
        v = np.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        return int(np.clip(int(v), self.low, self.high - 1))


@dataclass(frozen=True)
class SampleFrom(Domain):
    fn: Callable[[Dict[str, Any]], Any]

    def sample(self, rng):  # pragma: no cover - resolved via resolve(), not sample()
        raise TypeError("sample_from domains are resolved with the config context")


@dataclass(frozen=True)
class Constant(Domain):
    value: Any

    def sample(self, rng):
        return self.value


# Public constructors, mirroring the ray.tune names the reference uses.
def choice(categories: Sequence[Any]) -> Choice:
    return Choice(tuple(categories))


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def qloguniform(low: float, high: float, q: float) -> QLogUniform:
    return QLogUniform(low, high, q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Randn:
    return Randn(mean, sd)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def qrandint(low: int, high: int, q: int = 1) -> QRandInt:
    """Quantized integer; ``high`` INCLUSIVE (Ray's qrandint convention,
    unlike randint's exclusive numpy convention)."""
    return QRandInt(low, high, q)


def lograndint(low: int, high: int) -> LogRandInt:
    return LogRandInt(low, high)


def sample_from(fn: Callable[[Dict[str, Any]], Any]) -> SampleFrom:
    return SampleFrom(fn)


def constant(value: Any) -> Constant:
    return Constant(value)


@dataclass
class Constraint:
    """A joint-validity predicate over a resolved config."""

    fn: Callable[[Dict[str, Any]], bool]
    description: str = ""

    def __call__(self, config: Dict[str, Any]) -> bool:
        return bool(self.fn(config))


class _ResolutionView(dict):
    """Config view handed to sample_from lambdas; raises on unresolved keys."""

    def __missing__(self, key):
        raise _Unresolved(key)


class _Unresolved(Exception):
    def __init__(self, key):
        self.key = key


class SearchSpace:
    """A dict of Domains / literals plus joint constraints, with seeded sampling."""

    MAX_REJECTION_SAMPLES = 1000

    def __init__(
        self,
        space: Dict[str, Any],
        constraints: Optional[List[Constraint]] = None,
    ):
        self.space = dict(space)
        self.constraints = list(constraints or [])

    # -- structure queries used by search algorithms -------------------------
    def continuous_keys(self) -> List[str]:
        return [
            k for k, v in self.space.items()
            if isinstance(v, Domain) and v.is_continuous
        ]

    def domain(self, key: str) -> Domain:
        v = self.space[key]
        if not isinstance(v, Domain):
            raise TypeError(f"{key!r} is a literal, not a Domain")
        return v

    # -- sampling ------------------------------------------------------------
    def sample(self, seed_parts: Sequence[Any]) -> Dict[str, Any]:
        """Draw one valid config. ``seed_parts`` makes sampling reproducible."""
        for attempt in range(self.MAX_REJECTION_SAMPLES):
            rng = rng_from(*seed_parts, attempt)
            cfg = self._sample_once(rng)
            if all(c(cfg) for c in self.constraints):
                return cfg
        failed = [c.description or repr(c.fn) for c in self.constraints]
        raise RuntimeError(
            f"Could not draw a config satisfying constraints {failed} in "
            f"{self.MAX_REJECTION_SAMPLES} attempts"
        )

    def _sample_once(self, rng: np.random.Generator) -> Dict[str, Any]:
        resolved: Dict[str, Any] = {}
        deferred: Dict[str, SampleFrom] = {}
        for key, dom in self.space.items():
            if isinstance(dom, SampleFrom):
                deferred[key] = dom
            elif isinstance(dom, Domain):
                resolved[key] = dom.sample(rng)
            else:
                resolved[key] = dom  # literal passthrough

        # Iteratively resolve sample_from entries to a fixpoint so they may
        # depend on each other in any order.
        pending = dict(deferred)
        while pending:
            progressed = False
            for key in list(pending):
                view = _ResolutionView(resolved)
                try:
                    value = pending[key].fn(view)
                    # A sample_from may itself return a Domain (the reference's
                    # `tune.choice` inside `sample_from` intent) — resolve it,
                    # deferring again if a nested lambda needs an unresolved key.
                    while isinstance(value, Domain):
                        if isinstance(value, SampleFrom):
                            value = value.fn(_ResolutionView(resolved))
                        else:
                            value = value.sample(rng)
                except _Unresolved:
                    continue
                resolved[key] = value
                del pending[key]
                progressed = True
            if not progressed:
                raise RuntimeError(
                    f"Cyclic or unresolvable sample_from dependencies: {sorted(pending)}"
                )
        return resolved

    def with_overrides(self, **overrides) -> "SearchSpace":
        new = dict(self.space)
        new.update(overrides)
        return SearchSpace(new, self.constraints)
