"""Population-Based Training (stop-and-respawn variant) and the decision
step the vectorized runner shares with it.

Port of ``distributed_machine_learning_tpu/tune/schedulers/pbt.py`` (the
whole file).  Respawn: at every ``perturbation_interval`` reports a
bottom-quantile trial is stopped, its config mutated (explore), its
weights replaced by a top-quantile peer's latest checkpoint (exploit),
and the trial is requeued; the executor restarts it and the trainable
resumes from the restored epoch.

The vectorized runner (``tune/vectorized.py``) runs the population in one
batched program instead: exploit is a row gather of the stacked state and
explore rewrites each row's lr/wd.  Its decisions come from
:func:`reference_generation_step` (host) or its device form
(``tune/_regression_program.py::make_exploit_explore``), which agree bit
for bit on the same draws.  The draws (:func:`generation_draws`) are
JAX's threefry2x32 written in numpy: the same bits as the JAX package's
``jax.random`` chain on the same seed, so the port makes the same
decisions as the JAX package on the same scores.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from distributed_machine_learning_tpu_torch.tune.schedulers.base import (
    CONTINUE,
    REQUEUE,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.search_space import (
    Domain,
    LogRandInt,
    LogUniform,
    RandInt,
    Uniform,
)
from distributed_machine_learning_tpu_torch.tune.trial import Trial
from distributed_machine_learning_tpu_torch.utils.seeding import rng_from

# Resample values of the device exploit/explore step land on a fixed
# host-precomputed grid (geometric for loguniform domains, linear for
# uniform) instead of an exp/log inverse transform: transcendental ops are
# not bit-stable between devices and kernels, and the parity contract
# (device step == host reference, bit for bit) needs every operation to
# be exactly reproducible.  1024 points across an HPO domain is far below
# the noise floor of any search.
RESAMPLE_GRID_POINTS = 1024

# Multiplicative scalarization weights: score = quality
# * step_latency_s ** lat_w * param_millions ** param_w (mode="min" only —
# every term is a cost).  Latency and params are constant across the rows
# of one population (same architecture), so WITHIN a population the
# ranking is pure quality; across populations / groups the scalarized
# score (emitted per record as ``pbt_objective``) is what makes a
# serve-bound sweep pick the best *deployable* model.
_OBJECTIVE_WEIGHTS = {
    "quality": (0.0, 0.0),
    "quality_latency": (1.0, 0.0),
    "quality_latency_params": (1.0, 1.0),
    # Post-quantization selection: the vectorized runner re-scores every
    # surviving row int8-quantized at sweep end (quant/, not ported:
    # run_vectorized refuses it, ROADMAP.md A8).
    "quality_after_quant": (0.0, 0.0),
}


def _parse_objective(objective) -> Tuple[str, Tuple[float, float]]:
    if objective is None:
        objective = "quality"
    if isinstance(objective, str):
        if objective not in _OBJECTIVE_WEIGHTS:
            raise ValueError(
                f"objective must be one of {sorted(_OBJECTIVE_WEIGHTS)} or a "
                f"weight dict {{'latency': w, 'params': w}}, got {objective!r}"
            )
        return objective, _OBJECTIVE_WEIGHTS[objective]
    if isinstance(objective, dict):
        unknown = set(objective) - {"latency", "params"}
        if unknown:
            raise ValueError(
                f"objective weight dict supports 'latency'/'params', got "
                f"{sorted(unknown)}"
            )
        lat = float(objective.get("latency", 0.0))
        par = float(objective.get("params", 0.0))
        return f"custom_lat{lat:g}_par{par:g}", (lat, par)
    raise TypeError(f"objective must be a string or dict, got {objective!r}")


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        metric: str = None,
        mode: str = None,
        perturbation_interval: int = 2,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        perturbation_factors=(0.8, 1.2),
        seed: int = 0,
        objective=None,
    ):
        if not hyperparam_mutations:
            raise ValueError("PBT requires hyperparam_mutations")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.factors = perturbation_factors
        self.seed = seed
        self.objective, self.objective_weights = _parse_objective(objective)
        self.quant_aware = self.objective == "quality_after_quant"
        # trial_id -> [(iteration, score), ...] in report order (lower=better)
        self._history: Dict[str, list] = {}
        self._num_perturbations = 0
        # Decision trace of the deterministic generation step (the device
        # and boundary paths append one entry per generation): the parity
        # tests replay these through reference_generation_step.
        self._generation_log: list = []

    def set_experiment(self, metric: str, mode: str):
        self.metric = self.metric if self.metric is not None else metric
        self.mode = self.mode if self.mode is not None else mode

    # -- explore -------------------------------------------------------------
    def _mutate(self, config: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
        new = dict(config)
        for key, spec in self.mutations.items():
            resample = rng.random() < self.resample_p or key not in new
            if isinstance(spec, Domain):
                if resample:
                    new[key] = spec.sample(rng)
                elif isinstance(new.get(key), (int, float)) and not isinstance(new[key], bool):
                    val = new[key] * self.factors[int(rng.integers(len(self.factors)))]
                    lo = getattr(spec, "low", None)
                    hi = getattr(spec, "high", None)
                    if lo is not None and hi is not None:
                        # Clamp into the domain (min/max directly: a log
                        # round trip would fail on 0 and float-ify ints).
                        # RandInt/LogRandInt highs are exclusive.
                        if isinstance(spec, (RandInt, LogRandInt)):
                            hi = hi - 1
                        val = min(max(val, lo), hi)
                        q = getattr(spec, "q", None)
                        if q:
                            # Quantized domains: snap back onto the q grid
                            # inside the domain.
                            val = min(max(round(val / q) * q, spec._lo),
                                      spec._hi)
                    new[key] = type(new[key])(val)
                else:
                    new[key] = spec.sample(rng)
            elif isinstance(spec, (list, tuple)):
                if resample or new.get(key) not in spec:
                    new[key] = spec[int(rng.integers(len(spec)))]
                else:  # step to a neighbor in the ordered list
                    i = list(spec).index(new[key])
                    j = int(np.clip(i + rng.choice([-1, 1]), 0, len(spec) - 1))
                    new[key] = spec[j]
            elif callable(spec):
                new[key] = spec()
            else:
                raise TypeError(f"Unsupported mutation spec for {key!r}: {spec!r}")
        return new

    # -- exploit -------------------------------------------------------------
    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        if self.metric not in result:
            return CONTINUE
        it = int(result.get("training_iteration", trial.training_iteration))
        self._history.setdefault(trial.trial_id, []).append(
            (it, self._score(result))
        )

        if it == 0 or it % self.interval != 0:
            return CONTINUE

        # Iteration-bucketed ranking: each peer is judged by its most
        # recent score at or before iteration ``it``, so a trial at epoch 2
        # is never ranked against a peer's epoch-6 score.
        scores: Dict[str, float] = {}
        for tid, hist in self._history.items():
            eligible = [s for i2, s in hist if i2 <= it]
            if eligible:
                scores[tid] = eligible[-1]
        if len(scores) < 4:  # need a meaningful quantile split
            return CONTINUE
        ranked = sorted(scores.items(), key=lambda kv: kv[1])  # best first
        k = max(1, int(len(ranked) * self.quantile))
        top_ids = [tid for tid, _ in ranked[:k]]
        bottom_ids = {tid for tid, _ in ranked[-k:]}

        if trial.trial_id not in bottom_ids or trial.trial_id in top_ids:
            return CONTINUE

        rng = rng_from("pbt", self.seed, trial.trial_id, it)
        donors = []
        for tid in top_ids:
            donor = self._find_trial(tid)
            if donor is None or not donor.latest_checkpoint:
                continue
            # The lagger adopts the donor's weights AND progress (it
            # resumes at the restored epoch + 1), so a donor ahead of it
            # is fine.  The only ineligible donor is one whose checkpoint
            # leaves no remaining budget: restoring a final-epoch state
            # would end the lagger at once.  20 is the trainables' own
            # num_epochs default.
            budget = int(donor.config.get("num_epochs", 20) or 0)
            if budget and donor.latest_checkpoint_iteration >= budget:
                continue
            donors.append(donor)
        if not donors:
            return CONTINUE
        donor = donors[int(rng.integers(len(donors)))]

        # Exploit: resume from the donor's weights; explore: mutate its config.
        trial.restore_path = donor.latest_checkpoint
        trial.restore_base = donor.latest_checkpoint_iteration
        trial.config = self._mutate(dict(donor.config), rng)
        self._num_perturbations += 1
        return REQUEUE

    # -- vectorized-runner surface -------------------------------------------
    # run_vectorized replaces the REQUEUE protocol with a row gather and
    # bypasses on_trial_result; these hooks let model-based subclasses
    # (PB2) keep learning from the per-epoch stream anyway.

    def observe_result(self, trial: Trial, result: Dict[str, Any]) -> None:
        """Record whatever the explore model learns from one report
        (no decision).  Base PBT learns nothing."""

    def device_mutation_spec(self) -> Optional[Dict[str, Any]]:
        """Constants of the device exploit/explore step, or None.

        None means these mutations need per-generation host decisions and
        run_vectorized keeps the boundary path.  The device subset: every
        mutated key is ``learning_rate``/``weight_decay`` with a
        continuous unquantized ``Uniform``/``LogUniform`` domain.  List
        specs, quantized domains, callables and model-based explores (PB2
        overrides this to None) all need host decisions.
        """
        keys = tuple(sorted(self.mutations))
        if not keys or not set(keys) <= {"learning_rate", "weight_decay"}:
            return None
        specs = []
        for k in keys:
            spec = self.mutations[k]
            if not isinstance(spec, (Uniform, LogUniform)):
                return None
            if getattr(spec, "q", None):
                return None  # quantized grids need _mutate's snap logic
            specs.append({
                "key": k,
                "lo": float(spec.low),
                "hi": float(spec.high),
                "log": isinstance(spec, LogUniform),
            })
        return {
            "sign": 1.0 if (self.mode or "min") == "min" else -1.0,
            "quantile": float(self.quantile),
            "resample_p": float(self.resample_p),
            "factors": tuple(float(f) for f in self.factors),
            "keys": keys,
            "specs": tuple(specs),
            "grid_points": RESAMPLE_GRID_POINTS,
        }

    def reset_improvement_chain(self, trial_id: str) -> None:
        """The trial's weights were just replaced (exploit): any
        cross-boundary score delta is meaningless.  Base PBT keeps none."""

    def on_trial_add(self, trial: Trial):
        self._trials = getattr(self, "_trials", {})
        self._trials[trial.trial_id] = trial

    def _find_trial(self, trial_id: str) -> Optional[Trial]:
        return getattr(self, "_trials", {}).get(trial_id)

    def save_state(self) -> Dict[str, Any]:
        # ``_trials`` (live Trial refs) is deliberately absent: a resume
        # rebuilds it through on_trial_add before restore_state runs.
        return {
            "history": {t: [[int(i), float(s)] for i, s in h]
                        for t, h in self._history.items()},
            "num_perturbations": self._num_perturbations,
            "generation_log": list(self._generation_log),
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        self._history = {
            str(t): [(int(i), float(s)) for i, s in h]
            for t, h in state.get("history", {}).items()
        }
        self._num_perturbations = int(state.get("num_perturbations", 0))
        self._generation_log = list(state.get("generation_log", []))

    def debug_state(self):
        return {"num_perturbations": self._num_perturbations}


# ---------------------------------------------------------------------------
# Device-parity machinery: the device exploit/explore step and this host
# reference agree BIT FOR BIT on the same seed.  Everything here is built
# from exactly reproducible operations: threefry draw bits, IEEE float32
# multiply/min/max, integer truncation, and lookups into a host-built
# resample grid (RESAMPLE_GRID_POINTS).
# ---------------------------------------------------------------------------


def resample_grid(spec_entry: Dict[str, Any],
                  n: int = RESAMPLE_GRID_POINTS) -> np.ndarray:
    """The float32 resample table for one mutated hyperparameter:
    geometric for log domains, linear otherwise, built once on the host
    and shared by the device step and the reference."""
    if spec_entry["log"]:
        g = np.geomspace(spec_entry["lo"], spec_entry["hi"], n)
    else:
        g = np.linspace(spec_entry["lo"], spec_entry["hi"], n)
    return np.asarray(g, np.float32)


def generation_draw_count(spec: Dict[str, Any]) -> int:
    """Uniform draws consumed per row per generation: one donor pick plus
    (resample?, value) per mutated key."""
    return 1 + 2 * len(spec["keys"])


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KEY_PARITY = 0x1BD11BDA
_U32 = np.uint32


def _threefry2x32(k0: np.ndarray, k1: np.ndarray, x0: np.ndarray,
                  x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (the JAX PRNG's block function) on
    uint32 arrays that broadcast together; wraps mod 2**32."""
    ks = (k0, k1, k0 ^ k1 ^ _U32(_KEY_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _fold_in(k0: np.ndarray, k1: np.ndarray, data) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """``jax.random.fold_in``: the key hashed with the counter
    ``[0, data]`` (data as uint32)."""
    data = np.asarray(data, np.int64) & 0xFFFFFFFF
    return _threefry2x32(k0, k1, np.zeros_like(data, _U32),
                         data.astype(_U32))


def generation_draws(seed: int, n_rows: int, gen: int,
                     n_draws: int) -> np.ndarray:
    """The ``(n_rows, n_draws)`` float32 uniforms for generation ``gen``.

    The JAX package's chain, bit for bit: per-row key
    ``fold_in(key(seed), row)`` folded with the generation index, then
    ``uniform(key, (n_draws,))``.  ``key(seed)`` is ``[0, seed mod 2**32]``
    (JAX's 32-bit mode); ``uniform`` hashes the counters
    ``(0, arange(n_draws))``, XORs the two output words, keeps the top 23
    bits as the mantissa of a float in [1, 2) and subtracts 1.
    """
    k0 = np.zeros(1, _U32)
    k1 = np.asarray([int(seed) & 0xFFFFFFFF], _U32)
    r0, r1 = _fold_in(k0, k1, np.arange(n_rows))             # (rows,)
    g0, g1 = _fold_in(r0, r1, np.full(n_rows, int(gen)))     # (rows,)
    counters = np.arange(n_draws, dtype=_U32)[None, :]
    b1, b2 = _threefry2x32(g0[:, None], g1[:, None],
                           np.zeros_like(counters), counters)
    bits = (b1 ^ b2) >> _U32(9) | _U32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).astype(np.float32)


def reference_generation_step(
    spec: Dict[str, Any],
    scores: np.ndarray,
    row_lr: np.ndarray,
    row_wd: np.ndarray,
    valid: np.ndarray,
    draws: np.ndarray,
    fire: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host reference of ONE exploit/explore generation.

    Rows are ranked by sign-adjusted score with non-finite rows strictly
    worst (never donate, first rescued) and invalid rows (stopped trials)
    excluded; the bottom quantile adopts a uniformly drawn FINITE
    top-quantile row's state (``src``) and its hyperparams, each mutated
    resample-or-multiply with clamping into the domain.  No exploit with
    fewer than 4 live rows, when the best live score is non-finite, or
    after the final generation (``fire=False``).  Returns ``(src, new_lr,
    new_wd, exploited)``.
    """
    k = len(scores)
    src = np.arange(k)
    new_lr = np.asarray(row_lr, np.float32).copy()
    new_wd = np.asarray(row_wd, np.float32).copy()
    exploited = np.zeros(k, bool)
    s = np.asarray(scores, np.float32) * np.float32(spec["sign"])
    rank = np.where(np.isfinite(s), s, np.float32(np.inf)).astype(np.float32)
    order = sorted(
        range(k), key=lambda i: (0 if valid[i] else 1, rank[i], i)
    )
    n_valid = int(np.sum(np.asarray(valid, bool)))
    if not fire or n_valid < 4 or not np.isfinite(rank[order[0]]):
        return src, new_lr, new_wd, exploited
    q = max(1, int(n_valid * spec["quantile"]))
    donors = order[:q]
    finite_donors = [i for i in donors if np.isfinite(rank[i])]
    n_ok = len(finite_donors)
    if n_ok == 0:
        return src, new_lr, new_wd, exploited
    lag_start = max(q, n_valid - q)
    for i in order[lag_start:n_valid]:
        u0 = np.float32(draws[i, 0])
        d = finite_donors[
            min(int(u0 * np.float32(n_ok)), n_ok - 1)
        ]
        src[i] = d
        exploited[i] = True
    # Explore works on whole columns and applies to exploited rows only; a
    # key that is not mutated still adopts the donor's value (exploit
    # copies the donor's whole config).
    vals = {"learning_rate": new_lr, "weight_decay": new_wd}
    out = {}
    n_factors = len(spec["factors"])
    factors = np.asarray(spec["factors"], np.float32)
    for m, e in enumerate(spec["specs"]):
        base = vals[e["key"]]
        donor_v = base[src]
        u_res = np.asarray(draws[:, 1 + 2 * m], np.float32)
        u_val = np.asarray(draws[:, 2 + 2 * m], np.float32)
        grid = resample_grid(e, spec.get("grid_points",
                                         RESAMPLE_GRID_POINTS))
        gi = np.clip(
            (u_val * np.float32(len(grid))).astype(np.int32), 0,
            len(grid) - 1,
        )
        resampled = grid[gi]
        fi = np.clip(
            (u_val * np.float32(n_factors)).astype(np.int32), 0,
            n_factors - 1,
        )
        stepped = np.clip(
            donor_v * factors[fi], np.float32(e["lo"]), np.float32(e["hi"])
        ).astype(np.float32)
        cand = np.where(u_res < np.float32(spec["resample_p"]),
                        resampled, stepped)
        out[e["key"]] = np.where(exploited, cand, base).astype(np.float32)
    for key in ("learning_rate", "weight_decay"):
        if key not in spec["keys"]:
            out[key] = np.where(
                exploited, vals[key][src], vals[key]
            ).astype(np.float32)
    return src, out["learning_rate"], out["weight_decay"], exploited


def pbt_state_block(sched) -> Optional[Dict[str, Any]]:
    """The ``pbt`` counter family of a respawn driver's
    ``experiment_state.json`` (``tune.run``); the vectorized runner writes
    its richer counters instead."""
    if not isinstance(sched, PopulationBasedTraining):
        return None
    return {
        "mode": "respawn",
        "exploits": sched._num_perturbations,
        "explores": sched._num_perturbations,
        "objective": sched.objective,
    }
