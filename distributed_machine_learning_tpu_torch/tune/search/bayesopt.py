"""Bayesian-optimization search over the continuous subspace.

Port of ``distributed_machine_learning_tpu/tune/search/bayesopt.py`` (the
whole file): float64 numpy, so the same observations give the same
suggestions bit for bit.

The reference used ``BayesOptSearch(random_search_steps=10)``
(`ray-tune-hpo-regression.py:474`) over a categorical-heavy space — a latent
incompatibility, since upstream ``bayes_opt`` only models continuous params
(SURVEY.md §2b D2).  Here the mixed-space strategy is deliberate: a Gaussian
process with expected-improvement acquisition models the *continuous* keys
(uniform/loguniform, normalized to the unit cube); categorical/integer keys are
sampled randomly per suggestion.  Pure numpy — no GP library dependency.

Async-safe by construction: the runner keeps up to ``max_concurrent + 2``
trials in flight, so at suggest time the most recent proposals have no
observations yet.  Naively ignoring them makes the acquisition re-propose
the same optimum for every in-flight slot AND makes suggestions depend on
completion timing (which trials happen to be observed varies with machine
load — the full-suite flake this guards against).  Suggested-but-unfinished
points are therefore kept as PENDING and fed to the GP with a "constant
liar" target (the running mean): the posterior variance collapses around
in-flight points, EI moves elsewhere, and the proposal stream is far less
sensitive to when observations land.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from distributed_machine_learning_tpu_torch.tune.search.base import Searcher
from distributed_machine_learning_tpu_torch.tune.search_space import SearchSpace
from distributed_machine_learning_tpu_torch.utils.seeding import rng_from


def _rbf_kernel(a: np.ndarray, b: np.ndarray, lengthscale: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / lengthscale**2)


def gp_posterior(X: np.ndarray, y: np.ndarray, cand: np.ndarray,
                 lengthscale: float, noise: float):
    """(mu, sigma) of an RBF-GP posterior at ``cand``, fitted on (X, y).

    y is normalized internally; mu, sigma, and the returned normalized
    targets ``yn`` share that scale (ranking-equivalent, which is all the
    acquisitions need).  Shared by ``BayesOptSearch`` (EI) and the PB2
    scheduler (UCB).  Raises ``np.linalg.LinAlgError`` when the kernel is
    degenerate — callers fall back to their non-model behavior.
    """
    yn = (y - y.mean()) / (y.std() + 1e-9)
    K = _rbf_kernel(X, X, lengthscale) + noise * np.eye(len(X))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
    Ks = _rbf_kernel(cand, X, lengthscale)
    mu = Ks @ alpha
    v = np.linalg.solve(L, Ks.T)
    sigma = np.sqrt(np.clip(1.0 - (v**2).sum(axis=0), 1e-12, None))
    return mu, sigma, yn


class BayesOptSearch(Searcher):
    def __init__(
        self,
        metric: str = None,
        mode: str = None,
        random_search_steps: int = 10,
        num_candidates: int = 512,
        lengthscale: float = 0.2,
        noise: float = 1e-4,
        xi: float = 0.01,
    ):
        self.metric = metric
        self.mode = mode
        self.random_steps = random_search_steps
        self.num_candidates = num_candidates
        self.lengthscale = lengthscale
        self.noise = noise
        self.xi = xi
        self._X: List[np.ndarray] = []  # observed unit-cube points
        self._y: List[float] = []       # observed scores (lower = better)
        # trial_index -> suggested-but-unobserved unit-cube point
        # (constant-liar pending set; see module docstring).
        self._pending: Dict[int, np.ndarray] = {}

    def set_search_space(self, space: SearchSpace, seed: int):
        super().set_search_space(space, seed)
        self._cont_keys = space.continuous_keys()

    # -- encode/decode continuous subspace -----------------------------------
    def _encode(self, config: Dict[str, Any]) -> np.ndarray:
        return np.array(
            [self.space.domain(k).to_unit(config[k]) for k in self._cont_keys],
            dtype=np.float64,
        )

    def _apply(self, config: Dict[str, Any], u: np.ndarray) -> Dict[str, Any]:
        out = dict(config)
        for k, ui in zip(self._cont_keys, u):
            out[k] = self.space.domain(k).from_unit(float(ui))
        return out

    # -- searcher API --------------------------------------------------------
    def suggest(self, trial_index: int) -> Optional[Dict[str, Any]]:
        base = self.space.sample(("bayesopt", self.seed, trial_index))
        if not self._cont_keys:
            return base
        if len(self._y) < self.random_steps:
            # Bootstrap phase: pure random (random_search_steps).  Pending
            # registration still matters — the first GP suggestion must
            # know which random points are already in flight.
            self._pending[trial_index] = self._encode(base)
            return base

        rng = rng_from("bayesopt-acq", self.seed, trial_index)
        # Constant liar: in-flight points enter the fit at the observed
        # MEAN score, pinning the posterior there so EI explores elsewhere
        # instead of stacking every concurrent slot on one argmax (and so
        # the proposal depends far less on completion timing).
        X_obs = np.stack(self._X)
        y_obs = np.array(self._y)
        if self._pending:
            lie = float(y_obs.mean())
            X = np.concatenate(
                [X_obs, np.stack(list(self._pending.values()))]
            )
            y = np.concatenate(
                [y_obs, np.full(len(self._pending), lie)]
            )
        else:
            X, y = X_obs, y_obs
        cand = rng.random((self.num_candidates, len(self._cont_keys)))
        try:
            mu, sigma, yn = gp_posterior(
                X, y, cand, self.lengthscale, self.noise
            )
        except np.linalg.LinAlgError:
            self._pending[trial_index] = self._encode(base)
            return base  # degenerate kernel: stay with the random sample

        # Expected improvement (minimization of normalized score), judged
        # against the best OBSERVED point — liars must not shift the
        # improvement baseline, only the posterior shape.
        best = yn[: len(y_obs)].min()
        from math import erf, sqrt

        z = (best - self.xi - mu) / sigma
        cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
        pdf = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        ei = sigma * (z * cdf + pdf)
        u_best = cand[int(np.argmax(ei))]
        config = self._apply(base, u_best)

        # Re-check joint constraints after the GP overrides continuous keys.
        if not all(c(config) for c in self.space.constraints):
            self._pending[trial_index] = self._encode(base)
            return base
        self._pending[trial_index] = u_best
        return config

    @staticmethod
    def _trial_index_of(trial_id) -> Optional[int]:
        # Both drivers name trials "trial_<index>"; pending bookkeeping
        # falls back to nearest-point matching when the id doesn't parse.
        try:
            return int(str(trial_id).rsplit("_", 1)[-1])
        except ValueError:
            return None

    def _clear_pending(self, trial_id, config) -> None:
        idx = self._trial_index_of(trial_id)
        if idx is not None:
            self._pending.pop(idx, None)
            return
        if not self._pending:
            return
        u = self._encode(config)
        nearest = min(
            self._pending,
            key=lambda k: float(((self._pending[k] - u) ** 2).sum()),
        )
        self._pending.pop(nearest, None)

    def save_state(self) -> Dict[str, Any]:
        # float64 → JSON shortest-repr → float64 round-trips exactly, so
        # the restored GP fit (and therefore the next suggestion) is
        # bit-identical to the uninterrupted run's.
        return {
            "X": [[float(v) for v in x] for x in self._X],
            "y": [float(v) for v in self._y],
            "pending": {
                str(k): [float(v) for v in u]
                for k, u in self._pending.items()
            },
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        self._X = [np.array(x, dtype=np.float64)
                   for x in state.get("X", [])]
        self._y = [float(v) for v in state.get("y", [])]
        self._pending = {
            int(k): np.array(u, dtype=np.float64)
            for k, u in state.get("pending", {}).items()
        }

    def on_trial_complete(self, trial_id, config, result, metric, mode):
        if not self._cont_keys:
            return
        # Errored trials observe nothing but must still leave the pending
        # set — a permanently-pending liar would dent the posterior there
        # for the rest of the sweep.
        self._clear_pending(trial_id, config)
        score = self._effective_score(result, metric, mode)
        if score is None:
            return
        self._X.append(self._encode(config))
        self._y.append(score)
