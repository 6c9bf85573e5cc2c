"""PB2 — Population Based Bandits (Parker-Holder et al., NeurIPS 2020).

Port of ``distributed_machine_learning_tpu/tune/schedulers/pb2.py`` (the
whole file; float64 numpy, so the same reports give the same decisions
bit for bit).

PBT with a model-based explore step: instead of randomly perturbing
continuous hyperparameters at exploit time, PB2 fits a Gaussian process
to the observed *score improvements* as a function of the hyperparameter
values that produced them, and picks new values by UCB.  Exploit,
quantile ranking, the checkpoint budget guard and categorical mutation
are inherited from ``PopulationBasedTraining``; only continuous-key
exploration changes.  The GP is ``BayesOptSearch``'s
(``search/bayesopt.py::gp_posterior``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from distributed_machine_learning_tpu_torch.tune.schedulers.base import CONTINUE
from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
    PopulationBasedTraining,
)
from distributed_machine_learning_tpu_torch.tune.search.bayesopt import (
    gp_posterior,
)
from distributed_machine_learning_tpu_torch.tune.search_space import Domain
from distributed_machine_learning_tpu_torch.tune.trial import Trial


class PB2(PopulationBasedTraining):
    """Drop-in PBT replacement; continuous mutations become GP-UCB choices.

    Extra knobs: ``kappa`` (UCB exploration weight), ``lengthscale``/
    ``noise`` (GP hyperparams on the unit cube), ``num_candidates``
    (acquisition grid size), ``window`` (observations kept).  Continuous
    keys are the ``hyperparam_mutations`` entries whose spec is a
    continuous ``Domain``; everything else mutates exactly as in PBT.
    """

    def __init__(self, *args, kappa: float = 1.0, lengthscale: float = 0.2,
                 noise: float = 1e-4, num_candidates: int = 256,
                 window: int = 512, **kwargs):
        super().__init__(*args, **kwargs)
        self.kappa = kappa
        self.lengthscale = lengthscale
        self.noise = noise
        self.num_candidates = num_candidates
        self.window = window
        self._cont_keys = [
            k for k, spec in self.mutations.items()
            if isinstance(spec, Domain) and spec.is_continuous
        ]
        # Observations: (unit-cube hyperparam vector, score improvement it
        # produced over one reporting step); lower score = better, so
        # improvement = previous - current.  A sliding window bounds the
        # O(n^3) GP refit and keeps late mutations steered by late
        # evidence.
        self._obs: list = []
        # trial_id -> (iteration, score) of the last observed report.
        self._last_score: Dict[str, tuple] = {}

    # -- observe improvements ------------------------------------------------
    def _encode(self, config: Dict[str, Any]):
        try:
            return np.array(
                [self.mutations[k].to_unit(config[k])
                 for k in self._cont_keys],
                dtype=np.float64,
            )
        except (KeyError, TypeError, ValueError):
            return None  # config missing a key / non-numeric: skip this obs

    def observe_result(self, trial: Trial, result: Dict[str, Any]) -> None:
        """One improvement observation per consecutive-report pair; also
        the hook run_vectorized calls directly (the row gather replaces
        REQUEUE there)."""
        if self.metric not in result or not self._cont_keys:
            return
        score = self._score(result)
        it = int(result.get("training_iteration",
                            trial.training_iteration))
        prev = self._last_score.get(trial.trial_id)
        # A non-monotone iteration means the trial restarted from a
        # checkpoint without a scheduler decision (a retry): a delta
        # across it would blame the config for the rewound weights, so it
        # only re-baselines.
        if prev is not None and it > prev[0]:
            x = self._encode(trial.config)
            if x is not None:
                self._obs.append((x, prev[1] - score))
                if len(self._obs) > self.window:
                    del self._obs[: -self.window]
        self._last_score[trial.trial_id] = (it, score)

    def reset_improvement_chain(self, trial_id: str) -> None:
        self._last_score.pop(trial_id, None)

    def device_mutation_spec(self):
        """None: the GP-UCB explore refits on host observations at every
        generation, so run_vectorized runs PB2 on the boundary path (one
        read back per perturbation interval); its choices ride the same
        row gather on the device."""
        return None

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        self.observe_result(trial, result)
        decision = super().on_trial_result(trial, result)
        if decision != CONTINUE:
            # The trial restarts from a donor's weights under a new config;
            # a delta across that boundary would credit the new config with
            # the donor's head start.
            self.reset_improvement_chain(trial.trial_id)
        return decision

    # -- explore (GP-UCB over the continuous keys) ---------------------------
    def _mutate(self, config: Dict[str, Any],
                rng: np.random.Generator) -> Dict[str, Any]:
        new = super()._mutate(config, rng)  # categorical + in-domain clamp
        if not self._cont_keys or len(self._obs) < 4:
            return new
        X = np.stack([x for x, _ in self._obs])
        y = np.array([dy for _, dy in self._obs])
        cand = rng.random((self.num_candidates, len(self._cont_keys)))
        try:
            mu, sigma, _ = gp_posterior(
                X, y, cand, self.lengthscale, self.noise
            )
        except np.linalg.LinAlgError:
            return new  # degenerate observations: keep the PBT mutation
        u = cand[int(np.argmax(mu + self.kappa * sigma))]  # max improvement
        for k, ui in zip(self._cont_keys, u):
            new[k] = self.mutations[k].from_unit(float(ui))
        return new

    def save_state(self) -> Dict[str, Any]:
        state = super().save_state()
        state["obs"] = [
            [[float(v) for v in x], float(dy)] for x, dy in self._obs
        ]
        state["last_score"] = {
            t: [int(i), float(s)]
            for t, (i, s) in self._last_score.items()
        }
        return state

    def restore_state(self, state: Dict[str, Any]) -> None:
        super().restore_state(state)
        self._obs = [
            (np.array(x, dtype=np.float64), float(dy))
            for x, dy in state.get("obs", [])
        ]
        self._last_score = {
            str(t): (int(v[0]), float(v[1]))
            for t, v in state.get("last_score", {}).items()
        }

    def debug_state(self):
        state = super().debug_state()
        state["num_observations"] = len(self._obs)
        return state
