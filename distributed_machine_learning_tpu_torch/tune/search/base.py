"""Search-algorithm interface: proposes configs, learns from completed trials.

Native replacement for Ray Tune's search algs (random sampling of the space
dict; ``BayesOptSearch`` at `ray-tune-hpo-regression.py:474`; SURVEY.md §2b D2).

Port of ``distributed_machine_learning_tpu/tune/search/base.py``: every
class.  The ``Repeater`` (``search/repeater.py`` there) is not ported yet
(ROADMAP.md A3d), so :func:`maybe_warm_start` refuses one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from distributed_machine_learning_tpu_torch.tune.search_space import SearchSpace


class Searcher:
    def set_search_space(self, space: SearchSpace, seed: int):
        self.space = space
        self.seed = seed

    def suggest(self, trial_index: int) -> Optional[Dict[str, Any]]:
        """Propose a config for trial #``trial_index``; None when exhausted."""
        raise NotImplementedError

    def fast_forward(self, num_trials: int) -> None:
        """Called on experiment resume with the number of trials already
        created in the prior run. Index-seeded searchers (random, TPE,
        BayesOpt) need nothing — suggest(i) is deterministic per index —
        but searchers with suggest-side state (GridSearch's cursor) must
        advance past configs already proposed or resume would re-propose
        the covered prefix of the space."""

    def _effective_score(self, result: Optional[Dict[str, Any]], metric: str,
                         mode: str) -> Optional[float]:
        """Resolve searcher-level metric/mode overrides against the experiment
        defaults and normalize so LOWER is always better; None if absent."""
        own_metric = getattr(self, "metric", None)
        own_mode = getattr(self, "mode", None)
        metric = own_metric if own_metric is not None else metric
        mode = own_mode if own_mode is not None else mode
        if not result or metric not in result:
            return None
        score = float(result[metric])
        return -score if mode == "max" else score

    def on_trial_result(self, trial_id: str, config: Dict[str, Any],
                        result: Dict[str, Any], metric: str, mode: str):
        """Per-epoch observation hook (multi-fidelity searchers, e.g. TPE/BOHB)."""
        pass

    def on_trial_complete(self, trial_id: str, config: Dict[str, Any],
                          result: Optional[Dict[str, Any]], metric: str, mode: str):
        pass

    def save_state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of ALL decision-relevant mutable
        state — journaled by ``tune/journal.py`` after every decision so
        a restarted head restores a bit-identical searcher (the WAL
        contract: ``restore_state(save_state())`` followed by
        ``suggest(i)`` must equal the uninterrupted ``suggest(i)``).
        Stateless searchers (RandomSearch — suggest is pure in the trial
        index) inherit this empty default."""
        return {}

    def restore_state(self, state: Dict[str, Any]) -> None:
        pass


class WarmStartSearcher(Searcher):
    """Evaluate given configs first, then delegate to the wrapped searcher.

    Ray's ``points_to_evaluate``: known-good or must-check configs (a
    previous sweep's best, a paper's setting) run as the first trials.
    Points may be PARTIAL configs — missing keys are sampled from the
    space, fixed keys are honored exactly (constraints still apply). The
    inner searcher sees a shifted trial index, so its proposal sequence is
    identical to a run without warm-start points, and it observes the
    point-trials' results through the usual hooks (model-based searchers
    learn from them).
    """

    def __init__(self, inner: Searcher, points):
        self.inner = inner
        self.points = [dict(p) for p in points]

    def set_search_space(self, space: SearchSpace, seed: int):
        super().set_search_space(space, seed)
        self.inner.set_search_space(space, seed)

    def suggest(self, trial_index: int) -> Optional[Dict[str, Any]]:
        if trial_index < len(self.points):
            return self.space.with_overrides(
                **self.points[trial_index]
            ).sample(("point", self.seed, trial_index))
        return self.inner.suggest(trial_index - len(self.points))

    def fast_forward(self, num_trials: int) -> None:
        self.inner.fast_forward(max(0, num_trials - len(self.points)))

    def on_trial_result(self, trial_id, config, result, metric, mode):
        self.inner.on_trial_result(trial_id, config, result, metric, mode)

    def on_trial_complete(self, trial_id, config, result, metric, mode):
        self.inner.on_trial_complete(trial_id, config, result, metric, mode)

    def save_state(self) -> Dict[str, Any]:
        # The points list is constructor state; only the inner model moves.
        return {"inner": self.inner.save_state()}

    def restore_state(self, state: Dict[str, Any]) -> None:
        self.inner.restore_state(state.get("inner", {}))


def refuse_repeater(searcher: Searcher) -> None:
    """The ``Repeater`` is not ported yet: refuse one rather than run it
    as a plain searcher."""
    if type(searcher).__name__ == "Repeater":
        raise NotImplementedError(
            "the Repeater searcher (search/repeater.py) is not ported yet; "
            "see ROADMAP.md A3d"
        )


def maybe_warm_start(searcher: Searcher, points) -> Searcher:
    """The runners' shared ``points_to_evaluate`` hook: wrap when points
    are given, pass through otherwise.  (The reference composes a
    ``Repeater`` outside the warm start; the port refuses a ``Repeater``.)"""
    refuse_repeater(searcher)
    if not points:
        return searcher
    return WarmStartSearcher(searcher, points)


class RandomSearch(Searcher):
    """Seeded i.i.d. sampling of the search space (Ray's default variant
    generator)."""

    def suggest(self, trial_index: int) -> Dict[str, Any]:
        return self.space.sample(("random", self.seed, trial_index))


class GridSearch(Searcher):
    """Exhaustive cartesian product over Choice domains; non-choice domains are
    sampled per grid point (matching ray.tune.grid_search semantics)."""

    def set_search_space(self, space: SearchSpace, seed: int):
        super().set_search_space(space, seed)
        from itertools import product

        from distributed_machine_learning_tpu_torch.tune.search_space import Choice

        keys, values = [], []
        for k, dom in space.space.items():
            if isinstance(dom, Choice):
                keys.append(k)
                values.append(list(dom.categories))
        self._grid_keys = keys
        self._grid_points = list(product(*values)) if keys else [()]

    def suggest(self, trial_index: int) -> Optional[Dict[str, Any]]:
        # Walk an internal cursor so infeasible grid points (fixed values that
        # violate a joint constraint) are skipped rather than crashing the run.
        cursor = getattr(self, "_cursor", 0)
        while cursor < len(self._grid_points):
            point = dict(zip(self._grid_keys, self._grid_points[cursor]))
            cursor += 1
            try:
                cfg = self.space.with_overrides(**point).sample(
                    ("grid", self.seed, cursor - 1)
                )
            except RuntimeError:
                continue  # no feasible completion of this grid point
            self._cursor = cursor
            return cfg
        self._cursor = cursor
        return None

    def fast_forward(self, num_trials: int) -> None:
        # Re-walk the cursor over the already-proposed prefix (identical
        # feasibility skipping), discarding the configs.
        for i in range(num_trials):
            if self.suggest(i) is None:
                break

    def save_state(self) -> Dict[str, Any]:
        return {"cursor": getattr(self, "_cursor", 0)}

    def restore_state(self, state: Dict[str, Any]) -> None:
        # Restoring the cursor directly (instead of fast_forward's re-walk)
        # lands on the identical next grid point without re-evaluating
        # feasibility — bit-identical by construction.
        self._cursor = int(state.get("cursor", 0))

    @property
    def num_points(self) -> int:
        return len(self._grid_points)
