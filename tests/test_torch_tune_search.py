"""The port's tune decision layer against the JAX package's.

Search-space sampling, the searchers (random, grid, warm start,
BayesOpt), the ASHA scheduler and the stoppers are fed the same seeds and
the same scripted results in both packages and must make the same
decisions: equal samples, BayesOpt suggestions equal to the last float64
bit, the same CONTINUE/STOP at every report.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from _torch_tune_common import restore_global_state  # noqa: F401

pytest.importorskip("torch")

from distributed_machine_learning_tpu.tune import search_space as jax_space  # noqa: E402
from distributed_machine_learning_tpu.tune import stoppers as jax_stoppers  # noqa: E402
from distributed_machine_learning_tpu.tune.schedulers import (  # noqa: E402
    ASHAScheduler as JaxASHA,
)
from distributed_machine_learning_tpu.tune.search import (  # noqa: E402
    BayesOptSearch as JaxBayesOpt,
    GridSearch as JaxGrid,
    RandomSearch as JaxRandom,
)
from distributed_machine_learning_tpu.tune.search.base import (  # noqa: E402
    maybe_warm_start as jax_warm_start,
)
from distributed_machine_learning_tpu.tune.trial import Trial as JaxTrial  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    search_space as port_space,
    stoppers as port_stoppers,
)
from distributed_machine_learning_tpu_torch.tune.schedulers import (  # noqa: E402
    ASHAScheduler as PortASHA,
)
from distributed_machine_learning_tpu_torch.tune.search import (  # noqa: E402
    BayesOptSearch as PortBayesOpt,
    GridSearch as PortGrid,
    RandomSearch as PortRandom,
)
from distributed_machine_learning_tpu_torch.tune.search.base import (  # noqa: E402
    maybe_warm_start as port_warm_start,
)
from distributed_machine_learning_tpu_torch.tune.trial import Trial as PortTrial  # noqa: E402

# Each domain as (constructor name, arguments): built in both packages.
DOMAINS = {
    "choice": ("choice", ([16, "a", 2.5, None],)),
    "uniform": ("uniform", (-2.0, 3.0)),
    "loguniform": ("loguniform", (1e-5, 1e-2)),
    "quniform": ("quniform", (0.0, 1.0, 0.125)),
    "qloguniform": ("qloguniform", (1e-3, 10.0, 0.5)),
    "randn": ("randn", (1.5, 0.25)),
    "randint": ("randint", (-3, 17)),
    "qrandint": ("qrandint", (8, 60, 8)),
    "lograndint": ("lograndint", (1, 1000)),
    "constant": ("constant", ((1, 2),)),
}


def _space(mod):
    """The README quickstart's space with every other domain beside it,
    a lazy arithmetic expression and two sample_from entries that depend
    on each other out of declaration order."""
    space = {name: getattr(mod, fn)(*args)
             for name, (fn, args) in DOMAINS.items()}
    space.update({
        "model": "transformer",
        "d_model": mod.choice([64, 128, 256]),
        "num_heads": mod.choice([2, 4, 8]),
        "num_layers": mod.choice([2, 4]),
        "attention_type": mod.choice(
            ["scaled_dot_product", "linear_attention", "flash"]),
        "learning_rate": mod.loguniform(1e-5, 1e-2),
        "weight_decay": mod.loguniform(1e-6, 1e-2),
        "ff": mod.sample_from(lambda c: c["width"] + 1),
        "width": mod.sample_from(lambda c: c["d_model"] * mod.choice([2, 3])),
        "scaled": mod.uniform(0.0, 1.0) * 4 + 1,
        "num_epochs": 20,
    })
    return space


@pytest.mark.parametrize("name", sorted(DOMAINS))
def test_every_domain_samples_like_the_reference(name):
    fn, args = DOMAINS[name]
    jax_dom, port_dom = getattr(jax_space, fn)(*args), getattr(port_space, fn)(*args)
    for seed in range(3):
        jax_rng = jax_space.rng_from("domain", name, seed)
        port_rng = port_space.rng_from("domain", name, seed)
        got = [port_dom.sample(port_rng) for _ in range(64)]
        want = [jax_dom.sample(jax_rng) for _ in range(64)]
        assert got == want
        assert [type(g) for g in got] == [type(w) for w in want]


@pytest.mark.parametrize("name", ["uniform", "loguniform"])
def test_continuous_domains_map_the_unit_cube_like_the_reference(name):
    fn, args = DOMAINS[name]
    jax_dom, port_dom = getattr(jax_space, fn)(*args), getattr(port_space, fn)(*args)
    assert port_dom.is_continuous and jax_dom.is_continuous
    for u in np.linspace(-0.25, 1.25, 31):
        assert port_dom.from_unit(u) == jax_dom.from_unit(u)
        v = jax_dom.from_unit(u)
        assert port_dom.to_unit(v) == jax_dom.to_unit(v)


@pytest.mark.parametrize("constrained", [False, True])
def test_search_space_samples_like_the_reference(constrained):
    def constraints(mod):
        if not constrained:
            return None
        return [mod.Constraint(lambda c: c["d_model"] % (4 * c["num_heads"]) == 0
                               and c["randint"] % 2 == 0, "even and divisible")]

    jax_ss = jax_space.SearchSpace(_space(jax_space), constraints(jax_space))
    port_ss = port_space.SearchSpace(_space(port_space), constraints(port_space))
    assert port_ss.continuous_keys() == jax_ss.continuous_keys()
    for i in range(40):
        assert port_ss.sample(("t", 7, i)) == jax_ss.sample(("t", 7, i))


def test_search_space_refuses_like_the_reference():
    for mod in (jax_space, port_space):
        with pytest.raises(ValueError):
            mod.qrandint(3, 5, 8)
        with pytest.raises(ValueError):
            mod.loguniform(0.0, 1.0)
        cyclic = mod.SearchSpace({"a": mod.sample_from(lambda c: c["b"]),
                                  "b": mod.sample_from(lambda c: c["a"])})
        with pytest.raises(RuntimeError, match="Cyclic"):
            cyclic.sample((0,))
        never = mod.SearchSpace({"x": mod.uniform(0, 1)},
                                [mod.Constraint(lambda c: False, "never")])
        never.MAX_REJECTION_SAMPLES = 5
        with pytest.raises(RuntimeError, match="never"):
            never.sample((0,))


def _pair(kind, **kwargs):
    ctor = {"random": (JaxRandom, PortRandom), "grid": (JaxGrid, PortGrid),
            "bayesopt": (JaxBayesOpt, PortBayesOpt)}[kind]
    return ctor[0](**kwargs), ctor[1](**kwargs)


@pytest.mark.parametrize("kind", ["random", "grid"])
@pytest.mark.parametrize("points", [None, [{"attention_type": "flash"},
                                           {"d_model": 64, "num_layers": 4}]])
def test_searchers_suggest_like_the_reference(kind, points):
    jax_s, port_s = _pair(kind)
    jax_s, port_s = jax_warm_start(jax_s, points), port_warm_start(port_s, points)
    space = {k: v for k, v in _space(jax_space).items() if k in (
        "d_model", "num_heads", "num_layers", "attention_type",
        "learning_rate", "model")}
    jax_s.set_search_space(jax_space.SearchSpace(space), 3)
    space = {k: v for k, v in _space(port_space).items() if k in space}
    port_s.set_search_space(port_space.SearchSpace(space), 3)
    for i in range(45):
        assert port_s.suggest(i) == jax_s.suggest(i)
    assert port_s.save_state() == jax_s.save_state()


def _bayes_space(mod, constrained: bool):
    space = {
        "learning_rate": mod.loguniform(1e-5, 1e-2),
        "weight_decay": mod.loguniform(1e-6, 1e-2),
        "dropout": mod.uniform(0.0, 0.5),
        "d_model": mod.choice([64, 128, 256]),
        "attention_type": mod.choice(["scaled_dot_product", "flash"]),
    }
    constraints = ([mod.Constraint(lambda c: c["dropout"] < 0.4, "dropout")]
                   if constrained else None)
    return mod.SearchSpace(space, constraints)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("constrained", [False, True])
def test_bayesopt_suggests_like_the_reference_bit_for_bit(mode, constrained):
    """20 rounds: two suggestions per round (one stays in flight, so the
    constant-liar pending set is exercised), then one completes with a
    scripted score; an errored trial completes with no result."""
    jax_s, port_s = _pair("bayesopt", random_search_steps=4,
                          num_candidates=128)
    jax_s.set_search_space(_bayes_space(jax_space, constrained), 11)
    port_s.set_search_space(_bayes_space(port_space, constrained), 11)
    in_flight, index = [], 0
    for rnd in range(20):
        for _ in range(2):
            got, want = port_s.suggest(index), jax_s.suggest(index)
            assert got == want, (rnd, got, want)
            in_flight.append((f"trial_{index:05d}", want))
            index += 1
        trial_id, config = in_flight.pop(0)
        score = (math.log10(config["learning_rate"]) + 3.5) ** 2 \
            + config["dropout"] + 1e-3 * config["d_model"]
        result = None if rnd % 7 == 3 else {"validation_mape": score}
        for s in (jax_s, port_s):
            s.on_trial_complete(trial_id, config, result, "validation_mape",
                                mode)
        assert port_s.save_state() == jax_s.save_state()
    assert len(port_s._y) >= 15


def test_bayesopt_restores_its_state_like_the_reference():
    jax_s, port_s = _pair("bayesopt", random_search_steps=2, num_candidates=64)
    jax_s.set_search_space(_bayes_space(jax_space, False), 5)
    port_s.set_search_space(_bayes_space(port_space, False), 5)
    for i in range(6):
        cfg = jax_s.suggest(i)
        port_s.suggest(i)
        for s in (jax_s, port_s):
            s.on_trial_complete(f"trial_{i:05d}", cfg,
                                {"loss": cfg["dropout"]}, "loss", "min")
    fresh = PortBayesOpt(random_search_steps=2, num_candidates=64)
    fresh.set_search_space(_bayes_space(port_space, False), 5)
    fresh.restore_state(jax_s.save_state())
    assert fresh.suggest(6) == jax_s.suggest(6)


def _asha_stream(mode, n_trials, iters):
    """Scripted per-trial metric streams: trial t at iteration i."""
    rng = np.random.default_rng(4)
    base = rng.uniform(0.5, 2.0, size=n_trials)
    sign = 1.0 if mode == "min" else -1.0
    return {t: [float(sign * base[t] / (i + 1) + 0.01 * rng.standard_normal())
                for i in range(iters)] for t in range(n_trials)}


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("grace,eta,max_t", [(1, 3.0, 9), (2, 2.0, 20),
                                             (1, 4.0, 4)])
def test_asha_decides_like_the_reference(mode, grace, eta, max_t):
    n_trials = 14
    streams = _asha_stream(mode, n_trials, max_t + 2)
    decisions = {}
    for pkg, (sched_cls, trial_cls) in {"jax": (JaxASHA, JaxTrial),
                                        "port": (PortASHA, PortTrial)}.items():
        sched = sched_cls(max_t=max_t, grace_period=grace,
                          reduction_factor=eta)
        sched.set_experiment("validation_mape", mode)
        trials = [trial_cls(trial_id=f"trial_{t:05d}", config={})
                  for t in range(n_trials)]
        for tr in trials:
            sched.on_trial_add(tr)
        out, alive = [], set(range(n_trials))
        # Round-robin reports (asynchronous arrival order, as in a sweep).
        for it in range(max_t + 2):
            for t in sorted(alive):
                tr = trials[t]
                tr.reports_since_restart += 1
                result = {"validation_mape": streams[t][it],
                          "training_iteration": tr.training_iteration}
                d = sched.on_trial_result(tr, result)
                out.append((t, it, d))
                if d == "stop":
                    alive.discard(t)
        decisions[pkg] = (out, sched.save_state())
    assert decisions["port"] == decisions["jax"]
    assert any(d == "stop" for _, it, d in decisions["port"][0]
               if it + 1 < max_t)


def test_stoppers_decide_like_the_reference():
    results = [{"validation_mape": 1.0 / (i + 1) + (0.5 if i > 6 else 0.0),
                "training_iteration": i + 1} for i in range(15)]
    pairs = [
        (jax_stoppers.MaximumIterationStopper(5),
         port_stoppers.MaximumIterationStopper(5)),
        (jax_stoppers.TrialPlateauStopper("validation_mape", std=0.05,
                                          num_results=3, grace_period=2),
         port_stoppers.TrialPlateauStopper("validation_mape", std=0.05,
                                           num_results=3, grace_period=2)),
        (jax_stoppers.TrialPlateauStopper("validation_mape", std=0.2,
                                          metric_threshold=0.3, mode="min"),
         port_stoppers.TrialPlateauStopper("validation_mape", std=0.2,
                                           metric_threshold=0.3, mode="min")),
        ({"training_iteration": 9}, {"training_iteration": 9}),
    ]
    for jax_stop, port_stop in pairs:
        jax_stop = jax_stoppers.resolve_stop(jax_stop)
        port_stop = port_stoppers.resolve_stop(port_stop)
        got = [port_stoppers.stop_hit(port_stop, "t", r) for r in results]
        want = [jax_stoppers.stop_hit(jax_stop, "t", r) for r in results]
        assert got == want
        assert any(want)
    with pytest.raises(ValueError):
        port_stoppers.resolve_stop(3)
