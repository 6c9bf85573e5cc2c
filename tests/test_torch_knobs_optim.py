"""The port's registry-form optimizers against the JAX package's optax
chains: all seven names, clipping and weight decay on and off, the
``warmup_linear_decay`` schedule, ``MultiSteps`` accumulation, adafactor's
factored statistics in the flax layout, and ``param_opt_bytes``.

Leaves are kept in each package's own layout: the port's dense kernels are
``[out..., in...]``, flax's ``[in..., out...]`` (``models.convert.
flax_axes``).  The leaves hold a 128x256 dense kernel, a square 128x128 one,
a 3-D ``DenseGeneral`` query kernel with two axes of at least 128 (flax
``(256, 2, 128)``) and a bias vector.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jax_optimizers = importlib.import_module(
    "distributed_machine_learning_tpu.ops.optimizers")
jax_schedules = importlib.import_module(
    "distributed_machine_learning_tpu.ops.schedules")
jax_flagship = importlib.import_module(
    "distributed_machine_learning_tpu.models.flagship")
optimizers = importlib.import_module(
    "distributed_machine_learning_tpu_torch.ops.optimizers")
schedules = importlib.import_module(
    "distributed_machine_learning_tpu_torch.ops.schedules")
flagship = importlib.import_module(
    "distributed_machine_learning_tpu_torch.models.flagship")
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    flax_axes,
)

# Port names and shapes.
SHAPES = {
    "layer_0.ff.Dense_0.weight": (256, 128),
    "layer_0.ff.square.weight": (128, 128),
    "layer_0.attention.query.weight": (2, 128, 256),
    "layer_0.ff.Dense_0.bias": (7,),
}
LEAF_AXES = {k: flax_axes(k, len(s)) for k, s in SHAPES.items()
             if flax_axes(k, len(s)) is not None}
LR = 3e-3
SCHEDULE = dict(warmup_steps=2, total_steps=6)
CASES = {
    "plain": dict(clip=0.0, wd=0.0, momentum=0.0),
    "clipped": dict(clip=0.5, wd=0.0, momentum=0.0),
    "decayed": dict(clip=0.0, wd=0.01, momentum=0.0),
    "all": dict(clip=0.5, wd=0.01, momentum=0.9),
}
# Largest difference of an update leaf, over its largest entry.
TOL = 1e-5
# A lion entry whose update differs by a whole lr is a sign taken of an
# argument that is rounding noise: at most this share of its largest.
SIGN_TOL = 1e-6


def to_flax(key, a):
    axes = flax_axes(key, np.ndim(a))
    return a if axes is None else np.transpose(a, axes)


def _draws(seed: int, steps: int):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _pair(name, case, accumulate=1):
    c = CASES[case]
    kw = dict(weight_decay=c["wd"], momentum=c["momentum"],
              gradient_clipping=c["clip"], accumulate_grad_batches=accumulate)
    jtx = jax_optimizers.make_optimizer(
        name, jax_schedules.get_schedule("warmup_linear_decay",
                                         learning_rate=LR, **SCHEDULE), **kw)
    tx = optimizers.make_optimizer(
        name, schedules.get_schedule("warmup_linear_decay", learning_rate=LR,
                                     **SCHEDULE), leaf_axes=LEAF_AXES, **kw)
    return jtx.init, jax.jit(jtx.update), tx


def _lion_arg(state, grads):
    """The argument lion takes the sign of, from the port's state before
    the update."""
    return {k: (1.0 - optimizers.LION_B1) * g
            + optimizers.LION_B1 * state["mu"][k] for k, g in grads.items()}


def _compare(name, want, got, arg=None) -> int:
    """Holds each update leaf to ``TOL``; returns how many lion entries
    differ by a whole lr (each with a sign argument under ``SIGN_TOL``)."""
    flips = 0
    for k in SHAPES:
        w = np.asarray(want[k])
        g = to_flax(k, got[k].numpy())
        scale = max(np.abs(w).max(), 1e-30)
        off = np.abs(g - w) > TOL * scale
        if name == "lion" and off.any():
            a = to_flax(k, arg[k].numpy())
            assert np.all(np.abs(a[off]) <= SIGN_TOL * np.abs(a).max()), k
            flips += int(off.sum())
            continue
        assert not off.any(), (k, np.abs(g - w).max() / scale)
    return flips


@pytest.mark.parametrize("name", optimizers.ALL_OPTIMIZERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_the_optax_chain(name, case):
    params, grads = _draws(1, 6)
    jinit, jupdate, tx = _pair(name, case)
    jp = {k: jnp.asarray(to_flax(k, v)) for k, v in params.items()}
    js = jinit(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tx.init(tp)
    flips = 0
    for g in grads:
        ju, js = jupdate({k: jnp.asarray(to_flax(k, v))
                          for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        arg = _lion_arg(ts, tg) if name == "lion" else None
        tu = tx.update(tg, ts, tp)
        optimizers.apply_updates(tp, tu)
        flips += _compare(name, ju, tu, arg)
    assert ts["count"] == len(grads)
    total = sum(int(np.prod(s)) for s in SHAPES.values()) * len(grads)
    assert flips <= total * 1e-4, flips


@pytest.mark.parametrize("name", optimizers.ALL_OPTIMIZERS)
def test_multisteps_accumulates_three_of_seven_micro_steps(name):
    params, grads = _draws(2, 7)
    jinit, jupdate, tx = _pair(name, "all", accumulate=3)
    jp = {k: jnp.asarray(to_flax(k, v)) for k, v in params.items()}
    js = jinit(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tx.init(tp)
    emitted = []
    for g in grads:
        ju, js = jupdate({k: jnp.asarray(to_flax(k, v))
                          for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        inner = ts["inner_opt_state"]
        arg = None
        if name == "lion":
            mean = {k: ts["acc_grads"][k]
                    + (t - ts["acc_grads"][k]) / (ts["mini_step"] + 1)
                    for k, t in tg.items()}
            arg = _lion_arg(inner, mean)
        tu = tx.update(tg, ts, tp)
        optimizers.apply_updates(tp, tu)
        emitted.append(bool(tu))
        if not tu:
            # optax emits zeros on the non-final micro-steps.
            assert all(not np.asarray(ju[k]).any() for k in SHAPES)
        else:
            assert _compare(name, ju, tu, arg) == 0 or name == "lion"
    assert emitted == [False, False, True, False, False, True, False]
    assert ts["mini_step"] == int(js.mini_step) == 1
    assert ts["gradient_step"] == int(js.gradient_step) == 2
    assert ts["inner_opt_state"]["count"] == 2
    for k in SHAPES:
        # The running mean of the one micro-step since the last update.
        np.testing.assert_allclose(to_flax(k, ts["acc_grads"][k].numpy()),
                                   np.asarray(js.acc_grads[k]), atol=1e-7)


def _factored_state(tree):
    """optax's adafactor state (under clipping and MultiSteps wrappers):
    the ``FactoredState`` with ``v_row``/``v_col``/``v``."""
    for node in (tree if isinstance(tree, tuple) else (tree,)):
        if hasattr(node, "v_row"):
            return node
        if isinstance(node, tuple):
            found = _factored_state(node)
            if found is not None:
                return found
    return None


def test_adafactor_factors_each_leaf_over_the_flax_axes():
    # A three-way tie: by its own order the port's leaf would keep a
    # different axis whole than flax's.
    shapes = {"layer_0.attention.query.weight": (128, 128, 128),
              "layer_0.ff.Dense_0.weight": (256, 128)}
    axes = {k: flax_axes(k, len(s)) for k, s in shapes.items()}
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jtx = jax_optimizers.make_optimizer("adafactor", LR)
    jupdate = jax.jit(jtx.update)
    tx = optimizers.make_optimizer("adafactor", LR, leaf_axes=axes)
    jp = {k: jnp.asarray(to_flax(k, v)) for k, v in params.items()}
    js = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tx.init(tp)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        ju, js = jupdate({k: jnp.asarray(to_flax(k, v))
                          for k, v in g.items()}, js, jp)
        tu = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in shapes:
            w = np.asarray(ju[k])
            np.testing.assert_allclose(to_flax(k, tu[k].numpy()), w,
                                       atol=TOL * np.abs(w).max(), err_msg=k)
    state = _factored_state(js)
    assert not ts["v"]
    for k in shapes:
        for slot in ("v_row", "v_col"):
            want = np.asarray(getattr(state, slot)[k])
            got = ts[slot][k].numpy()
            assert got.shape == want.shape, (k, slot)
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)


FLAGSHIP = dict(model="transformer", d_model=512, num_heads=8, num_layers=4,
                dim_feedforward=2048, max_seq_length=2048, dropout=0.0,
                attention_type="flash")


@pytest.mark.parametrize("name", optimizers.ALL_OPTIMIZERS)
def test_param_opt_bytes_matches_the_jax_pricing(name):
    want = jax_flagship.param_opt_bytes(FLAGSHIP, 16, name)
    got = flagship.param_opt_bytes(FLAGSHIP, 16, name)
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_lion_holds_half_of_adams_state_and_adafactor_less():
    params = flagship.param_opt_bytes(FLAGSHIP, 16, "sgd")
    state = {n: flagship.param_opt_bytes(FLAGSHIP, 16, n) - params
             for n in ("adam", "lion", "adafactor")}
    assert state["lion"] * 2 == state["adam"]
    assert state["adafactor"] < state["lion"]


def test_flagship_sharded_config_matches_and_prices_past_the_budget(
        monkeypatch):
    monkeypatch.setenv("DML_CPU_DEVICE_BUDGET_BYTES", str(8 << 20))
    budget = flagship.single_chip_hbm_bytes("cpu")
    assert budget == 8 << 20
    config = flagship.flagship_sharded_config(budget)
    assert config == jax_flagship.flagship_sharded_config(budget)
    assert flagship.param_opt_bytes(config) > budget
    smaller = dict(config, d_model=config["d_model"] // 2,
                   dim_feedforward=config["dim_feedforward"] // 2)
    assert flagship.param_opt_bytes(smaller) <= budget
    with pytest.raises(ValueError, match="exceeds budget_bytes"):
        flagship.flagship_sharded_config(1 << 60, max_d_model=128)
