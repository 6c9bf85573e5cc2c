"""The port's losses, schedules and optimizers against the JAX package's
(optax) ones, fed the same numpy values."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jax_losses = importlib.import_module("distributed_machine_learning_tpu.ops.losses")
jax_schedules = importlib.import_module(
    "distributed_machine_learning_tpu.ops.schedules")
jax_optimizers = importlib.import_module(
    "distributed_machine_learning_tpu.ops.optimizers")
losses = importlib.import_module("distributed_machine_learning_tpu_torch.ops.losses")
schedules = importlib.import_module(
    "distributed_machine_learning_tpu_torch.ops.schedules")
optimizers = importlib.import_module(
    "distributed_machine_learning_tpu_torch.ops.optimizers")


@pytest.mark.parametrize("name", ["mse", "mae", "huber", "mape", "rmse"])
def test_losses_match(name):
    rng = np.random.default_rng(0)
    # Errors on both sides of huber's delta, targets near and far from 0.
    preds = (rng.normal(size=(16, 1)) * 2).astype(np.float32)
    targets = rng.normal(size=(16, 1)).astype(np.float32)
    want = float(jax_losses.get_loss(name)(jnp.asarray(preds),
                                           jnp.asarray(targets)))
    got = losses.get_loss(name)(torch.from_numpy(preds),
                                torch.from_numpy(targets))
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


SCHEDULE_CASES = [(w, t) for w in (0, 1, 3, 8) for t in (1, 2, 9, 16)
                  if w < t or w == 0]


@pytest.mark.parametrize("name", ["constant", "warmup_linear_decay",
                                  "warmup_cosine"])
@pytest.mark.parametrize("warmup,total", SCHEDULE_CASES)
def test_schedules_match_at_every_step(name, warmup, total):
    kw = dict(learning_rate=1.0, warmup_steps=warmup, total_steps=total)
    if name == "warmup_cosine" and max(total, 2) <= max(warmup, 1):
        with pytest.raises(ValueError):
            jax_schedules.get_schedule(name, **kw)(0)
        with pytest.raises(ValueError):
            schedules.get_schedule(name, **kw)
        return
    want = jax_schedules.get_schedule(name, **kw)
    got = schedules.get_schedule(name, **kw)
    for step in range(total + 3):
        # Both in float32; the cosine may differ in its last bit.
        np.testing.assert_allclose(got(step), float(want(step)), atol=1e-7,
                                   err_msg=f"step {step}")


def test_warmup_zero_gives_the_peak_at_step_zero():
    sched = schedules.get_schedule("warmup_linear_decay", learning_rate=1.0,
                                   warmup_steps=0, total_steps=4)
    assert [sched(s) for s in range(6)] == [1.0, 0.75, 0.5, 0.25, 0.0, 0.0]


SHAPES = {"w": (3, 4), "b": (5,), "v": (2, 2, 2)}
OPT_CASES = {
    "plain": dict(momentum=0.0, wd=0.0, clip=0.0),
    "momentum_wd": dict(momentum=0.9, wd=0.05, clip=0.0),
    "clipped": dict(momentum=0.0, wd=0.0, clip=0.5),
    "all": dict(momentum=0.5, wd=0.1, clip=1.0),
}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_five_updates_match_the_optax_chain(name, case):
    c = OPT_CASES[case]
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    kw = dict(learning_rate=1.0, warmup_steps=2, total_steps=6)

    jtx = jax_optimizers.make_injected_optimizer(
        name, jax_schedules.get_schedule("warmup_linear_decay", **kw),
        momentum=c["momentum"], gradient_clipping=c["clip"])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_optimizers.set_injected_hyperparams(jtx.init(jp), 0.03, c["wd"])

    tx = optimizers.make_injected_optimizer(
        name, schedules.get_schedule("warmup_linear_decay", **kw),
        momentum=c["momentum"], gradient_clipping=c["clip"])
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = optimizers.set_injected_hyperparams(tx.init(tp), 0.03, c["wd"])

    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        optimizers.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       atol=1e-6, err_msg=k)
    assert ts["count"] == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)


def test_global_norm_matches_optax():
    rng = np.random.default_rng(2)
    tree = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    want = float(optax.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = optimizers.global_norm({k: torch.from_numpy(v)
                                  for k, v in tree.items()})
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["lamb", "adafactor", "lion"])
def test_unported_optimizers_raise_naming_roadmap(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizers.make_injected_optimizer(name, lambda s: 1.0)


def test_gradient_accumulation_and_unknown_names_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizers.check_supported("adam", accumulate_grad_batches=4)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optimizers.check_supported("adagrad")
    assert optimizers.check_supported("AdamW") == "adamw"
