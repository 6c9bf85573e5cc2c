"""The port's training path against the JAX package's.

A small flash transformer (2 layers, d_model 16, 2 heads, seq 12, 4
features, dropout 0, f32) starts from flax-initialized weights carried over
with ``from_flax_params``; both epoch programs see the JAX program's own
``jax.random.permutation`` of the rows.  Then ``train_regressor`` itself:
its record keys and lr against the JAX trainable's, resuming from a
reported checkpoint, and seeded dropout.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
torch.set_num_threads(1)

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.data import (  # noqa: E402
    dummy_regression_data as jax_dummy,
)
from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu.tune import (  # noqa: E402
    _regression_program as jax_program,
)
from distributed_machine_learning_tpu.utils.seeding import fold_seed  # noqa: E402
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.models import build_model  # noqa: E402
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params,
)
from distributed_machine_learning_tpu_torch.ops import (  # noqa: E402
    optimizers as port_optimizers,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    _regression_program as port_program,
)

jax_optimizers = importlib.import_module(
    "distributed_machine_learning_tpu.ops.optimizers")
jax_schedules = importlib.import_module(
    "distributed_machine_learning_tpu.ops.schedules")
jax_losses = importlib.import_module("distributed_machine_learning_tpu.ops.losses")
port_schedules = importlib.import_module(
    "distributed_machine_learning_tpu_torch.ops.schedules")
port_losses = importlib.import_module(
    "distributed_machine_learning_tpu_torch.ops.losses")

CPU = torch.device("cpu")
MODEL = dict(model="transformer", d_model=16, num_heads=2, num_layers=2,
             dim_feedforward=32, attention_type="flash", dropout=0.0,
             max_seq_length=16)
DATA = dict(num_samples=40, seq_len=12, num_features=4)
EPOCHS, LR, BATCH = 3, 3e-3, 8


def _jax_run(train, val, params):
    data = jax_program.stage_data(train, val, BATCH, jnp.float32)
    total = EPOCHS * data.num_batches
    tx = jax_optimizers.make_injected_optimizer(
        "adam", jax_schedules.get_schedule(
            "warmup_linear_decay", learning_rate=1.0, warmup_steps=2,
            total_steps=total))
    opt = jax_optimizers.set_injected_hyperparams(tx.init(params), LR, 0.0)
    forward = jax_program.make_forward(jax_build(MODEL), "deterministic",
                                       False)
    epoch_fn = jax.jit(jax_program.make_epoch_fn(
        forward, tx, jax_losses.get_loss("mse"), data.n_train,
        data.num_batches, data.batch_size))
    eval_fn = jax.jit(jax_program.make_eval_fn(
        forward, "mse", data.n_val_blocks, data.eval_bs))
    perms, losses, metrics = [], [], []
    for epoch in range(EPOCHS):
        key = jax.random.key(fold_seed(0, "epoch", epoch))
        perm_key, _ = jax.random.split(key)  # the program's own split
        perms.append(np.asarray(jax.random.permutation(perm_key,
                                                       data.n_train)))
        params, opt, _, loss = epoch_fn(params, opt, {}, data.x_train,
                                        data.y_train, key)
        losses.append(float(loss))
        m = eval_fn(params, {}, data.x_val, data.y_val, data.val_mask)
        metrics.append({k: float(v) for k, v in m.items()})
    return perms, losses, metrics, params


def test_epoch_and_eval_match_the_jax_programs():
    jtrain, jval = jax_dummy(**DATA)
    flax_model = jax_build(MODEL)
    params0 = flax_model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.asarray(jtrain.x[:1]), deterministic=True,
    )["params"]
    perms, want_losses, want_metrics, want_params = _jax_run(
        jtrain, jval, params0)

    train, val = dummy_regression_data(**DATA)
    model = build_model(MODEL, DATA["num_features"])
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params0)))
    data = port_program.stage_data(train, val, BATCH, torch.float32, CPU)
    tx = port_optimizers.make_injected_optimizer(
        "adam", port_schedules.get_schedule(
            "warmup_linear_decay", learning_rate=1.0, warmup_steps=2,
            total_steps=EPOCHS * data.num_batches))
    opt = port_optimizers.set_injected_hyperparams(
        tx.init(dict(model.named_parameters())), LR, 0.0)
    epoch_fn = port_program.make_epoch_fn(
        model, tx, port_losses.get_loss("mse"), data.n_train,
        data.num_batches, data.batch_size)
    eval_fn = port_program.make_eval_fn(model, "mse", data.n_val_blocks,
                                        data.eval_bs)
    for epoch in range(EPOCHS):
        loss = float(epoch_fn(opt, data.x_train, data.y_train, perms[epoch],
                              None))
        metrics = eval_fn(data.x_val, data.y_val, data.val_mask)
        np.testing.assert_allclose(loss, want_losses[epoch], rtol=1e-5)
        assert metrics.keys() == want_metrics[epoch].keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(v, want_metrics[epoch][k], rtol=1e-5,
                                       err_msg=k)
    assert opt["count"] == EPOCHS * data.num_batches
    want = from_flax_params(jax.tree.map(np.asarray, want_params))
    got = model.state_dict()
    for k, w in want.items():
        if k.endswith("attention.key.bias"):
            # A key bias adds q.b to every logit of a row, which the softmax
            # cancels: its gradient is 0 up to rounding noise, and Adam
            # scales that noise to steps of ~lr, differently in each
            # framework.  Both stay within the steps Adam can take.
            bound = LR * EPOCHS * data.num_batches
            assert got[k].abs().max() <= bound and w.abs().max() <= bound
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-4,
                                   err_msg=k)


TRIAL = dict(MODEL, learning_rate=1e-3, num_epochs=3, batch_size=8,
             optimizer="adam", lr_schedule="warmup_linear_decay",
             warmup_steps=2)


def _recorder(records, checkpoints=None):
    def report(metrics, checkpoint):
        records.append(metrics)
        if checkpoints is not None:
            checkpoints.append(checkpoint)
        return "continue"

    return report


def _run_port(config, checkpoint=None):
    records, checkpoints = [], []
    train, val = dummy_regression_data(**DATA)
    trainable = tune.with_parameters(tune.train_regressor, train_data=train,
                                     val_data=val)
    with tune.session.standalone(devices=[CPU],
                                 report_fn=_recorder(records, checkpoints)):
        tune.session._get_session()._checkpoint_loader = lambda: checkpoint
        trainable(config)
    return records, checkpoints


def test_train_regressor_reports_the_reference_keys_and_lr():
    records, checkpoints = _run_port(TRIAL)
    train, val = jax_dummy(**DATA)
    jax_records = []
    with jax_tune.standalone():
        jax_tune.session._get_session()._report_fn = _recorder(jax_records)
        jax_tune.with_parameters(jax_tune.train_regressor, train_data=train,
                                 val_data=val)(TRIAL)
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert [r["steps"] for r in records] == [r["steps"] for r in jax_records]
    np.testing.assert_allclose([r["lr"] for r in records],
                               [r["lr"] for r in jax_records], rtol=1e-6)
    assert records[-1]["lr"] == 0.0
    assert set(records[0]) == set(jax_records[0])
    for r in records:
        assert np.isfinite(r["train_loss"]) and r["epoch_time_s"] > 0
        assert r["epoch_flops"] == jax_records[0]["epoch_flops"]
    assert set(checkpoints[0]) == {"params", "opt_state", "epoch",
                                   "generator"}


def test_restoring_a_reported_checkpoint_resumes_at_the_next_epoch():
    config = dict(TRIAL, dropout=0.1)
    records, checkpoints = _run_port(config)
    resumed, resumed_ckpts = _run_port(config, checkpoint=checkpoints[0])
    assert [r["epoch"] for r in resumed] == [1, 2]
    # The restored params, moments and dropout stream continue the run
    # exactly: the same records and the same final weights.
    for a, b in zip(resumed, records[1:]):
        assert a["train_loss"] == b["train_loss"]
        assert a["validation_mse"] == b["validation_mse"]
    for k, v in checkpoints[-1]["params"].items():
        assert torch.equal(resumed_ckpts[-1]["params"][k], v), k


def test_dropout_runs_are_identical_for_one_seed():
    config = dict(TRIAL, dropout=0.2, stochastic_depth_rate=0.1, seed=4)
    first, ck1 = _run_port(config)
    second, ck2 = _run_port(config)
    other, _ = _run_port(dict(config, seed=5))
    assert [r["train_loss"] for r in first] == [r["train_loss"] for r in second]
    for k, v in ck1[-1]["params"].items():
        assert torch.equal(ck2[-1]["params"][k], v), k
    assert [r["train_loss"] for r in first] != [r["train_loss"] for r in other]


def test_dropout_in_training_needs_an_explicit_generator():
    model = build_model(dict(MODEL, dropout=0.1), 4).train()
    x = torch.zeros(2, 12, 4)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(x)
    gen = torch.Generator().manual_seed(0)
    assert model(x, rng=gen).shape == (2, 1)
    model.eval()
    assert torch.equal(model(x), model(x))


@pytest.mark.parametrize("override,error", [
    (dict(seq_axis="sp"), NotImplementedError),
])
def test_unported_features_raise_naming_roadmap(override, error):
    with pytest.raises(error, match="ROADMAP"):
        _run_port(dict(TRIAL, **override))


def test_train_regressor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    train, val = dummy_regression_data(**DATA)
    with tune.session.standalone():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune.train_regressor(TRIAL, train_data=train, val_data=val)
