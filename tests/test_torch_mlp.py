"""The port's mlp family against the JAX package's.

``models/mlp.py`` with flax-initialized weights carried over by
``from_flax_params`` (its ``Dense_0`` ... ``Dense_n``), in f32 and bf16
compute; the port's input width read off ``Dense_0`` (the flattened
row); and ``train_regressor`` over ``model: "mlp"`` against the JAX
trainable, fed the JAX initial weights and batch order (dropout off), as
``tests/test_torch_knobs_train.py`` does for the transformer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_machine_learning_tpu import tune as jax_tune  # noqa: E402
from distributed_machine_learning_tpu.data import (  # noqa: E402
    dummy_regression_data as jax_dummy,
)
from distributed_machine_learning_tpu.models import build_model as jax_build  # noqa: E402
from distributed_machine_learning_tpu.utils.seeding import (  # noqa: E402
    fold_seed,
    init_rngs_for,
)
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.models import (  # noqa: E402
    build_model,
    init_parameters,
    input_width,
)
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params,
    input_features_of,
    to_flax_params,
)
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    trainable as port_trainable,
)

from _torch_tune_common import restore_global_state  # noqa: E402,F401

CPU = torch.device("cpu")
MLP = dict(model="mlp", hidden_sizes=[32, 16], dropout=0.0)
TRIAL = dict(MLP, learning_rate=3e-3, num_epochs=3, batch_size=8,
             lr_schedule="warmup_linear_decay", warmup_steps=1,
             weight_decay=1e-3, seed=3)
DATA = dict(num_samples=40, seq_len=12, num_features=5)
SEQ, FEATURES = 12, 5


def _flax(config, x):
    model = jax_build(config)
    params = model.init(jax.random.key(0), jnp.asarray(x))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("compute_dtype,tol", [(None, 1e-6),
                                               ("bfloat16", 2e-2)])
def test_forward_matches_flax_with_converted_weights(compute_dtype, tol):
    config = dict(MLP, compute_dtype=compute_dtype)
    x = np.random.default_rng(0).normal(size=(6, SEQ, FEATURES)).astype(
        np.float32)
    flax_model, params = _flax(config, x)
    width = input_features_of(params)
    assert width == input_width(config, x.shape[1:]) == SEQ * FEATURES
    model = build_model(config, width)
    model.load_state_dict(from_flax_params(params))
    got = model.eval()(torch.from_numpy(x)).float().detach().numpy()
    want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    assert got.shape == want.shape == (6, 1)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    # Tabular rows (no sequence axis) are not flattened further.
    flat = x.reshape(6, -1)
    np.testing.assert_allclose(
        model(torch.from_numpy(flat)).float().detach().numpy(), got,
        rtol=1e-6)


def test_names_and_init_order_follow_flax():
    model = build_model(MLP, SEQ * FEATURES)
    assert [n for n, _ in model.named_children()] == [
        "Dense_0", "Dropout_0", "Dense_1", "Dropout_1", "Dense_2"]
    a = init_parameters(build_model(MLP, 7), torch.Generator().manual_seed(1))
    b = init_parameters(build_model(MLP, 7), torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    tree = to_flax_params(a.state_dict())
    assert sorted(tree) == ["Dense_0", "Dense_1", "Dense_2"]
    assert tree["Dense_0"]["kernel"].shape == (7, 32)


def _recorder(records, checkpoints):
    def report(metrics, checkpoint):
        records.append(metrics)
        checkpoints.append(checkpoint)
        return "continue"

    return report


def _jax_perm(seed: int, epoch: int, n_train: int):
    key = jax.random.key(fold_seed(seed, "epoch", epoch))
    perm_key, _ = jax.random.split(key)  # the JAX epoch program's split
    return torch.from_numpy(np.array(
        jax.random.permutation(perm_key, n_train)))


def test_train_regressor_over_the_mlp_matches_the_jax_trainable(monkeypatch):
    jtrain, jval = jax_dummy(**DATA)
    jrec, jck = [], []
    with jax_tune.standalone():
        jax_tune.session._get_session()._report_fn = _recorder(jrec, jck)
        jax_tune.with_parameters(jax_tune.train_regressor, train_data=jtrain,
                                 val_data=jval)(TRIAL)
    params0 = jax_build(TRIAL).init(
        init_rngs_for(int(TRIAL["seed"])), jnp.asarray(jtrain.x[:1]),
        deterministic=True)["params"]
    state0 = from_flax_params(jax.tree.map(np.asarray, params0))

    def load(model, generator):
        model.load_state_dict(state0)
        return model

    monkeypatch.setattr(port_trainable, "init_parameters", load)
    monkeypatch.setattr(port_trainable, "epoch_permutation", _jax_perm)
    train, val = dummy_regression_data(**DATA)
    rec, ck = [], []
    with tune.session.standalone(devices=[CPU],
                                 report_fn=_recorder(rec, ck)):
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val)(TRIAL)
    assert len(rec) == len(jrec) == TRIAL["num_epochs"]
    assert set(rec[0]) == set(jrec[0])
    assert [r["lr"] for r in rec] == [r["lr"] for r in jrec]
    assert [r["steps"] for r in rec] == [r["steps"] for r in jrec]
    for r, jr in zip(rec, jrec):
        np.testing.assert_allclose(r["train_loss"], jr["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["validation_mape"],
                                   jr["validation_mape"], rtol=1e-5)
        # The analytic FLOPs of the flattened mlp agree too.
        assert r["epoch_flops"] == jr["epoch_flops"]
    want = from_flax_params(jax.tree.map(np.asarray, jck[-1]["params"]))
    for k, w in want.items():
        np.testing.assert_allclose(ck[-1]["params"][k].numpy(), w.numpy(),
                                   atol=1e-5, err_msg=k)
