"""The training knobs of the port's trainable against the JAX package's:
lamb, adafactor and lion, gradient accumulation, and remat.

``train_regressor`` runs on both sides from the same flax-initialized
weights (carried over with ``from_flax_params``) and the same batch order
(the JAX program's own ``jax.random.permutation`` of the rows), with
dropout off; its records' ``lr`` and ``steps`` must agree bit for bit and
its final parameters within the trainable tolerance.  Remat is held
against no remat in the port (every policy, the flash attention's plain
version, dropout on), and against the JAX ``nn.remat`` model.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
# A non-reentrant torch.utils.checkpoint imports torch._dynamo on its first
# call, which sets TORCHINDUCTOR_CACHE_DIR in os.environ; import it here,
# before restore_global_state takes its copy of the environment.
import torch._dynamo  # noqa: E402,F401

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
    layers,
)
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    from_flax_params,
)
from distributed_machine_learning_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
)
from distributed_machine_learning_tpu_torch.ops.losses import mse_loss  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    trainable as port_trainable,
)
from distributed_machine_learning_tpu_torch.tune.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
from _torch_tune_common import restore_global_state  # noqa: E402,F401

jax_optimizers = importlib.import_module(
    "distributed_machine_learning_tpu.ops.optimizers")

CPU = torch.device("cpu")
# d_model 128 and FF 256: adafactor factors the feed-forward kernels.
MODEL = dict(model="transformer", d_model=128, num_heads=2, num_layers=2,
             dim_feedforward=256, attention_type="flash", dropout=0.0,
             max_seq_length=16)
TRIAL = dict(MODEL, learning_rate=3e-3, num_epochs=2, batch_size=8,
             lr_schedule="warmup_linear_decay", warmup_steps=1,
             gradient_clipping=1.0, weight_decay=1e-3, seed=3)
DATA = dict(num_samples=40, seq_len=12, num_features=4)  # 4 steps an epoch
DATA_7 = dict(num_samples=44, seq_len=12, num_features=4)  # 7 of batch 5
# The trainable tolerance of tests/test_torch_train.py.
PARAM_ATOL = 1e-4


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


def _both(config, data, monkeypatch, checkpoint=None):
    """The JAX trainable's and the port's records and checkpoints, the
    port fed the JAX initial weights and batch order."""
    jtrain, jval = jax_dummy(**data)
    jrec, jck = [], []
    with jax_tune.standalone():
        jax_tune.session._get_session()._report_fn = _recorder(jrec, jck)
        jax_tune.with_parameters(jax_tune.train_regressor, train_data=jtrain,
                                 val_data=jval)(config)
    params0 = jax_build(config).init(
        init_rngs_for(int(config["seed"])), jnp.asarray(jtrain.x[:1]),
        deterministic=True)["params"]
    state0 = from_flax_params(jax.tree.map(np.asarray, params0))

    def load(model, generator):
        model.load_state_dict(state0)
        return model

    monkeypatch.setattr(port_trainable, "init_parameters", load)
    monkeypatch.setattr(port_trainable, "epoch_permutation", _jax_perm)
    rec, ck = _run_port(config, data, checkpoint)
    return jrec, jck, rec, ck


def _run_port(config, data, checkpoint=None):
    train, val = dummy_regression_data(**data)
    records, checkpoints = [], []
    with tune.session.standalone(devices=[CPU],
                                 report_fn=_recorder(records, checkpoints)):
        tune.session._get_session()._checkpoint_loader = lambda: checkpoint
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val)(config)
    return records, checkpoints


def _assert_params_close(port_params, jax_params, bound):
    want = from_flax_params(jax.tree.map(np.asarray, jax_params))
    for k, w in want.items():
        got = port_params[k]
        if k.endswith("attention.key.bias"):
            # Its exact gradient is 0 (the softmax cancels a per-row
            # shift); what each side steps on is rounding noise.
            assert got.abs().max() <= bound and w.abs().max() <= bound, k
            continue
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=PARAM_ATOL,
                                   err_msg=k)


KNOB_CASES = {
    "lamb": (dict(optimizer="lamb"), DATA),
    "adafactor": (dict(optimizer="adafactor"), DATA),
    "lion": (dict(optimizer="lion", learning_rate=3e-4), DATA),
    "adamw_accum2": (dict(optimizer="adamw", accumulate_grad_batches=2), DATA),
    "adafactor_accum4_7steps": (dict(optimizer="adafactor", batch_size=5,
                                     accumulate_grad_batches=4), DATA_7),
    "lion_accum4_7steps": (dict(optimizer="lion", learning_rate=3e-4,
                                batch_size=5, accumulate_grad_batches=4),
                           DATA_7),
}


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_train_regressor_matches_the_jax_trainable(case, monkeypatch):
    override, data = KNOB_CASES[case]
    config = dict(TRIAL, **override)
    jrec, jck, rec, ck = _both(config, data, monkeypatch)
    assert [r["lr"] for r in rec] == [r["lr"] for r in jrec]
    assert [r["steps"] for r in rec] == [r["steps"] for r in jrec]
    assert set(rec[0]) == set(jrec[0])
    accum = int(config.get("accumulate_grad_batches", 1))
    steps = rec[0]["steps"]
    opt_steps = len(rec) * max(steps // accum, 1)
    _assert_params_close(ck[-1]["params"], jck[-1]["params"],
                         2 * config["learning_rate"] * opt_steps)
    for r, jr in zip(rec, jrec):
        np.testing.assert_allclose(r["train_loss"], jr["train_loss"],
                                   rtol=1e-4)


def test_accumulation_moves_the_parameters_every_kth_micro_step():
    # 7 micro-steps an epoch, k = 4: updates at 4, 8 (epoch 2's first), 12.
    config = dict(TRIAL, optimizer="adamw", batch_size=5,
                  accumulate_grad_batches=4, num_epochs=2)
    emitted = []
    real_update = port_trainable.make_optimizer

    def recording(*args, **kwargs):
        tx = real_update(*args, **kwargs)
        update = tx.update

        def counted(grads, state, params):
            out = update(grads, state, params)
            emitted.append(bool(out))
            return out

        tx.update = counted
        return tx

    port_trainable.make_optimizer = recording
    try:
        records, ckpts = _run_port(config, DATA_7)
    finally:
        port_trainable.make_optimizer = real_update
    assert [i + 1 for i, e in enumerate(emitted) if e] == [4, 8, 12]
    opt = ckpts[-1]["opt_state"]
    assert opt["mini_step"] == 14 % 4 and opt["gradient_step"] == 3
    assert [r["steps"] for r in records] == [7, 14]


def test_a_baked_state_resumes_from_its_checkpoint_bit_for_bit(tmp_path):
    # adafactor under MultiSteps, its mini_step carried past an epoch end,
    # saved through the pickle-free checkpoint and loaded back.
    config = dict(TRIAL, optimizer="adafactor", batch_size=5,
                  accumulate_grad_batches=4, dropout=0.1)
    records, ckpts = _run_port(config, DATA_7)
    path = str(tmp_path / "ckpt_000001.json")
    save_checkpoint(path, ckpts[0])
    loaded = load_checkpoint(path)
    assert loaded["opt_state"]["mini_step"] == 3
    assert "hyperparams" not in loaded["opt_state"]["inner_opt_state"]
    resumed, resumed_ckpts = _run_port(config, DATA_7, checkpoint=loaded)
    assert [r["epoch"] for r in resumed] == [1]
    for a, b in zip(resumed, records[1:]):
        assert a["train_loss"] == b["train_loss"] and a["lr"] == b["lr"]
    for k, v in ckpts[-1]["params"].items():
        assert torch.equal(resumed_ckpts[-1]["params"][k], v), k


# -- remat --------------------------------------------------------------------

REMAT_MODEL = dict(model="transformer", d_model=16, num_heads=2, num_layers=2,
                   dim_feedforward=32, attention_type="flash", dropout=0.1,
                   stochastic_depth_rate=0.1, max_seq_length=16)
POLICIES = [None, "nothing_saveable", "everything_saveable", "dots_saveable",
            "checkpoint_dots", "dots_with_no_batch_dims_saveable"]


def _step(config, run_block=None):
    """Loss, gradients and the dropout generator's end state of one
    training step of ``config`` from fixed weights and inputs."""
    model = build_model(config, 4)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.train()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 12, 4)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(4, 1)).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    if run_block is not None:
        for i in range(model.num_layers):
            layer = getattr(model, f"layer_{i}")
            layer.forward = run_block(layer.forward)
    loss = mse_loss(model(x, rng=gen), y)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, gen.get_state()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gives_the_same_outputs_and_gradients(policy, shared):
    base = dict(REMAT_MODEL, shared_weights=shared)
    loss, grads, gen_state = _step(base)
    r_loss, r_grads, r_gen_state = _step(dict(base, remat=True,
                                              remat_policy=policy))
    assert torch.equal(r_loss, loss)
    for a, b in zip(r_grads, grads):
        assert torch.equal(a, b)
    # The generator advanced once: the recompute replayed its draws.
    assert torch.equal(r_gen_state, gen_state)


def test_plain_checkpoint_redraws_the_masks_of_an_explicit_generator():
    from torch.utils.checkpoint import checkpoint

    loss, grads, gen_state = _step(REMAT_MODEL)

    def plain(forward):
        return lambda x, rng=None: checkpoint(forward, x, rng,
                                              use_reentrant=False)

    p_loss, p_grads, p_gen_state = _step(REMAT_MODEL, run_block=plain)
    assert torch.equal(p_loss, loss)  # the forward draws the same masks
    assert any(not torch.equal(a, b) for a, b in zip(p_grads, grads))
    assert not torch.equal(p_gen_state, gen_state)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "everything_saveable"])
def test_remat_reruns_each_flash_forward_in_the_backward(policy,
                                                        monkeypatch):
    calls = {"fwd": 0, "dkdv": 0, "dq": 0}
    for key, name in (("fwd", "flash_attention_reference"),
                      ("dkdv", "flash_bwd_dkdv_reference"),
                      ("dq", "flash_bwd_dq_reference")):
        fn = getattr(fa, name)

        def counted(*args, _fn=fn, _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(fa, name, counted)
    _step(REMAT_MODEL)
    assert calls == {"fwd": 2, "dkdv": 2, "dq": 2}
    calls.update(fwd=0, dkdv=0, dq=0)
    _step(dict(REMAT_MODEL, remat=True, remat_policy=policy))
    # everything_saveable keeps every residual, as in JAX: no rerun.
    reruns = 1 if policy == "everything_saveable" else 2
    assert calls == {"fwd": 2 * reruns, "dkdv": 2, "dq": 2}


def test_everything_saveable_runs_one_plain_forward_per_layer(monkeypatch):
    """Fault C1's repair: ``everything_saveable`` takes no checkpoint, so
    each layer's flash forward runs once and the step equals remat off's
    bit for bit (dropout on)."""
    import torch.utils.checkpoint as tuc

    loss, grads, gen_state = _step(REMAT_MODEL)
    fwd = [0]
    plain = fa.flash_attention_reference

    def counted(*args, **kwargs):
        fwd[0] += 1
        return plain(*args, **kwargs)

    def no_checkpoint(*args, **kwargs):
        raise AssertionError("everything_saveable took a checkpoint")

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    monkeypatch.setattr(layers, "checkpoint", no_checkpoint)
    monkeypatch.setattr(tuc, "checkpoint", no_checkpoint)
    s_loss, s_grads, s_gen_state = _step(
        dict(REMAT_MODEL, remat=True, remat_policy="everything_saveable"))
    assert fwd[0] == REMAT_MODEL["num_layers"]
    assert torch.equal(s_loss, loss)
    for a, b in zip(s_grads, grads):
        assert torch.equal(a, b)
    assert torch.equal(s_gen_state, gen_state)


def test_unknown_remat_policy_raises_the_jax_wording():
    with pytest.raises(ValueError, match="Unknown remat policy 'bogus'; "
                                         "expected one of"):
        build_model(dict(REMAT_MODEL, remat=True, remat_policy="bogus"), 4)
    # As in flax, the name is read only with remat on.
    build_model(dict(REMAT_MODEL, remat_policy="bogus"), 4)
    assert layers.resolve_remat_policy("none") is None


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_remat_model_matches_the_jax_remat_model(policy):
    config = dict(REMAT_MODEL, dropout=0.0, stochastic_depth_rate=0.0,
                  remat=True, remat_policy=policy)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 12, 4)).astype(np.float32)
    y = rng.normal(size=(4, 1)).astype(np.float32)
    flax_model = jax_build(config)
    params = flax_model.init({"params": jax.random.key(0),
                              "dropout": jax.random.key(1)},
                             jnp.asarray(x[:1]), deterministic=True)["params"]

    def loss_fn(p):
        preds = flax_model.apply({"params": p}, jnp.asarray(x),
                                 deterministic=False,
                                 rngs={"dropout": jax.random.key(2)})
        return jnp.mean((preds - jnp.asarray(y)) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model = build_model(config, 4)
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    model.train()
    loss = mse_loss(model(torch.from_numpy(x), rng=torch.Generator()),
                    torch.from_numpy(y))
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_params(jax.tree.map(np.asarray, want_grads))
    for k, w in want.items():
        if k.endswith("attention.key.bias"):
            continue  # exact gradient 0: rounding noise on both sides
        scale = max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(),
                                   atol=1e-5 * scale, err_msg=k)


# -- what the population refuses ---------------------------------------------

def _population(config, tmp_path):
    train, val = dummy_regression_data(**DATA)
    return tune.run_vectorized(dict(config, num_epochs=1), train_data=train,
                               val_data=val, metric="validation_mape",
                               device="cpu", num_samples=1,
                               storage_path=str(tmp_path), verbose=0)


@pytest.mark.parametrize("name", ["lamb", "adafactor", "lion"])
def test_run_vectorized_refuses_non_injectable_optimizers(name, tmp_path):
    with pytest.raises(ValueError) as want:
        jax_optimizers.make_injected_optimizer(name, lambda s: 1.0)
    with pytest.raises(ValueError) as got:
        _population(dict(REMAT_MODEL, learning_rate=1e-3, optimizer=name),
                    tmp_path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob,match", [
    (dict(accumulate_grad_batches=2), "never reads accumulate_grad_batches"),
])
def test_run_vectorized_refuses_accumulation_and_remat_by_name(knob, match,
                                                               tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        _population(dict(REMAT_MODEL, learning_rate=1e-3, **knob), tmp_path)
