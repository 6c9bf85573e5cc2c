"""Remat in a population: the port's ``run_vectorized(remat=True)``.

* Port against port, dropout 0.1: one population epoch of a remat group
  under each of the five ``remat_policy`` names, for
  ``scaled_dot_product`` and ``flash`` attention, the shared-body form
  and an MoE feed-forward, equals the same group with remat off bit for
  bit: the epoch's losses, the eval sums, every parameter, and the row
  streams' sites after each step.  A whole ``run_vectorized`` sweep with
  remat gives remat off's records and final checkpoints bit for bit.
* Against the JAX package, dropout 0: the JAX ``_GroupProgram`` with
  ``remat=True`` and three of the policies (its vmapped ``nn.remat``;
  each JAX compile takes ~10 s here, and the port's other names equal
  these bit for bit), fed to the
  port's group as its initial rows and its own permutations: losses and
  metrics within ``rtol=1e-5``, parameters within ``atol=1e-4`` (the
  attention key biases within the steps adam can take, as in
  tests/test_torch_vectorized.py).
* What the recompute does: the flash forward runs twice per layer per
  step (once under ``everything_saveable``), a dots policy hands its
  products back to the rerun, and a block that is no module is refused
  rather than run without remat.
* ``remat`` and ``remat_policy`` group configs as the JAX runner groups
  them, and the epoch FLOPs count the rerun (4x the forward).

Every test runs under ``no_cache_no_orphans`` (HOME in ``tmp_path``).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tune_common import jax_disk_cache_off  # noqa: E402,F401
from _torch_tune_common import (  # noqa: F401
    no_cache_no_orphans,
    restore_global_state,
)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
# torch.func imports torch._dynamo, which sets TORCHINDUCTOR_CACHE_DIR:
# import it before restore_global_state takes its copy of the environment.
import torch._dynamo  # noqa: E402,F401

from distributed_machine_learning_tpu.data import (  # noqa: E402
    dummy_regression_data as jax_dummy,
)
from distributed_machine_learning_tpu_torch import tune  # noqa: E402
from distributed_machine_learning_tpu_torch.data import (  # noqa: E402
    dummy_regression_data,
)
from distributed_machine_learning_tpu_torch.models import layers  # noqa: E402
from distributed_machine_learning_tpu_torch.models.convert import (  # noqa: E402
    population_from_flax,
)
from distributed_machine_learning_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
    flops as port_flops,
)
from distributed_machine_learning_tpu_torch.ops.rng import RowStream  # noqa: E402
from distributed_machine_learning_tpu_torch.tune import (  # noqa: E402
    _regression_program as port_program,
    vectorized as port_vec,
)
from distributed_machine_learning_tpu_torch.tune.checkpoint import (  # noqa: E402
    load_checkpoint,
)

jax_vec = importlib.import_module(
    "distributed_machine_learning_tpu.tune.vectorized")
jax_flops = importlib.import_module("distributed_machine_learning_tpu.ops.flops")

pytestmark = pytest.mark.usefixtures("no_cache_no_orphans")

CPU = torch.device("cpu")
DATA = dict(num_samples=40, seq_len=12, num_features=4)  # 4 steps of 8
MODEL = dict(model="transformer", d_model=16, num_heads=2, num_layers=2,
             dim_feedforward=32, dropout=0.1, max_seq_length=16,
             batch_size=8, num_epochs=2, learning_rate=1e-3,
             weight_decay=0.0, seed=0)
POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable",
            "checkpoint_dots", "dots_with_no_batch_dims_saveable")
SEEDS, LRS, WDS = [0, 1, 2], [1e-3, 3e-3, 1e-2], [0.0, 1e-4, 1e-3]
# The trainable tolerances of tests/test_torch_vectorized.py.
RTOL, PARAM_ATOL = 1e-5, 1e-4
VARIANTS = {
    "sdpa": dict(attention_type="scaled_dot_product"),
    "flash": dict(attention_type="flash"),
    "shared": dict(attention_type="flash", shared_weights=True),
    "moe": dict(feedforward_type="moe", num_experts=4),
}


class _Recorded(RowStream):
    """A row stream that keeps every instance, so a test reads the sites
    each step's stream ended at."""

    made: list = []

    def __init__(self, *args):
        super().__init__(*args)
        _Recorded.made.append(self)


def _epoch(config, monkeypatch):
    """One population epoch of ``config``'s group on three rows: its mean
    losses, eval sums, final parameters and each step's last site."""
    monkeypatch.setattr(port_program, "RowStream", _Recorded)
    _Recorded.made = []
    train, val = dummy_regression_data(**DATA)
    program = port_vec._GroupProgram(config, train, val, CPU)
    state = program.init_population(SEEDS, LRS, WDS)
    losses = program.train_epoch(state, 0)
    sums = program.eval_sums(state)
    return (losses, sums, {k: v.clone() for k, v in state.params.items()},
            [s.site for s in _Recorded.made])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_remat_population_epoch_is_remat_off_bit_for_bit(variant, policy,
                                                          monkeypatch):
    base = dict(MODEL, **VARIANTS[variant])
    want = _epoch(base, monkeypatch)
    got = _epoch(dict(base, remat=True, remat_policy=policy), monkeypatch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    for k, v in want[2].items():
        assert torch.equal(got[2][k], v), k
    # Each step's stream ends where a plain forward leaves it.
    assert got[3] == want[3] and len(want[3]) == 4 and want[3][0] > 0


def test_remat_sweep_records_and_checkpoints_are_remat_off(tmp_path):
    train, val = dummy_regression_data(**DATA)
    space = dict(MODEL, attention_type="flash",
                 learning_rate=tune.loguniform(1e-3, 1e-2),
                 seed=tune.randint(0, 1000))

    def sweep(name, **extra):
        return tune.run_vectorized(
            dict(space, **extra), train_data=train, val_data=val,
            metric="validation_mape", num_samples=3, max_batch_trials=3,
            storage_path=str(tmp_path), name=name, device="cpu", verbose=0)

    off = sweep("off")
    on = sweep("on", remat=True, remat_policy="dots_saveable")

    def plain(record):
        return {k: v for k, v in record.items()
                if k not in ("timestamp", "time_total_s")}

    assert [t.trial_id for t in on.trials] == [t.trial_id for t in off.trials]
    for a, b in zip(on.trials, off.trials):
        assert a.config["remat"] and "remat" not in b.config
        assert [plain(r) for r in a.results] == [plain(r) for r in b.results]
        pa = load_checkpoint(a.latest_checkpoint)["params"]
        pb = load_checkpoint(b.latest_checkpoint)["params"]
        assert all(torch.equal(pa[k], v) for k, v in pb.items())


# -- against the JAX runner -----------------------------------------------------

def _jax_group(cfg):
    """The JAX ``_GroupProgram``'s first epoch on three rows: initial
    rows, its own permutations, mean losses, metrics and final rows."""
    train, val = jax_dummy(**DATA)
    program = jax_vec._GroupProgram(cfg, train, val)
    keys = jax.vmap(jax.random.key)(jnp.asarray(SEEDS, jnp.uint32))
    params, opt, bs = program.init_population(
        keys, jnp.asarray(LRS, jnp.float32), jnp.asarray(WDS, jnp.float32))
    params0 = jax.tree.map(np.asarray, params)
    epoch_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(k)[0], program.data.n_train)) for k in epoch_keys])
    d = program.data
    params, opt, bs, tl = program.train_epoch(params, opt, bs, d.x_train,
                                              d.y_train, epoch_keys)
    metrics = program.eval_population(params, bs, d.x_val, d.y_val,
                                      d.val_mask)
    return (params0, perms, np.asarray(tl),
            {k: np.asarray(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, params))


# Three of the JAX compiles (each ~10 s here); the other names equal
# these bit for bit in the port (the first test).
@pytest.mark.parametrize("policy,attention", [
    ("nothing_saveable", "scaled_dot_product"),
    ("dots_with_no_batch_dims_saveable", "scaled_dot_product"),
    ("dots_saveable", "flash"),
])
def test_remat_population_matches_the_jax_runner(policy, attention):
    cfg = dict(MODEL, dropout=0.0, attention_type=attention, remat=True,
               remat_policy=policy)
    params0, perms, want_tl, want_m, want_params = _jax_group(cfg)
    train, val = dummy_regression_data(**DATA)
    program = port_vec._GroupProgram(cfg, train, val, CPU)
    assert program.model.remat
    state = program.init_population(SEEDS, LRS, WDS)
    state.params.update(population_from_flax(params0))
    tl = program.train_epoch(state, 0, perms=torch.from_numpy(perms).long())
    sums = program.eval_sums(state).numpy().astype(np.float64)
    np.testing.assert_allclose(tl.numpy(), want_tl, rtol=RTOL)
    for r in range(len(SEEDS)):
        got = port_vec.eval_metrics_from_sums("mse", *sums[r], len(val))
        for k, v in got.items():
            np.testing.assert_allclose(v, want_m[k][r], rtol=RTOL,
                                       err_msg=f"row {r} {k}")
    bound = max(LRS) * program.steps_per_epoch
    for k, w in population_from_flax(want_params).items():
        got = state.params[k]
        if k.endswith("attention.key.bias"):
            # Zero in exact arithmetic: both stay within adam's steps.
            assert got.abs().max() <= bound and w.abs().max() <= bound
            continue
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=PARAM_ATOL,
                                   err_msg=k)


# -- what the recompute does ------------------------------------------------------

def _counting(monkeypatch):
    calls = {"flash_forward": 0, "replayed": 0}
    forward = fa.flash_attention_reference

    def counted(*args, **kwargs):
        calls["flash_forward"] += 1
        return forward(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    dispatch = layers._DotsTape.__torch_dispatch__

    def replaying(self, func, types, args=(), kwargs=None):
        if self.replay and func in self.ops:
            calls["replayed"] += 1
        return dispatch(self, func, types, args, kwargs)

    monkeypatch.setattr(layers._DotsTape, "__torch_dispatch__", replaying)
    return calls


@pytest.mark.parametrize("policy,forwards,replays", [
    (None, 1, 0), ("everything_saveable", 1, 0), ("nothing_saveable", 2, 0),
    # Under vmap a row's dense products are batched: what a dots policy
    # keeps are its bmm outputs (6 per block, and the plain flash's 2).
    ("dots_saveable", 2, 8), ("checkpoint_dots", 2, 8),
    # ... and it keeps none without batch dimensions, as JAX's vmapped
    # policy does.
    ("dots_with_no_batch_dims_saveable", 2, 0),
])
def test_the_recompute_reruns_the_forward_and_replays_the_products(
        policy, forwards, replays, monkeypatch):
    cfg = dict(MODEL, attention_type="flash")
    if policy:
        cfg.update(remat=True, remat_policy=policy)
    train, val = dummy_regression_data(**DATA)
    program = port_vec._GroupProgram(cfg, train, val, CPU)
    state = program.init_population(SEEDS, LRS, WDS)
    calls = _counting(monkeypatch)
    program.train_epoch(state, 0)
    steps, layers_n = program.steps_per_epoch, MODEL["num_layers"]
    assert calls["flash_forward"] == forwards * layers_n * steps
    assert calls["replayed"] == replays * layers_n * steps


def test_a_block_that_is_no_module_is_refused():
    seed = torch.tensor(3, dtype=torch.int64)
    with pytest.raises(TypeError, match="nn.Module block"):
        layers.population_remat(lambda x, rng: x, torch.ones(2, 3),
                                RowStream(seed, 0))


def test_the_sites_end_where_a_plain_block_leaves_them():
    block = layers.EncoderLayer(d_model=8, num_heads=2, dim_feedforward=16,
                                dropout_rate=0.5)
    block.train()
    x = torch.randn(2, 5, 8)
    plain, rematted = RowStream(torch.tensor(9), 4), RowStream(
        torch.tensor(9), 4)
    plain.site = rematted.site = 3
    want = block(x, plain)
    got = layers.remat_call(block, x, rematted,
                            layers.resolve_remat_policy("dots_saveable"))
    assert torch.equal(got, want) and rematted.site == plain.site == 5


# -- grouping and accounting ------------------------------------------------------

REMAT_CONFIGS = [
    dict(MODEL, seed=1),
    dict(MODEL, seed=2, remat=True),
    dict(MODEL, seed=3, remat=True, remat_policy="dots_saveable"),
    dict(MODEL, seed=4, remat=True, remat_policy="dots_saveable",
         learning_rate=5e-3),
    dict(MODEL, seed=5, remat=True, remat_policy="nothing_saveable"),
]


def test_remat_keys_group_as_the_jax_runner():
    assert [port_vec._static_signature(c) for c in REMAT_CONFIGS] == \
        [jax_vec._static_signature(c) for c in REMAT_CONFIGS]
    assert len({port_vec._static_signature(c) for c in REMAT_CONFIGS}) == 4


@pytest.mark.parametrize("remat", [False, True])
def test_epoch_flops_count_the_rerun_as_the_jax_accounting(remat):
    cfg = dict(MODEL, remat=remat, remat_policy="dots_saveable")
    args = (cfg, 8, 12, 4, 4, 8)
    assert port_flops.epoch_flops(*args) == jax_flops.epoch_flops(*args)
    off = port_flops.epoch_flops(dict(cfg, remat=False), 8, 12, 4, 4)
    on = port_flops.epoch_flops(dict(cfg, remat=True), 8, 12, 4, 4)
    assert on == pytest.approx(off * 4 / 3)
