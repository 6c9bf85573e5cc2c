"""The pieces of the built-in regression workload: epoch, eval, staging.

Port of ``distributed_machine_learning_tpu/tune/_regression_program.py``
(``per_example_losses``, ``make_epoch_fn``, ``eval_metrics_from_sums``,
``make_eval_fn``, ``StagedData``, ``stage_data``).  In the JAX package an
epoch is one jitted ``lax.scan``; here it is a Python loop of eager steps
on the device, with the same batches, loss, gradient and update order.
Two things become explicit arguments:

* the epoch's permutation of the training rows (the trainer draws it from
  a ``torch.Generator``; a test can hand in the JAX program's own
  ``jax.random.permutation``);
* the ``torch.Generator`` the dropout masks are drawn from, one draw after
  another through the epoch's steps.

``make_forward``/``detect_call_convention`` are not needed: a torch model
switches between training and evaluation with ``train()``/``eval()``.

The population forms (:func:`make_population_epoch_fn`,
:func:`make_population_eval_fn`) are what the JAX package gets from
``jax.vmap`` over the same bodies (``tune/vectorized.py``): K trials'
parameters stacked on a leading axis (``torch.func.stack_module_state``),
the loss through ``torch.func.functional_call``, and
``vmap(grad(loss))`` over (the row's parameters, the row's batch, the
row's dropout seed), so a step of K trials is one batched program.  Each
row draws its dropout masks from its own counter-based stream
(``ops/rng.py``), so nothing in a row depends on the others.

The PBT generation step (:func:`make_exploit_explore`,
:func:`make_pbt_generation_fn`) is the JAX package's
``make_pbt_generation_fn`` written in torch ops on the population's
device: ``interval`` population epochs, then the ranking, the exploit
gather and the lr/wd explore, generation after generation, with nothing
read back until the caller reads the stacked outputs.  There is no
``lax.scan``: the generations are enqueued one after another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.ops.losses import huber
from distributed_machine_learning_tpu_torch.ops.optimizers import (
    InjectedOptimizer,
    MultiSteps,
    Optimizer,
    PopulationOptimizer,
    apply_updates,
    set_injected_hyperparams,
    take_rows,
)
from distributed_machine_learning_tpu_torch.ops.rng import RowStream
from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
    RESAMPLE_GRID_POINTS,
    resample_grid,
)


def per_example_losses(preds: torch.Tensor, targets: torch.Tensor):
    """Per-example squared error, absolute error, and APE (for masked eval)."""
    se = torch.mean((preds - targets) ** 2, dim=-1)
    ae = torch.mean(torch.abs(preds - targets), dim=-1)
    ape = torch.mean(torch.abs(targets - preds) / (torch.abs(targets) + 1e-8),
                     dim=-1)
    return se, ae, ape


def make_epoch_fn(
    model: torch.nn.Module,
    tx: Union[InjectedOptimizer, Optimizer, MultiSteps],
    loss_fn: Callable,
    n_train: int,
    num_batches: int,
    batch_size: int,
) -> Callable:
    """One training epoch over ``model``'s parameters, updated in place.

    ``epoch(opt_state, x_all, y_all, perm, generator) -> mean_loss`` (a 0-d
    tensor on the device, not yet read back).  ``perm`` is a permutation of
    ``n_train`` rows; its first ``num_batches * batch_size`` entries are the
    epoch's batches in order.  ``tx`` is any of the port's optimizers; a
    ``MultiSteps`` micro-step returns no update and leaves the parameters
    as they are.
    """
    params = dict(model.named_parameters())

    def epoch(opt_state, x_all, y_all, perm, generator: Optional[torch.Generator]):
        perm = torch.as_tensor(
            np.asarray(perm[: num_batches * batch_size]).copy(),
            dtype=torch.long, device=x_all.device)
        if perm.numel() != num_batches * batch_size:
            raise ValueError(f"perm of {n_train} rows has too few entries")
        model.train()
        losses = []
        for idx in perm.reshape(num_batches, batch_size):
            xb, yb = x_all[idx], y_all[idx]
            preds = model(xb, rng=generator)
            loss = loss_fn(preds.float(), yb)
            grads = torch.autograd.grad(loss, list(params.values()))
            updates = tx.update(dict(zip(params, grads)), opt_state, params)
            apply_updates(params, updates)
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    return epoch


def eval_metrics_from_sums(
    loss_name: str, se: float, ae: float, ape: float, hub: float, count: float
) -> Dict[str, float]:
    """The validation metric dict from the masked sums over all rows."""
    count = max(float(count), 1e-9)
    mse = se / count
    mae = ae / count
    mape = 100.0 * ape / count
    huber_mean = hub / count
    rmse = float(np.sqrt(mse))
    by_name = {
        "mse": mse, "mae": mae, "mape": mape, "huber": huber_mean,
        "rmse": rmse,
    }
    return {
        "validation_loss": float(by_name.get(loss_name, mse)),
        "validation_mse": float(mse),
        "validation_rmse": float(rmse),
        "validation_mae": float(mae),
        "validation_mape": float(mape),
    }


# Metric names the eval produces (plus "train_loss" from the epoch): the
# keys a PBT generation step can rank on.
EVAL_METRIC_KEYS = (
    "validation_loss", "validation_mse", "validation_rmse",
    "validation_mae", "validation_mape",
)


def make_score_fn(metric: str, loss_name: str, n_val: int) -> Callable:
    """``score(train_losses [K], sums [K, 4]) -> [K]`` float32 on the
    device: the metric a PBT generation ranks on, computed from the eval
    sums in float64 exactly as :func:`eval_metrics_from_sums` computes it
    on the host, so the device ranks the same float32 scores the host
    would read back."""
    if metric != "train_loss" and metric not in EVAL_METRIC_KEYS:
        raise ValueError(
            f"PBT metric {metric!r} is not produced by this trainable "
            f"(have: train_loss, {', '.join(EVAL_METRIC_KEYS)})"
        )
    count = max(float(n_val), 1e-9)

    def score(train_losses: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
        if metric == "train_loss":
            return train_losses.float()
        se, ae, ape, hub = sums.double().unbind(-1)
        mse = se / count
        by_name = {"mse": mse, "mae": ae / count, "mape": 100.0 * ape / count,
                   "huber": hub / count, "rmse": torch.sqrt(mse)}
        value = {
            "validation_loss": by_name.get(loss_name, mse),
            "validation_mse": mse,
            "validation_rmse": by_name["rmse"],
            "validation_mae": by_name["mae"],
            "validation_mape": by_name["mape"],
        }[metric]
        return value.float()

    return score


def make_eval_fn(
    model: torch.nn.Module, loss_name: str, n_blocks: int, eval_bs: int
) -> Callable:
    """Masked blockwise eval: ``(x, y, mask) -> {validation_loss, _mse,
    _rmse, _mae, _mape}``.  The padded rows of the last block carry mask 0;
    the sums stay on the device until one read back at the end."""

    def evaluate(x_all, y_all, mask) -> Dict[str, float]:
        model.eval()
        sums = []
        with torch.inference_mode():
            for i in range(n_blocks):
                rows = slice(i * eval_bs, (i + 1) * eval_bs)
                x, y, m = x_all[rows], y_all[rows], mask[rows]
                preds = model(x).float()
                se, ae, ape = per_example_losses(preds, y)
                hub = torch.mean(huber(preds, y, delta=1.0), dim=-1)
                sums.append(torch.stack([(se * m).sum(), (ae * m).sum(),
                                         (ape * m).sum(), (hub * m).sum()]))
            total = torch.stack(sums).sum(dim=0)
            se, ae, ape, hub, count = (*total.tolist(), mask.sum().item())
        return eval_metrics_from_sums(loss_name, se, ae, ape, hub, count)

    return evaluate


def make_population_epoch_fn(
    model: torch.nn.Module,
    tx: PopulationOptimizer,
    loss_fn: Callable,
    n_train: int,
    num_batches: int,
    batch_size: int,
) -> Callable:
    """One training epoch of a population, its stacked parameters updated
    in place.

    ``epoch(params, opt_state, x_all, y_all, perms, stream_seeds, step0)
    -> mean_losses`` (``[K]`` on the device, not read back).  ``params``
    is ``{name: [K, ...]}`` over ``model``'s parameter names (``model``
    lends its structure and buffers to ``functional_call``); ``perms`` is
    ``[K, >= num_batches * batch_size]``, each row that row's shuffle of
    the ``n_train`` rows; ``stream_seeds`` ``[K]`` int64 are the rows'
    dropout seeds; step i of the epoch draws its masks at step index
    ``step0 + i``.  Row k's batch is gathered from the shared staged data
    as ``[K, batch, ...]``."""
    from torch.func import functional_call, grad_and_value, vmap

    def loss_of(params, xb, yb, seed, step):
        preds = functional_call(model, params, (xb,),
                                {"rng": RowStream(seed, step)})
        return loss_fn(preds.float(), yb)

    grad_step = vmap(grad_and_value(loss_of), in_dims=(0, 0, 0, 0, None),
                     randomness="error")

    def epoch(params, opt_state, x_all, y_all, perms, stream_seeds,
              step0: int):
        rows = perms.shape[0]
        if perms.shape[1] < num_batches * batch_size:
            raise ValueError(f"perms of {n_train} rows have too few entries")
        idx = perms[:, : num_batches * batch_size].reshape(
            rows, num_batches, batch_size)
        model.train()
        losses = []
        for i in range(num_batches):
            batch = idx[:, i]
            grads, loss = grad_step(params, x_all[batch], y_all[batch],
                                    stream_seeds, step0 + i)
            apply_updates(params, tx.update(grads, opt_state, params))
            losses.append(loss)
        return torch.stack(losses, dim=1).mean(dim=1)

    return epoch


def make_population_eval_fn(model: torch.nn.Module, n_blocks: int,
                            eval_bs: int) -> Callable:
    """Masked blockwise eval of a population: ``(params, x, y, mask) ->
    [K, 4]`` sums of squared error, absolute error, APE and Huber over the
    unmasked rows, on the device (:func:`eval_metrics_from_sums` turns a
    row's sums into its metrics after the one read back).  Runs under
    ``torch.no_grad()``: ``inference_mode`` tensors cannot enter
    ``vmap``."""
    from torch.func import functional_call, vmap

    forward = vmap(lambda params, x: functional_call(model, params, (x,)),
                   in_dims=(0, None), randomness="error")

    def evaluate(params, x_all, y_all, mask) -> torch.Tensor:
        model.eval()
        sums = []
        with torch.no_grad():
            for i in range(n_blocks):
                rows = slice(i * eval_bs, (i + 1) * eval_bs)
                x, y, m = x_all[rows], y_all[rows], mask[rows]
                preds = forward(params, x).float()
                se, ae, ape = per_example_losses(preds, y)
                hub = torch.mean(huber(preds, y, delta=1.0), dim=-1)
                sums.append(torch.stack([(se * m).sum(1), (ae * m).sum(1),
                                         (ape * m).sum(1), (hub * m).sum(1)],
                                        dim=1))
            return torch.stack(sums).sum(dim=0)

    return evaluate


def make_exploit_explore(spec: Dict[str, Any], valid, device) -> Callable:
    """The device form of ``schedulers/pbt.py::reference_generation_step``.

    ``step(scores, lr, wd, draws, fire) -> (src, new_lr, new_wd,
    exploited)``: ``scores``, ``lr``, ``wd`` ``[K]`` float32 and ``draws``
    ``[K, n_draws]`` float32 on ``device``; ``fire`` a host bool.  Every
    operation reproduces the reference bit for bit: a stable three-key
    sort of (invalid, rank, row index) by successive stable sorts, with
    non-finite scores ranked ``+inf``; donors are the finite rows of the
    top quantile in a stable partition; a lagger's donor is
    ``trunc(u0 * n_ok)`` in float32; the resample is a gather into the
    host-built grid, the step a float32 multiply and clip.  ``valid``
    (``[K]`` bools, host) fixes the quantile split; the constants go to
    the device here, so a step enqueues its work and reads nothing back.
    """
    valid = np.asarray(valid, bool)
    n_rows = len(valid)
    n_valid = int(valid.sum())
    q = max(1, int(n_valid * spec["quantile"]))
    lag_start = max(q, n_valid - q)
    exploit_possible = n_valid >= 4 and lag_start < n_valid

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    rows = torch.arange(n_rows, device=device)
    invalid = put(~valid, torch.int32)
    sign = put(np.float32(spec["sign"]), torch.float32)
    inf = put(np.float32(np.inf), torch.float32)
    resample_p = put(np.float32(spec["resample_p"]), torch.float32)
    factors = put(np.asarray(spec["factors"], np.float32), torch.float32)
    n_factors = len(spec["factors"])
    explore = []
    for m, e in enumerate(spec["specs"]):
        grid = resample_grid(e, spec.get("grid_points", RESAMPLE_GRID_POINTS))
        explore.append((m, e["key"], put(grid, torch.float32), len(grid),
                        put(np.float32(e["lo"]), torch.float32),
                        put(np.float32(e["hi"]), torch.float32)))

    def trunc_index(u: torch.Tensor, n: int) -> torch.Tensor:
        # numpy's clip(astype(int32)) of a non-negative float32 product.
        return (u * np.float32(n)).to(torch.int32).clamp(0, n - 1).long()

    def step(scores, lr, wd, draws, fire: bool):
        if not fire or not exploit_possible:
            return rows, lr, wd, torch.zeros_like(rows, dtype=torch.bool)
        s = scores.float() * sign
        rank = torch.where(torch.isfinite(s), s, inf)
        # Least significant key first: rank (ties by index), then invalid.
        by_rank = torch.sort(rank, stable=True).indices
        order = by_rank[torch.sort(invalid[by_rank], stable=True).indices]
        donors = order[:q]
        donor_ok = torch.isfinite(rank[donors])
        n_ok = donor_ok.sum()
        # A 0-d index tensor would be read back as an int: slice instead.
        enabled = (torch.isfinite(rank[order[:1]]) & (n_ok > 0)).squeeze(0)
        finite_donors = donors[torch.sort((~donor_ok).to(torch.int32),
                                          stable=True).indices]
        laggers = order[lag_start:n_valid]
        d_idx = (draws[laggers, 0] * n_ok.to(torch.float32)).to(torch.int32)
        d_idx = torch.minimum(d_idx.long(), (n_ok - 1).clamp(min=0))
        src = rows.clone()
        src[laggers] = torch.where(enabled, finite_donors[d_idx], laggers)
        exploited = torch.zeros_like(rows, dtype=torch.bool)
        exploited[laggers] = enabled.expand(laggers.shape)
        vals = {"learning_rate": lr, "weight_decay": wd}
        out = {}
        for m, key, grid, n_grid, lo, hi in explore:
            base = vals[key]
            u_res, u_val = draws[:, 1 + 2 * m], draws[:, 2 + 2 * m]
            resampled = grid[trunc_index(u_val, n_grid)]
            stepped = torch.minimum(torch.maximum(
                base[src] * factors[trunc_index(u_val, n_factors)], lo), hi)
            cand = torch.where(u_res < resample_p, resampled, stepped)
            out[key] = torch.where(exploited, cand, base)
        for key in ("learning_rate", "weight_decay"):
            if key not in spec["keys"]:
                # Exploit copies the donor's whole config: a key that is
                # not mutated still adopts the donor's value.
                out[key] = torch.where(exploited, vals[key][src], vals[key])
        return src, out["learning_rate"], out["weight_decay"], exploited

    return step


def make_pbt_generation_fn(
    epoch_fn: Callable,
    eval_fn: Callable,
    score_fn: Callable,
    spec: Dict[str, Any],
    *,
    interval: int,
    num_epochs_total: int,
    steps_per_epoch: int,
    valid,
    device,
) -> Callable:
    """The PBT generations of a population, enqueued on its device.

    Returns ``run(params, opt_state, stream_seeds, lr, wd, x, y, xv, yv,
    mask, perms, draws, gen0, obj_scale) -> (params, opt_state, lr, wd,
    outputs)``.  ``perms`` ``[g * interval, K, n]`` holds the rows'
    shuffles of the chunk's epochs and ``draws`` ``[g, K, n_draws]`` the
    generations' uniforms (``schedulers/pbt.py::generation_draws``), both
    uploaded before the call; ``obj_scale`` is a float32 device scalar.
    Each generation runs ``interval`` epochs (``epoch_fn``, ``eval_fn``:
    the population forms above), scores the rows on the last one
    (``score_fn``), takes the exploit/explore step (no perturbation after
    the sweep's last epoch), gathers every parameter and optimizer leaf by
    ``src`` (``take_rows``) and writes the new lr/wd.  The rows' dropout
    and shuffle seeds are not gathered: a lagger keeps its own streams.
    ``outputs`` is one tuple per generation of device tensors: train
    losses ``[K, interval]``, eval sums ``[K, interval, 4]``, scores,
    src, new lr, new wd, exploited.  Nothing is read back.
    """
    exploit_explore = make_exploit_explore(spec, valid, device)

    def run(params, opt_state, stream_seeds, lr, wd, x, y, xv, yv, mask,
            perms, draws, gen0: int, obj_scale):
        outputs = []
        for gi in range(draws.shape[0]):
            gen = gen0 + gi
            losses, sums = [], []
            for e_off in range(interval):
                epoch = gen * interval + e_off
                losses.append(epoch_fn(params, opt_state, x, y,
                                       perms[gi * interval + e_off],
                                       stream_seeds, epoch * steps_per_epoch))
                sums.append(eval_fn(params, xv, yv, mask))
            losses, sums = torch.stack(losses, 1), torch.stack(sums, 1)
            scores = score_fn(losses[:, -1], sums[:, -1]) * obj_scale
            fire = (gen + 1) * interval < num_epochs_total
            src, lr, wd, exploited = exploit_explore(scores, lr, wd,
                                                     draws[gi], fire)
            params = {k: v[src] for k, v in params.items()}
            opt_state = set_injected_hyperparams(take_rows(opt_state, src),
                                                 lr, wd)
            outputs.append((losses, sums, scores, src, lr, wd, exploited))
        return params, opt_state, lr, wd, outputs

    return run


@dataclass
class StagedData:
    """Device-resident dataset + padded validation block layout."""

    x_train: torch.Tensor
    y_train: torch.Tensor
    x_val: torch.Tensor
    y_val: torch.Tensor
    val_mask: torch.Tensor
    n_train: int
    num_batches: int
    batch_size: int
    n_val_blocks: int
    eval_bs: int


def stage_data(
    train_data, val_data, batch_size: int, compute_dtype: torch.dtype,
    device,
) -> StagedData:
    """Stage both splits to ``device`` once; pad validation to whole
    blocks.  Inputs in the compute dtype, targets in f32."""
    n_train = len(train_data)
    batch_size = int(min(batch_size, n_train))
    num_batches = max(n_train // batch_size, 1)

    n_val = len(val_data)
    eval_bs = int(min(max(batch_size, 1), n_val))
    n_val_pad = -(-n_val // eval_bs) * eval_bs
    pad = n_val_pad - n_val

    def padded(a):
        return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) \
            if pad else a

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    return StagedData(
        x_train=put(train_data.x, compute_dtype),
        y_train=put(train_data.y, torch.float32),
        x_val=put(padded(val_data.x), compute_dtype),
        y_val=put(padded(val_data.y), torch.float32),
        val_mask=put(np.concatenate([np.ones(n_val, np.float32),
                                     np.zeros(pad, np.float32)]),
                     torch.float32),
        n_train=n_train,
        num_batches=num_batches,
        batch_size=batch_size,
        n_val_blocks=n_val_pad // eval_bs,
        eval_bs=eval_bs,
    )
