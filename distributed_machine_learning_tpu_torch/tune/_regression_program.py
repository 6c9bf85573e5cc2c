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

The streaming chunk programs (:func:`make_chunk_epoch_fn`,
:func:`make_chunk_eval_fn`, the JAX module's counterparts) run the same
step and the same block sums over a staged slab of gathered batches
(``data/pipeline.py``).

``make_forward``/``detect_call_convention`` are not needed: a torch model
switches between training and evaluation with ``train()``/``eval()``.  An
MoE model's load-balance terms come back through an explicit ``aux`` list
handed to its forward (:func:`aux_kwargs`, :func:`with_aux`), not through
module state, so the single-trial epoch, the population epoch and the
PBT generation step all add them to the objective (and to the reported
train loss), as the JAX epoch adds what the model sowed into ``"moe"``.

A model with BatchNorm (``models/resnet.py``, ``carries_batch_stats``)
returns its new running statistics the same way, through a
``batch_stats_out`` dict (:func:`stats_kwargs`), and only in training,
as the JAX forward makes ``"batch_stats"`` mutable in train mode only
(``make_forward``).  The single-trial epoch copies them into the model's
buffers after each step; evaluation reads the buffers.  A population
carries them as a stacked dict beside its parameters (``stats``, ``{name:
[K, ...]}``, empty for a model without them): each step's ``vmap``
returns the rows' new statistics, the eval passes them to
``functional_call`` with the parameters, and a PBT exploit gathers them
with the parameters and the optimizer state, as the JAX generation step
gathers ``(params, opt_state, batch_stats)``.

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
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.models.moe import collect_aux
from distributed_machine_learning_tpu_torch.models.resnet import (
    batch_stats_of,
    stats_kwargs,
)
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


def aux_kwargs(aux: Optional[list]) -> Dict[str, Any]:
    """The forward's ``aux`` argument for a model whose blocks return an
    aux term (``models/moe.py``), none for the others."""
    return {} if aux is None else {"aux": aux}


def with_aux(loss: torch.Tensor, aux: Optional[list]) -> torch.Tensor:
    """The objective: the loss plus what the model's MoE blocks appended
    to ``aux`` (the JAX epoch adds what the model sowed into ``"moe"``);
    the loss alone for a model without them."""
    total = collect_aux(aux)
    return loss if total is None else loss + total


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
    step = _make_train_step(model, tx, loss_fn)

    def epoch(opt_state, x_all, y_all, perm, generator: Optional[torch.Generator]):
        perm = torch.as_tensor(
            np.asarray(perm[: num_batches * batch_size]).copy(),
            dtype=torch.long, device=x_all.device)
        if perm.numel() != num_batches * batch_size:
            raise ValueError(f"perm of {n_train} rows has too few entries")
        model.train()
        losses = [step(opt_state, x_all[idx], y_all[idx], generator)
                  for idx in perm.reshape(num_batches, batch_size)]
        return torch.stack(losses).mean()

    return epoch


def _make_train_step(model: torch.nn.Module, tx, loss_fn: Callable
                     ) -> Callable:
    """One training step on one batch, the parameters updated in place:
    ``step(opt_state, xb, yb, generator) -> loss`` (detached).  The body
    of both the resident epoch and the streaming chunk."""
    params = dict(model.named_parameters())
    collects_aux = getattr(model, "collects_aux", False)
    running = batch_stats_of(model)

    def step(opt_state, xb, yb, generator):
        aux = [] if collects_aux else None
        new_stats = {} if running else None
        preds = model(xb, rng=generator, **aux_kwargs(aux),
                      **stats_kwargs(new_stats))
        loss = with_aux(loss_fn(preds.float(), yb), aux)
        grads = torch.autograd.grad(loss, list(params.values()))
        updates = tx.update(dict(zip(params, grads)), opt_state, params)
        apply_updates(params, updates)
        if running:
            with torch.no_grad():
                for name, value in new_stats.items():
                    running[name].copy_(value)
        return loss.detach()

    return step


def make_chunk_epoch_fn(
    model: torch.nn.Module,
    tx: Union[InjectedOptimizer, Optimizer, MultiSteps],
    loss_fn: Callable,
) -> Callable:
    """One streamed CHUNK of an epoch (``data/pipeline.py``): the resident
    epoch's step over a staged slab of gathered batches.

    ``chunk(opt_state, xb, yb, generator) -> losses`` (``[rows]``, on the
    device, not read back) for ``xb``/``yb`` slabs ``[rows, batch_size,
    ...]``.  The step is :func:`make_epoch_fn`'s own, and the dropout
    generator carries on from chunk to chunk, so step i of an epoch
    draws its masks where the resident epoch's step i draws them
    whatever the chunk boundaries: given the resident epoch's batches in
    its order, a streamed epoch is the resident epoch bit for bit (its
    mean loss is the mean of the chunks' losses concatenated)."""
    step = _make_train_step(model, tx, loss_fn)

    def chunk(opt_state, xb, yb, generator: Optional[torch.Generator]):
        model.train()
        return torch.stack([step(opt_state, xb[i], yb[i], generator)
                            for i in range(xb.shape[0])])

    return chunk


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


def _block_sums(model: torch.nn.Module, x, y, m) -> torch.Tensor:
    """One validation block's masked sums of squared error, absolute
    error, APE and Huber: ``[4]`` on the device."""
    preds = model(x).float()
    se, ae, ape = per_example_losses(preds, y)
    hub = torch.mean(huber(preds, y, delta=1.0), dim=-1)
    return torch.stack([(se * m).sum(), (ae * m).sum(), (ape * m).sum(),
                        (hub * m).sum()])


def make_eval_fn(
    model: torch.nn.Module, loss_name: str, n_blocks: int, eval_bs: int
) -> Callable:
    """Masked blockwise eval: ``(x, y, mask) -> {validation_loss, _mse,
    _rmse, _mae, _mape}``.  The padded rows of the last block carry mask 0;
    the sums stay on the device until one read back at the end."""

    def evaluate(x_all, y_all, mask) -> Dict[str, float]:
        model.eval()
        with torch.inference_mode():
            sums = [_block_sums(model, x_all[rows], y_all[rows], mask[rows])
                    for rows in (slice(i * eval_bs, (i + 1) * eval_bs)
                                 for i in range(n_blocks))]
            total = torch.stack(sums).sum(dim=0)
            se, ae, ape, hub, count = (*total.tolist(), mask.sum().item())
        return eval_metrics_from_sums(loss_name, se, ae, ape, hub, count)

    return evaluate


def make_chunk_eval_fn(model: torch.nn.Module) -> Callable:
    """Masked eval over ONE streamed chunk of validation blocks:
    ``(xb, yb, mb) -> [rows, 4]``, each block's sums as
    :func:`make_eval_fn` takes them.  The caller concatenates the chunks'
    rows and sums them as :func:`make_eval_fn` sums its blocks, so a
    streamed validation reads the resident one's metrics bit for bit."""

    def evaluate_chunk(xb, yb, mb) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return torch.stack([_block_sums(model, xb[i], yb[i], mb[i])
                                for i in range(xb.shape[0])])

    return evaluate_chunk


def chunk_eval_metrics(loss_name: str, parts, count: float
                       ) -> Dict[str, float]:
    """The metric dict from the chunks' ``[rows, 4]`` block sums (in
    epoch order) over ``count`` real rows."""
    se, ae, ape, hub = torch.cat(list(parts)).sum(dim=0).tolist()
    return eval_metrics_from_sums(loss_name, se, ae, ape, hub, count)


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

    ``epoch(params, opt_state, x_all, y_all, perms, stream_seeds, step0,
    stats) -> mean_losses`` (``[K]`` on the device, not read back).
    ``params`` is ``{name: [K, ...]}`` over ``model``'s parameter names
    (``model`` lends its structure and buffers to ``functional_call``);
    ``stats`` the rows' running statistics ``{name: [K, ...]}``, replaced
    entry by entry with each step's new ones (empty or None for a model
    without BatchNorm); ``perms`` is
    ``[K, >= num_batches * batch_size]``, each row that row's shuffle of
    the ``n_train`` rows; ``stream_seeds`` ``[K]`` int64 are the rows'
    dropout seeds; step i of the epoch draws its masks at step index
    ``step0 + i``.  Row k's batch is gathered from the shared staged data
    as ``[K, batch, ...]``."""
    from torch.func import functional_call, grad_and_value, vmap

    collects_aux = getattr(model, "collects_aux", False)

    def loss_of(params, stats, xb, yb, seed, step):
        aux = [] if collects_aux else None
        new_stats = {} if stats else None
        preds = functional_call(model, (params, stats), (xb,),
                                {"rng": RowStream(seed, step),
                                 **aux_kwargs(aux),
                                 **stats_kwargs(new_stats)})
        return with_aux(loss_fn(preds.float(), yb), aux), new_stats or {}

    grad_step = vmap(grad_and_value(loss_of, has_aux=True),
                     in_dims=(0, 0, 0, 0, 0, None), randomness="error")

    def epoch(params, opt_state, x_all, y_all, perms, stream_seeds,
              step0: int, stats: Optional[Dict[str, torch.Tensor]] = None):
        rows = perms.shape[0]
        if perms.shape[1] < num_batches * batch_size:
            raise ValueError(f"perms of {n_train} rows have too few entries")
        idx = perms[:, : num_batches * batch_size].reshape(
            rows, num_batches, batch_size)
        model.train()
        losses = []
        stats = {} if stats is None else stats
        for i in range(num_batches):
            batch = idx[:, i]
            grads, (loss, new_stats) = grad_step(
                params, stats, x_all[batch], y_all[batch], stream_seeds,
                step0 + i)
            stats.update(new_stats)
            apply_updates(params, tx.update(grads, opt_state, params))
            losses.append(loss)
        return torch.stack(losses, dim=1).mean(dim=1)

    return epoch


def make_population_eval_fn(model: torch.nn.Module, n_blocks: int,
                            eval_bs: int) -> Callable:
    """Masked blockwise eval of a population: ``(params, x, y, mask,
    stats=None) -> [K, 4]`` sums of squared error, absolute error, APE and
    Huber over the unmasked rows (``stats``: the rows' running statistics,
    where the model has them), on the device (:func:`eval_metrics_from_sums` turns a
    row's sums into its metrics after the one read back).  Runs under
    ``torch.no_grad()``: ``inference_mode`` tensors cannot enter
    ``vmap``."""
    from torch.func import functional_call, vmap

    forward = vmap(
        lambda params, stats, x: functional_call(model, (params, stats),
                                                 (x,)),
        in_dims=(0, 0, None), randomness="error")

    def evaluate(params, x_all, y_all, mask,
                 stats: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        model.eval()
        sums = []
        with torch.no_grad():
            for i in range(n_blocks):
                rows = slice(i * eval_bs, (i + 1) * eval_bs)
                x, y, m = x_all[rows], y_all[rows], mask[rows]
                preds = forward(params, stats or {}, x).float()
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
    mask, perms, draws, gen0, obj_scale, stats=None) -> (params,
    opt_state, lr, wd, outputs, stats)``.  ``perms`` ``[g * interval, K,
    n]`` holds the rows' shuffles of the chunk's epochs and ``draws`` ``[g, K, n_draws]`` the
    generations' uniforms (``schedulers/pbt.py::generation_draws``), both
    uploaded before the call; ``obj_scale`` is a float32 device scalar.
    Each generation runs ``interval`` epochs (``epoch_fn``, ``eval_fn``:
    the population forms above), scores the rows on the last one
    (``score_fn``), takes the exploit/explore step (no perturbation after
    the sweep's last epoch), gathers every parameter, running statistic
    and optimizer leaf by ``src`` (``take_rows``) and writes the new
    lr/wd.  The rows' dropout and shuffle seeds are not gathered: a
    lagger keeps its own streams.
    ``outputs`` is one tuple per generation of device tensors: train
    losses ``[K, interval]``, eval sums ``[K, interval, 4]``, scores,
    src, new lr, new wd, exploited.  Nothing is read back.
    """
    exploit_explore = make_exploit_explore(spec, valid, device)

    def run(params, opt_state, stream_seeds, lr, wd, x, y, xv, yv, mask,
            perms, draws, gen0: int, obj_scale, stats=None):
        stats = dict(stats or {})
        outputs = []
        for gi in range(draws.shape[0]):
            gen = gen0 + gi
            losses, sums = [], []
            # Running statistics go to the epoch and eval only where the
            # model has them (the epoch replaces their entries in place).
            extra = (stats,) if stats else ()
            for e_off in range(interval):
                epoch = gen * interval + e_off
                losses.append(epoch_fn(params, opt_state, x, y,
                                       perms[gi * interval + e_off],
                                       stream_seeds, epoch * steps_per_epoch,
                                       *extra))
                sums.append(eval_fn(params, xv, yv, mask, *extra))
            losses, sums = torch.stack(losses, 1), torch.stack(sums, 1)
            scores = score_fn(losses[:, -1], sums[:, -1]) * obj_scale
            fire = (gen + 1) * interval < num_epochs_total
            src, lr, wd, exploited = exploit_explore(scores, lr, wd,
                                                     draws[gi], fire)
            params = {k: v[src] for k, v in params.items()}
            stats = {k: v[src] for k, v in stats.items()}
            opt_state = set_injected_hyperparams(take_rows(opt_state, src),
                                                 lr, wd)
            outputs.append((losses, sums, scores, src, lr, wd, exploited))
        return params, opt_state, lr, wd, outputs, stats

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


def batch_layout(n_train: int, batch_size: int, n_val: int
                 ) -> Tuple[int, int, int, int]:
    """``(batch_size, num_batches, eval_bs, n_val_pad)``: the batch size
    cut to the training rows, the batches per epoch (the remainder is
    dropped), the validation block size and the validation rows padded
    to whole blocks."""
    batch_size = int(min(batch_size, n_train))
    num_batches = max(n_train // batch_size, 1)
    eval_bs = int(min(max(batch_size, 1), n_val))
    return batch_size, num_batches, eval_bs, -(-n_val // eval_bs) * eval_bs


def padded_validation(val_data, n_val_pad: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The validation arrays zero-padded to ``n_val_pad`` rows, and the
    f32 mask of the real rows, on the host."""
    n_val = len(val_data)
    pad = n_val_pad - n_val

    def padded(a):
        return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) \
            if pad else a

    mask = np.concatenate([np.ones(n_val, np.float32),
                           np.zeros(pad, np.float32)])
    return padded(val_data.x), padded(val_data.y), mask


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array staged onto ``device`` in ``dtype`` (the cast rounds
    to nearest even)."""
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def stage_data(
    train_data, val_data, batch_size: int, compute_dtype: torch.dtype,
    device,
) -> StagedData:
    """Stage both splits to ``device`` once; pad validation to whole
    blocks.  Inputs in the compute dtype, targets in f32."""
    n_train = len(train_data)
    batch_size, num_batches, eval_bs, n_val_pad = batch_layout(
        n_train, batch_size, len(val_data))
    xv, yv, mask = padded_validation(val_data, n_val_pad)
    return StagedData(
        x_train=to_device(train_data.x, compute_dtype, device),
        y_train=to_device(train_data.y, torch.float32, device),
        x_val=to_device(xv, compute_dtype, device),
        y_val=to_device(yv, torch.float32, device),
        val_mask=to_device(mask, torch.float32, device),
        n_train=n_train,
        num_batches=num_batches,
        batch_size=batch_size,
        n_val_blocks=n_val_pad // eval_bs,
        eval_bs=eval_bs,
    )
