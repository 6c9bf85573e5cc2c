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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.ops.losses import huber
from distributed_machine_learning_tpu_torch.ops.optimizers import (
    InjectedOptimizer,
    apply_updates,
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
    tx: InjectedOptimizer,
    loss_fn: Callable,
    n_train: int,
    num_batches: int,
    batch_size: int,
) -> Callable:
    """One training epoch over ``model``'s parameters, updated in place.

    ``epoch(opt_state, x_all, y_all, perm, generator) -> mean_loss`` (a 0-d
    tensor on the device, not yet read back).  ``perm`` is a permutation of
    ``n_train`` rows; its first ``num_batches * batch_size`` entries are the
    epoch's batches in order.
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
