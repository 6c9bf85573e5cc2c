"""Loss registry, in PyTorch.

Port of ``distributed_machine_learning_tpu/ops/losses.py``: every loss is a
function of ``(predictions, targets)`` returning a scalar tensor, with the
same definitions (huber at delta 1.0, MAPE over ``|t| + 1e-8`` times 100).
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.utils.registry import Registry

losses: Registry = Registry("loss")


def huber(predictions: torch.Tensor, targets: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """Elementwise huber loss, written as ``optax.huber_loss`` writes it."""
    abs_errors = (predictions - targets).abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


@losses.register("mse")
def mse_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((predictions - targets) ** 2)


@losses.register("mae")
def mae_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(predictions - targets))


@losses.register("huber")
def huber_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(huber(predictions, targets, delta=1.0))


@losses.register("mape")
def mape_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error x100, over ``|t|`` as in the JAX
    package (not the signed target)."""
    return torch.mean(
        torch.abs(targets - predictions) / (torch.abs(targets) + 1e-8)
    ) * 100.0


@losses.register("rmse")
def rmse_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((predictions - targets) ** 2))


def get_loss(name: str):
    return losses.get(name)
