"""Synthetic datasets for smoke tests and benchmarks.

Port of ``dummy_regression_data`` and ``glucose_like_data`` from
``distributed_machine_learning_tpu/data/synthetic.py``: the same numpy
draws from the same seeds, so both packages make byte-equal arrays.
``california_housing_data`` downloads its data and is not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from distributed_machine_learning_tpu_torch.data.loader import (
    Dataset,
    split_into_intervals,
    train_val_split,
)
from distributed_machine_learning_tpu_torch.utils.seeding import rng_from


def dummy_regression_data(
    num_samples: int = 1000,
    seq_len: int = 50,
    num_features: int = 10,
    val_fraction: float = 0.2,
    seed: int = 0,
) -> Tuple[Dataset, Dataset]:
    """Random sequence-regression data; the target is a weighted sum of the
    last five steps plus noise, so validation loss responds to training."""
    rng = rng_from("dummy", seed)
    x = rng.standard_normal((num_samples, seq_len, num_features)).astype(np.float32)
    w = rng.standard_normal((num_features,)).astype(np.float32)
    y = (x[:, -5:, :] @ w).mean(axis=1, keepdims=True) + 0.1 * rng.standard_normal(
        (num_samples, 1)
    ).astype(np.float32)
    return train_val_split(x, y, val_fraction=val_fraction, seed=seed, shuffle=False)


def glucose_like_data(
    num_steps: int = 20_000,
    num_features: int = 16,
    interval: int = 96,
    stride: int = 96,
    val_fraction: float = 0.3,
    seed: int = 7,
) -> Tuple[Dataset, Dataset]:
    """Windowed synthetic wearable-sensor series with a forecastable glucose
    target."""
    rng = rng_from("glucose", seed)
    t = np.arange(num_steps, dtype=np.float32)
    # Sensor channels: daily/meal-cycle sinusoids + AR noise.
    phases = rng.uniform(0, 2 * np.pi, num_features)
    periods = rng.choice([96.0, 288.0, 1440.0], num_features)
    sensors = np.sin(2 * np.pi * t[:, None] / periods[None, :] + phases[None, :])
    noise = rng.standard_normal((num_steps, num_features)).astype(np.float32)
    for i in range(1, num_steps):  # AR(1) smoothing
        noise[i] = 0.9 * noise[i - 1] + 0.1 * noise[i]
    x = (sensors + 0.5 * noise).astype(np.float32)

    w = rng.standard_normal((num_features,)).astype(np.float32) / np.sqrt(num_features)
    latent = x @ w
    glucose = 120.0 + 30.0 * np.tanh(np.convolve(latent, np.ones(12) / 12, mode="same"))
    glucose = (glucose + rng.standard_normal(num_steps) * 2.0).astype(np.float32)

    xw = split_into_intervals(x, interval, stride)
    yw = split_into_intervals(glucose, interval, stride)[:, -1, 0:1]
    return train_val_split(xw, yw, val_fraction=val_fraction, seed=seed)
