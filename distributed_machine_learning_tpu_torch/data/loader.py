"""Datasets: strided windowing, seeded batch iteration and splits.

Port of the parts of ``distributed_machine_learning_tpu/data/loader.py``
that training needs: ``split_into_intervals`` (the numpy stride path),
``Dataset`` and ``train_val_split``.  The epoch shuffle of
``Dataset.batches`` is the splitmix64 Fisher-Yates of the JAX package's
numpy fallback (``data/native.py``), so a seed gives the same batch order.
The native C++ windowing, the dataset caches and ``get_dataset`` are not
ported yet (ROADMAP.md queue A).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

from distributed_machine_learning_tpu_torch.utils.seeding import (
    fold_seed,
    rng_from,
)

_SM64_MIX = np.uint64(0xD1B54A32D192ED03)
_SM64_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_SM64_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_M2 = np.uint64(0x94D049BB133111EB)


def split_into_intervals(
    array: np.ndarray, interval: int, stride: int
) -> np.ndarray:
    """[T, F] -> [num_intervals, interval, F] with the given stride."""
    if array.ndim == 1:
        array = array[:, None]
    T = array.shape[0]
    if T < interval:
        return np.empty((0, interval, array.shape[1]), dtype=array.dtype)
    windows = np.lib.stride_tricks.sliding_window_view(array, interval, axis=0)
    # sliding_window_view gives [T-interval+1, F, interval]; stride + reorder.
    return np.ascontiguousarray(np.transpose(windows[::stride], (0, 2, 1)))


def _splitmix64_draws(seed: int, count: int) -> np.ndarray:
    """The first ``count`` splitmix64 outputs for ``seed``."""
    state = np.uint64(seed & (2**64 - 1)) ^ _SM64_MIX
    with np.errstate(over="ignore"):
        z = state + np.arange(1, count + 1, dtype=np.uint64) * _SM64_GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _SM64_M1
        z = (z ^ (z >> np.uint64(27))) * _SM64_M2
        return z ^ (z >> np.uint64(31))


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic permutation of [0, n): Fisher-Yates on splitmix64."""
    out = np.arange(n, dtype=np.int64)
    draws = _splitmix64_draws(seed, max(n - 1, 0))
    for k, i in enumerate(range(n - 1, 0, -1)):
        j = int(draws[k] % np.uint64(i + 1))
        out[i], out[j] = out[j], out[i]
    return out


@dataclass
class Dataset:
    """A fully materialized (x, y) array pair with seeded batch iteration."""

    x: np.ndarray
    y: np.ndarray

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError(f"x/y length mismatch: {len(self.x)} vs {len(self.y)}")

    def __len__(self) -> int:
        return len(self.x)

    @property
    def num_features(self) -> int:
        return int(self.x.shape[-1])

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed_parts: Sequence = (0,),
        drop_remainder: bool = True,
        with_mask: bool = False,
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (x, y) batches of a static shape.

        A dataset smaller than ``batch_size`` yields ONE batch zero-padded
        to ``batch_size``.  ``with_mask=True`` yields ``(x, y, mask)``
        (``mask`` float32, 1.0 for real rows) and also pads the final
        ragged batch under ``drop_remainder=False``.
        """
        n = len(self)
        idx = (shuffled_indices(n, fold_seed(*seed_parts)) if shuffle
               else np.arange(n))
        end = (n // batch_size) * batch_size if drop_remainder else n
        if end == 0:
            end = n  # tiny dataset: one batch, PADDED to batch_size below
        for start in range(0, end, batch_size):
            sel = idx[start : start + batch_size]
            bx, by = self.x[sel], self.y[sel]
            short = batch_size - len(sel)
            if short > 0 and (start == 0 or with_mask):
                bx = np.concatenate(
                    [bx, np.zeros((short, *bx.shape[1:]), bx.dtype)]
                )
                by = np.concatenate(
                    [by, np.zeros((short, *by.shape[1:]), by.dtype)]
                )
            if with_mask:
                mask = np.ones(len(bx), np.float32)
                if short > 0:
                    mask[len(sel):] = 0.0
                yield bx, by, mask
            else:
                yield bx, by

    def num_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        n = len(self)
        return max(n // batch_size if drop_remainder else -(-n // batch_size), 1)


def train_val_split(
    x: np.ndarray,
    y: np.ndarray,
    val_fraction: float = 0.3,
    seed: int = 42,
    shuffle: bool = True,
) -> Tuple[Dataset, Dataset]:
    """Deterministic split: the first ``round(n * val_fraction)`` rows of a
    seeded shuffle are validation."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        rng_from("split", seed).shuffle(idx)
    n_val = int(round(n * val_fraction))
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    return Dataset(x[train_idx], y[train_idx]), Dataset(x[val_idx], y[val_idx])
