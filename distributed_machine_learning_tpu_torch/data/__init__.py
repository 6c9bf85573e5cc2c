"""Data of the port: datasets, windowing, splits and synthetic sets."""

from distributed_machine_learning_tpu_torch.data.loader import (
    Dataset,
    split_into_intervals,
    train_val_split,
)
from distributed_machine_learning_tpu_torch.data.synthetic import (
    dummy_regression_data,
    glucose_like_data,
)

__all__ = [
    "Dataset",
    "split_into_intervals",
    "train_val_split",
    "dummy_regression_data",
    "glucose_like_data",
]
