"""Data of the port: loading, windowing, splits, feature frames and
synthetic sets (``__all__``: the JAX package's ``data`` exports), and the
out-of-core input ring (``data.pipeline``, whose errors and counters are
importable from here too)."""

from distributed_machine_learning_tpu_torch.data import features, pipeline
from distributed_machine_learning_tpu_torch.data.loader import (
    Dataset,
    get_dataset,
    load_dataframe_from_npy,
    make_regression_dataset,
    split_into_intervals,
    train_val_split,
)
from distributed_machine_learning_tpu_torch.data.pipeline import (
    INPUT_MODES,
    ProducerStalled,
    ResidentOverBudgetError,
    get_host_input_counters,
)
from distributed_machine_learning_tpu_torch.data.synthetic import (
    california_housing_data,
    dummy_regression_data,
    glucose_like_data,
)

__all__ = [
    "features",
    "Dataset",
    "get_dataset",
    "load_dataframe_from_npy",
    "make_regression_dataset",
    "split_into_intervals",
    "train_val_split",
    "california_housing_data",
    "dummy_regression_data",
    "glucose_like_data",
]
