from distributed_machine_learning_tpu_torch.tune.search.base import (
    GridSearch,
    RandomSearch,
    Searcher,
    WarmStartSearcher,
)
from distributed_machine_learning_tpu_torch.tune.search.bayesopt import (
    BayesOptSearch,
)

__all__ = ["Searcher", "RandomSearch", "GridSearch", "BayesOptSearch",
           "WarmStartSearcher"]
