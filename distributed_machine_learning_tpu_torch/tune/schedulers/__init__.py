from distributed_machine_learning_tpu_torch.tune.schedulers.asha import (
    ASHAScheduler,
)
from distributed_machine_learning_tpu_torch.tune.schedulers.base import (
    CONTINUE,
    FIFOScheduler,
    REQUEUE,
    STOP,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.schedulers.pb2 import PB2
from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
    PopulationBasedTraining,
)

__all__ = [
    "ASHAScheduler",
    "FIFOScheduler",
    "PopulationBasedTraining",
    "PB2",
    "TrialScheduler",
    "CONTINUE",
    "STOP",
    "REQUEUE",
]
