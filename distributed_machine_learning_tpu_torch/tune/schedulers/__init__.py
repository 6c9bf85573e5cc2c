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

__all__ = [
    "ASHAScheduler",
    "FIFOScheduler",
    "TrialScheduler",
    "CONTINUE",
    "STOP",
    "REQUEUE",
]
