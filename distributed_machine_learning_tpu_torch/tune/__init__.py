"""Public tune API of the port.

Ported so far: the per-trial session and the built-in trainable, so one
trial runs outside a sweep:

    from distributed_machine_learning_tpu_torch import tune

    trainable = tune.with_parameters(tune.train_regressor,
                                     train_data=train, val_data=val)
    with tune.session.standalone():
        trainable(config)

``tune.run`` with its searchers and schedulers is not ported yet
(ROADMAP.md queue A).
"""

from distributed_machine_learning_tpu_torch.tune import session
from distributed_machine_learning_tpu_torch.tune.session import (
    get_checkpoint,
    report,
    with_parameters,
)
from distributed_machine_learning_tpu_torch.tune.trainable import (
    train_regressor,
)

__all__ = [
    "session",
    "report",
    "get_checkpoint",
    "with_parameters",
    "train_regressor",
]
