"""Public tune API of the port.

The README quickstart of the JAX package runs here with only the package
name changed:

    from distributed_machine_learning_tpu_torch import tune

    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=..., val_data=...),
        param_space={"learning_rate": tune.loguniform(1e-5, 1e-2), ...},
        metric="validation_mape", mode="min", num_samples=50,
        scheduler=tune.ASHAScheduler(...),
        search_alg=tune.BayesOptSearch(...),
    )
    print(analysis.best_config)

Trials run on every visible card unless ``tune.run(devices=...)`` says
otherwise (``[torch.device("cpu")]`` on a machine without one).  One
trial runs outside a sweep under ``tune.session.standalone()``.

Ported so far: ``tune.run`` with the thread executor, the search space,
``RandomSearch``/``GridSearch``/``BayesOptSearch`` and warm-start points,
the FIFO, ASHA, PBT and PB2 schedulers, the stoppers, the experiment store and
analysis, the logger/JSONL/progress/TensorBoard/profiler callbacks,
pickle-free checkpoints, the session and ``train_regressor`` with every
optimizer, gradient accumulation and remat; and ``tune.run_vectorized``, which
trains a population of trials as one batched program (the bench
headline's runner, with PBT and PB2 as a row gather of the population;
``device="cpu"`` without a card).  The rest (TPE,
HyperBand, the median rule, ``Repeater``, the process executor, the
journal, remote storage, the sharded runners) is in ROADMAP.md queue A.
"""

from distributed_machine_learning_tpu_torch.tune import session
from distributed_machine_learning_tpu_torch.tune.callbacks import (
    Callback,
    JsonlCallback,
    LoggerCallback,
    ProfilerCallback,
    ProgressReporter,
    TensorBoardCallback,
)
from distributed_machine_learning_tpu_torch.tune.experiment import (
    ExperimentAnalysis,
    ExperimentStore,
)
from distributed_machine_learning_tpu_torch.tune.runner import run
from distributed_machine_learning_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.search import (
    BayesOptSearch,
    GridSearch,
    RandomSearch,
    Searcher,
    WarmStartSearcher,
)
from distributed_machine_learning_tpu_torch.tune.search_space import (
    Constraint,
    SearchSpace,
    choice,
    constant,
    loguniform,
    lograndint,
    qloguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from distributed_machine_learning_tpu_torch.tune.session import (
    get_checkpoint,
    get_devices,
    get_trial_id,
    heartbeat,
    report,
    standalone,
    with_parameters,
)
from distributed_machine_learning_tpu_torch.tune.stoppers import (
    MaximumIterationStopper,
    Stopper,
    TrialPlateauStopper,
)
from distributed_machine_learning_tpu_torch.tune.trainable import (
    train_regressor,
)
from distributed_machine_learning_tpu_torch.tune.trial import (
    Resources,
    Trial,
    TrialStatus,
)
from distributed_machine_learning_tpu_torch.tune.vectorized import (
    run_vectorized,
)

__all__ = [
    "session",
    "run",
    "run_vectorized",
    "report",
    "heartbeat",
    "get_checkpoint",
    "get_devices",
    "get_trial_id",
    "standalone",
    "with_parameters",
    "train_regressor",
    "choice",
    "uniform",
    "loguniform",
    "quniform",
    "qloguniform",
    "randint",
    "qrandint",
    "lograndint",
    "randn",
    "sample_from",
    "constant",
    "Constraint",
    "SearchSpace",
    "ASHAScheduler",
    "FIFOScheduler",
    "PopulationBasedTraining",
    "PB2",
    "TrialScheduler",
    "RandomSearch",
    "GridSearch",
    "BayesOptSearch",
    "WarmStartSearcher",
    "Stopper",
    "TrialPlateauStopper",
    "MaximumIterationStopper",
    "Searcher",
    "ExperimentAnalysis",
    "ExperimentStore",
    "Callback",
    "LoggerCallback",
    "JsonlCallback",
    "ProgressReporter",
    "TensorBoardCallback",
    "ProfilerCallback",
    "Resources",
    "Trial",
    "TrialStatus",
]
