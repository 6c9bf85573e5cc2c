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

Ported so far: ``tune.run`` with the thread and process executors (per-trial
time limits, the liveness watchdog, pre-warmed runners), the search space,
``RandomSearch``/``GridSearch``/``BayesOptSearch``/``TPESearch``, the
``Repeater`` and warm-start points, the FIFO, ASHA, HyperBand (BOHB with
TPE), median-stopping, PBT and PB2 schedulers, the stoppers, the experiment store and
analysis (``best_model`` and ``export_bundle``, on the port's
experiments and the JAX package's), the logger/JSONL/progress/
TensorBoard/profiler callbacks, pickle-free checkpoints (the port's
single blob, or ``checkpoint_format="sharded"`` generations through the
content store; the JAX package's msgpack checkpoints and generations are
read too) on any ``tune.storage`` scheme (``gs://``, ``s3://``, fsspec's
``memory://``), the session and ``train_regressor`` with every
optimizer, gradient accumulation, remat and ``input_mode`` (resident
epochs or the out-of-core prefetch ring of ``data/pipeline.py``); and
``tune.run_vectorized``, which
trains a population of trials as one batched program (the bench
headline's runner, with PBT and PB2 as a row gather of the population,
remat under every policy name, and PBT's ``quality_after_quant``;
``device="cpu"`` without a card); and the
decision journal (``tune/journal.py``), with which ``tune.run(resume="auto")``
restores a sweep whose head died, and ``tune/crashsim.py``, the harness
that kills a head mid-sweep.  The rest (the sharded runners, the
cluster driver, the observability plane) is in ROADMAP.md queue A.
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
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from distributed_machine_learning_tpu_torch.tune.search import (
    BayesOptSearch,
    GridSearch,
    RandomSearch,
    Repeater,
    Searcher,
    TPESearch,
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
    "HyperBandScheduler",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "PB2",
    "TrialScheduler",
    "RandomSearch",
    "GridSearch",
    "BayesOptSearch",
    "TPESearch",
    "WarmStartSearcher",
    "Repeater",
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
