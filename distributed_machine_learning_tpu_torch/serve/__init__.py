"""Serving plane of the port: sweep -> bundle -> engine -> batcher ->
replicas -> HTTP, with hot swap and rollback."""

from distributed_machine_learning_tpu_torch.serve.batcher import (
    BatcherStopped,
    ContinuousBatcher,
    MicroBatcher,
    QueueFull,
)
from distributed_machine_learning_tpu_torch.serve.engine import (
    InferenceEngine,
    bucket_sizes,
)
from distributed_machine_learning_tpu_torch.serve.export import (
    BUNDLE_VERSION,
    ServableBundle,
    export_bundle,
    load_bundle,
    write_bundle,
)
from distributed_machine_learning_tpu_torch.serve.metrics import (
    LatencyWindow,
    ServeMetrics,
)
from distributed_machine_learning_tpu_torch.serve.replica import (
    AllReplicasOpen,
    CircuitBreaker,
    Overloaded,
    Replica,
    ReplicaSet,
    ReplicaTimeout,
)
from distributed_machine_learning_tpu_torch.serve.server import PredictionServer
from distributed_machine_learning_tpu_torch.serve.swap import (
    HISTORY_DEPTH,
    hot_swap,
    rollback,
    warm_swap_bundle,
)

__all__ = [
    "AllReplicasOpen",
    "BUNDLE_VERSION",
    "BatcherStopped",
    "HISTORY_DEPTH",
    "CircuitBreaker",
    "ContinuousBatcher",
    "InferenceEngine",
    "LatencyWindow",
    "MicroBatcher",
    "Overloaded",
    "PredictionServer",
    "QueueFull",
    "Replica",
    "ReplicaSet",
    "ReplicaTimeout",
    "ServableBundle",
    "ServeMetrics",
    "bucket_sizes",
    "export_bundle",
    "hot_swap",
    "load_bundle",
    "rollback",
    "warm_swap_bundle",
    "write_bundle",
]
