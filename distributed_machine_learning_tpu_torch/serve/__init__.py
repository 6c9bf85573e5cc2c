"""Serving plane of the port: bundle -> engine -> batcher -> replicas -> HTTP."""

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

__all__ = [
    "AllReplicasOpen",
    "BUNDLE_VERSION",
    "BatcherStopped",
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
    "load_bundle",
    "write_bundle",
]
