"""Per-epoch MFU accounting.

Port of ``EpochPerfAccounting`` from
``distributed_machine_learning_tpu/perf/costmodel.py``, with the same
record keys and rounding: ``epoch_time_s`` (4 dp), ``device_bytes_in_use``
(``torch.cuda.memory_allocated`` on a card; absent on the CPU),
``epoch_flops`` and ``mfu`` (5 dp, only where the device has a known
peak).  The XLA program-cost capture, its roofline classification and the
step-stream anomaly detector are not ported yet (ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from distributed_machine_learning_tpu_torch.ops.flops import (
    device_peak_flops,
    epoch_flops,
)


class EpochPerfAccounting:
    """Stamps one epoch's perf keys onto a trainable's record."""

    def __init__(
        self,
        config: Dict[str, Any],
        *,
        batch_size: int,
        seq_len: int,
        features: int,
        steps_per_epoch: int,
        eval_rows: int,
        device=None,
    ):
        self.epoch_flops = epoch_flops(
            config, batch_size, seq_len, features, steps_per_epoch, eval_rows,
        )
        self.peak = device_peak_flops(
            device, str(config.get("compute_dtype", "float32"))
        )

    def annotate(self, record: Dict[str, Any], exec_s: float, *,
                 device=None) -> Dict[str, Any]:
        record["epoch_time_s"] = round(exec_s, 4)
        if device is not None and torch.device(device).type == "cuda":
            record["device_bytes_in_use"] = int(
                torch.cuda.memory_allocated(device)
            )
        if self.epoch_flops is not None:
            record["epoch_flops"] = self.epoch_flops
            if self.peak:
                record["mfu"] = round(self.epoch_flops / exec_s / self.peak, 5)
        return record
