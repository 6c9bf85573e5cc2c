"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  Asking
for a card that is not there raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import List, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for, but no CUDA device is "
                f"available (pass device='cpu' to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} asked for, but only {torch.cuda.device_count()} "
                f"CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev


def replica_devices(device: DeviceLike, count: int) -> List[torch.device]:
    """``count`` placements for replicas: round-robin over the visible
    cards for a bare ``"cuda"``, the one named device otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        n = torch.cuda.device_count()
        return [torch.device("cuda", i % n) for i in range(count)]
    return [resolve_device(dev)] * count
