"""MLP regressor, in PyTorch.

Port of ``distributed_machine_learning_tpu/models/mlp.py``: a row is
flattened (``[seq, features]`` -> ``seq * features``), then each hidden
width is a dense layer, a ReLU and dropout, and a last dense layer gives
``out_features``.  The dense layers carry flax's auto names
(``Dense_0`` ... ``Dense_n``, ``Dropout_0`` ...), so ``models/convert.py`` maps weights by
path.  flax infers the first layer's input width from the flattened row
at init; here the caller passes it (``models.input_width``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_machine_learning_tpu_torch.models.layers import (
    Dense,
    Dropout,
    Rng,
)


class MLPRegressor(nn.Module):
    def __init__(
        self,
        input_features: int,
        hidden_sizes: Sequence[int] = (128, 64),
        dropout_rate: float = 0.0,
        out_features: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        widths = [int(input_features), *(int(w) for w in hidden_sizes),
                  int(out_features)]
        self.num_hidden = len(hidden_sizes)
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}",
                            Dense(widths[i], widths[i + 1], dtype))
            if i < self.num_hidden:
                self.add_module(f"Dropout_{i}", Dropout(dropout_rate))

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        """x: ``[batch, ...]`` -> ``[batch, out_features]``."""
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        for i in range(self.num_hidden):
            x = getattr(self, f"Dropout_{i}")(
                F.relu(getattr(self, f"Dense_{i}")(x)), rng)
        return getattr(self, f"Dense_{self.num_hidden}")(x)
