"""The sharded flagship: a config that cannot fit one device.

Port of ``distributed_machine_learning_tpu/models/flagship.py``.  The claim
that a config needs a mesh is checked, not asserted:
:func:`param_opt_bytes` prices a config's parameter and optimizer state by
building the model and running the optimizer's ``init`` on
``torch.device("meta")`` (shapes only, nothing allocated),
:func:`single_chip_hbm_bytes` reads one device's budget, and
:func:`flagship_sharded_config` grows ``d_model`` by doublings until the
price exceeds the budget.

On a card the budget is its memory (``torch.cuda.mem_get_info``'s total).
On the CPU it is a virtual one, ``DML_CPU_DEVICE_BUDGET_BYTES`` (default
8 MiB), as in the JAX package, so a CPU test derives a small flagship.
The config's ``mesh_shape`` is refused by the port's ``tune.run`` until
the sharded runners are ported (ROADMAP.md A9).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from distributed_machine_learning_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

_CPU_VIRTUAL_BUDGET_BYTES = 8 << 20


def single_chip_hbm_bytes(device: DeviceLike = "cuda") -> int:
    """The memory budget of one device, in bytes: a card's total memory,
    or the CPU's virtual budget."""
    device = resolve_device(device)
    if device.type == "cpu":
        return int(os.environ.get("DML_CPU_DEVICE_BUDGET_BYTES",
                                  _CPU_VIRTUAL_BUDGET_BYTES))
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)


def tree_nbytes(tree) -> int:
    """The bytes of every tensor in a nest of dicts (a parameter dict or
    an optimizer state); other leaves count 0."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Mapping):
        return sum(tree_nbytes(v) for v in tree.values())
    return 0


def param_opt_bytes(config: Dict[str, Any], features: int = 16,
                    optimizer: Optional[str] = None) -> int:
    """Parameter + optimizer-state bytes of ``config``, from shapes alone:
    the model and the optimizer's state are built on the meta device."""
    from distributed_machine_learning_tpu_torch.models import build_model
    from distributed_machine_learning_tpu_torch.models.convert import (
        flax_leaf_axes,
    )
    from distributed_machine_learning_tpu_torch.ops.optimizers import (
        make_optimizer,
    )

    with torch.device("meta"):
        model = build_model(config, int(features))
        params = dict(model.named_parameters())
        tx = make_optimizer(
            str(optimizer or config.get("optimizer", "adam")),
            learning_rate=1e-3, leaf_axes=flax_leaf_axes(params))
        opt_state = tx.init(params)
    return tree_nbytes(params) + tree_nbytes(opt_state)


def flagship_sharded_config(
    budget_bytes: Optional[int] = None,
    *,
    mesh_shape: Optional[Dict[str, int]] = None,
    seq_len: int = 16,
    features: int = 16,
    batch_size: int = 32,
    num_layers: int = 2,
    max_d_model: int = 1 << 15,
) -> Dict[str, Any]:
    """The smallest power-of-two ``d_model`` transformer whose params +
    adam moments exceed ``budget_bytes`` (default: the current card's
    :func:`single_chip_hbm_bytes`), configured for a 2-D (dp, tp) mesh
    (default ``{"dp": 2, "tp": 4}``).  Raises if no ``d_model`` up to
    ``max_d_model`` exceeds the budget."""
    if budget_bytes is None:
        budget_bytes = single_chip_hbm_bytes()
    mesh_shape = dict(mesh_shape or {"dp": 2, "tp": 4})
    d_model = 64
    while d_model <= max_d_model:
        config = {
            "model": "transformer",
            "d_model": d_model,
            "num_heads": 8,
            "num_layers": num_layers,
            "dim_feedforward": 4 * d_model,
            "dropout": 0.0,
            "max_seq_length": seq_len,
            "batch_size": batch_size,
            "optimizer": "adam",
            "mesh_shape": mesh_shape,
            # Remat keeps a block's activations from living to the
            # backward (dots_saveable: the products are kept, the rest
            # recomputed).
            "remat": True,
            "remat_policy": "dots_saveable",
        }
        if param_opt_bytes(config, features=features) > budget_bytes:
            return config
        d_model *= 2
    raise ValueError(
        f"no d_model <= {max_d_model} exceeds budget_bytes={budget_bytes}"
    )
