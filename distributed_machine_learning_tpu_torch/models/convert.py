"""Weights across frameworks: flax params tree <-> torch ``state_dict``.

The port's modules carry the flax module names (``models/layers.py``), so
a flax path ``layer_0/attention/query/kernel`` is the torch key
``layer_0.attention.query.weight``.  Only the leaf layouts differ:

* ``Dense`` kernel ``(in, out)`` -> weight ``(out, in)``;
* ``DenseGeneral`` q/k/v kernel ``(d_model, heads, head_dim)`` -> weight
  ``(heads, head_dim, d_model)``; the attention output kernel
  ``(heads, head_dim, d_model)`` (module ``out``, ``axis=(-2, -1)``) ->
  weight ``(d_model, heads, head_dim)``;
* ``Conv`` kernel ``(window, in/groups, out)`` (modules ``depthwise`` and
  ``pointwise``) -> weight ``(out, in/groups, window)``;
* ``LayerNorm`` ``scale`` -> ``weight``; biases keep their shape.

With ``shared_weights`` the one scanned block lives under
``shared_layer/layer``, which is also the torch path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV_MODULES = ("depthwise", "pointwise")


def _kernel_in_dims(module: str, ndim: int) -> int:
    """How many leading axes of a flax dense kernel are input axes."""
    return 2 if (module == "out" and ndim == 3) else 1


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax_params(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``params`` tree (nested dicts of numpy arrays) -> a torch
    ``state_dict`` of float32 tensors for the port's model."""
    state = OrderedDict()
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        module, name = path[-2], path[-1]
        if name == "kernel":
            if module in _CONV_MODULES:
                arr = arr.transpose(2, 1, 0)
            else:
                n_in = _kernel_in_dims(module, arr.ndim)
                arr = arr.transpose(
                    list(range(n_in, arr.ndim)) + list(range(n_in))
                )
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (name,))
        state[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return state


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`from_flax_params`: a nested dict of float32
    numpy arrays in the flax layout (``write_bundle``'s params tree)."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path = key.split(".")
        module, name = path[-2], path[-1]
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if name == "weight" and arr.ndim == 1:
            name = "scale"
        elif name == "weight":
            if module in _CONV_MODULES:
                arr = arr.transpose(2, 1, 0)
            else:
                n_out = arr.ndim - _kernel_in_dims(module, arr.ndim)
                arr = arr.transpose(
                    list(range(n_out, arr.ndim)) + list(range(n_out))
                )
            name = "kernel"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def input_features_of(params: Mapping[str, Any]) -> int:
    """Width of one input row, read off the input projection kernel."""
    return int(np.shape(params["input_projection"]["kernel"])[0])
