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

:func:`flax_axes` names the permutation back to the flax layout per leaf
(adafactor factors each leaf in that order, ``ops/optimizers.py``).

With ``shared_weights`` the one scanned block lives under
``shared_layer/layer``, which is also the torch path.

A population (``tune/vectorized.py``) holds K models' weights stacked on a
leading axis in both packages: :func:`population_from_flax` carries a JAX
population's params (numpy leaves ``[K, ...]``) into the port's stacked
state, :func:`stack_rows`/:func:`unstack_rows` go between K state dicts
and one stacked dict.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_CONV_MODULES = ("depthwise", "pointwise")


def _kernel_in_dims(module: str, ndim: int) -> int:
    """How many leading axes of a flax dense kernel are input axes."""
    return 2 if (module == "out" and ndim == 3) else 1


def flax_axes(key: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The permutation of a port leaf's axes that gives its flax layout
    (``weight.permute(*axes)`` is the flax kernel), or None for a leaf
    whose layout is the same in both (biases, layer-norm scales)."""
    path = key.split(".")
    if path[-1] != "weight" or ndim < 2:
        return None
    if path[-2] in _CONV_MODULES:
        return (2, 1, 0)
    n_out = ndim - _kernel_in_dims(path[-2], ndim)
    return tuple(range(n_out, ndim)) + tuple(range(n_out))


def flax_leaf_axes(params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Tuple[int, ...]]:
    """:func:`flax_axes` of every parameter that has one (the
    ``leaf_axes`` of ``ops.optimizers.make_optimizer``)."""
    axes = {k: flax_axes(k, p.dim()) for k, p in params.items()}
    return {k: a for k, a in axes.items() if a is not None}


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
        name = path[-1]
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if name == "weight" and arr.ndim == 1:
            name = "scale"
        elif name == "weight":
            arr = arr.transpose(flax_axes(key, arr.ndim))
            name = "kernel"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def input_features_of(params: Mapping[str, Any]) -> int:
    """Width of one input row, read off the input projection kernel."""
    return int(np.shape(params["input_projection"]["kernel"])[0])


def stack_rows(states: Sequence[Mapping[str, torch.Tensor]]
               ) -> "OrderedDict[str, torch.Tensor]":
    """K state dicts of one model -> one dict of ``[K, ...]`` tensors."""
    return OrderedDict((k, torch.stack([s[k] for s in states]))
                       for k in states[0])


def unstack_rows(stacked: Mapping[str, torch.Tensor]
                 ) -> List["OrderedDict[str, torch.Tensor]"]:
    """The inverse of :func:`stack_rows`."""
    rows = next(iter(stacked.values())).shape[0]
    return [OrderedDict((k, t[i]) for k, t in stacked.items())
            for i in range(rows)]


def _row_of(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: _row_of(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def population_from_flax(params: Mapping[str, Any]
                         ) -> "OrderedDict[str, torch.Tensor]":
    """A JAX population's ``params`` (flax layout, every leaf ``[K, ...]``)
    -> the port's stacked state: :func:`from_flax_params` per row."""
    rows = next(np.shape(leaf)[0] for _, leaf in _flatten(params))
    return stack_rows([from_flax_params(_row_of(params, i))
                       for i in range(rows)])
