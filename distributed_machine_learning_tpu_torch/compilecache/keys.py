"""Canonical program keys: config -> shape-class fingerprint -> stable id.

Port of ``shape_class_fingerprint``, ``program_key`` and
``chunked_program_key`` from
``distributed_machine_learning_tpu/compilecache/keys.py`` (stdlib only,
copied as they are).  A trial's program is determined by everything that
shapes its computation: model family and architecture knobs,
batch/sequence shapes, dtypes, optimizer family.  It is NOT determined by
the hyperparameters that ride in state (``learning_rate``,
``weight_decay``, ``seed``), so two trials differing only in those share
a key.  The process executor asks an idle pre-warmed child to run the
first epoch of each new key during scheduler think-time
(``ProcessTrialExecutor.prewarm_program``).

The key is a sha256 over a canonical JSON rendering, stable across
processes and hosts, never ``hash()`` (salted per process).
"""

import hashlib
import json
from typing import Any, Dict, Optional, Sequence, Tuple

# Hyperparameters that never shape the traced program: they are carried in
# optimizer state / PRNG arguments (the vectorized runner's VECTOR_KEYS is
# this same set; tests/test_torch_liveness.py asserts they agree).
NON_STRUCTURAL_KEYS = frozenset({"learning_rate", "weight_decay", "seed"})

# Driver-level knobs that select HOW a program is built/cached but never
# appear in the traced computation itself.
_DRIVER_KEYS = frozenset({"share_programs", "checkpoint_freq"})


def _canonical(value: Any) -> Any:
    """JSON-stable rendering: tuples -> lists, sets sorted, floats via repr
    (json floats are already deterministic in CPython, but -0.0 vs 0.0 and
    int-valued floats must not alias ints)."""
    if isinstance(value, (list, tuple)):
        return [_canonical(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(_canonical(v) for v in value)
    if isinstance(value, dict):
        return {str(k): _canonical(v) for k, v in sorted(value.items())}
    if isinstance(value, float):
        return f"f:{value!r}"
    if isinstance(value, bool):
        return f"b:{value}"
    return value


def shape_class_fingerprint(config: Dict[str, Any]) -> Tuple:
    """The structural slice of a trial config, as a sorted item tuple.

    Everything except :data:`NON_STRUCTURAL_KEYS` and pure driver knobs is
    structural — d_model, heads, layers, batch_size, optimizer family,
    schedule family, interval/steps counts, dtypes all change the traced
    program.  EXCEPTION: with ``inject_hyperparams=False`` the optimizer
    bakes lr/wd into the HLO as constants, so they become structural again
    (the key must split what the compiler splits)."""
    injected = bool(config.get("inject_hyperparams", True))
    skip = set(_DRIVER_KEYS)
    skip.update(
        k for k in NON_STRUCTURAL_KEYS
        if injected or k == "seed"  # seed is a traced argument either way
    )
    items = []
    for k in sorted(config):
        if k in skip:
            continue
        items.append((k, _canonical(config[k])))
    return tuple(items)


def program_key(
    config: Dict[str, Any],
    *,
    batch_shape: Optional[Sequence[Sequence[int]]] = None,
    dtype: Optional[str] = None,
    donation: Sequence[int] = (),
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Stable id for one (shape class, batch shape, dtype, donation) program.

    ``batch_shape``: the data shapes the program closes over / is called
    with (e.g. staged train/val split shapes, or a serve bucket's padded
    input shape).  ``donation``: the ``donate_argnums`` signature — a
    donated and an undonated build of the same computation are different
    executables.  ``extra``: any additional identity the caller knows
    (population row count, scan trip count, mesh topology).
    """
    payload = {
        "v": 1,  # key-format version: bump if the canonicalization changes
        "fingerprint": _canonical(list(shape_class_fingerprint(config))),
        "batch_shape": _canonical(
            [list(s) for s in batch_shape] if batch_shape else []
        ),
        "dtype": dtype or "",
        "donation": sorted(int(d) for d in donation),
        "extra": _canonical(extra or {}),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return "pk_" + hashlib.sha256(blob.encode()).hexdigest()[:32]


def chunked_program_key(
    config: Dict[str, Any],
    *,
    chunk_rows: int,
    batch_shape: Optional[Sequence[Sequence[int]]] = None,
    dtype: Optional[str] = None,
    donation: Sequence[int] = (),
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """:func:`program_key` of one streaming CHUNK program
    (``data/pipeline.py``).

    The slab's row count (batches per staged chunk) folds into the key;
    the number of chunks per epoch does not: the host loops over chunks,
    so epochs of 10 and of 1000 chunks of one slab shape run the same
    program.  An epoch whose batch count the chunk size does not divide
    has one key more, its tail's.  The dataset's length therefore never
    splits streaming keys; the slab's geometry does."""
    merged = {"stream_chunk_rows": int(chunk_rows)}
    if extra:
        merged.update(extra)
    return program_key(
        config,
        batch_shape=batch_shape,
        dtype=dtype,
        donation=donation,
        extra=merged,
    )

