"""Pickle-free tensor checkpoints over pluggable storage.

Port of ``distributed_machine_learning_tpu/tune/checkpoint.py`` together
with the generation helpers of ``ckpt/manager.py`` it delegates to
(newest-valid fallback, retention).  The JAX package writes a flax msgpack
blob; the port writes raw tensor bytes plus a JSON index, two files per
step under a trial's checkpoint directory:

* ``ckpt_NNNNNN.tensors`` — the bytes of every tensor of the tree, one
  after another (each at a 64-byte aligned offset);
* ``ckpt_NNNNNN.json`` — the tree itself: its dicts, lists, tuples, ints,
  floats, strings, bools and None, and for each tensor its dtype, shape,
  byte offset and byte count; plus the sha256 of the ``.tensors`` file.

Each file is written atomically (temp file + ``os.replace``), the tensors
first and the index last, so an index on storage names bytes that landed;
the checksum catches bytes damaged or cut later.  A checkpoint's path is
its index, ``ckpt_NNNNNN.json``.  The names never end in ``.msgpack``, so
no JAX reader mistakes them for its own format.

A checkpoint that is overwritten in place (the population checkpoint of
``run_vectorized``) goes through :func:`save_replacing` instead: its
tensor file is named by its checksum (``population.<sha>.tensors``), the
index that names it is replaced last, and the tensor file of the old index
is deleted only after that.  A kill at any point leaves an index whose
bytes are on storage: the old checkpoint, or the new one.

bf16 has no numpy dtype, so every tensor is written as its bytes
(``tensor.view(torch.uint8)``) and read back by viewing them as its dtype:
a round trip gives the same bits and dtypes.  Nothing here imports
``pickle`` or calls ``torch.save``/``torch.load`` (both are pickle).
Loaded tensors are on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import posixpath
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.tune.storage import get_storage

FORMAT = "dml-torch-tensors-v1"
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.json$")
INDEX_SUFFIX = ".json"
TENSORS_SUFFIX = ".tensors"
_ALIGN = 64


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint's index or bytes failed their integrity check."""


def tensors_path_for(path: str) -> str:
    """The ``.tensors`` file that belongs to the index at ``path``."""
    if not path.endswith(INDEX_SUFFIX):
        raise ValueError(f"not a checkpoint index path: {path!r}")
    return path[: -len(INDEX_SUFFIX)] + TENSORS_SUFFIX


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointCorruptionError(f"unknown tensor dtype {name!r}")
    return dtype


def _encode(node, chunks: List[bytes], offset: List[int]):
    """The JSON form of ``node``; tensor bytes go to ``chunks``."""
    if isinstance(node, torch.Tensor):
        t = node.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        pad = -offset[0] % _ALIGN
        if pad:
            chunks.append(b"\0" * pad)
            offset[0] += pad
        entry = {"tensor": {"dtype": _dtype_name(t.dtype),
                            "shape": list(t.shape),
                            "offset": offset[0], "nbytes": len(raw)}}
        chunks.append(raw)
        offset[0] += len(raw)
        return entry
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str):
                raise TypeError(
                    f"checkpoint dict keys must be str, got {k!r}")
        return {"dict": {k: _encode(v, chunks, offset)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, chunks, offset) for v in node]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(
        f"a checkpoint holds tensors, dicts, lists, tuples, numbers, "
        f"strings and None; got {type(node).__name__}"
    )


def _decode(node, flat: torch.Tensor):
    if not isinstance(node, dict) or len(node) != 1:
        raise CheckpointCorruptionError(f"malformed checkpoint node {node!r}")
    (kind, body), = node.items()
    if kind == "tensor":
        dtype = _dtype_of(body["dtype"])
        shape = [int(s) for s in body["shape"]]
        off, n = int(body["offset"]), int(body["nbytes"])
        want = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        if n != want or off < 0 or off + n > flat.numel():
            raise CheckpointCorruptionError(
                f"tensor entry {body} does not fit its {flat.numel()} bytes")
        if n == 0:
            return torch.empty(shape, dtype=dtype)
        return flat[off:off + n].view(dtype).reshape(shape).clone()
    if kind == "dict":
        return {k: _decode(v, flat) for k, v in body.items()}
    if kind == "list":
        return [_decode(v, flat) for v in body]
    if kind == "tuple":
        return tuple(_decode(v, flat) for v in body)
    if kind == "value":
        return body
    raise CheckpointCorruptionError(f"unknown checkpoint node kind {kind!r}")


def _serialize(tree: Dict[str, Any]) -> Tuple[bytes, Dict[str, Any]]:
    """``tree``'s tensor bytes and its index (without a tensor name)."""
    chunks: List[bytes] = []
    index = _encode(tree, chunks, [0])
    payload = b"".join(chunks)
    return payload, {
        "format": FORMAT,
        "sha256": hashlib.sha256(payload).hexdigest(),
        "bytes": len(payload),
        "tree": index,
    }


def save_checkpoint(path: str, tree: Dict[str, Any]) -> str:
    """Write ``tree`` as the checkpoint whose index is ``path`` (any
    storage scheme): the tensor bytes first, then the index with their
    sha256.  Returns ``path``."""
    payload, meta = _serialize(tree)
    backend, p = get_storage(path)
    backend.write_bytes(tensors_path_for(p), payload)
    backend.write_bytes(p, json.dumps(meta).encode())
    return path


def save_replacing(path: str, tree: Dict[str, Any]) -> str:
    """Overwrite the checkpoint whose index is ``path`` so that a kill at
    any point leaves the old checkpoint or the new one whole.

    The tensor bytes go to a file of their own, named by their sha256
    (``<stem>.<sha[:16]>.tensors`` beside the index); then the index that
    names it replaces the old index; only then are the other tensor files
    of this stem deleted (the old index's, and any that a save cut before
    its index left behind).  Returns ``path``."""
    if not path.endswith(INDEX_SUFFIX):
        raise ValueError(f"not a checkpoint index path: {path!r}")
    payload, meta = _serialize(tree)
    backend, p = get_storage(path)
    directory, base = posixpath.split(p)
    stem = base[: -len(INDEX_SUFFIX)]
    name = f"{stem}.{meta['sha256'][:16]}{TENSORS_SUFFIX}"
    backend.write_bytes(backend.join(directory, name), payload)
    meta["tensors"] = name
    backend.write_bytes(p, json.dumps(meta).encode())
    stale = re.compile(re.escape(stem) + r"\.[0-9a-f]{16}"
                       + re.escape(TENSORS_SUFFIX) + "$")
    for other in backend.listdir(directory):
        if other != name and stale.match(other):
            backend.delete(backend.join(directory, other))
    return path


def _tensors_of(backend, p: str, meta: Dict[str, Any]) -> str:
    """The tensor file the index at ``p`` names: its own ``tensors``
    entry (a file name beside it), else the ``.tensors`` twin."""
    name = meta.get("tensors")
    if name is None:
        return tensors_path_for(p)
    if (not isinstance(name, str) or "/" in name or name.startswith(".")
            or not name.endswith(TENSORS_SUFFIX)):
        raise CheckpointCorruptionError(f"bad tensor file name {name!r}")
    return backend.join(posixpath.dirname(p), name)


def load_checkpoint(path: Optional[str],
                    verify: bool = True) -> Optional[Dict[str, Any]]:
    """Decode the checkpoint at ``path`` (its index); None when there is
    none.  With ``verify`` the sha256 of the tensor bytes is checked first.
    Damage raises :class:`CheckpointCorruptionError`."""
    if not path:
        return None
    backend, p = get_storage(path)
    raw = backend.read_bytes(p)
    if raw is None:
        return None
    try:
        meta = json.loads(raw)
        tree_node = meta["tree"]
        if meta.get("format") != FORMAT:
            raise ValueError(f"format {meta.get('format')!r}")
    except (ValueError, KeyError, TypeError) as exc:
        raise CheckpointCorruptionError(
            f"unreadable checkpoint index {path}: {exc!r}") from exc
    data = backend.read_bytes(_tensors_of(backend, p, meta))
    if data is None:
        raise CheckpointCorruptionError(f"{path}: its tensor file is missing")
    if verify and (len(data) != meta.get("bytes")
                   or hashlib.sha256(data).hexdigest() != meta.get("sha256")):
        raise CheckpointCorruptionError(
            f"checksum mismatch for {path} ({len(data)} bytes on storage)")
    flat = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if data
            else torch.empty(0, dtype=torch.uint8))
    return _decode(tree_node, flat)


def step_of_path(path: str) -> int:
    """The step encoded in a checkpoint path (0 if it names none)."""
    m = _CKPT_RE.match(posixpath.basename(str(path).rstrip("/")))
    return int(m.group(1)) if m else 0


def checkpoint_path(directory: str, iteration: int) -> str:
    """The index path of step ``iteration`` under ``directory``."""
    backend, d = get_storage(directory)
    return backend.join(d, f"ckpt_{int(iteration):06d}{INDEX_SUFFIX}")


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Sorted ``(step, index_path)`` of every checkpoint under
    ``directory``."""
    backend, d = get_storage(directory)
    out = []
    for name in backend.listdir(d):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), backend.join(d, name)))
    return sorted(out)


def find_latest_checkpoint(directory: str) -> Tuple[Optional[str], int]:
    """(path, step) of the newest checkpoint by name (no integrity check),
    or (None, 0)."""
    found = list_checkpoints(directory)
    if not found:
        return None, 0
    step, path = found[-1]
    return path, step


def load_checkpoint_with_fallback(
    path: Optional[str], directory: Optional[str] = None, log=None,
) -> Tuple[Optional[Dict[str, Any]], Optional[str], int]:
    """Restore ``path``; when it is missing or corrupt, fall back to the
    newest valid checkpoint under ``directory``.

    Returns ``(tree, used_path, used_iteration)`` — ``(None, None, 0)``
    when nothing restorable survives (the caller restarts from scratch).
    The corrupt files stay in place; retention prunes them like any old
    step.  Callers rewind their iteration bookkeeping to
    ``used_iteration``."""
    emit = log or (lambda msg: print(f"[checkpoint] {msg}", flush=True))
    if not path:
        # No restore target = a fresh trial; never restore one by accident.
        return None, None, 0
    try:
        tree = load_checkpoint(path)
        if tree is not None:
            return tree, path, step_of_path(path)
        emit(f"restore target {path} is missing")
    except CheckpointCorruptionError as exc:
        emit(f"restore target is corrupt: {exc}")
    if not directory:
        return None, None, 0
    for step, full in reversed(list_checkpoints(directory)):
        if full == path:
            continue  # already tried (and failed) above
        try:
            tree = load_checkpoint(full)
        except CheckpointCorruptionError as exc:
            emit(f"skipping corrupt checkpoint {full}: {exc}")
            continue
        if tree is not None:
            emit(f"fell back to valid checkpoint {full} (step={step})")
            return tree, full, step
    return None, None, 0


def prune_checkpoints(directory: str, keep: int, protect=None,
                      pending_latest: Optional[str] = None) -> int:
    """Keep only the ``keep`` newest checkpoints in ``directory``.

    ``protect`` (a path, or an iterable of them) is never deleted even if
    old — e.g. a checkpoint a pending retry is about to restore.
    ``pending_latest`` is protected likewise.  Returns the number of
    checkpoints deleted (each with its tensor file)."""
    if keep <= 0:
        return 0
    if protect is None:
        protected = set()
    elif isinstance(protect, str):
        protected = {protect}
    else:
        protected = set(protect)
    if pending_latest is not None:
        protected.add(pending_latest)
    found = list_checkpoints(directory)
    excess = found[:-keep] if len(found) > keep else []
    backend, _ = get_storage(directory)
    deleted = 0
    for _step, full in excess:
        if full in protected:
            continue
        # Index first: a reader never sees an index whose bytes are gone.
        backend.delete(full)
        backend.delete(tensors_path_for(full))
        deleted += 1
    return deleted
