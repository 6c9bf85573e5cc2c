"""Pluggable byte storage for checkpoints and experiment artifacts.

Port of ``distributed_machine_learning_tpu/tune/storage.py``: the
backends a local sweep uses, dispatched on the path's scheme:

* plain paths / ``file://``  -> ``LocalStorage`` (atomic POSIX writes)
* ``mem://``                 -> ``MemoryStorage`` (process-local fake for
  tests; no disk, no network)

Remote object storage (``gs://``, ``s3://``: ``FsspecStorage`` there) and
the chaos fault wrapper are not ported yet (ROADMAP.md A3f); any other
scheme raises ``NotImplementedError``.

``get_storage`` wraps the backend in ``RetryingStorage``: exponential
backoff + jitter + a bounded attempt budget for transient I/O faults.
``retry_call`` is the same policy as a bare function, used by the
experiment store's local JSON writes (state snapshots, params) which
bypass the byte-backend interface.
"""

from __future__ import annotations

import hashlib
import os
import posixpath
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class StorageBackend:
    """Minimal byte-level interface checkpoints need."""

    def write_bytes(self, path: str, data: bytes) -> str:
        raise NotImplementedError

    def read_bytes(self, path: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Names (not full paths) of entries under ``path``; [] if absent."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def join(self, *parts: str) -> str:
        return posixpath.join(*parts)


class LocalStorage(StorageBackend):
    """Local filesystem with atomic writes (temp file + rename)."""

    def write_bytes(self, path: str, data: bytes) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def read_bytes(self, path: str) -> Optional[bytes]:
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))

    def delete(self, path: str) -> None:
        if os.path.exists(path):
            os.unlink(path)

    def join(self, *parts: str) -> str:
        return os.path.join(*parts)


class MemoryStorage(StorageBackend):
    """Process-local in-memory store keyed by full path (test fake).

    A single shared namespace (class-level) so independently constructed
    instances — e.g. the saver inside the executor and the loader in a test —
    see the same data, mirroring how a bucket behaves across components.
    """

    _store: Dict[str, bytes] = {}
    _lock = threading.Lock()

    def write_bytes(self, path: str, data: bytes) -> str:
        with self._lock:
            self._store[path] = bytes(data)
        return path

    def read_bytes(self, path: str) -> Optional[bytes]:
        with self._lock:
            return self._store.get(path)

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._store

    def listdir(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/"
        with self._lock:
            names = {
                key[len(prefix):].split("/", 1)[0]
                for key in self._store if key.startswith(prefix)
            }
        return sorted(names)

    def delete(self, path: str) -> None:
        with self._lock:
            self._store.pop(path, None)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._store.clear()


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-budget exponential backoff for transient storage faults.

    ``attempts`` is the TOTAL number of tries (1 = no retry).  Delay before
    retry k (1-based) is ``base_delay_s * 2**(k-1)`` capped at
    ``max_delay_s``, plus a deterministic jitter in ``[0, jitter * delay]``
    derived from the operation key — reproducible, yet decorrelated across
    concurrent writers.
    """

    attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    retry_on: Tuple[type, ...] = field(default=(OSError, TimeoutError))

    def delay_for(self, attempt: int, key: str = "") -> float:
        delay = min(self.base_delay_s * (2 ** attempt), self.max_delay_s)
        if self.jitter > 0:
            h = hashlib.sha256(f"{key}/{attempt}".encode()).digest()
            frac = int.from_bytes(h[:8], "little") / 2**64
            delay += self.jitter * delay * frac
        return delay


DEFAULT_RETRY_POLICY = RetryPolicy()


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               key: str = "", log: Optional[Callable[[str], None]] = None,
               **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``policy`` (default:
    ``DEFAULT_RETRY_POLICY``).  Retries only the policy's exception types; the final attempt's
    error propagates unchanged so callers keep their existing error paths."""
    policy = policy if policy is not None else DEFAULT_RETRY_POLICY
    if policy.attempts <= 1:
        return fn(*args, **kwargs)
    last_exc: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as exc:
            last_exc = exc
            if attempt == policy.attempts - 1:
                raise
            delay = policy.delay_for(attempt, key)
            if log is not None:
                log(
                    f"transient storage fault (attempt "
                    f"{attempt + 1}/{policy.attempts}): {exc!r}; retrying "
                    f"in {delay:.3f}s"
                )
            time.sleep(delay)
    raise last_exc  # pragma: no cover - loop always returns or raises


class RetryingStorage(StorageBackend):
    """Decorator adding the retry policy to every byte operation; ``join``
    delegates straight through."""

    def __init__(self, inner: StorageBackend,
                 policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.policy = policy or DEFAULT_RETRY_POLICY

    def _retry(self, op: str, fn: Callable, path: str, *args):
        return retry_call(fn, path, *args, policy=self.policy,
                          key=f"{op}:{path}")

    def write_bytes(self, path: str, data: bytes) -> str:
        return self._retry("write", self.inner.write_bytes, path, data)

    def read_bytes(self, path: str) -> Optional[bytes]:
        return self._retry("read", self.inner.read_bytes, path)

    def exists(self, path: str) -> bool:
        return self._retry("exists", self.inner.exists, path)

    def listdir(self, path: str) -> List[str]:
        return self._retry("listdir", self.inner.listdir, path)

    def delete(self, path: str) -> None:
        return self._retry("delete", self.inner.delete, path)

    def join(self, *parts: str) -> str:
        return self.inner.join(*parts)


_local = LocalStorage()
_memory = MemoryStorage()


def _raw_storage(path: str) -> Tuple[StorageBackend, str]:
    if "://" not in path:
        return _local, path
    scheme, rest = path.split("://", 1)
    if scheme == "file":
        return _local, rest
    if scheme == "mem":
        return _memory, path  # keep full mem:// key
    raise NotImplementedError(
        f"storage scheme {scheme!r}: remote storage (FsspecStorage) is not "
        f"ported yet; see ROADMAP.md A3f"
    )


def get_storage(path: str) -> Tuple[StorageBackend, str]:
    """Backend + normalized path for ``path``, dispatched on its scheme and
    wrapped with the default retry policy."""
    backend, p = _raw_storage(path)
    return RetryingStorage(backend), p
