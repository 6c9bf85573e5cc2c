"""Structured logging for the framework.

The reference's only logging was a stdlib file handler with a hard-coded
home-directory path in the smoke script (`ray-tune-hpo-regression-sample.py:
16-23`) and bare ``print`` in the production script (`:350,480`).  Here every
component logs through one namespaced logger tree (``dml_torch.*``) with the same
``asctime - levelname - message`` format the reference used, a configurable
destination, and an optional JSONL handler for machine-readable event streams
(SURVEY.md §5 observability).

A copy of ``distributed_machine_learning_tpu/utils/logging.py`` under its
own logger root, ``dml_torch``, so the two packages' handlers never mix.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Mapping, Optional

ROOT_NAME = "dml_torch"
_FORMAT = "%(asctime)s - %(levelname)s - %(name)s - %(message)s"


def _root() -> logging.Logger:
    root = logging.getLogger(ROOT_NAME)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return root


def get_logger(name: str = "", level: Optional[int] = None) -> logging.Logger:
    """Return a namespaced framework logger.

    ``get_logger("tune.runner")`` -> logger ``dml_torch.tune.runner``.  An
    explicit ``level`` is applied to the framework root on every call (not just
    the first), so later callers can raise/lower verbosity.
    """
    root = _root()
    if level is not None:
        root.setLevel(level)
    return logging.getLogger(f"{ROOT_NAME}.{name}" if name else ROOT_NAME)


def add_file_handler(log_file: str) -> logging.Handler:
    """Attach a file handler to the framework root; caller owns its lifetime.

    Pair with :func:`remove_handler` (e.g. at experiment end) so handlers do
    not accumulate across experiments in a long-lived process.
    """
    path = os.path.abspath(os.path.expanduser(log_file))
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_FORMAT))
    _root().addHandler(handler)
    return handler


def remove_handler(handler: logging.Handler):
    _root().removeHandler(handler)
    handler.close()


class JsonlEventLog:
    """Append-only JSONL event stream (one experiment-level file).

    Every event gets a wall-clock timestamp; values are coerced to JSON-safe
    types the same way the experiment store does.  Field names that collide
    with the reserved ``event``/``timestamp`` keys are prefixed rather than
    dropped or crashed on.
    """

    RESERVED = ("event", "timestamp")

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, event: str, fields: Optional[Mapping[str, Any]] = None):
        from distributed_machine_learning_tpu_torch.tune.experiment import _jsonable

        record: Dict[str, Any] = {"event": event, "timestamp": time.time()}
        for k, v in (fields or {}).items():
            key = f"field_{k}" if k in self.RESERVED else k
            record[key] = _jsonable(v)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()
