"""Shared pieces of the port's tune tests (tests/test_torch_tune_*.py).

``restore_global_state`` puts back what a port tune test could change in
the worker process it shares with other test files: the environment, the
cwd, torch's default dtype and thread count, the logging handlers of both
packages' logger roots, and it fails a test that leaves a trial thread
running.  ``scripted_metric`` is the pure-Python objective both packages'
scripted trainables report.
"""

from __future__ import annotations

import logging
import math
import os
import threading

import pytest

torch = pytest.importorskip("torch")


def _environ():
    # pytest itself rewrites PYTEST_CURRENT_TEST at every phase.
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


def _trial_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("trial-") and t.is_alive())


@pytest.fixture(autouse=True)
def restore_global_state(monkeypatch, tmp_path):
    env = _environ()
    cwd = os.getcwd()
    dtype = torch.get_default_dtype()
    threads = torch.get_num_threads()
    handlers = {name: list(logging.getLogger(name).handlers)
                for name in ("dml_tpu", "dml_torch")}
    # A JAX tune.run used as the oracle must not write the AOT cache
    # under HOME: point the cache variable into this test's tmp_path.
    monkeypatch.setenv("DML_TPU_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    torch.set_num_threads(1)
    before = _trial_threads()
    yield
    left = [n for n in _trial_threads() if n not in before]
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)
    os.chdir(cwd)
    for name, saved in handlers.items():
        logging.getLogger(name).handlers[:] = saved
    monkeypatch.undo()
    assert _environ() == env, "a test changed os.environ"
    assert not left, f"trial threads left running: {left}"


def scripted_metric(config, iteration: int) -> float:
    """A deterministic objective of the config and the epoch (1-based)."""
    lr = float(config.get("learning_rate", 1e-3))
    width = float(config.get("d_model", 32))
    return (abs(math.log10(lr) + 3.0) + 32.0 / width
            + 1.0 / (iteration + 1.0) + 0.01 * iteration)
