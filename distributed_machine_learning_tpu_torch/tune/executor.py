"""Trial executor: binds trials to devices and runs them.

Port of ``distributed_machine_learning_tpu/tune/executor.py``:
``DeviceManager`` and ``ThreadTrialExecutor``.  A ``DeviceManager`` owns
the ``torch.device``s of a sweep (every visible card by default) and
leases 1..N of them per trial, the lowest free indices first; the
trainable runs in a thread under ``torch.cuda.device(lease[0])`` (the
current device is per thread) and finds its lease in the session
(``session.get_devices()``).  Threads, not processes: PyTorch releases
the GIL while a kernel runs and while it waits on the card, so trials on
different cards overlap.

``report`` is synchronous with the runner (the thread blocks until the
scheduler answers), which makes early-stop decisions take effect on the
very next epoch and keeps scheduler state single-threaded.  A reported
checkpoint is written on the trial's thread before the report reaches the
runner (the JAX package writes on a background thread).

Not ported yet (ROADMAP.md A3b): ``ProcessTrialExecutor``, the process per
trial with device visibility by ``CUDA_VISIBLE_DEVICES``, and the liveness
watchdog and chaos hooks.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

from distributed_machine_learning_tpu_torch.tune import checkpoint as ckpt_lib
from distributed_machine_learning_tpu_torch.tune.session import (
    PauseTrial,
    Session,
    StopTrial,
    set_session,
)
from distributed_machine_learning_tpu_torch.tune.trial import Trial
from distributed_machine_learning_tpu_torch.utils.device import resolve_device


class DeviceManager:
    """Leases ``torch.device``s to trials. Runner-thread only.

    ``devices=None`` takes every visible card and raises when there is
    none; a caller who wants the CPU passes ``[torch.device("cpu"), ...]``
    — n entries are n concurrent lease slots.  Tracks per-device busy time
    so the runner can report device utilization.
    """

    def __init__(self, devices: Optional[List] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "tune.run found no CUDA device; pass "
                    "devices=[torch.device('cpu'), ...] to run trials on "
                    "the CPU"
                )
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise RuntimeError("DeviceManager needs at least one device")
        self._free = list(range(len(self.devices)))
        self._busy_s = [0.0] * len(self.devices)
        self._leased_at: Dict[int, float] = {}

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def acquire(self, n: int) -> Optional[List]:
        """``[(index, device), ...]`` for the ``n`` lowest free indices, or
        None when fewer than ``n`` are free."""
        if n > len(self.devices):
            raise ValueError(
                f"Trial requests {n} devices but only {len(self.devices)} exist"
            )
        if len(self._free) < n:
            return None
        idxs = sorted(self._free)[:n]
        now = time.time()
        for i in idxs:
            self._free.remove(i)
            self._leased_at[i] = now
        return [(i, self.devices[i]) for i in idxs]

    def release(self, leased: List):
        now = time.time()
        for i, _ in leased:
            self._free.append(i)
            start = self._leased_at.pop(i, None)
            if start is not None:
                self._busy_s[i] += now - start
        self._free.sort()

    def utilization(self, wall_clock_s: float) -> float:
        """Fraction of device-seconds spent leased to trials over the run."""
        if wall_clock_s <= 0:
            return 0.0
        now = time.time()
        busy = sum(self._busy_s) + sum(
            now - start for start in self._leased_at.values()
        )
        return min(busy / (wall_clock_s * len(self.devices)), 1.0)


def _rewind_after_fallback(trial: Trial, tree, used_path, used_iteration):
    """Align a trial's progress bookkeeping with what actually restored.

    When corruption forced ``load_checkpoint_with_fallback`` off the
    requested restore target (older checkpoint, or nothing at all), the
    trial's ``restore_base``/checkpoint pointers rewind with it — otherwise
    ``training_iteration`` (scheduler rungs, checkpoint numbering) would
    claim progress the restored state doesn't have.  Runs before the
    incarnation's first report.
    """
    if not trial.restore_path:
        return
    if tree is None:
        print(
            f"[executor] WARNING: no checksum-valid checkpoint for "
            f"{trial.trial_id} (wanted {trial.restore_path}); restarting "
            f"from scratch",
            flush=True,
        )
        trial.restore_path = None
        trial.restore_base = 0
        trial.latest_checkpoint = None
        trial.latest_checkpoint_iteration = 0
    elif used_path != trial.restore_path:
        print(
            f"[executor] WARNING: {trial.trial_id} restore fell back "
            f"{trial.restore_path} -> {used_path} (iteration "
            f"{used_iteration})",
            flush=True,
        )
        trial.restore_path = used_path
        trial.restore_base = used_iteration
        trial.latest_checkpoint = used_path
        trial.latest_checkpoint_iteration = used_iteration


class ResultEvent:
    __slots__ = ("trial", "metrics", "decision", "done", "incarnation")

    def __init__(self, trial: Trial, metrics: Dict, incarnation: int = 0):
        self.trial = trial
        self.metrics = metrics
        self.decision = "continue"
        self.done = threading.Event()
        self.incarnation = incarnation


class ThreadTrialExecutor:
    """Runs each trial in a thread on its leased devices."""

    def __init__(self, store, event_queue: "queue.Queue"):
        self.store = store
        self.events = event_queue
        self._threads: Dict[str, threading.Thread] = {}
        # Set at teardown: every later report answers "stop", so a trial
        # still running when the runner stops ends at its next epoch.
        self._closing = threading.Event()

    def start_trial(self, trial: Trial, trainable: Callable, leased_devices: List):
        devices = [d for _, d in leased_devices]
        trial.assigned_devices = leased_devices
        thread = threading.Thread(
            target=self._run,
            args=(trial, trainable, devices, trial.incarnation),
            name=f"trial-{trial.trial_id}",
            daemon=True,
        )
        self._threads[trial.trial_id] = thread
        thread.start()

    def is_alive(self, trial: Trial) -> bool:
        t = self._threads.get(trial.trial_id)
        return t is not None and t.is_alive()

    def join_all(self, timeout: float = 300.0) -> bool:
        """Stop and join every trial thread (shared deadline).

        Reports made from now on answer "stop", and every report already
        queued for the runner is answered "stop" here, so no thread stays
        blocked on a decision; a thread in the middle of an epoch ends at
        its next report.  Returns False if a thread outlived ``timeout``."""
        self._closing.set()
        deadline = time.monotonic() + timeout
        threads = list(self._threads.values())
        while any(t.is_alive() for t in threads):
            while True:
                try:
                    event = self.events.get_nowait()
                except queue.Empty:
                    break
                if event[0] == "result":
                    event[1].decision = "stop"
                    event[1].done.set()
            if time.monotonic() > deadline:
                return False
            for t in threads:
                t.join(timeout=0.05)
        return True

    # -- trial thread body ---------------------------------------------------
    def _run(self, trial: Trial, trainable: Callable, devices: List,
             incarnation: int = 0):
        def report_fn(metrics: Dict, checkpoint) -> str:
            if self._closing.is_set():
                return "stop"
            if checkpoint is not None:
                count = trial.training_iteration + 1
                path = ckpt_lib.checkpoint_path(
                    self.store.checkpoint_dir(trial), count)
                ckpt_lib.save_checkpoint(path, checkpoint)
                trial.latest_checkpoint = path
                trial.latest_checkpoint_iteration = count
            event = ResultEvent(trial, metrics, incarnation)
            self.events.put(("result", event))
            event.done.wait()
            return event.decision

        def checkpoint_loader():
            tree, used, used_it = ckpt_lib.load_checkpoint_with_fallback(
                trial.restore_path, self.store.checkpoint_dir(trial),
            )
            _rewind_after_fallback(trial, tree, used, used_it)
            return tree

        set_session(Session(trial, report_fn, checkpoint_loader, devices))
        try:
            on_card = (torch.cuda.device(devices[0])
                       if devices[0].type == "cuda"
                       else contextlib.nullcontext())
            with on_card:
                trainable(dict(trial.config))
            self.events.put(("complete", trial, None, incarnation))
        except (StopTrial, PauseTrial):
            self.events.put(("complete", trial, None, incarnation))
        except BaseException:  # noqa: BLE001 - report crash to the runner
            self.events.put(("error", trial, traceback.format_exc(), incarnation))
        finally:
            set_session(None)
