#!/usr/bin/env python3
"""The README quickstart on one NVIDIA GPU through the port, and where a
quickstart trial's time goes.

    python3 chip_quickstart.py

1. sweep — README.md:42-62 with the package name changed and the
   experiment written to a temporary directory: ``tune.run`` over the
   quickstart's space (``chip_smoke.quickstart_sweep``) with its 50
   samples of at most 20 epochs, BayesOpt and ASHA, then
   ``print(analysis.best_config)`` as the README does.  One JSON line
   follows: the card's name and power limit, the trial count, wall
   seconds, ``trials_per_hour``, each trial's attention type and stop
   iteration, the median epoch seconds of flash and other trials, and the
   sweep's kernel launches.  Every trial must end TERMINATED.
   ``chip_smoke.py``'s phase ``tune`` runs the same sweep cut in depth.
2. trial — one flash trial of the quickstart (the best flash config of the
   sweep) trained alone for its ``num_epochs`` under
   ``tune.session.standalone``, each reported checkpoint written as
   ``tune.run`` writes it: its kernel launches; the host time spent
   inside the flash wrappers (``flash_forward`` and ``flash_backward``,
   timed around each call, kernel launches included) per epoch; the
   checkpoint write's time; each epoch's wall time from one report to
   the next; and one such epoch under ``torch.profiler``: the device
   time and count of every kernel and copy in it, the busy time's share
   of the median unprofiled epoch, and the top kernels.

The script imports nothing of JAX; it exits nonzero without a card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from chip_smoke import (
    _reset_counters,
    median_epoch_s,
    quickstart_sweep,
    smi_line,
)

# The README quickstart's depth (README.md:53-61).
SAMPLES, EPOCHS = 50, 20


def sweep(tune, train, val, root: str):
    analysis, wall_s, launches = quickstart_sweep(
        tune, train, val, root, num_samples=SAMPLES, num_epochs=EPOCHS,
        grace_period=2, random_search_steps=10)
    print(analysis.best_config, flush=True)
    trials = analysis.trials
    print(json.dumps({
        "phase": "sweep", "card": smi_line(), "trials": len(trials),
        "wall_s": wall_s, "trials_per_hour": analysis.trials_per_hour(),
        "device_utilization": analysis.device_utilization,
        "epochs_run": sum(t.training_iteration for t in trials),
        "stop_iterations": [[t.config["attention_type"],
                             t.training_iteration] for t in trials],
        "median_epoch_s": {"flash": median_epoch_s(trials, True),
                           "other": median_epoch_s(trials, False)},
        "launches": launches,
    }), flush=True)
    return analysis


def flash_trial(tune, train, val, config: dict, profile_epoch: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.tune import checkpoint

    wrapper_s = [0.0]
    save_ms = []
    ckpt_dir = tempfile.mkdtemp()

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                wrapper_s[0] += time.perf_counter() - t0
        return call

    plain = (fa.flash_forward, fa.flash_backward)
    fa.flash_forward, fa.flash_backward = map(timed, plain)
    marks, wrapper_marks, prof = [], [], [None]

    def on_report(metrics, checkpoint_tree):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        wrapper_marks.append(wrapper_s[0])
        epoch = metrics["epoch"]
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(
            checkpoint.checkpoint_path(ckpt_dir, epoch + 1), checkpoint_tree)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        if epoch == profile_epoch - 1:
            prof[0] = profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
            prof[0].__enter__()
        elif epoch == profile_epoch:
            prof[0].__exit__(None, None, None)

    counters = _reset_counters()
    try:
        with tune.session.standalone(devices=[torch.device("cuda", 0)],
                                     report_fn=on_report):
            tune.train_regressor(config, train_data=train, val_data=val)
    finally:
        fa.flash_forward, fa.flash_backward = plain
    launches = {c.name: c.count for c in counters}
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, n))
                     for n in os.listdir(ckpt_dir)
                     if n.startswith(f"ckpt_{len(marks):06d}."))
    shutil.rmtree(ckpt_dir)

    windows_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    wrapper_ms = [(b - a) * 1e3 for a, b in zip(wrapper_marks,
                                                 wrapper_marks[1:])]
    # Window i ends at the report of epoch i + 1; the profiled one is
    # left out of the unprofiled medians.
    plain_windows = [w for i, w in enumerate(windows_ms)
                     if i + 1 != profile_epoch]
    plain_wrapper = [w for i, w in enumerate(wrapper_ms)
                     if i + 1 != profile_epoch]
    by_kernel, device_events = {}, 0
    for evt in prof[0].key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = (by_kernel.get(evt.key, 0.0)
                                  + evt.self_device_time_total / 1e3)
            device_events += evt.count
    busy_ms = sum(by_kernel.values())
    median_ms = float(np.median(plain_windows))
    flash_ms = sum(ms for k, ms in by_kernel.items() if "flash_" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "phase": "trial", "card": smi_line(), "config": config,
        "epochs": len(marks), "launches": launches,
        "launches_per_epoch": {k: v / len(marks) for k, v in launches.items()},
        "epoch_wall_ms_median": median_ms,
        "epoch_wall_ms": windows_ms,
        "flash_wrapper_host_ms_per_epoch_median": float(
            np.median(plain_wrapper)),
        "profiled_epoch": profile_epoch,
        "profiled_epoch_wall_ms": windows_ms[profile_epoch - 1],
        "checkpoint_write_ms_median": float(np.median(save_ms)),
        "checkpoint_bytes": ckpt_bytes,
        "profiled_epoch_device_busy_ms": busy_ms,
        "profiled_epoch_device_events": device_events,
        "profiled_epoch_flash_kernel_ms": flash_ms,
        "device_busy_share": busy_ms / median_ms,
        "device_top_ms": {k[:70]: v for k, v in top},
    }), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the quickstart runs on a card",
              file=sys.stderr)
        return 2
    from distributed_machine_learning_tpu_torch import tune
    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )

    train, val = dummy_regression_data(num_samples=1000, seq_len=50,
                                       num_features=10)
    with tempfile.TemporaryDirectory() as root:
        analysis = sweep(tune, train, val, root)
    flash = [t for t in analysis.trials
             if t.config["attention_type"] == "flash"]
    if not flash:
        print("error: the sweep sampled no flash trial", file=sys.stderr)
        return 1
    best = min(flash, key=lambda t: min(t.metric_history("validation_mape")))
    flash_trial(tune, train, val, dict(best.config),
                profile_epoch=EPOCHS // 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
