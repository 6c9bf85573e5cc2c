#!/usr/bin/env python3
"""The bench headline sweep on one NVIDIA GPU through the port's
``tune.run_vectorized``, beside the same space through per-trial
``tune.run``, and where a population step's time goes.

    python3 chip_vectorized.py

1. headline — ``bench.py``'s headline sweep uncut (``chip_smoke.
   headline_sweep``: 50 trials x 20 epochs of the d_model 64 transformer
   on ``glucose_like_data(100_000, 16)``, f32, seed 42): FIFO twice, then
   ASHA (max_t 20, grace 5, factor 2) once.  One JSON line per sweep: the
   card's name and power limit, wall seconds, trials/hour, row-epochs,
   the runner's ``device_utilization`` (dispatch-to-sync seconds over
   wall seconds), compactions and stop iterations.
2. per_trial — the same space through the port's ``tune.run`` with
   ``tune.train_regressor`` (one trial at a time on the card, the same
   seed), cut to 8 trials x 20 epochs: wall seconds and trials/hour, the
   number to set beside the population's.
3. step — one population step (one batch of every row: forward,
   backward, population adam) at K = 50 and K = 1, profiled: host ms,
   device span and busy ms, launches, and the top kernels by device time;
   at K = 50 also one epoch split into shuffles, training steps, eval
   blocks and the read back.
   The same for the flash group (``attention_type="flash"``) at K = 8 and
   K = 50, with the host ms inside the flash wrappers and inside their
   conforming copy (``tensor_core_operands``) per step.

The script imports nothing of JAX; it exits nonzero without a card.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

from chip_smoke import (
    HEADLINE,
    HEADLINE_ASHA,
    headline_data,
    headline_space,
    headline_sweep,
    population_step,
    profile_population_step,
    smi_line,
)

PER_TRIAL_SAMPLES = 8


def sweep_line(tag, analysis, wall_s, state) -> dict:
    return {
        "phase": "headline", "sweep": tag, "card": smi_line(),
        "trials": len(analysis.trials), "wall_s": wall_s,
        "trials_per_hour": analysis.num_terminated() * 3600.0 / wall_s,
        "row_epochs": state["row_epochs_computed"],
        "device_utilization": state["device_utilization"],
        "device_exec_s": state["device_exec_s"],
        "compactions": state["population_compactions"],
        "stop_iterations": sorted(t.training_iteration
                                  for t in analysis.trials),
        "best_validation_mape": analysis.best_result["validation_mape"],
    }


def per_trial(tune, train, val, root) -> dict:
    import torch

    t0 = time.monotonic()
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        headline_space(tune), metric="validation_mape", mode="min",
        num_samples=PER_TRIAL_SAMPLES, seed=42, storage_path=root,
        name="per_trial", devices=[torch.device("cuda", 0)], verbose=0)
    wall_s = time.monotonic() - t0
    bad = [t.trial_id for t in analysis.trials
           if t.status.value != "TERMINATED"]
    if bad:
        raise AssertionError(f"per_trial: trials not TERMINATED: {bad}")
    epochs = [r["epoch_time_s"] for t in analysis.trials for r in t.results]
    return {
        "phase": "per_trial", "card": smi_line(),
        "cut": f"{PER_TRIAL_SAMPLES} trials x {HEADLINE['num_epochs']} "
               f"epochs, from the headline's 50 x 20",
        "trials": len(analysis.trials), "wall_s": wall_s,
        "trials_per_hour": analysis.trials_per_hour(),
        "epochs_run": len(epochs),
        "median_epoch_s": sorted(epochs)[len(epochs) // 2],
    }


def top_kernels(step_fn, n: int = 8) -> dict:
    """The step's device time by kernel (torch.profiler, one step behind
    a discarded warm-up step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            float(step_fn().sum())
            prof.step()
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    events.sort(key=lambda e: -e[1])
    return {k[:70]: {"ms": ms, "count": c} for k, ms, c in events[:n]}


def epoch_breakdown(program, state) -> dict:
    """One population epoch split into its parts, each timed on the host
    clock to a synchronize: the rows' shuffles, the training steps, the
    eval blocks and the one read back (the mean of epochs 1 and 2, after
    epoch 0 as a warm-up)."""
    import torch

    spent = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    for epoch in range(3):
        if epoch == 1:
            spent.clear()
        perms = timed("permutations_ms",
                      lambda: program.permutations(state, epoch))
        losses = timed("train_ms",
                       lambda: program.train_epoch(state, epoch, perms))
        sums = timed("eval_ms", lambda: program.eval_sums(state))
        timed("read_back_ms",
              lambda: torch.cat([losses[:, None], sums], dim=1).cpu())
    return {k: v / 2 for k, v in spent.items()}


def flash_host_ms(step_fn) -> dict:
    """Host ms per step inside ``flash_forward``/``flash_backward`` and
    inside their conforming copy, timed around each call."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    spent = {"wrappers": 0.0, "tensor_core_operands": 0.0}
    saved = fa.flash_forward, fa.flash_backward, fa.tensor_core_operands

    def timed(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += (time.perf_counter() - t0) * 1e3
        return call

    float(step_fn().sum())
    torch.cuda.synchronize()
    fa.flash_forward = timed("wrappers", saved[0])
    fa.flash_backward = timed("wrappers", saved[1])
    fa.tensor_core_operands = timed("tensor_core_operands", saved[2])
    try:
        for _ in range(5):
            float(step_fn().sum())
    finally:
        fa.flash_forward, fa.flash_backward, fa.tensor_core_operands = saved
    return {k: v / 5 for k, v in spent.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_vectorized.py runs on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_machine_learning_tpu_torch import tune

    train, val = headline_data()
    with tempfile.TemporaryDirectory() as root:
        results = []
        for tag, kwargs in (
                ("fifo_1", {"epochs_per_dispatch": HEADLINE["num_epochs"]}),
                ("fifo_2", {"epochs_per_dispatch": HEADLINE["num_epochs"]}),
                ("asha", {"scheduler": tune.ASHAScheduler(**HEADLINE_ASHA)})):
            analysis, wall_s, state, _ = headline_sweep(
                tune, train, val, root, tag, **kwargs)
            results.append(sweep_line(tag, analysis, wall_s, state))
            print(json.dumps(results[-1]), flush=True)
        config = dict(analysis.trials[0].config)
        print(json.dumps(per_trial(tune, train, val, root)), flush=True)
    steps = {}
    for label, cfg, rows in (
            ("headline K=50", config, 50), ("headline K=1", config, 1),
            ("flash K=8", dict(config, attention_type="flash"), 8),
            ("flash K=50", dict(config, attention_type="flash"), 50)):
        step_fn, program, state = population_step(tune, train, val, cfg,
                                                  rows)
        steps[label] = {**profile_population_step(step_fn),
                        "top_kernels": top_kernels(step_fn)}
        if label == "headline K=50":
            steps[label]["epoch"] = epoch_breakdown(program, state)
        if label.startswith("flash"):
            steps[label]["flash_host_ms"] = flash_host_ms(step_fn)
    print(json.dumps({"phase": "step", "card": smi_line(), **steps}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
