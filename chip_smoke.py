#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one output line each (a failed phase raises and the script exits
nonzero; nothing is caught and passed over):

1. build  — the card's name and power limit; every CUDA kernel compiled
   from the sources in the checkout (one nvcc per source, all at once),
   with ptxas's registers and spills per kernel and each library's
   tensor-core instructions (HGMMA/HMMA in ``cuobjdump -sass``) per
   kernel; a bf16 tensor-core kernel without HGMMA, or one that spills at
   a head dim up to 128, fails the phase.
2. kernel — the forward kernel held against its plain PyTorch version on
   the card over a grid of dtypes, causal flags, grouped-kv layouts, head
   dims (D = 33 among them), sequence lengths, scales and a transposed
   memory layout (the last two go through the wrapper's conforming copy
   in bf16); then timed at the flagship shape beside its plain version
   and the PyTorch library call that computes the same function.
3. kernel_bwd — the same for the two backward kernels (dK/dV and dQ),
   timed at the flagship training shape, where both bf16 kernels are
   also rerun and must give the same bits; then B*H = 65544 through all
   three kernels in f32 and bf16 (the grid's batch x heads axis past
   65535).  kernel_f32 — the three f32 kernels (split-precision
   tensor-core kernels) held against their plain versions and timed at
   the flagship shape beside the plain versions and SDPA in f32, with
   their registers, spills and HGMMA counts and bit-identical reruns of
   dK/dV and dQ; then all three and SDPA timed at the README quickstart's
   shapes (batch 32, S = 50, D = 8, 32, 128).
4. serve  — the bench flagship transformer (d_model 512, 8 heads, 4
   layers, seq 2048, bf16, flash attention) written as a bundle with
   seeded weights, loaded back and served over HTTP by the port's
   PredictionServer; ~32 concurrent /predict requests, each answer held
   against the plain-PyTorch forward with the same weights, and the
   kernels' launch counters read around the run.
5. serve_gqa — the same for the GQA + RoPE transformer (8 q heads, 4 kv
   heads) at a cut depth, in f32.
6. train  — ``tune.train_regressor`` trains the flagship for 2 epochs of
   8 steps on ``dummy_regression_data`` (80 rows of seq 2048 x 16), with
   the launch counters read around the run; one step's gradients held
   against the same step through the plain forward and backward (f32 and
   bf16), each bf16 attention call of that step held against its plain
   version on the same inputs, and planted kernel faults shown to fail
   both checks; one step's device time split by kernel (torch.profiler,
   four profiles behind a discarded warm-up step each, two of which must
   agree on every kernel's count) and its device idle share (CUDA
   events); the same profile of one f32 step (``train_f32_step``), which
   must run the three f32 tensor-core kernels.
7. tune   — the README quickstart through the port's ``tune.run`` at its
   own widths (``d_model`` 64/128/256, 2/4/8 heads, 2/4 layers, all three
   attention types, 1000 rows of seq 50 x 10, batch 32, BayesOpt, ASHA)
   and a cut depth (8 samples of at most 4 epochs, a first point with
   ``attention_type="flash"``): every trial must end TERMINATED, the sweep
   must launch all three f32 flash kernels, ``best_config`` must be one of
   the sampled configs and read back the same from the experiment
   directory, and ``best_model()`` must reproduce the best trial's last
   ``validation_mape`` on the card within 1e-5 of relative error.
8. vectorized — the bench headline (``bench.py``: d_model 64, 4 heads, 2
   layers, FF 128, dropout 0.1, batch 32, f32, ``glucose_like_data(100_000,
   16)``, 50 trials x 20 epochs) uncut through the port's
   ``tune.run_vectorized``, FIFO then ASHA (max_t 20, grace 5, factor 2):
   every trial TERMINATED, FIFO 1000 row-epochs, ASHA fewer and at least
   one compaction; wall seconds, trials/hour and the runner's
   ``device_utilization``.  Row independence: a trial that ran all 20
   epochs in the compacting ASHA population, the same trial in the FIFO
   population and that config trained alone end within ``ROW_TOL`` (final
   parameters and ``validation_mape``), with its dropout draws bit-equal in
   all three; one row's training forward alone and in the population agree
   (and with other masks do not).  One population step at K = 50 and K = 1:
   host ms, device span and busy ms, launches (torch.profiler).  Then a
   flash group (the same space with ``attention_type="flash"``, cut to 8
   trials x 3 epochs): the kernels launched once per layer per population
   step or eval block, the same at K = 8 and K = 1, and each folded kernel
   call of a step held against its plain version (``KERNEL_TOL`` f32).

9. pbt — population-based training on the card.  (a) bench.py's
   ``ours_pbt`` arm uncut (the headline space, 50 x 20, interval 5, PBT
   seed 3000, sweep seed 2000) through ``run_vectorized`` compiled, then
   on the boundary path: their generation logs (src, new lr/wd, exploited)
   and donor notes equal bit for bit, ``best_config`` equal, final
   ``validation_mape`` within ``ROW_TOL``, every compiled generation
   replayed through the host reference step, ``host_dispatches`` 1 and 4,
   ``generations`` 4 and 3, and no synchronizing CUDA call while the
   compiled generations are enqueued (torch's sync debug mode).  (b) the
   same space with flash, 16 x 12, interval 3: each f32 kernel once per
   layer per population step and eval block across the exploits, and one
   population step right after an exploit with each folded call within
   ``KERNEL_TOL``.  (c) PB2 on the boundary path as
   ``examples/pbt_vectorized.py --scheduler pb2`` runs it, 16 x 12.  (d)
   respawn PBT through ``tune.run`` (the quickstart's data and widths,
   flash, 8 x 8, interval 2, 4 lease slots on the card): every trial
   TERMINATED, requeued trials resumed from a donor's checkpoint with its
   weights bit for bit and reported ``restore_base + 1`` first.
10. resume — interrupted sweeps resumed, each against an uninterrupted
   run of the same spec in this process.  (a) phase vectorized's ASHA
   headline (50 x 20) through ``run_vectorized(checkpoint_every_epochs=5)``,
   interrupted on the first record of epoch 12 (the planted scheduler
   raises) and resumed with ``resume=True`` from the epoch-10 checkpoint,
   written after the second compaction: every trial TERMINATED, the same
   stop iterations, population sizes, row-epochs, compactions and
   ``best_config``, each ``training_iteration`` once in ``result.jsonl``,
   final parameters and ``validation_mape`` within ``ROW_TOL`` (and
   whether they are bit-equal); each population save's ms and bytes.
   (b) the flash group at 8 x 6, saved every 2 epochs and interrupted at
   3: after the resume each f32 kernel once per layer per population step
   and eval block, and one step from the checkpoint with each folded call
   within ``KERNEL_TOL``.  (c) ``examples/pbt_vectorized.py`` as it runs
   (16 x 12, interval 3, compiled, dispatch and checkpoint every
   interval), interrupted after generation 2: the resume stays compiled,
   its generation log and donor notes bit-equal to the uninterrupted
   run's.  (d) ``tune.run`` at the quickstart's widths with flash (8 x 4,
   one lease slot) in a child process, SIGKILLed once 6 trial checkpoints
   have landed, then ``tune.run(resume=True)`` in a fresh process: every
   trial TERMINATED, each epoch reported once, each requeued trial's
   first report at ``restore_base + 1``, the f32 kernels launched; then
   the uninterrupted run in that process, its configs equal.
11. knobs — the training knobs.  (a) ``examples/training_knobs.py``
   uncut (8 samples x 10 epochs, ASHA, plateau stopper, a warm-start
   point, lion/adamw, accumulation 4, RoPE, GQA, ``TensorBoardCallback``)
   through the port's ``tune.run`` on the card: every trial TERMINATED,
   each trial's event run read back with its records' tags and steps,
   ``best_model()`` reloaded and predicting.  (b) the flagship through
   ``train_regressor`` at the train phase's cut with
   ``accumulate_grad_batches=4``: lamb, adafactor and lion under remat
   (``dots_saveable``), each bf16 attention call held against its plain
   version (``_checking``); adam with remat off, ``dots_saveable``,
   ``nothing_saveable`` and ``everything_saveable``.  Each run's flash
   launches (the forward twice per layer per micro-step under remat), its
   logged ``lr`` by optimizer steps, its peak memory and its optimizer
   state's bytes beside ``param_opt_bytes``; peak memory under
   ``nothing_saveable`` below remat off; with dropout 0.1 on one seed, the
   parameters still between updates and moving on every 4th micro-step,
   and one optimizer step with remat on equal to remat off within 1e-6 of
   the largest entry; each run's micro-step host ms and device ms.  (c)
   one f32 flagship step with remat and adafactor: the three f32 kernels
   under remat, each call within ``KERNEL_TOL``.

The last lines are the card's name and power limit, a JSON object of
per-kernel measurements, and ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense FLOP/s
# per input type (bf16 on the tensor cores, f32 on the CUDA cores).  The
# f32 tensor-core kernels take each f32 product as three bf16 products
# (the split of csrc/hopper.cuh), so their f32 work runs at most at a
# third of the bf16 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              "float32_split": 989e12 / 3}

FLAGSHIP = {
    "model": "transformer", "d_model": 512, "num_heads": 8, "num_layers": 4,
    "dim_feedforward": 2048, "dropout": 0.0, "attention_type": "flash",
    "compute_dtype": "bfloat16", "max_seq_length": 2048,
}
GQA_ROPE = {
    "model": "transformer", "d_model": 128, "num_heads": 8, "num_kv_heads": 4,
    "position_encoding": "rope", "num_layers": 2, "dim_feedforward": 256,
    "dropout": 0.0, "attention_type": "flash", "max_seq_length": 128,
}
FEATURES = 16


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float | None:
    """Device time of one ``fn()``: the device time of every kernel it
    launches (torch.profiler) over ``iters`` calls, over ``iters``; None
    (not measured) when the profile holds no device event, as one has.
    At small shapes the host takes longer to launch a call than the
    device to run it, and cuda_ms of back-to-back calls then times the
    host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / iters if busy_us > 0 else None


# -- phase 1 ----------------------------------------------------------------


def phase_build():
    from distributed_machine_learning_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    seconds = _build.build(names)
    ptxas = {name: _ptxas_by_kernel(_build.build_log(name)) for name in names}
    tensor_cores = {}
    for name in names:
        counts = _build.sass_counts(name)
        if counts is None:
            tensor_cores[name] = None
            continue
        tensor_cores[name] = {
            op: sum(c[op] for c in counts.values()) for op in ("HGMMA", "HMMA")
        }
        tensor_cores[name]["by_kernel"] = {
            k: c for k, c in counts.items() if any(c.values())}
        idle = [k for k, c in counts.items()
                if "_wgmma" in k and c["HGMMA"] == 0]
        if idle:
            raise AssertionError(f"build: no HGMMA in the tensor-core "
                                 f"kernels {idle}")
    # The tensor-core kernels (bf16 and f32) keep everything in registers
    # up to D = 128 (their first template argument is the head-dim
    # bucket).
    spilled = {k: r for n in names for k, r in ptxas[n].items()
               if (m := re.search(r"_wgmma(?:_f32)?<(\d+),", k))
               and int(m.group(1)) <= 128 and r.get("spill_bytes") != 0}
    if spilled:
        raise AssertionError(f"build: tensor-core kernels spill at D <= 128: "
                             f"{spilled}")
    emit("build", card=smi_line(), kernels=names, seconds=seconds,
         ptxas=ptxas, tensor_cores=tensor_cores,
         tensor_cores_note=None if all(tensor_cores.values()) else
         "null: the toolkit has no cuobjdump")
    return ptxas, tensor_cores


def _ptxas_by_kernel(log: str) -> dict:
    """{kernel: {"registers": R, "spill_bytes": S}} from nvcc's
    -Xptxas -v."""
    from distributed_machine_learning_tpu_torch.ops import _build

    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = _build._kernel_name(m.group(1))
            out[kernel] = {}
        elif kernel is not None:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[kernel]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


# -- phase 2 ----------------------------------------------------------------


def _layout(t, layout: str):
    """``t`` [B, S, H, D] as is ("dense"), or the same values stored as
    [B, H, D, S] ("transposed": D is not innermost, so the kernels take
    the wrapper's conforming copy)."""
    if layout == "dense":
        return t
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _qkv(B, S, H, Hkv, D, dtype, seed, layout="dense"):
    import torch

    gen = torch.Generator().manual_seed(seed)
    mk = lambda h: _layout(  # noqa: E731
        torch.randn(B, S, h, D, generator=gen).to("cuda", dtype), layout)
    return mk(H), mk(Hkv), mk(Hkv)


def _compare(q, k, v, scale, causal):
    """The kernel's (out, lse) against the plain version: max |out err|,
    the same over max |out| (:func:`_rel_err`) and max |lse err|."""
    import torch

    from distributed_machine_learning_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        flash_forward,
    )

    out, lse = flash_forward(q, k, v, scale, causal, with_lse=True)
    ref_out, ref_lse = flash_attention_reference(q, k, v, q.shape[-1] ** -0.5
                                                 if scale is None else scale,
                                                 causal)
    torch.cuda.synchronize()
    if out.shape != ref_out.shape or out.dtype != q.dtype:
        raise AssertionError(f"kernel out {out.shape}/{out.dtype}")
    if not torch.equal(torch.isfinite(lse), torch.isfinite(ref_lse)):
        raise AssertionError("kernel lse finite pattern differs")
    fin = torch.isfinite(ref_lse)
    err_o = (out.float() - ref_out.float()).abs().max().item()
    err_l = (lse[fin] - ref_lse[fin]).abs().max().item()
    return err_o, _rel_err(out, ref_out), err_l


def _bound(flops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the operations
    at the peak rate for ``dtype`` and the bytes at the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _rel_err(got, want) -> float:
    """max |err| over max |want|.  Outputs and gradients shrink as S grows
    (at S = 2048 most gradient entries are a few hundredths), so a
    tolerance is a share of the largest entry, never an absolute one."""
    want = want.float()
    top = want.abs().max().item()
    return (got.float() - want).abs().max().item() / (top if top > 0 else 1.0)


# Relative to the largest entry (_rel_err).  f32: the kernels take each
# product as three bf16 products of split parts, every operand to 2**-16
# (csrc/hopper.cuh), and read 1e-5 to 4e-5.  bf16: both sides accumulate in
# f32 and round each output entry to bf16 once, at most one bf16 ulp apart,
# at most 2**-7 = 7.8e-3 of the largest entry.  The bf16 kernels round
# where the plain versions do not: the forward
# carries P into P V as two bf16 parts (high and the rounded rest, P to about
# 2**-16), the dK/dV kernel rounds P^T and dS^T to bf16 before P^T dO and dS^T
# Q, and the dQ kernel rounds dS to bf16 before dS K (relative 2**-9 per entry,
# averaging out over the S terms of each sum).  2e-2 leaves room for these, and
# a kernel off by 3 % everywhere fails.
KERNEL_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from distributed_machine_learning_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        flash_forward,
    )

    tol_out = {dt: KERNEL_TOL[str(dt).split(".")[1]]
               for dt in (torch.float32, torch.bfloat16)}
    tol_lse = 1e-3
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for H, Hkv in ((8, 8), (8, 4), (8, 1)):
                for D in (16, 64, 128):
                    for S in (96, 2048):
                        cases.append((dtype, causal, H, Hkv, D, S, None,
                                      "dense"))
            # A non-default scale, odd head dims, the largest head dim, and
            # inputs the bf16 kernel reads through the conforming copy.
            cases.append((dtype, causal, 8, 4, 64, 96, 0.37, "dense"))
            cases.append((dtype, causal, 8, 2, 40, 130, 0.2, "dense"))
            cases.append((dtype, causal, 4, 4, 256, 200, None, "dense"))
            cases.append((dtype, causal, 8, 2, 33, 130, None, "dense"))
            cases.append((dtype, causal, 8, 4, 64, 200, None, "transposed"))
            cases.append((dtype, causal, 4, 1, 33, 2048, 0.3, "transposed"))
    worst = {"out": 0.0, "out_rel": 0.0, "lse": 0.0}
    for i, (dtype, causal, H, Hkv, D, S, scale, layout) in enumerate(cases):
        B = 2 if S >= 1024 else 3
        q, k, v = _qkv(B, S, H, Hkv, D, dtype, seed=i, layout=layout)
        err_o, rel_o, err_l = _compare(q, k, v, scale, causal)
        if not (rel_o <= tol_out[dtype] and err_l <= tol_lse):
            raise AssertionError(
                f"flash_fwd disagrees with its plain version: dtype={dtype} "
                f"causal={causal} H={H} Hkv={Hkv} D={D} S={S} scale={scale} "
                f"layout={layout}: rel out err {rel_o} (tol "
                f"{tol_out[dtype]}), |lse err| {err_l} (tol {tol_lse})"
            )
        worst["out"] = max(worst["out"], err_o)
        worst["out_rel"] = max(worst["out_rel"], rel_o)
        worst["lse"] = max(worst["lse"], err_l)

    # The serving shape: one layer's attention at the flagship bucket.
    B, S, H, D = 8, FLAGSHIP["max_seq_length"], FLAGSHIP["num_heads"], 64
    dtype = torch.bfloat16
    q, k, v = _qkv(B, S, H, H, D, dtype, seed=1234)
    err_o, rel_o, err_l = _compare(q, k, v, None, False)
    if not (rel_o <= tol_out[dtype] and err_l <= tol_lse):
        raise AssertionError(f"flash_fwd at the flagship shape: rel out err "
                             f"{rel_o}, |lse err| {err_l}")
    kernel_ms = cuda_ms(lambda: flash_forward(q, k, v), iters=20)
    plain_ms = cuda_ms(
        lambda: flash_attention_reference(q, k, v, D ** -0.5, False), iters=5
    )
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=20
    )
    flops = 4.0 * B * H * S * S * D
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    nbytes += B * H * S * 4  # lse
    timing = {
        "shape": [B, S, H, D], "dtype": "bfloat16", "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        **_bound(flops, nbytes, "bfloat16"), "max_abs_err": err_o,
        "gflop": flops / 1e9,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }
    emit("kernel", card=torch.cuda.get_device_name(0), cases=len(cases),
         max_err_out=worst["out"], max_rel_err_out=worst["out_rel"],
         max_err_lse=worst["lse"], kernels=["flash_fwd"],
         max_rel_err=rel_o, **timing)
    return timing


# -- phase 3 ----------------------------------------------------------------


def _bwd_inputs(B, S, H, Hkv, D, dtype, scale, causal, seed,
                layout="dense"):
    """q, k, v, dO and the forward's lse and delta, on the card."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(B, S, H, Hkv, D, dtype, seed, layout)
    gen = torch.Generator().manual_seed(seed + 1)
    do = _layout(torch.randn(B, S, H, D, generator=gen).to("cuda", dtype),
                 layout)
    out, lse = fa.flash_forward(q, k, v, scale, causal, with_lse=True)
    return q, k, v, do, lse, fa.backward_delta(out, do)


def phase_kernel_bwd():
    import torch
    import torch.nn.functional as F

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    # KERNEL_TOL, relative to each gradient's largest entry: the backward
    # kernels, like their plain version, accumulate in f32 and round once.
    tol = {dt: KERNEL_TOL[str(dt).split(".")[1]]
           for dt in (torch.float32, torch.bfloat16)}
    worst = {str(dt).split(".")[1]: {"dq": 0.0, "dk": 0.0, "dv": 0.0}
             for dt in (torch.float32, torch.bfloat16)}
    cases = [
        (dtype, causal, H, Hkv, D, S, scale, "dense")
        for dtype in (torch.float32, torch.bfloat16)
        for causal in (False, True)
        for H, Hkv in ((8, 8), (8, 4), (8, 1))
        for D in (16, 33, 40, 64, 128, 256)
        for S in (96, 130, 2048)
        for scale in (None, 0.37)
    ] + [
        # q, k, v and dO stored [B, H, D, S]: the kernels take the
        # wrapper's conforming copy.
        (dtype, causal, H, Hkv, D, S, None, "transposed")
        for dtype in (torch.float32, torch.bfloat16)
        for causal in (False, True)
        for H, Hkv, D, S in ((8, 2, 64, 130), (8, 8, 33, 2048))
    ]
    for n, (dtype, causal, H, Hkv, D, S, scale, layout) in enumerate(cases):
        B = 1 if S >= 1024 else 2
        s = D ** -0.5 if scale is None else scale
        q, k, v, do, lse, delta = _bwd_inputs(B, S, H, Hkv, D, dtype, scale,
                                              causal, n, layout)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, s, causal)
        dq = fa.flash_bwd_dq(q, k, v, lse, do, delta, s, causal)
        ref = fa.flash_attention_backward_reference(q, k, v, lse, do, delta,
                                                    s, causal)
        torch.cuda.synchronize()
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err = _rel_err(got, want)
            if (got.shape != want.shape or got.dtype != dtype
                    or not err <= tol[dtype]):
                raise AssertionError(
                    f"flash_bwd {name} disagrees with its plain version: "
                    f"dtype={dtype} causal={causal} H={H} Hkv={Hkv} D={D} "
                    f"S={S} scale={scale} layout={layout}: rel err {err} "
                    f"(tol {tol[dtype]})")
            by_dtype = worst[str(dtype).split(".")[1]]
            by_dtype[name] = max(by_dtype[name], err)
        del q, k, v, do, lse, delta, dq, dk, dv, ref
    n = len(cases)

    # The training shape: one layer's backward at the flagship batch.
    B, S, H, D = 8, FLAGSHIP["max_seq_length"], FLAGSHIP["num_heads"], 64
    dtype, s = torch.bfloat16, D ** -0.5
    q, k, v, do, lse, delta = _bwd_inputs(B, S, H, H, D, dtype, None, False,
                                          4321)
    args = (q, k, v, lse, do, delta, s, False)
    dk, dv = fa.flash_bwd_dkdv(*args)
    dq = fa.flash_bwd_dq(*args)
    # No atomics: a rerun gives the same bits.
    dk2, dv2 = fa.flash_bwd_dkdv(*args)
    rerun = max((dk2.float() - dk.float()).abs().max().item(),
                (dv2.float() - dv.float()).abs().max().item())
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"flash_bwd_dkdv: a rerun differs by {rerun}")
    dq2 = fa.flash_bwd_dq(*args)
    rerun_dq = (dq2.float() - dq.float()).abs().max().item()
    if not torch.equal(dq, dq2):
        raise AssertionError(f"flash_bwd_dq: a rerun differs by {rerun_dq}")
    del dk2, dv2, dq2
    ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(*args)
    ref_dq = fa.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    pairs = {"dq": (dq, ref_dq), "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
    flagship_rel = {n: _rel_err(*p) for n, p in pairs.items()}
    if not max(flagship_rel.values()) <= tol[dtype]:
        raise AssertionError(f"flash_bwd at the flagship shape: rel err "
                             f"{flagship_rel} (tol {tol[dtype]})")
    abs_err = {n: (g.float() - w.float()).abs().max().item()
               for n, (g, w) in pairs.items()}
    err = {"flash_bwd_dkdv": max(abs_err["dk"], abs_err["dv"]),
           "flash_bwd_dq": abs_err["dq"]}
    del pairs, ref_dk, ref_dv, ref_dq
    # The library yardstick: SDPA's backward (autograd.grad) for the same
    # gradients, [B, H, S, D] views of the same tensors.
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    library = {
        "flash_bwd_dkdv": lambda: torch.autograd.grad(
            sdpa_out, (kt, vt), dot, retain_graph=True),
        "flash_bwd_dq": lambda: torch.autograd.grad(
            sdpa_out, (qt,), dot, retain_graph=True),
    }
    kernel = {"flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(*args),
              "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args)}
    plain = {"flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv_reference(*args),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq_reference(*args)}
    # 4 matmuls of 2*B*H*S^2*D flop per tile pair in dkdv, 3 in dq.
    flops = {"flash_bwd_dkdv": 8.0 * B * H * S * S * D,
             "flash_bwd_dq": 6.0 * B * H * S * S * D}
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    rows = B * H * S * 4 * 2  # lse and delta, f32
    nbytes = {"flash_bwd_dkdv": size(q, do, k, v, dk, dv) + rows,
              "flash_bwd_dq": size(q, do, k, v, dq) + rows}
    timing = {}
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        ms = cuda_ms(kernel[name], iters=10)
        timing[name] = {
            "ms": ms,
            "plain_ms": cuda_ms(plain[name], iters=3, warmup=1),
            "library_ms": cuda_ms(library[name], iters=10),
            **_bound(flops[name], nbytes[name], "bfloat16"),
            "max_abs_err": err[name], "gflop": flops[name] / 1e9,
            "tflops": flops[name] / (ms * 1e-3) / 1e12,
        }
    del q, k, v, do, lse, delta, args, dq, dk, dv, qt, kt, vt, sdpa_out, dot
    emit("kernel_bwd", card=torch.cuda.get_device_name(0), cases=n,
         max_rel_err=worst, shape=[B, S, H, D], dtype="bfloat16",
         flagship_rel_err=flagship_rel, dkdv_rerun_max_abs_diff=rerun,
         dq_rerun_max_abs_diff=rerun_dq, grid_past_65535=_grid_past_65535(),
         **timing)
    return timing


def _grid_past_65535() -> dict:
    """B*H = 65544 (B = 8193, H = 8, Hkv = 4, S = 24, D = 16, causal)
    through all three kernels in f32 and bf16, against the plain versions
    at KERNEL_TOL: (batch, head) lies on the grid's x axis, past the 65535
    that the y axis would allow.  Returns the readings by dtype."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    B, S, H, Hkv, D = 8193, 24, 8, 4, 16
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, do, lse, delta = _bwd_inputs(B, S, H, Hkv, D, dtype, None,
                                              True, 65544)
        s = D ** -0.5
        counters = _reset_counters()
        out = fa.flash_forward(q, k, v, s, True)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, s, True)
        dq = fa.flash_bwd_dq(q, k, v, lse, do, delta, s, True)
        launched = [c.count for c in counters]
        ref_out = fa.flash_attention_reference(q, k, v, s, True)[0]
        ref = fa.flash_attention_backward_reference(q, k, v, lse, do, delta,
                                                    s, True)
        torch.cuda.synchronize()
        errs = {n: _rel_err(g, w) for n, g, w in zip(
            ("out", "dq", "dk", "dv"), (out, dq, dk, dv), (ref_out, *ref))}
        if launched != [1, 1, 1] or not max(errs.values()) <= KERNEL_TOL[name]:
            raise AssertionError(
                f"B*H = {B * H} ({name}): launches {launched}, rel err "
                f"{errs} (tol {KERNEL_TOL[name]})")
        readings[name] = errs
        del q, k, v, do, lse, delta, out, dq, dk, dv, ref_out, ref
    return {"shape": [B, S, H, Hkv, D], "batch_x_heads": B * H,
            "max_rel_err": readings}


# The f32 kernels as ptxas and cuobjdump name their instantiations, all
# on the tensor cores as split bf16.
F32_KERNELS = {"flash_fwd": ("flash_fwd", "flash_fwd_kernel_wgmma_f32<"),
               "flash_bwd_dkdv": ("flash_bwd",
                                  "flash_bwd_dkdv_kernel_wgmma_f32<"),
               "flash_bwd_dq": ("flash_bwd", "flash_bwd_dq_kernel_wgmma_f32<")}
# The rate that bounds each f32 kernel: the split's third of the bf16
# tensor-core peak.
F32_RATE = {"flash_fwd": "float32_split", "flash_bwd_dkdv": "float32_split",
            "flash_bwd_dq": "float32_split"}


def _f32_build(build) -> dict:
    """{kernel: {instantiation: registers, spill bytes and HGMMA count}}
    of the f32 kernels, from phase_build's readings (HGMMA None where the
    toolkit has no cuobjdump)."""
    ptxas, tensor_cores = build
    out = {}
    for name, (source, prefix) in F32_KERNELS.items():
        sass = tensor_cores.get(source)
        out[name] = {
            k: {**r, "HGMMA": None if sass is None else
                sass["by_kernel"].get(k, {}).get("HGMMA", 0)}
            for k, r in ptxas[source].items() if k.startswith(prefix)}
    return out


def _f32_timing(name, kernel, plain, library, flops, nbytes, iters) -> dict:
    """``kernel`` timed beside ``plain`` and ``library``, with its bound
    at its own rate (F32_RATE) and at the f32 CUDA-core peak."""
    ms = cuda_ms(kernel, iters=iters, warmup=1)
    bound = _bound(flops, nbytes, F32_RATE[name])
    cuda_core = _bound(flops, nbytes, "float32")["bound_ms"]
    return {"ms": ms, "plain_ms": cuda_ms(plain, iters=3, warmup=1),
            "library_ms": cuda_ms(library, iters=iters, warmup=1),
            **bound, "bound_share": bound["bound_ms"] / ms,
            "cuda_core_bound_ms": cuda_core,
            "cuda_core_bound_share": cuda_core / ms,
            "gflop": flops / 1e9, "tflops": flops / (ms * 1e-3) / 1e12}


def _f32_calls(B, S, H, D, seed):
    """(readings against the plain versions, {kernel: (kernel call, plain
    call, library call, flops, bytes)}, (arguments, dK/dV output, dQ
    output)) for f32 inputs of one shape: the library call is SDPA's
    forward, or its backward (``autograd.grad``) for the gradients the
    kernel computes."""
    import torch
    import torch.nn.functional as F

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    s = D ** -0.5
    q, k, v, do, lse, delta = _bwd_inputs(B, S, H, H, D, torch.float32,
                                          None, False, seed)
    args = (q, k, v, lse, do, delta, s, False)
    dkdv = fa.flash_bwd_dkdv(*args)
    dq = fa.flash_bwd_dq(*args)
    pairs = {
        "flash_fwd": ((fa.flash_forward(q, k, v),),
                      fa.flash_attention_reference(q, k, v, s, False)[:1]),
        "flash_bwd_dkdv": (dkdv, fa.flash_bwd_dkdv_reference(*args)),
        "flash_bwd_dq": ((dq,), (fa.flash_bwd_dq_reference(*args),)),
    }
    torch.cuda.synchronize()
    rel = {n: max(_rel_err(a, b) for a, b in zip(*p)) for n, p in pairs.items()}
    abs_err = {n: max((a - b).abs().max().item() for a, b in zip(*p))
               for n, p in pairs.items()}
    if not max(rel.values()) <= KERNEL_TOL["float32"]:
        raise AssertionError(f"f32 kernels at [B, S, H, D] = "
                             f"{[B, S, H, D]}: rel err {rel} (tol "
                             f"{KERNEL_TOL['float32']})")
    del pairs
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    tensor = q.numel() * q.element_size()
    rows = B * H * S * 4
    calls = {
        "flash_fwd": (lambda: fa.flash_forward(q, k, v),
                      lambda: fa.flash_attention_reference(q, k, v, s, False),
                      lambda: F.scaled_dot_product_attention(qt, kt, vt),
                      4.0 * B * H * S * S * D, 4 * tensor + rows),
        "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args),
                           lambda: fa.flash_bwd_dkdv_reference(*args),
                           lambda: torch.autograd.grad(
                               sdpa_out, (kt, vt), dot, retain_graph=True),
                           8.0 * B * H * S * S * D, 6 * tensor + 2 * rows),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args),
                         lambda: fa.flash_bwd_dq_reference(*args),
                         lambda: torch.autograd.grad(
                             sdpa_out, (qt,), dot, retain_graph=True),
                         6.0 * B * H * S * S * D, 5 * tensor + 2 * rows),
    }
    return {"rel": rel, "abs": abs_err}, calls, (args, dkdv, dq)


# The README quickstart's attention (README.md:39-64): batch 32, seq 50,
# d_model in {64, 128, 256} over num_heads in {2, 4, 8}, non-causal; one
# (d_model, num_heads) pair for each head dim 8, 32 and 128.
QUICKSTART = ((64, 8), (128, 4), (256, 2))


def phase_kernel_f32(build):
    """The f32 kernels at the flagship shape: the forward, dK/dV and dQ
    (split-precision tensor-core kernels) held against their plain
    versions, dK/dV and dQ rerun for identical bits, and each timed beside
    its plain version and SDPA in f32; bound at its own rate (F32_RATE),
    with the share of the f32 CUDA-core bound beside it (what earlier
    readings used).  Then the same at the quickstart's shapes,
    where the kernel's and SDPA's device times (device_ms) stand beside
    the times of back-to-back calls, which there are the host's."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    B, S, H, D = 8, FLAGSHIP["max_seq_length"], FLAGSHIP["num_heads"], 64
    err, calls, (args, (dk, dv), dq) = _f32_calls(B, S, H, D, 4322)
    # No atomics: a rerun gives the same bits.
    dk2, dv2 = fa.flash_bwd_dkdv(*args)
    rerun = max((dk2 - dk).abs().max().item(), (dv2 - dv).abs().max().item())
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"f32 flash_bwd_dkdv: a rerun differs by {rerun}")
    dq2 = fa.flash_bwd_dq(*args)
    rerun_dq = (dq2 - dq).abs().max().item()
    if not torch.equal(dq, dq2):
        raise AssertionError(f"f32 flash_bwd_dq: a rerun differs by "
                             f"{rerun_dq}")
    del dk, dv, dk2, dv2, dq, dq2
    timing = {}
    for name, (kernel, plain, library, flops, nbytes) in calls.items():
        timing[name] = {
            **_f32_timing(name, kernel, plain, library, flops, nbytes, 5),
            "max_abs_err": err["abs"][name], "max_rel_err": err["rel"][name],
        }
    del calls, args
    quickstart = []
    for d_model, heads in QUICKSTART:
        shape = [32, 50, heads, d_model // heads]
        err, calls, _ = _f32_calls(*shape, seed=50 + d_model)
        quickstart.append({
            "d_model": d_model, "num_heads": heads, "shape": shape,
            "max_rel_err": err["rel"],
            **{name: {**{k: v for k, v in _f32_timing(
                name, kernel, plain, library, flops, nbytes, 50).items()
                if k in ("ms", "library_ms", "plain_ms", "bound_ms")},
                "device_ms": device_ms(kernel, 20),
                "library_device_ms": device_ms(library, 20)}
               for name, (kernel, plain, library, flops, nbytes)
               in calls.items()}})
        del calls
    emit("kernel_f32", card=torch.cuda.get_device_name(0),
         shape=[B, S, H, D], dtype="float32",
         dkdv_rerun_max_abs_diff=rerun, dq_rerun_max_abs_diff=rerun_dq,
         build=_f32_build(build),
         quickstart=quickstart, **timing)
    return timing


# -- phases 4 and 5 -----------------------------------------------------------


def _post(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _plain_forwards(bundle, batches):
    """The model's forward on the card with the flash kernel replaced by
    its plain version — the reference for the served answers."""
    import torch

    from distributed_machine_learning_tpu_torch.models import layers
    from distributed_machine_learning_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
    )

    kernel_fn = layers.flash_attention
    layers.flash_attention = (
        lambda q, k, v, scale=None, causal=False:
        flash_attention_reference(q, k, v, scale, causal)[0]
    )
    try:
        model = bundle.build_model().to("cuda")
        with torch.inference_mode():
            return [
                model(torch.from_numpy(x).to("cuda")).float().cpu().numpy()
                for x in batches
            ]
    finally:
        layers.flash_attention = kernel_fn


def _profile_forward(server, requests, seq: int) -> dict:
    """Where one top-bucket request's time goes: the JSON decode of its
    body on the host, and its engine forward split by device kernel
    (torch.profiler; kernel times are device times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    replica = server.replicas.replicas[0]
    step_ms_ewma = replica.batcher.stats.step_ewma_ms()
    engine = replica.engine
    rows = np.concatenate(requests)[: engine.buckets[-1]]
    body = json.dumps({"instances": rows.tolist()})
    t0 = time.perf_counter()
    np.asarray(json.loads(body)["instances"], dtype=np.float32)
    decode_ms = (time.perf_counter() - t0) * 1e3
    engine.predict(rows)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(rows)
        forward_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        # Device-side events only: a CPU op also carries the device time
        # of the kernels it launched, which would count them twice.
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = evt.self_device_time_total / 1e3
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {
        "step_ms_ewma": step_ms_ewma,
        "profile_rows": int(rows.shape[0]), "json_decode_ms": decode_ms,
        "forward_ms": forward_ms, "device_ms": device_ms,
        "device_top_ms": {k[:60]: v for k, v in top},
    }


def phase_serve(name: str, config: dict, seq: int, n_requests: int, atol):
    import torch

    from distributed_machine_learning_tpu_torch.models import build_model
    from distributed_machine_learning_tpu_torch.models.convert import (
        to_flax_params,
    )
    from distributed_machine_learning_tpu_torch.ops import flash_attention
    from distributed_machine_learning_tpu_torch.serve import (
        BUNDLE_VERSION,
        PredictionServer,
        load_bundle,
        write_bundle,
    )

    torch.manual_seed(0)
    model = build_model(config, FEATURES)
    with tempfile.TemporaryDirectory() as tmp:
        write_bundle(
            tmp, {"bundle_version": BUNDLE_VERSION, "config": config,
                  "precision": "f32"},
            {"params": to_flax_params(model.state_dict())},
        )
        bundle = load_bundle(tmp)
    rng = np.random.default_rng(0)
    requests = [
        rng.normal(size=(int(rng.integers(1, 5)), seq, FEATURES))
        .astype(np.float32)
        for _ in range(n_requests)
    ]

    counters = _reset_counters()
    t_start = time.monotonic()
    server = PredictionServer(bundle, port=0, num_replicas=1,
                              device="cuda:0", max_bucket=8,
                              max_batch_size=8)
    answers = [None] * n_requests
    try:
        server.warmup(np.zeros((1, seq, FEATURES), np.float32))
        host, port = server.start()
        url = f"http://{host}:{port}/predict"
        t_req = time.monotonic()

        def worker(tid: int):
            for i in range(tid, n_requests, 8):
                answers[i] = _post(url, {"instances": requests[i].tolist()})

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.monotonic() - t_req
        if any(t.is_alive() for t in threads) or any(a is None for a in answers):
            raise AssertionError(f"{name}: not every request was answered")
        breakdown = _profile_forward(server, requests, seq)
        metrics = server.handle_metrics()
    finally:
        server.close()
    counts = {c.name: c.count for c in counters}
    launches = counts[flash_attention.launches.name]
    forwards = metrics["compile"]["per_replica"][0]["forwards"]
    layers_n = config["num_layers"]
    if launches < layers_n * forwards:
        raise AssertionError(
            f"{name}: flash_fwd launched {launches} times for {forwards} "
            f"bucket forwards of {layers_n} layers"
        )
    if sum(counts.values()) != launches:
        raise AssertionError(f"{name}: serving ran a backward kernel: {counts}")

    worst = 0.0
    for x, ans, ref in zip(requests, answers, _plain_forwards(bundle, requests)):
        pred = np.asarray(ans["predictions"], np.float32)
        if pred.shape != (x.shape[0], 1) or not np.all(np.isfinite(pred)):
            raise AssertionError(f"{name}: bad prediction {pred.shape}")
        worst = max(worst, float(np.abs(pred - ref).max()))
    if worst > atol:
        raise AssertionError(
            f"{name}: served answers off the plain forward by {worst} "
            f"(atol {atol})"
        )
    rows = sum(x.shape[0] for x in requests)
    emit(name, card=torch.cuda.get_device_name(0), requests=n_requests,
         rows=rows, rows_per_s=rows / wall_s, wall_s=wall_s,
         p50_ms=metrics["latency_ms_p50"], p99_ms=metrics["latency_ms_p99"],
         bucket_forwards=forwards, flash_fwd_launches=launches,
         max_abs_err=worst, atol=atol,
         **breakdown,
         total_s=time.monotonic() - t_start)
    return launches


# -- phase 6 ----------------------------------------------------------------

TRAIN = dict(FLAGSHIP, learning_rate=1e-3, batch_size=8, num_epochs=2,
             optimizer="adam", lr_schedule="warmup_linear_decay", seed=0)
TRAIN_ROWS = 80  # 64 train rows (8 steps of 8) and 16 val rows


def _reset_counters():
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    counters = (fa.launches, fa.dkdv_launches, fa.dq_launches)
    for c in counters:
        c.reset()
    return counters


def _plain_flash():
    """flash_attention with the plain forward and the plain backward."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale, causal):
            s = q.shape[-1] ** -0.5 if scale is None else scale
            out, lse = fa.flash_attention_reference(q, k, v, s, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (s, causal)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            s, causal = ctx.args
            grads = fa.flash_attention_backward_reference(
                q, k, v, lse, do, fa.backward_delta(out, do), s, causal)
            return (*grads, None, None)

    return lambda q, k, v, scale=None, causal=False: PlainFlash.apply(
        q, k, v, scale, causal)


def _flagship_step_setup(train, compute_dtype: str = "bfloat16",
                         config: dict | None = None):
    """The flagship model (``config``, TRAIN by default) with seeded
    weights (the same for every compute dtype: parameters are f32) and
    one 8-row batch."""
    import torch

    from distributed_machine_learning_tpu_torch.models import (
        build_model,
        compute_dtype_of,
        init_parameters,
    )

    config = dict(config or TRAIN, compute_dtype=compute_dtype)
    model = build_model(config, FEATURES)
    init_parameters(model, torch.Generator().manual_seed(0)).to("cuda")
    x = torch.from_numpy(train.x[:8]).to("cuda", compute_dtype_of(config))
    y = torch.from_numpy(train.y[:8]).to("cuda")
    return model, x, y


def _faulty_backward(factors: dict):
    """The kernels' ``flash_backward`` with each gradient named in
    ``factors`` multiplied by its factor: a planted kernel fault."""
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    kernel_backward = fa.flash_backward

    def backward(*args, **kwargs):
        grads = kernel_backward(*args, **kwargs)
        return tuple(g * factors.get(n, 1.0)
                     for n, g in zip(("dq", "dk", "dv"), grads))

    return backward


def _checking(record: dict):
    """Wrappers of ``flash_forward`` and ``flash_backward`` that hold each
    call's result against the plain version on the very same inputs (the
    model's own activations), keeping the largest :func:`_rel_err` of
    out, dq, dk and dv in ``record``."""
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    kernel_fwd, kernel_bwd = fa.flash_forward, fa.flash_backward

    def keep(name, got, want):
        record[name] = max(record.get(name, 0.0), _rel_err(got, want))

    def forward(q, k, v, scale=None, causal=False, *rest, **kwargs):
        res = kernel_fwd(q, k, v, scale, causal, *rest, **kwargs)
        s = q.shape[-1] ** -0.5 if scale is None else scale
        keep("out", res[0] if kwargs.get("with_lse") else res,
             fa.flash_attention_reference(q, k, v, s, causal)[0])
        return res

    def backward(q, k, v, out, lse, do, scale=None, causal=False, *rest,
                 **kwargs):
        grads = kernel_bwd(q, k, v, out, lse, do, scale, causal, *rest,
                           **kwargs)
        s = q.shape[-1] ** -0.5 if scale is None else scale
        ref = fa.flash_attention_backward_reference(
            q, k, v, lse, do, fa.backward_delta(out, do), s, causal)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            keep(name, got, want)
        record["calls"] = record.get("calls", 0) + 1
        return grads

    return forward, backward


def _step_grads(train, compute_dtype: str, plain: bool = False,
                fault: dict | None = None,
                check: dict | None = None) -> dict:
    """{parameter name: f32 gradient} of one step through the kernels;
    ``plain`` swaps them for the plain forward and backward, ``fault``
    plants :func:`_faulty_backward`, and ``check`` receives
    :func:`_checking`'s record of every attention call."""
    import torch

    from distributed_machine_learning_tpu_torch.models import layers
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops.losses import mse_loss

    model, x, y = _flagship_step_setup(train, compute_dtype)
    model.train()
    names, params = zip(*model.named_parameters())
    saved = layers.flash_attention, fa.flash_forward, fa.flash_backward
    if plain:
        layers.flash_attention = _plain_flash()
    if fault:
        fa.flash_backward = _faulty_backward(fault)
    if check is not None:
        fa.flash_forward, fa.flash_backward = _checking(check)
    try:
        loss = mse_loss(model(x).float(), y)
        grads = torch.autograd.grad(loss, params)
    finally:
        layers.flash_attention, fa.flash_forward, fa.flash_backward = saved
    out = {n: g.float() for n, g in zip(names, grads)}
    if not all(bool(g.isfinite().all()) for g in out.values()):
        raise AssertionError("train: non-finite gradient")
    return out


# The attention key biases are left out of the per-parameter comparison.
# A key bias adds q . b_k to every logit of query row q, a shift that the
# softmax ignores, so its exact gradient is 0 and what a step computes for
# it is rounding alone.
ZERO_GRAD_PARAMS = ".attention.key.bias"


def _grad_err(a: dict, b: dict) -> dict:
    """``a`` against ``b``: ``worst``, the largest ||a - b|| / ||b|| of one
    parameter (key biases left out), and that parameter; ``whole``, the
    same over the other parameters as one vector; ``whole_all``, over
    every parameter, key biases included."""
    kept = [n for n in b if not n.endswith(ZERO_GRAD_PARAMS)]
    per = {n: ((a[n] - b[n]).norm() / b[n].norm()).item() for n in kept}
    name = max(per, key=per.get)

    def whole(names):
        diff = sum(((a[n] - b[n]).norm() ** 2).item() for n in names)
        return (diff / sum((b[n].norm() ** 2).item() for n in names)) ** 0.5

    return {"worst": per[name], "param": name, "whole": whole(kept),
            "whole_all": whole(list(b))}


# Planted faults: one backward output off everywhere, in every layer.  The
# in-model check (_checking, at KERNEL_TOL) must reject every one; the
# whole-step bf16 limit, the 10 % ones (STEP_FAULTS).
PLANTED_FAULTS = {"dq_x0.9": {"dq": 0.9}, "dk_x0.9": {"dk": 0.9},
                  "dv_x0.9": {"dv": 0.9}, "dq_x0.97": {"dq": 0.97},
                  "dv_x0.97": {"dv": 0.97}}
STEP_FAULTS = ("dq_x0.9", "dk_x0.9", "dv_x0.9")
# Whole-step limits on the kernel step against the plain one, per
# parameter (_grad_err's ``worst``), set from readings on an H100 80GB
# HBM3 (PERF.md).  f32: the paths differ by the kernels' split products
# and in summation order, and read 1.7e-5 to 1.8e-5.
# bf16: on the step's own activations the backward kernels agree bit for
# bit with their plain version and the forward within one ulp,
# but those one-ulp differences, carried through four bf16 layers and the
# backward, move one parameter's gradient by up to 6.5e-2; the in-model
# check is the tight bf16 gate.  0.09 lies between that and the 0.116 to
# 0.143 that the 10 % faults read.
STEP_TOL = {"float32": 1e-4, "bfloat16": 0.09}


def _grad_check(train) -> dict:
    """One flagship step's gradients through the kernels against the same
    step through the plain forward and backward, in f32 and bf16; the bf16
    kernel step against itself (run to run); the bf16 plain step against
    the f32 one; and each planted fault against the plain bf16 step.
    ``in_model`` entries hold :func:`_checking`'s record of the bf16 step
    and of each planted fault."""
    g, checks = {}, {}
    for dt in ("float32", "bfloat16"):
        for plain in (False, True):
            check = None if plain or dt == "float32" else checks.setdefault(
                "bf16", {})
            g[dt, plain] = _step_grads(train, dt, plain, check=check)
    plain16, plain32 = g["bfloat16", True], g["float32", True]
    out = {
        "f32_kernel_vs_plain": _grad_err(g["float32", False], plain32),
        "bf16_kernel_vs_plain": _grad_err(g["bfloat16", False], plain16),
        "bf16_kernel_rerun": _grad_err(_step_grads(train, "bfloat16"),
                                       g["bfloat16", False]),
        "bf16_plain_vs_f32": _grad_err(plain16, plain32),
    }
    for name, fault in PLANTED_FAULTS.items():
        grads = _step_grads(train, "bfloat16", fault=fault,
                            check=checks.setdefault(name, {}))
        out[f"fault_{name}"] = _grad_err(grads, plain16)
    out["in_model"] = checks
    return out


# The kernel each flash group of a step must run, by compute dtype, as
# (what its name holds, what it must not hold): every kernel on the
# tensor cores, the f32 ones as split bf16.
STEP_KERNELS = {
    "bfloat16": {"flash_fwd": ("flash_fwd_kernel_wgmma", "_f32"),
                 "flash_bwd_dkdv": ("flash_bwd_dkdv_kernel_wgmma", "_f32"),
                 "flash_bwd_dq": ("flash_bwd_dq_kernel_wgmma", "_f32")},
    "float32": {"flash_fwd": ("flash_fwd_kernel_wgmma_f32", None),
                "flash_bwd_dkdv": ("flash_bwd_dkdv_kernel_wgmma_f32", None),
                "flash_bwd_dq": ("flash_bwd_dq_kernel_wgmma_f32", None)},
}


def _profile_step(train, compute_dtype: str = "bfloat16") -> dict:
    """One flagship training step (forward, backward, adam update) in
    ``compute_dtype`` split by device kernel (torch.profiler; kernel times
    are device times).

    The step is profiled four times, each profile tracing one warm-up
    step that it discards before the step it keeps (an event at the edge
    of a window can go missing: one earlier profile lost 53 of 1731).
    The same step launches the same kernels, so a profile is complete
    when every kernel's count equals its largest count over the profiles
    and each flash group shows the launches its wrapper counted; at least
    two must be.  The breakdown is the first complete profile's.  The
    step's device span (CUDA events around unprofiled steps) gives the
    device's idle share within the step.  Each flash group must have run
    the kernels of ``compute_dtype`` (STEP_KERNELS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from distributed_machine_learning_tpu_torch.ops.losses import mse_loss
    from distributed_machine_learning_tpu_torch.ops.optimizers import (
        make_injected_optimizer,
        set_injected_hyperparams,
    )
    from distributed_machine_learning_tpu_torch.ops.schedules import (
        get_schedule,
    )
    from distributed_machine_learning_tpu_torch.tune._regression_program import (
        make_epoch_fn,
    )

    model, x, y = _flagship_step_setup(train, compute_dtype)
    tx = make_injected_optimizer("adam", get_schedule("constant",
                                                      learning_rate=1.0))
    opt = set_injected_hyperparams(tx.init(dict(model.named_parameters())),
                                   TRAIN["learning_rate"], 0.0)
    step = make_epoch_fn(model, tx, mse_loss, 8, 1, 8)
    perm = torch.arange(8)
    float(step(opt, x, y, perm, None))  # warm
    torch.cuda.synchronize()
    span_ms = cuda_ms(lambda: float(step(opt, x, y, perm, None)), iters=3,
                      warmup=0)
    names = ("flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd")
    runs = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            float(step(opt, x, y, perm, None))
            prof.step()
            counters = _reset_counters()
            t0 = time.perf_counter()
            float(step(opt, x, y, perm, None))
            step_ms = (time.perf_counter() - t0) * 1e3
            launched = {c.name: c.count for c in counters}
            prof.step()
        by_kernel, counts = {}, {}
        for evt in prof.key_averages():
            # The schedule's step annotation spans the step on the device
            # timeline; it is no kernel.
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.key.startswith("ProfilerStep")):
                by_kernel[evt.key] = evt.self_device_time_total / 1e3
                counts[evt.key] = evt.count
        group_counts = {g: sum(n for k, n in counts.items()
                               if f"{g}_kernel" in k) for g in names}
        runs.append((step_ms, by_kernel, counts, group_counts, launched))
    totals = [sum(r[2].values()) for r in runs]
    most = {k: max(r[2].get(k, 0) for r in runs)
            for r in runs for k in r[2]}
    complete = [r for r in runs if r[2] == most and r[3] == r[4]]
    if len(complete) < 2:
        missing = [{k: n - r[2].get(k, 0) for k, n in most.items()
                    if r[2].get(k, 0) != n} for r in runs]
        raise AssertionError(
            f"train: fewer than two complete profiles of the step: device "
            f"events {totals}, missing {missing}, flash groups "
            f"{[(r[3], r[4]) for r in runs]}")
    step_ms, by_kernel, counts, group_counts, _ = complete[0]
    for group, (kernel, other) in STEP_KERNELS[compute_dtype].items():
        ran = [k for k in counts if f"{group}_kernel" in k]
        if not ran or not all(kernel in k and (other is None or other not in k)
                              for k in ran):
            raise AssertionError(f"train: the {compute_dtype} step ran "
                                 f"{group} through {ran}, not {kernel}")
    groups = {g: 0.0 for g in (*names, "other")}
    for key, ms in by_kernel.items():
        groups[next((g for g in names if f"{g}_kernel" in key),
                    "other")] += ms
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "step_host_ms": step_ms, "step_device_ms": busy_ms,
        "step_device_span_ms": span_ms,
        "step_device_idle_share": 1.0 - busy_ms / span_ms,
        "step_kernel_launches": sum(most.values()),
        "step_kernel_launches_by_profile": totals,
        "step_launches_by_group": {**group_counts,
                                   "other": sum(most.values()) - sum(
                                       group_counts.values())},
        "step_device_ms_by_group": groups,
        "step_device_top_ms": {k[:70]: v for k, v in top},
    }


def phase_train():
    import torch

    from distributed_machine_learning_tpu_torch import tune
    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )

    t_start = time.monotonic()
    train, val = dummy_regression_data(num_samples=TRAIN_ROWS,
                                       seq_len=TRAIN["max_seq_length"],
                                       num_features=FEATURES)
    records = []
    trainable = tune.with_parameters(tune.train_regressor, train_data=train,
                                     val_data=val)
    counters = _reset_counters()
    with tune.session.standalone(devices=[torch.device("cuda", 0)],
                                 report_fn=lambda m, c: records.append(m)):
        t0 = time.monotonic()
        trainable(TRAIN)
        train_s = time.monotonic() - t0
    launches = {c.name: c.count for c in counters}

    layers_n = TRAIN["num_layers"]
    steps = records[-1]["steps"]
    eval_forwards = TRAIN["num_epochs"] * -(-len(val) // TRAIN["batch_size"])
    if steps != 16 or len(records) != TRAIN["num_epochs"]:
        raise AssertionError(f"train: {len(records)} epochs, {steps} steps")
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        if launches[name] != layers_n * steps:
            raise AssertionError(
                f"train: {name} launched {launches[name]} times, not "
                f"{layers_n} x {steps}")
    if launches["flash_fwd"] < layers_n * (steps + eval_forwards):
        raise AssertionError(
            f"train: flash_fwd launched {launches['flash_fwd']} times, "
            f"fewer than {layers_n} x ({steps} + {eval_forwards})")
    for r in records:
        if not all(np.isfinite(r[k]) for k in ("train_loss",
                                               "validation_loss")):
            raise AssertionError(f"train: non-finite loss in {r}")

    grads = _grad_check(train)
    worst = {k: v["worst"] for k, v in grads.items() if "worst" in v}
    in_model, tol16 = grads["in_model"], KERNEL_TOL["bfloat16"]
    if not worst["f32_kernel_vs_plain"] <= STEP_TOL["float32"]:
        raise AssertionError(f"train: f32 kernel gradients off the plain "
                             f"step: {grads} (tol {STEP_TOL['float32']})")
    sound = in_model["bf16"]
    if (sound.get("calls") != layers_n
            or not max(sound[n] for n in ("out", "dq", "dk", "dv")) <= tol16):
        raise AssertionError(f"train: a bf16 attention call of the step off "
                             f"its plain version: {sound} (tol {tol16})")
    missed = [n for n in PLANTED_FAULTS
              if not max(in_model[n][g] for g in ("dq", "dk", "dv")) > tol16]
    if missed:
        raise AssertionError(f"train: the in-model check passes the planted "
                             f"faults {missed}: {in_model}")
    if not worst["bf16_kernel_vs_plain"] <= STEP_TOL["bfloat16"]:
        raise AssertionError(f"train: bf16 kernel gradients off the plain "
                             f"step: {grads} (tol {STEP_TOL['bfloat16']})")
    missed = [n for n in STEP_FAULTS
              if not worst[f"fault_{n}"] > STEP_TOL["bfloat16"]]
    if missed:
        raise AssertionError(f"train: the bf16 step limit passes the "
                             f"planted faults {missed}: {grads}")
    profile = _profile_step(train)
    profile_f32 = _profile_step(train, "float32")
    epoch_s = sum(r["epoch_time_s"] for r in records)
    emit("train", card=torch.cuda.get_device_name(0),
         config={k: TRAIN[k] for k in ("d_model", "num_heads", "num_layers",
                                       "dim_feedforward", "max_seq_length",
                                       "compute_dtype", "batch_size")},
         epochs=[{k: r.get(k) for k in ("epoch", "train_loss",
                                          "validation_mape", "epoch_time_s",
                                          "mfu")} for r in records],
         steps=steps, steps_per_s=steps / epoch_s,
         launches=launches, grad_rel_err=grads,
         train_s=train_s, **profile, total_s=time.monotonic() - t_start)
    emit("train_f32_step", card=torch.cuda.get_device_name(0),
         config=dict(TRAIN, compute_dtype="float32"), **profile_f32)
    return launches, profile_f32["step_launches_by_group"]


# -- phase 7 ----------------------------------------------------------------

# The README quickstart (README.md:39-64) at its own widths, cut in depth.
TUNE_SAMPLES, TUNE_EPOCHS = 8, 4
TUNE_MAPE_TOL = 1e-5


def quickstart_sweep(tune, train, val, root: str, *, num_samples: int,
                     num_epochs: int, grace_period: int,
                     random_search_steps: int, **run_kwargs):
    """README.md:42-62 through the port's ``tune.run``: the quickstart's
    space at its own widths, ASHA and BayesOpt, the experiment under
    ``root``.  Returns the analysis, the wall seconds and the three flash
    kernels' launches; raises unless every trial ends TERMINATED."""
    counters = _reset_counters()
    t0 = time.monotonic()
    analysis = tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        {
            "model": "transformer",
            "d_model": tune.choice([64, 128, 256]),
            "num_heads": tune.choice([2, 4, 8]),
            "num_layers": tune.choice([2, 4]),
            "attention_type": tune.choice(
                ["scaled_dot_product", "linear_attention", "flash"]),
            "learning_rate": tune.loguniform(1e-5, 1e-2),
            "weight_decay": tune.loguniform(1e-6, 1e-2),
            "num_epochs": num_epochs,
            "batch_size": 32,
        },
        metric="validation_mape",
        mode="min",
        num_samples=num_samples,
        scheduler=tune.ASHAScheduler(max_t=num_epochs,
                                     grace_period=grace_period,
                                     reduction_factor=3),
        search_alg=tune.BayesOptSearch(
            random_search_steps=random_search_steps),
        storage_path=root,
        **run_kwargs,
    )
    wall_s = time.monotonic() - t0
    launches = {c.name: c.count for c in counters}
    trials = analysis.trials
    bad = {t.trial_id: (t.status.value, (t.error or "")[-800:])
           for t in trials if t.status.value != "TERMINATED"}
    if len(trials) != num_samples or bad:
        raise AssertionError(f"tune: {len(trials)} trials, not all "
                             f"TERMINATED: {bad}")
    return analysis, wall_s, launches


def median_epoch_s(trials, flash: bool) -> float | None:
    """Median ``epoch_time_s`` over the flash trials' epochs, or the
    others'."""
    times = [r["epoch_time_s"] for t in trials for r in t.results
             if (t.config["attention_type"] == "flash") == flash]
    return float(np.median(times)) if times else None


def _best_model_mape(analysis, train, val) -> float:
    """The best trial's newest checkpoint through ``best_model()`` and
    the trainable's own validation pass, on the card."""
    import torch

    from distributed_machine_learning_tpu_torch.tune._regression_program \
        import make_eval_fn, stage_data

    config = analysis.best_trial.config
    model = analysis.best_model().to("cuda")
    data = stage_data(train, val, int(config["batch_size"]), torch.float32,
                      torch.device("cuda"))
    evaluate = make_eval_fn(model, str(config.get("loss_function", "mse")),
                            data.n_val_blocks, data.eval_bs)
    return evaluate(data.x_val, data.y_val, data.val_mask)["validation_mape"]


def phase_tune():
    from distributed_machine_learning_tpu_torch import tune
    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )
    from distributed_machine_learning_tpu_torch.tune.checkpoint import (
        load_checkpoint,
    )

    train, val = dummy_regression_data(num_samples=1000, seq_len=50,
                                       num_features=10)
    with tempfile.TemporaryDirectory() as root:
        analysis, wall_s, launches = quickstart_sweep(
            tune, train, val, root, num_samples=TUNE_SAMPLES,
            num_epochs=TUNE_EPOCHS, grace_period=1, random_search_steps=4,
            points_to_evaluate=[{"attention_type": "flash"}],
            name="quickstart", verbose=0)
        trials = analysis.trials
        unlaunched = [n for n, c in launches.items() if c < 1]
        if unlaunched:
            raise AssertionError(f"tune: the sweep launched no {unlaunched} "
                                 f"kernel: {launches}")
        best = analysis.best_config
        if best not in [t.config for t in trials]:
            raise AssertionError(f"tune: best_config {best} was not sampled")
        reread = tune.ExperimentAnalysis.from_directory(
            analysis.root, "validation_mape", "min")
        if reread.best_config != best:
            raise AssertionError(f"tune: the experiment directory gives "
                                 f"{reread.best_config}, the run {best}")
        trial = analysis.best_trial
        ckpt = load_checkpoint(trial.latest_checkpoint)
        if ckpt is None or ckpt["epoch"] != trial.training_iteration - 1:
            raise AssertionError(f"tune: the best trial's newest checkpoint "
                                 f"{trial.latest_checkpoint} does not load")
        want = trial.last_result["validation_mape"]
        got = _best_model_mape(analysis, train, val)
        mape_rel_err = abs(got - want) / abs(want)
        if not mape_rel_err <= TUNE_MAPE_TOL:
            raise AssertionError(f"tune: best_model() gives validation_mape "
                                 f"{got}, the trial reported {want}")

    emit("tune", card=smi_line(), trials=len(trials), wall_s=wall_s,
         trials_per_hour=analysis.trials_per_hour(),
         median_epoch_s={"flash": median_epoch_s(trials, True),
                         "other": median_epoch_s(trials, False)},
         stop_iterations={t.trial_id: [t.config["attention_type"],
                                       t.training_iteration] for t in trials},
         launches=launches, best_config=best,
         best_validation_mape=want, best_model_rel_err=mape_rel_err)
    return launches


# -- phase 8 ----------------------------------------------------------------

# The bench headline (bench.py:52, :75-81, :451-483): FULL scale.
HEADLINE = dict(num_trials=50, num_epochs=20, data_steps=100_000)
HEADLINE_ASHA = dict(max_t=20, grace_period=5, reduction_factor=2)
# The flash group's depth, cut from 50 x 20.
FLASH_TRIALS, FLASH_EPOCHS = 8, 3
# One trial's f32 trajectory alone, in the 50-row population and in an ASHA
# population that compacted around it.  The card's batched products pick
# other kernels at other batch counts, so the rows agree to rounding, not
# bit for bit, and 440 adam steps scale that rounding up to steps of about
# lr in the entries whose gradient is near 0 (a unit whose ReLU rarely
# fires): on an H100 80GB HBM3 the worst parameter read 2.4e-3 of its
# largest entry alone against the population (the layer-0 FF weight), and
# the final validation_mape 8.0e-8 of itself (PERF.md, PR 11).  A wrong
# mask or a row mixed up in compaction moves them by O(0.1-1): the same
# row's forward with other masks reads 0.77.
ROW_TOL = {"params": 1e-2, "validation_mape": 1e-5}
# One row's training forward (dropout on) alone and in the population, on
# the same weights, batch and masks: read 3.6e-7 of its largest entry.
FORWARD_ROW_TOL = 1e-5


def headline_data():
    """``glucose_like_data(100_000, 16)``: 729 training and 312
    validation windows of 96 x 16."""
    from distributed_machine_learning_tpu_torch.data import glucose_like_data

    return glucose_like_data(num_steps=HEADLINE["data_steps"],
                             num_features=FEATURES)


def headline_space(tune, num_epochs: int = HEADLINE["num_epochs"],
                   **overrides) -> dict:
    """``bench.py::_bench_space`` at FULL scale with compute_dtype
    float32, spelled for the port."""
    space = {
        "model": "transformer",
        "d_model": 64,
        "num_heads": 4,
        "num_layers": 2,
        "dim_feedforward": 128,
        "dropout": 0.1,
        "learning_rate": tune.loguniform(1e-4, 1e-2),
        "weight_decay": tune.loguniform(1e-6, 1e-3),
        "seed": tune.randint(0, 1_000_000),
        "num_epochs": num_epochs,
        "batch_size": 32,
        "max_seq_length": 128,
        "loss_function": "mse",
        "compute_dtype": "float32",
    }
    space.update(overrides)
    return space


def headline_sweep(tune, train, val, root: str, tag: str, *, space=None,
                   scheduler=None, num_samples: int = HEADLINE["num_trials"],
                   epochs_per_dispatch="auto"):
    """bench.py's ``sweep`` (:529-550) through the port's
    ``tune.run_vectorized``: ``num_samples`` trials in one chunk, seed 42.
    Returns the analysis, the wall seconds, the experiment state and the
    three flash kernels' launches; raises unless every trial ends
    TERMINATED."""
    counters = _reset_counters()
    t0 = time.monotonic()
    analysis = tune.run_vectorized(
        space or headline_space(tune), train_data=train, val_data=val,
        metric="validation_mape", mode="min", num_samples=num_samples,
        max_batch_trials=num_samples, scheduler=scheduler,
        storage_path=root, name=f"bench_{tag}", seed=42, verbose=0,
        epochs_per_dispatch=epochs_per_dispatch)
    wall_s = time.monotonic() - t0
    launches = {c.name: c.count for c in counters}
    with open(f"{analysis.root}/experiment_state.json") as f:
        state = json.load(f)
    bad = {t.trial_id: t.status.value for t in analysis.trials
           if t.status.value != "TERMINATED"}
    if len(analysis.trials) != num_samples or bad:
        raise AssertionError(f"vectorized {tag}: {len(analysis.trials)} "
                             f"trials, not all TERMINATED: {bad}")
    return analysis, wall_s, state, launches


def population_step(tune, train, val, config: dict, rows: int):
    """One training step (one batch of every row: forward, backward,
    population adam) of ``rows`` trials of ``config``'s group, as the
    sweep runs it; returns ``(step_fn, program, state)``."""
    import torch

    from distributed_machine_learning_tpu_torch.ops.losses import get_loss
    from distributed_machine_learning_tpu_torch.tune import vectorized
    from distributed_machine_learning_tpu_torch.tune._regression_program \
        import make_population_epoch_fn

    program = vectorized._GroupProgram(config, train, val,
                                       torch.device("cuda", 0))
    seeds = [int(config["seed"]) + i for i in range(rows)]
    state = program.init_population(seeds, [config["learning_rate"]] * rows,
                                    [config["weight_decay"]] * rows)
    d = program.data
    step = make_population_epoch_fn(
        program.model, program.tx, get_loss(program.loss_name), d.n_train, 1,
        d.batch_size)
    perms = program.permutations(state, 0)

    def step_fn():
        return step(state.params, state.opt_state, d.x_train, d.y_train,
                    perms, state.stream_seeds, 0)

    return step_fn, program, state


def profile_population_step(step_fn) -> dict:
    """One population step: its host ms (to the read back of its losses),
    its device span (CUDA events around unprofiled steps) and its device
    busy ms and launches (torch.profiler, four profiles behind a discarded
    warm-up step each: an event at a window's edge can go missing, so the
    launches are the largest count, which at least two must show)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    float(step_fn().sum())  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        float(step_fn().sum())
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    span_ms = cuda_ms(lambda: step_fn(), iters=5, warmup=0)
    runs = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            float(step_fn().sum())
            prof.step()
            float(step_fn().sum())
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        runs.append((sum(e.count for e in events),
                     sum(e.self_device_time_total for e in events) / 1e3))
    launches = max(n for n, _ in runs)
    complete = [ms for n, ms in runs if n == launches]
    if len(complete) < 2:
        raise AssertionError(f"vectorized: fewer than two complete profiles "
                             f"of the step: {runs}")
    busy_ms = complete[0]
    return {"host_ms": host_ms, "device_span_ms": span_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / span_ms,
            "launches": launches,
            "launches_by_profile": [n for n, _ in runs]}


def _params_rel_err(a: dict, b: dict):
    """The largest :func:`_rel_err` of one parameter and its name, the
    attention key biases left out (ZERO_GRAD_PARAMS: their gradient is
    rounding alone, which adam scales up to steps of about lr)."""
    per = {k: _rel_err(a[k], b[k]) for k in b
           if not k.endswith(ZERO_GRAD_PARAMS)}
    name = max(per, key=per.get)
    return per[name], name


def _row_independence(tune, train, val, root, fifo, asha) -> dict:
    """A trial that ran all epochs in the ASHA population (which compacted
    around it), against the same trial in the FIFO population and trained
    alone; and the dropout masks of that row, bit for bit."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import rng
    from distributed_machine_learning_tpu_torch.tune.checkpoint import (
        load_checkpoint,
    )

    epochs = HEADLINE["num_epochs"]
    survivor = next(t for t in asha.trials if t.training_iteration == epochs)
    row = next(t for t in fifo.trials if t.trial_id == survivor.trial_id)
    if row.config != survivor.config:
        raise AssertionError("vectorized: FIFO and ASHA sampled other "
                             "configs for one trial id")
    alone, _, _, _ = headline_sweep(tune, train, val, root, "alone",
                                    space=dict(row.config), num_samples=1)
    want = load_checkpoint(row.latest_checkpoint)["params"]
    want_mape = row.last_result["validation_mape"]
    errs = {}
    for name, trial in (("alone", alone.trials[0]), ("asha", survivor)):
        got = load_checkpoint(trial.latest_checkpoint)["params"]
        worst, param = _params_rel_err(got, want)
        errs[name] = {
            "params": worst, "worst_param": param,
            "validation_mape": abs(trial.last_result["validation_mape"]
                                   - want_mape) / abs(want_mape)}
    # The masks: the row's draws at a dropout site's shape, in the whole
    # population, alone and in a compacted half, on the card.
    seeds = torch.tensor([rng.stream_seed(t.config["seed"])
                          for t in fifo.trials], device="cuda")
    i = fifo.trials.index(row)
    shape = (32, 96, 64)
    masks_equal = True
    for step in (0, 439):
        whole = rng.uniform(seeds, step, 3, shape)
        masks_equal &= bool(torch.equal(
            whole[i], rng.uniform(seeds[i:i + 1], step, 3, shape)[0]))
        half = sorted({i, *range(0, len(seeds), 2)})
        masks_equal &= bool(torch.equal(
            whole[i], rng.uniform(seeds[half], step, 3, shape)[half.index(i)]))
    bad = {k: v for k, v in errs.items()
           if any(v[m] > ROW_TOL[m] for m in ROW_TOL)}
    if bad or not masks_equal:
        raise AssertionError(f"vectorized: {row.trial_id} is not the same "
                             f"alone / after compaction: {errs} (tol "
                             f"{ROW_TOL}), masks equal {masks_equal}")
    return {"trial": row.trial_id, "rel_err": errs, "tol": ROW_TOL,
            "masks_bit_equal": masks_equal}


def _forward_rows_agree(tune, train, val, config: dict):
    """The training forward (dropout on) of row 17 in a population of 50
    and alone, on the same weights and batch: equal masks give outputs
    within f32 rounding.  The same row at another step (other masks) is
    the planted fault that must read far off.  Returns both readings."""
    import torch
    from torch.func import functional_call, vmap

    from distributed_machine_learning_tpu_torch.ops.rng import RowStream

    _, program, state = population_step(tune, train, val, config, 50)
    program.model.train()
    xb = program.data.x_train[program.permutations(state, 0)[:, :32]]

    def forward(params, x, seed, step):
        return functional_call(program.model, params, (x,),
                               {"rng": RowStream(seed, step)})

    run = vmap(forward, in_dims=(0, 0, 0, None), randomness="error")
    i = 17
    alone = ({k: v[i:i + 1] for k, v in state.params.items()}, xb[i:i + 1],
             state.stream_seeds[i:i + 1])
    with torch.no_grad():
        whole = run(state.params, xb, state.stream_seeds, 7)[i]
        same, other = run(*alone, 7)[0], run(*alone, 8)[0]
    return _rel_err(same, whole), _rel_err(other, whole)


def _flash_group(tune, train, val, root) -> dict:
    """The headline space with ``attention_type="flash"`` (cut to 8
    trials x 3 epochs): launches per population step at K = 8 and K = 1,
    the sweep's launches, and every kernel call of one population step
    held against its plain version on the model's own activations."""
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    space = headline_space(tune, num_epochs=FLASH_EPOCHS,
                           attention_type="flash")
    analysis, wall_s, state, launches = headline_sweep(
        tune, train, val, root, "flash", space=space,
        num_samples=FLASH_TRIALS)
    layers_n = space["num_layers"]
    steps = analysis.trials[0].results[-1]["steps"]
    eval_blocks = -(-len(val) // space["batch_size"])
    want = {"flash_fwd": layers_n * (steps + FLASH_EPOCHS * eval_blocks),
            "flash_bwd_dkdv": layers_n * steps,
            "flash_bwd_dq": layers_n * steps}
    if launches != want:
        raise AssertionError(f"vectorized flash: the sweep launched "
                             f"{launches}, not {want} (once per layer per "
                             f"population step or eval block)")
    config = dict(analysis.trials[0].config)
    per_step = {}
    for rows in (FLASH_TRIALS, 1):
        step_fn, _, _ = population_step(tune, train, val, config, rows)
        float(step_fn().sum())
        counters = _reset_counters()
        float(step_fn().sum())
        per_step[rows] = {c.name: c.count for c in counters}
    if any(n != layers_n for v in per_step.values() for n in v.values()):
        raise AssertionError(f"vectorized flash: launches per population "
                             f"step {per_step}, not {layers_n} each")
    record = {}
    step_fn, _, _ = population_step(tune, train, val, config, FLASH_TRIALS)
    saved = fa.flash_forward, fa.flash_backward
    fa.flash_forward, fa.flash_backward = _checking(record)
    try:
        float(step_fn().sum())
    finally:
        fa.flash_forward, fa.flash_backward = saved
    tol = KERNEL_TOL["float32"]
    if (record.get("calls") != layers_n
            or not max(record[n] for n in ("out", "dq", "dk", "dv")) <= tol):
        raise AssertionError(f"vectorized flash: a folded kernel call off "
                             f"its plain version: {record} (tol {tol})")
    return {"trials": FLASH_TRIALS, "epochs": FLASH_EPOCHS,
            "cut": "8 trials x 3 epochs, from the headline's 50 x 20",
            "wall_s": wall_s, "launches": launches,
            "launches_per_step": {f"K={k}": v for k, v in per_step.items()},
            "folded_rel_err": record, "tol": tol}


def phase_vectorized():
    from distributed_machine_learning_tpu_torch import tune

    t_start = time.monotonic()
    train, val = headline_data()
    with tempfile.TemporaryDirectory() as root:
        fifo, fifo_s, fifo_state, _ = headline_sweep(
            tune, train, val, root, "fifo",
            epochs_per_dispatch=HEADLINE["num_epochs"])
        asha, asha_s, asha_state, _ = headline_sweep(
            tune, train, val, root, "asha",
            scheduler=tune.ASHAScheduler(**HEADLINE_ASHA))
        full = HEADLINE["num_trials"] * HEADLINE["num_epochs"]
        if fifo_state["row_epochs_computed"] != full:
            raise AssertionError(f"vectorized: FIFO ran "
                                 f"{fifo_state['row_epochs_computed']} "
                                 f"row-epochs, not {full}")
        if not (asha_state["row_epochs_computed"] < full
                and asha_state["population_compactions"] >= 1):
            raise AssertionError(f"vectorized: ASHA ran "
                                 f"{asha_state['row_epochs_computed']} "
                                 f"row-epochs with "
                                 f"{asha_state['population_compactions']} "
                                 f"compactions")
        independence = _row_independence(tune, train, val, root, fifo, asha)
        config = dict(fifo.trials[0].config)
        forward_err, other_masks_err = _forward_rows_agree(
            tune, train, val, config)
        if not (forward_err <= FORWARD_ROW_TOL < other_masks_err):
            raise AssertionError(f"vectorized: row 17's training forward "
                                 f"alone is {forward_err} off its forward in "
                                 f"the population, with other masks "
                                 f"{other_masks_err} (tol {FORWARD_ROW_TOL})")
        steps = {}
        for rows in (HEADLINE["num_trials"], 1):
            step_fn, _, _ = population_step(tune, train, val, config, rows)
            steps[f"K={rows}"] = profile_population_step(step_fn)
        flash = _flash_group(tune, train, val, root)
    emit("vectorized", card=smi_line(),
         data={"train": list(train.x.shape), "val": list(val.x.shape)},
         fifo={"wall_s": fifo_s, "trials_per_hour":
               fifo.num_terminated() * 3600.0 / fifo_s,
               "row_epochs": fifo_state["row_epochs_computed"],
               "device_utilization": fifo_state["device_utilization"]},
         asha={"wall_s": asha_s, "trials_per_hour":
               asha.num_terminated() * 3600.0 / asha_s,
               "row_epochs": asha_state["row_epochs_computed"],
               "compactions": asha_state["population_compactions"],
               "device_utilization": asha_state["device_utilization"],
               "stop_iterations": sorted(t.training_iteration
                                         for t in asha.trials)},
         best_validation_mape=fifo.best_result["validation_mape"],
         row_independence=independence, forward_row_rel_err=forward_err,
         forward_other_masks_rel_err=other_masks_err,
         population_step=steps, flash=flash,
         total_s=time.monotonic() - t_start)
    return flash


# -- phase 9 ----------------------------------------------------------------

# bench.py's ours_pbt arm (:913-995) at FULL: the headline space, 50 rows x
# 20 epochs, one generation per 5 epochs, its own seeds.
PBT_HEADLINE = dict(interval=5, pbt_seed=3000, sweep_seed=2000,
                    quantile=0.25)
# By the reference step's arithmetic: 12 of 50 rows exploited in each of
# the 3 generations that fire (the 4th ends the sweep), 2 keys explored.
PBT_EXPECT = {"compiled": dict(host_dispatches=1, generations=4),
              "boundary": dict(host_dispatches=4, generations=3),
              "exploits": 36, "explores": 72}
# examples/pbt_sweep.py and pbt_vectorized.py's own counts.
PBT_FLASH = dict(trials=16, epochs=12, interval=3)
# The README quickstart's data and widths with flash fixed, 8 x 8.
PBT_RESPAWN = dict(trials=8, epochs=8, interval=2, slots=4)


def _pbt_mutations(tune, lr_low=1e-4):
    return {"learning_rate": tune.loguniform(lr_low, 1e-2),
            "weight_decay": tune.loguniform(1e-6, 1e-3)}


def _counting_syncs(record: dict):
    """Wrap ``_GroupProgram.pbt_generation_program`` so that every compiled
    chunk runs under torch's sync debug mode and ``record`` counts the
    synchronizing CUDA calls made while its generations were enqueued
    (the read back comes after).  Returns the saved method."""
    import warnings

    import torch

    from distributed_machine_learning_tpu_torch.tune import vectorized

    saved = vectorized._GroupProgram.pbt_generation_program

    def program(self, *args, **kwargs):
        run = saved(self, *args, **kwargs)

        def counted(*a, **k):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = run(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message)[:200] for w in caught
                     if "called a synchronizing" in str(w.message)]
            record["chunks"] = record.get("chunks", 0) + 1
            record["syncs"] = record.get("syncs", 0) + len(syncs)
            record.setdefault("first", syncs[:2])
            return out

        return counted

    vectorized._GroupProgram.pbt_generation_program = program
    return saved


def _pbt_sweep(tune, train, val, root, tag, space, scheduler, *,
               num_samples, **kwargs):
    """One PBT sweep through ``tune.run_vectorized``: the analysis, wall
    seconds, the ``pbt`` block, launches and compiled-chunk syncs; raises
    unless every trial ends TERMINATED at full depth."""
    from distributed_machine_learning_tpu_torch.tune import vectorized

    counters = _reset_counters()
    syncs: dict = {}
    saved = _counting_syncs(syncs)
    t0 = time.monotonic()
    try:
        analysis = tune.run_vectorized(
            space, train_data=train, val_data=val, metric="validation_mape",
            mode="min", num_samples=num_samples,
            max_batch_trials=num_samples, scheduler=scheduler,
            storage_path=root, name=f"pbt_{tag}", verbose=0, **kwargs)
    finally:
        vectorized._GroupProgram.pbt_generation_program = saved
    wall_s = time.monotonic() - t0
    launches = {c.name: c.count for c in counters}
    with open(f"{analysis.root}/experiment_state.json") as f:
        block = json.load(f)["pbt"]
    bad = {t.trial_id: (t.status.value, t.training_iteration)
           for t in analysis.trials
           if t.status.value != "TERMINATED"
           or t.training_iteration != space["num_epochs"]}
    if len(analysis.trials) != num_samples or bad:
        raise AssertionError(f"pbt {tag}: {len(analysis.trials)} trials, "
                             f"not all TERMINATED at full depth: {bad}")
    return {"analysis": analysis, "wall_s": wall_s, "block": block,
            "launches": launches, "syncs": syncs,
            "trials_per_hour": analysis.num_terminated() * 3600.0 / wall_s}


def _pbt_notes(analysis):
    return sorted((t.trial_id, r["training_iteration"],
                   r["pbt_exploited_from"]) for t in analysis.trials
                  for r in t.results if "pbt_exploited_from" in r)


def _pbt_headline(tune, train, val, root) -> dict:
    """(a): the ours_pbt arm uncut, compiled then on the boundary path;
    their decisions bit for bit, each compiled generation replayed through
    the host reference step, the counters, no sync inside the compiled
    chunk, final validation_mape within ROW_TOL."""
    from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
        generation_draw_count,
        generation_draws,
        reference_generation_step,
    )

    runs, logs = {}, {}
    for mode, pbt_mode in (("compiled", "auto"), ("boundary", "boundary")):
        pbt = tune.PopulationBasedTraining(
            perturbation_interval=PBT_HEADLINE["interval"],
            hyperparam_mutations=_pbt_mutations(tune),
            quantile_fraction=PBT_HEADLINE["quantile"],
            seed=PBT_HEADLINE["pbt_seed"])
        runs[mode] = _pbt_sweep(
            tune, train, val, root, mode, headline_space(tune), pbt,
            num_samples=HEADLINE["num_trials"],
            seed=PBT_HEADLINE["sweep_seed"], pbt_mode=pbt_mode)
        logs[mode] = pbt._generation_log
        spec = pbt.device_mutation_spec()
    c, b = runs["compiled"], runs["boundary"]
    fired = [e for e in logs["compiled"] if e["fire"]]
    keys = ("src", "new_lr", "new_wd", "exploited", "scores")
    equal = {k: len(fired) == len(logs["boundary"]) and all(
        np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
        for x, y in zip(fired, logs["boundary"])) for k in keys}
    replayed = all(
        all(np.array_equal(np.asarray(got), want) for got, want in zip(
            (e["src"], e["new_lr"], e["new_wd"], e["exploited"]),
            reference_generation_step(
                spec, e["scores"], e["row_lr"], e["row_wd"], e["valid"],
                generation_draws(PBT_HEADLINE["pbt_seed"], len(e["scores"]),
                                 e["gen"], generation_draw_count(spec)),
                e["fire"])))
        for e in logs["compiled"])
    mape = {t.trial_id: t.last_result["validation_mape"]
            for t in b["analysis"].trials}
    mape_err = max(abs(t.last_result["validation_mape"] - mape[t.trial_id])
                   / abs(mape[t.trial_id]) for t in c["analysis"].trials)
    exploits = int(sum(np.asarray(e["exploited"]).sum()
                       for e in logs["boundary"]))
    checks = {
        "decisions_bit_equal": all(equal[k] for k in keys[:4]),
        "compiled_replays_reference": replayed,
        "notes_equal": _pbt_notes(c["analysis"]) == _pbt_notes(
            b["analysis"]),
        "best_config_equal": c["analysis"].best_config
        == b["analysis"].best_config,
        "mape_within_row_tol": mape_err <= ROW_TOL["validation_mape"],
        "no_sync_in_compiled_chunk": c["syncs"].get("chunks", 0) == 1
        and c["syncs"].get("syncs") == 0,
        **{f"{m}_{k}": runs[m]["block"][k] == v
           for m in ("compiled", "boundary")
           for k, v in PBT_EXPECT[m].items()},
        "exploits_agree": c["block"]["exploits"] == b["block"]["exploits"]
        == exploits and c["block"]["explores"] == 2 * exploits,
        "no_late_exploit": not np.asarray(
            logs["compiled"][-1]["exploited"]).any(),
    }
    if not all(checks.values()):
        raise AssertionError(f"pbt headline: {checks}; logs equal {equal}; "
                             f"compiled {c['block']}, boundary "
                             f"{b['block']}; syncs {c['syncs']}; mape err "
                             f"{mape_err}")
    return {"runs": runs, "checks": checks, "mape_rel_err": mape_err,
            "scores_bit_equal": equal["scores"], "exploits": exploits,
            "expected_exploits": PBT_EXPECT["exploits"]}


def _pbt_flash(tune, train, val, root) -> dict:
    """(b): the headline space with flash at 16 x 12, interval 3, compiled:
    every f32 kernel once per layer per population step and eval block
    across the exploit gathers; then one population step right after an
    exploit, each folded call held against its plain version."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops.losses import get_loss
    from distributed_machine_learning_tpu_torch.tune import vectorized
    from distributed_machine_learning_tpu_torch.tune._regression_program \
        import make_population_epoch_fn
    from distributed_machine_learning_tpu_torch.tune.schedulers.pbt import (
        generation_draw_count,
        generation_draws,
        reference_generation_step,
    )

    rows, epochs = PBT_FLASH["trials"], PBT_FLASH["epochs"]
    space = headline_space(tune, num_epochs=epochs, attention_type="flash")
    pbt = tune.PopulationBasedTraining(
        perturbation_interval=PBT_FLASH["interval"],
        hyperparam_mutations=_pbt_mutations(tune), quantile_fraction=0.25,
        seed=1)
    run = _pbt_sweep(tune, train, val, root, "flash", space, pbt,
                     num_samples=rows, seed=7)
    layers_n = space["num_layers"]
    steps = run["analysis"].trials[0].results[-1]["steps"]
    eval_blocks = -(-len(val) // space["batch_size"])
    want = {"flash_fwd": layers_n * (steps + epochs * eval_blocks),
            "flash_bwd_dkdv": layers_n * steps,
            "flash_bwd_dq": layers_n * steps}
    if (run["launches"] != want or run["block"]["exploits"] < 1
            or run["syncs"].get("syncs") != 0):
        raise AssertionError(f"pbt flash: launched {run['launches']}, not "
                             f"{want}; {run['block']}; syncs {run['syncs']}")

    # One population step right after an exploit.
    config = dict(run["analysis"].trials[0].config)
    program = vectorized._GroupProgram(config, train, val,
                                       torch.device("cuda", 0))
    lrs = np.geomspace(1e-4, 1e-2, rows).astype(np.float32)
    wds = np.full(rows, 1e-5, np.float32)
    state = program.init_population([11 + i for i in range(rows)], lrs, wds)
    _, metrics = program.read_epochs(*program.run_epochs(state, 0, 1))
    spec = pbt.device_mutation_spec()
    src, new_lr, new_wd, exploited = reference_generation_step(
        spec, metrics["validation_mape"][:, 0], lrs, wds,
        np.ones(rows, bool), generation_draws(1, rows, 0,
                                              generation_draw_count(spec)),
        True)
    state = program.gather_rows(state, src, new_lr, new_wd)
    d = program.data
    step = make_population_epoch_fn(program.model, program.tx,
                                    get_loss(program.loss_name), d.n_train,
                                    1, d.batch_size)
    perms = program.permutations(state, 1)
    record: dict = {}
    counters = _reset_counters()
    saved = fa.flash_forward, fa.flash_backward
    fa.flash_forward, fa.flash_backward = _checking(record)
    try:
        float(step(state.params, state.opt_state, d.x_train, d.y_train,
                   perms, state.stream_seeds, program.steps_per_epoch).sum())
    finally:
        fa.flash_forward, fa.flash_backward = saved
    per_step = {c.name: c.count for c in counters}
    tol = KERNEL_TOL["float32"]
    if (not exploited.any() or record.get("calls") != layers_n
            or any(n != layers_n for n in per_step.values())
            or not max(record[n] for n in ("out", "dq", "dk", "dv")) <= tol):
        raise AssertionError(f"pbt flash: after the exploit "
                             f"({int(exploited.sum())} rows) a step "
                             f"launched {per_step}, folded calls {record} "
                             f"(tol {tol})")
    run["after_exploit"] = {"exploited_rows": int(exploited.sum()),
                            "launches_per_step": per_step,
                            "folded_rel_err": record, "tol": tol}
    return run


def _pbt_pb2(tune, root) -> dict:
    """(c): PB2 on the boundary path as examples/pbt_vectorized.py
    --scheduler pb2 runs it, at 16 x 12, interval 3, with its population
    checkpoints every interval."""
    from distributed_machine_learning_tpu_torch.data import glucose_like_data

    train, val = glucose_like_data(num_steps=60_000, num_features=FEATURES)
    rows, epochs, interval = (PBT_FLASH["trials"], PBT_FLASH["epochs"],
                              PBT_FLASH["interval"])
    space = headline_space(tune, num_epochs=epochs,
                           learning_rate=tune.loguniform(1e-5, 1e-2))
    space.pop("compute_dtype")
    pb2 = tune.PB2(perturbation_interval=interval,
                   hyperparam_mutations=_pbt_mutations(tune, 1e-5),
                   quantile_fraction=0.25, seed=1)
    run = _pbt_sweep(tune, train, val, root, "pb2", space, pb2,
                     num_samples=rows, epochs_per_dispatch=interval,
                     checkpoint_every_epochs=interval)
    block = run["block"]
    if not (block["mode"] == "boundary" and block["num_observations"] > 0
            and block["num_perturbations"] > 0
            and block["host_dispatches"] == epochs // interval):
        raise AssertionError(f"pbt pb2: {block}")
    return run


def _pbt_respawn(tune, root) -> dict:
    """(d): respawn PBT through ``tune.run`` (README quickstart data and
    widths, flash fixed, 8 trials x 8 epochs, interval 2, the lr mutated;
    4 lease slots on the card so that a lagger meets donors still
    training).  Every trial TERMINATED with at least one requeue; each
    requeued trial resumed from a donor's checkpoint with its weights bit
    for bit and reported restore_base + 1 first."""
    import torch

    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )
    from distributed_machine_learning_tpu_torch.tune import (
        trainable as port_trainable,
    )
    from distributed_machine_learning_tpu_torch.tune.checkpoint import (
        load_checkpoint,
    )

    train, val = dummy_regression_data(num_samples=1000, seq_len=50,
                                       num_features=10)
    restored: dict = {}
    make_epoch_fn = port_trainable.make_epoch_fn

    def spy(model, *args):
        trial = tune.session._get_session().trial
        if trial.restore_path:
            restored.setdefault(trial.trial_id, []).append((
                trial.restore_path, trial.restore_base,
                {k: p.detach().cpu().clone()
                 for k, p in model.named_parameters()}))
        return make_epoch_fn(model, *args)

    pbt = tune.PopulationBasedTraining(
        perturbation_interval=PBT_RESPAWN["interval"],
        hyperparam_mutations={"learning_rate": tune.loguniform(1e-5, 1e-2)},
        quantile_fraction=0.25, seed=4)
    counters = _reset_counters()
    port_trainable.make_epoch_fn = spy
    t0 = time.monotonic()
    try:
        analysis = tune.run(
            tune.with_parameters(tune.train_regressor, train_data=train,
                                 val_data=val),
            {"model": "transformer",
             "d_model": tune.choice([64, 128, 256]),
             "num_heads": tune.choice([2, 4, 8]),
             "num_layers": tune.choice([2, 4]),
             "attention_type": "flash",
             "learning_rate": tune.loguniform(1e-5, 1e-2),
             "weight_decay": tune.loguniform(1e-6, 1e-2),
             "num_epochs": PBT_RESPAWN["epochs"], "batch_size": 32},
            metric="validation_mape", mode="min",
            num_samples=PBT_RESPAWN["trials"], scheduler=pbt, seed=3,
            devices=[torch.device("cuda", 0)] * PBT_RESPAWN["slots"],
            storage_path=root, name="pbt_respawn", verbose=0)
    finally:
        port_trainable.make_epoch_fn = make_epoch_fn
    wall_s = time.monotonic() - t0
    launches = {c.name: c.count for c in counters}
    with open(f"{analysis.root}/experiment_state.json") as f:
        block = json.load(f)["pbt"]
    by_id = {t.trial_id: t for t in analysis.trials}
    problems = []
    for tid, restarts in restored.items():
        for path, base, weights in restarts:
            donor_id = path.rsplit("/", 3)[-3]
            donor = load_checkpoint(path)
            if donor_id == tid or not all(
                    torch.equal(weights[k], w)
                    for k, w in donor["params"].items()):
                problems.append((tid, path, "weights"))
            if not any(r["training_iteration"] == base + 1
                       and r["epoch"] == base
                       for r in by_id[tid].results):
                problems.append((tid, base, "first record"))
    bad = {t.trial_id: t.status.value for t in analysis.trials
           if t.status.value != "TERMINATED"}
    if (bad or not restored or problems or block["exploits"]
            != sum(map(len, restored.values()))
            or min(launches.values()) < 1):
        raise AssertionError(f"pbt respawn: not TERMINATED {bad}; restored "
                             f"{ {k: len(v) for k, v in restored.items()} }; "
                             f"{problems}; {block}; launches {launches}")
    return {"analysis": analysis, "wall_s": wall_s, "block": block,
            "launches": launches,
            "trials_per_hour": analysis.trials_per_hour(),
            "requeues": {k: [(p.rsplit("/", 3)[-3], b) for p, b, _ in v]
                         for k, v in restored.items()}}


def _pbt_line(run: dict) -> dict:
    return {"wall_s": run["wall_s"], "trials_per_hour":
            run["trials_per_hour"], "pbt": run["block"],
            "launches": run["launches"],
            **({"compiled_chunk_syncs": run["syncs"]}
               if "syncs" in run else {})}


def phase_pbt():
    from distributed_machine_learning_tpu_torch import tune

    t_start = time.monotonic()
    train, val = headline_data()
    card = smi_line()
    with tempfile.TemporaryDirectory() as root:
        headline = _pbt_headline(tune, train, val, root)
        for mode, run in headline["runs"].items():
            emit("pbt", sub=f"a_headline_{mode}", card=card,
                 rows=HEADLINE["num_trials"], epochs=HEADLINE["num_epochs"],
                 best_validation_mape=run["analysis"].best_result[
                     "validation_mape"], **_pbt_line(run))
        flash = _pbt_flash(tune, train, val, root)
        emit("pbt", sub="b_flash", card=card, rows=PBT_FLASH["trials"],
             epochs=PBT_FLASH["epochs"],
             cut="16 x 12, interval 3 (examples/pbt_sweep.py's counts)",
             after_exploit=flash["after_exploit"], **_pbt_line(flash))
        pb2 = _pbt_pb2(tune, root)
        emit("pbt", sub="c_pb2", card=card, rows=PBT_FLASH["trials"],
             epochs=PBT_FLASH["epochs"], **_pbt_line(pb2))
        respawn = _pbt_respawn(tune, root)
        emit("pbt", sub="d_respawn", card=card,
             trials=PBT_RESPAWN["trials"], epochs=PBT_RESPAWN["epochs"],
             slots=PBT_RESPAWN["slots"], requeues=respawn["requeues"],
             best_config=respawn["analysis"].best_config,
             **_pbt_line(respawn))
    emit("pbt", card=card, checks=headline["checks"],
         headline_mape_rel_err=headline["mape_rel_err"],
         headline_scores_bit_equal=headline["scores_bit_equal"],
         headline_exploits=headline["exploits"],
         headline_expected_exploits=headline["expected_exploits"],
         cut=None, total_s=time.monotonic() - t_start)
    return {"flash_population": flash["launches"],
            "respawn": respawn["launches"]}


# -- phase 10 ---------------------------------------------------------------

# (a) phase vectorized's ASHA headline, saved every 5 epochs, interrupted
# on the first record of epoch 12: the newest checkpoint is epoch 10's,
# written after the second compaction (ASHA's rungs at 5 and 10).
RESUME_HEADLINE = dict(checkpoint_every=5, fatal_iteration=12)
# (b) the flash group at 8 x 6 (cut from 50 x 20), saved every 2 epochs,
# interrupted at 3.
RESUME_FLASH = dict(trials=8, epochs=6, checkpoint_every=2,
                    fatal_iteration=3)
# (c) examples/pbt_vectorized.py as it runs: 16 x 12, interval 3, the
# interval as dispatch and checkpoint cadence; interrupted on the first
# record after generation 2.
RESUME_PBT = dict(trials=16, epochs=12, interval=3, fatal_iteration=7)
# (d) the quickstart's widths with flash through tune.run, 8 x 4 on one
# lease slot (two ran 1.9x slower, PERF.md), SIGKILLed once 6 trial
# checkpoints have landed: trial 0 done or all but done, trial 1 in flight.
RESUME_RUN = dict(trials=8, epochs=4, slots=1, kill_after=6)


class _Preempted(RuntimeError):
    """The interruption planted in a sweep: its process dying."""


def _dying(sched, fatal: int, hook: str = "on_trial_result"):
    """``sched`` whose ``hook`` raises on the first record at ``fatal``
    (under PBT the vectorized runner only calls ``observe_result``)."""
    orig = getattr(sched, hook)

    def hooked(trial, result):
        if result["training_iteration"] >= fatal:
            raise _Preempted(f"planted at training_iteration {fatal}")
        return orig(trial, result)

    setattr(sched, hook, hooked)
    return sched


def _experiment_state(root: str) -> dict:
    with open(os.path.join(root, "experiment_state.json")) as f:
        return json.load(f)


def _result_lines(root: str, trial_id: str) -> list:
    with open(os.path.join(root, trial_id, "result.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _vectorized_resume(tune, train, val, root, tag, space, make_sched, *,
                       num_samples, fatal, **kwargs) -> dict:
    """One ``run_vectorized`` spec three times in this process:
    uninterrupted, interrupted at ``fatal`` (the scheduler from
    ``make_sched(fatal)`` raises) and resumed; with each population save's
    seconds and bytes, the resume's load seconds and the kernels'
    launches in the resumed run."""
    from distributed_machine_learning_tpu_torch.tune import (
        checkpoint as ckpt_lib,
    )
    from distributed_machine_learning_tpu_torch.tune import vectorized

    saves, loads, scheds = [], [], []
    save, load = ckpt_lib.save_replacing, vectorized._load_resume_state

    def timed_save(path, tree):
        t0 = time.monotonic()
        out = save(path, tree)
        with open(path) as f:
            nbytes = json.load(f)["bytes"]
        saves.append({"s": time.monotonic() - t0, "bytes": nbytes,
                      "rows": len(tree["rows"])})
        return out

    def timed_load(*args, **kw):
        t0 = time.monotonic()
        out = load(*args, **kw)
        loads.append(time.monotonic() - t0)
        return out

    def sweep(name, fatal=None, resume=False):
        sched = make_sched()
        if fatal is not None:
            sched = _dying(sched, fatal, "observe_result"
                           if hasattr(sched, "mutations")
                           else "on_trial_result")
        scheds.append(sched)
        counters = _reset_counters()
        t0 = time.monotonic()
        analysis = tune.run_vectorized(
            space, train_data=train, val_data=val, metric="validation_mape",
            mode="min", num_samples=num_samples, max_batch_trials=num_samples,
            scheduler=sched, storage_path=root, name=name, verbose=0,
            resume=resume, **kwargs)
        return {"analysis": analysis, "wall_s": time.monotonic() - t0,
                "state": _experiment_state(analysis.root), "sched": sched,
                "launches": {c.name: c.count for c in counters}}

    ckpt_lib.save_replacing = timed_save
    vectorized._load_resume_state = timed_load
    try:
        ref = sweep(f"resume_{tag}_ref")
        n_ref_saves = len(saves)
        name = f"resume_{tag}"
        t0 = time.monotonic()
        try:
            sweep(name, fatal=fatal)
        except _Preempted:
            crash_s = time.monotonic() - t0
        else:
            raise AssertionError(f"resume {tag}: the planted interruption "
                                 f"at {fatal} did not fire")
        ck = ckpt_lib.load_checkpoint(os.path.join(
            root, name, vectorized.POPULATION_CHECKPOINT))
        resumed = sweep(name, resume=True)
    finally:
        ckpt_lib.save_replacing = save
        vectorized._load_resume_state = load
    for run in (ref, resumed):
        bad = {t.trial_id: t.status.value for t in run["analysis"].trials
               if t.status.value != "TERMINATED"}
        if len(run["analysis"].trials) != num_samples or bad:
            raise AssertionError(f"resume {tag}: not all TERMINATED: {bad}")
    return {"ref": ref, "resumed": resumed, "crash_s": crash_s,
            "ckpt": ck,
            "saves": saves[:n_ref_saves], "load_s": loads,
            "resumed_saves": saves[n_ref_saves:]}


def _same_sweep(got, want) -> dict:
    """Records (less clocks), stop iterations, each epoch once in
    result.jsonl, best_config, and each trial's final parameters: bit
    for bit, with the largest relative error where they differ."""
    import torch

    from distributed_machine_learning_tpu_torch.tune.checkpoint import (
        load_checkpoint,
    )

    def plain(record):
        return {k: v for k, v in record.items()
                if k not in ("timestamp", "time_total_s")}

    a = sorted(got.trials, key=lambda t: t.trial_id)
    b = sorted(want.trials, key=lambda t: t.trial_id)
    once = all([r["training_iteration"] for r in
                _result_lines(got.root, t.trial_id)]
               == list(range(1, t.training_iteration + 1)) for t in a)
    params_equal, params_err, mape_err = True, (0.0, None), 0.0
    for x, y in zip(a, b):
        pa = load_checkpoint(x.latest_checkpoint)["params"]
        pb = load_checkpoint(y.latest_checkpoint)["params"]
        params_equal &= all(torch.equal(pa[k], pb[k]) for k in pb)
        params_err = max(params_err, _params_rel_err(pa, pb),
                         key=lambda e: e[0])
        want_mape = y.last_result["validation_mape"]
        mape_err = max(mape_err, abs(x.last_result["validation_mape"]
                                     - want_mape) / abs(want_mape))
    return {
        "trial_ids_equal": [t.trial_id for t in a] == [t.trial_id for t in b],
        "stop_iterations_equal": [t.training_iteration for t in a]
        == [t.training_iteration for t in b],
        "each_epoch_once": once,
        "best_config_equal": got.best_config == want.best_config,
        "records_bit_equal": all([plain(r) for r in x.results]
                                 == [plain(r) for r in y.results]
                                 for x, y in zip(a, b)),
        "params_bit_equal": params_equal,
        "params_rel_err": params_err[0], "params_worst": params_err[1],
        "mape_rel_err": mape_err,
    }


def _within_row_tol(same: dict) -> bool:
    return (same["params_rel_err"] <= ROW_TOL["params"]
            and same["mape_rel_err"] <= ROW_TOL["validation_mape"])


def _population_sizes(analysis) -> dict:
    return {r["epoch"]: r["population_size"] for t in analysis.trials
            for r in t.results}


def _resume_headline(tune, train, val, root) -> dict:
    """(a): the ASHA headline at full width, checkpointed every 5 epochs,
    interrupted at 12, resumed; against the uninterrupted run."""
    every = RESUME_HEADLINE["checkpoint_every"]
    run = _vectorized_resume(
        tune, train, val, root, "a_headline", headline_space(tune),
        lambda: tune.ASHAScheduler(**HEADLINE_ASHA),
        num_samples=HEADLINE["num_trials"],
        fatal=RESUME_HEADLINE["fatal_iteration"], seed=42,
        checkpoint_every_epochs=every)
    ref, resumed, ck = run["ref"], run["resumed"], run["ckpt"]
    sizes = _population_sizes(ref["analysis"])
    epoch0 = ck["epoch0"]
    same = _same_sweep(resumed["analysis"], ref["analysis"])
    # The interrupted run's count dies with it: its compactions are the
    # population's size changes up to the checkpoint.
    compactions = {
        "ref": ref["state"]["population_compactions"],
        "before_checkpoint": sum(sizes[e] != sizes[e - 1]
                                 for e in range(1, epoch0 + 1)),
        "resumed": resumed["state"]["population_compactions"]}
    checks = {
        "checkpoint_at_10": epoch0 == 10,
        "checkpoint_after_second_compaction": len(ck["rows"]) == sizes[epoch0]
        and len(set(sizes[e] for e in range(epoch0 + 1))) == 3,
        "population_sizes_equal": _population_sizes(resumed["analysis"])
        == sizes,
        "row_epochs_add_up": resumed["state"]["row_epochs_computed"] == sum(
            n for e, n in sizes.items() if e >= epoch0)
        and ref["state"]["row_epochs_computed"] == sum(sizes.values()),
        "compactions_add_up": compactions["before_checkpoint"]
        + compactions["resumed"] == compactions["ref"] == 2,
        "within_row_tol": _within_row_tol(same),
        **{k: v for k, v in same.items() if k in (
            "trial_ids_equal", "stop_iterations_equal", "each_epoch_once",
            "best_config_equal")},
    }
    if not all(checks.values()):
        raise AssertionError(f"resume a: {checks}; {same}; sizes {sizes}; "
                             f"compactions {compactions}")
    return {"run": run, "checks": checks, "same": same,
            "compactions": compactions, "epoch0": epoch0,
            "row_epochs": {"ref": ref["state"]["row_epochs_computed"],
                           "resumed": resumed["state"]["row_epochs_computed"]}}


def _resume_flash(tune, train, val, root) -> dict:
    """(b): the flash group, 8 x 6, checkpointed every 2 epochs,
    interrupted at 3: each f32 kernel once per layer per population step
    and eval block after the resume, and one post-resume step's folded
    calls against their plain versions."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops.losses import get_loss
    from distributed_machine_learning_tpu_torch.tune import vectorized
    from distributed_machine_learning_tpu_torch.tune._regression_program \
        import make_population_epoch_fn

    epochs = RESUME_FLASH["epochs"]
    space = headline_space(tune, num_epochs=epochs, attention_type="flash")
    run = _vectorized_resume(
        tune, train, val, root, "b_flash", space, tune.FIFOScheduler,
        num_samples=RESUME_FLASH["trials"],
        fatal=RESUME_FLASH["fatal_iteration"], seed=42,
        checkpoint_every_epochs=RESUME_FLASH["checkpoint_every"])
    ck, resumed = run["ckpt"], run["resumed"]
    layers_n = space["num_layers"]
    spe = resumed["analysis"].trials[0].results[-1]["steps"] // epochs
    left = epochs - ck["epoch0"]
    eval_blocks = -(-len(val) // space["batch_size"])
    want = {"flash_fwd": layers_n * left * (spe + eval_blocks),
            "flash_bwd_dkdv": layers_n * left * spe,
            "flash_bwd_dq": layers_n * left * spe}
    same = _same_sweep(resumed["analysis"], run["ref"]["analysis"])

    # One population step from the checkpoint the resume started from.
    program = vectorized._GroupProgram(
        dict(resumed["analysis"].trials[0].config), train, val,
        torch.device("cuda", 0))
    state = program.restore_population(ck["state"])
    d = program.data
    step = make_population_epoch_fn(program.model, program.tx,
                                    get_loss(program.loss_name), d.n_train,
                                    1, d.batch_size)
    perms = program.permutations(state, ck["epoch0"])
    record: dict = {}
    counters = _reset_counters()
    saved = fa.flash_forward, fa.flash_backward
    fa.flash_forward, fa.flash_backward = _checking(record)
    try:
        float(step(state.params, state.opt_state, d.x_train, d.y_train,
                   perms, state.stream_seeds,
                   ck["epoch0"] * program.steps_per_epoch).sum())
    finally:
        fa.flash_forward, fa.flash_backward = saved
    per_step = {c.name: c.count for c in counters}
    tol = KERNEL_TOL["float32"]
    checks = {
        "checkpoint_at_2": ck["epoch0"] == 2,
        "launches_per_step_and_eval_block": resumed["launches"] == want,
        "step_launches": all(n == layers_n for n in per_step.values()),
        "folded_calls_within_tol": record.get("calls") == layers_n and max(
            record[n] for n in ("out", "dq", "dk", "dv")) <= tol,
        "within_row_tol": _within_row_tol(same),
        "each_epoch_once": same["each_epoch_once"],
        "stop_iterations_equal": same["stop_iterations_equal"],
    }
    if not all(checks.values()):
        raise AssertionError(f"resume b: {checks}; launched "
                             f"{resumed['launches']}, not {want}; step "
                             f"{per_step}; folded {record}; {same}")
    return {"run": run, "checks": checks, "same": same,
            "launches": resumed["launches"], "want": want,
            "step": {"launches": per_step, "folded_rel_err": record,
                     "tol": tol}}


def _resume_pbt(tune, root) -> dict:
    """(c): examples/pbt_vectorized.py as it runs, compiled, interrupted
    after generation 2: the resume stays compiled, and its generation log
    and donor notes equal the uninterrupted run's bit for bit."""
    from distributed_machine_learning_tpu_torch.data import glucose_like_data

    train, val = glucose_like_data(num_steps=60_000, num_features=FEATURES)
    iv, epochs = RESUME_PBT["interval"], RESUME_PBT["epochs"]
    space = headline_space(tune, num_epochs=epochs,
                           learning_rate=tune.loguniform(1e-5, 1e-2))
    space.pop("compute_dtype")
    run = _vectorized_resume(
        tune, train, val, root, "c_pbt", space,
        lambda: tune.PopulationBasedTraining(
            perturbation_interval=iv,
            hyperparam_mutations=_pbt_mutations(tune, 1e-5),
            quantile_fraction=0.25, seed=1),
        num_samples=RESUME_PBT["trials"],
        fatal=RESUME_PBT["fatal_iteration"], epochs_per_dispatch=iv,
        checkpoint_every_epochs=iv)
    ref, resumed, ck = run["ref"], run["resumed"], run["ckpt"]
    gen0 = ck["epoch0"] // iv
    ref_log = [e for e in ref["sched"]._generation_log if e["gen"] >= gen0]
    log = resumed["sched"]._generation_log
    keys = ("gen", "fire", "scores", "row_lr", "row_wd", "valid", "src",
            "new_lr", "new_wd", "exploited")
    log_equal = len(log) == len(ref_log) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for a, b in zip(log, ref_log) for k in keys)

    def notes(analysis):
        return [n for n in _pbt_notes(analysis) if n[1] > ck["epoch0"]]

    block, ref_block = resumed["state"]["pbt"], ref["state"]["pbt"]
    same = _same_sweep(resumed["analysis"], ref["analysis"])
    checks = {
        "checkpoint_after_generation_2": ck["epoch0"] == 2 * iv,
        "stays_compiled": block["mode"] == ref_block["mode"] == "compiled"
        and "mode_fallbacks" not in block,
        "host_dispatches": block["host_dispatches"]
        == (epochs - ck["epoch0"]) // iv
        and ref_block["host_dispatches"] == epochs // iv,
        "generation_log_bit_equal": log_equal,
        "donor_notes_equal": notes(resumed["analysis"]) == notes(
            ref["analysis"]) and bool(notes(ref["analysis"])),
        "within_row_tol": _within_row_tol(same),
        "each_epoch_once": same["each_epoch_once"],
    }
    if not all(checks.values()):
        raise AssertionError(f"resume c: {checks}; {block} vs {ref_block}; "
                             f"{same}")
    return {"run": run, "checks": checks, "same": same, "pbt": block,
            "exploits_after_resume": block["exploits"]}


def _resume_run_sweep(tune, root: str, name: str, resume: bool):
    """Phase resume (d)'s spec: the quickstart's data and widths with
    flash fixed, 8 trials x 4 epochs, FIFO, one lease slot on the card."""
    import torch

    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )

    train, val = dummy_regression_data(num_samples=1000, seq_len=50,
                                       num_features=10)
    return tune.run(
        tune.with_parameters(tune.train_regressor, train_data=train,
                             val_data=val),
        {"model": "transformer", "d_model": tune.choice([64, 128, 256]),
         "num_heads": tune.choice([2, 4, 8]),
         "num_layers": tune.choice([2, 4]), "attention_type": "flash",
         "learning_rate": tune.loguniform(1e-5, 1e-2),
         "weight_decay": tune.loguniform(1e-6, 1e-2),
         "num_epochs": RESUME_RUN["epochs"], "batch_size": 32},
        metric="validation_mape", mode="min",
        num_samples=RESUME_RUN["trials"], seed=5,
        devices=[torch.device("cuda", 0)] * RESUME_RUN["slots"],
        storage_path=root, name=name, verbose=0, resume=resume)


def _resume_run_child(root: str, resume: bool, out: str) -> None:
    """Phase resume (d) in a process of its own: the first run (which the
    parent kills), or the resume, then the uninterrupted run of the same
    spec; what it saw goes to ``out`` as JSON."""
    import torch

    from distributed_machine_learning_tpu_torch import tune
    from distributed_machine_learning_tpu_torch.tune import _driver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    restored: dict = {}
    restore = _driver.TrialLifecycle.restore_experiment

    def spy(self, *args, **kwargs):
        restored["counts"] = restore(self, *args, **kwargs)
        restored["requeued"] = {t.trial_id: [t.restore_base, len(t.results)]
                                for t in self.pending}
        return restored["counts"]

    _driver.TrialLifecycle.restore_experiment = spy
    counters = _reset_counters()
    t0 = time.monotonic()
    analysis = _resume_run_sweep(tune, root, "resume_d", resume)
    doc = {"wall_s": time.monotonic() - t0,
           "launches": {c.name: c.count for c in counters}, **restored}

    def trials(a):
        return {t.trial_id: {"status": t.status.value, "config": t.config,
                             "its": [r["training_iteration"]
                                     for r in t.results],
                             "mape": [r["validation_mape"]
                                      for r in t.results]}
                for t in a.trials}

    doc["trials"] = trials(analysis)
    if resume:
        t0 = time.monotonic()
        doc["ref"] = trials(_resume_run_sweep(tune, root, "resume_d_ref",
                                              False))
        doc["ref_wall_s"] = time.monotonic() - t0
    with open(out, "w") as f:
        json.dump(doc, f)


def _resume_run(root: str) -> dict:
    """(d): ``tune.run`` in a child process, SIGKILLed once
    ``kill_after`` trial checkpoints have landed, then
    ``tune.run(resume=True)`` in a fresh process."""
    import glob

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, chip_smoke; chip_smoke._resume_run_child("
            "sys.argv[1], sys.argv[2] == '1', sys.argv[3])")
    exp = os.path.join(root, "resume_d")
    out = os.path.join(root, "resume_d.json")
    logs = {k: os.path.join(root, f"resume_d_{k}.log")
            for k in ("first", "resumed")}

    def tail(path):
        with open(path, errors="replace") as f:
            return f.read()[-3000:]

    t0 = time.monotonic()
    with open(logs["first"], "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code, root, "0", out],
                                cwd=here, stdout=log, stderr=log)
    try:
        deadline = time.monotonic() + 300
        while True:
            landed = glob.glob(os.path.join(exp, "trial_*", "checkpoints",
                                            "ckpt_*.json"))
            if len(landed) >= RESUME_RUN["kill_after"]:
                break
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"resume d: the first run ended ({proc.poll()}) or "
                    f"stalled before {RESUME_RUN['kill_after']} "
                    f"checkpoints:\n{tail(logs['first'])}")
            time.sleep(0.02)
        proc.kill()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    first_s = time.monotonic() - t0
    landed = sorted(os.path.relpath(p, exp) for p in glob.glob(os.path.join(
        exp, "trial_*", "checkpoints", "ckpt_*.json")))
    t0 = time.monotonic()
    with open(logs["resumed"], "w") as log:
        done = subprocess.run([sys.executable, "-c", code, root, "1", out],
                              cwd=here, stdout=log, stderr=log, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"resume d: the resume exited "
                             f"{done.returncode}:\n{tail(logs['resumed'])}")
    child_s = time.monotonic() - t0
    with open(out) as f:
        doc = json.load(f)
    trials, requeued = doc["trials"], doc["requeued"]
    full = list(range(1, RESUME_RUN["epochs"] + 1))
    on_disk = {tid: [r["training_iteration"] for r in _result_lines(exp, tid)]
               for tid in trials}
    # A trial restored at its full budget reports nothing more.
    first_after = {tid: trials[tid]["its"][kept] == base + 1
                   for tid, (base, kept) in requeued.items()
                   if kept < len(trials[tid]["its"])}
    mape_equal = {tid: t["mape"] == doc["ref"][tid]["mape"]
                  for tid, t in trials.items()}
    mape_err = max(abs(a - b) / abs(b) for tid, t in trials.items()
                   for a, b in zip(t["mape"], doc["ref"][tid]["mape"]))
    checks = {
        "killed_with_a_trial_in_flight": bool(requeued),
        "all_terminated": len(trials) == RESUME_RUN["trials"] and all(
            t["status"] == "TERMINATED" for t in trials.values()),
        "each_epoch_once": all(t["its"] == full == on_disk[tid]
                               for tid, t in trials.items()),
        "first_report_at_restore_base_plus_1": all(first_after.values()),
        "restored_from_a_checkpoint": any(
            requeued[tid][0] > 0 for tid in first_after),
        "f32_kernels_launched": min(doc["launches"].values()) >= 1,
        "configs_equal_uninterrupted": all(
            t["config"] == doc["ref"][tid]["config"]
            for tid, t in trials.items()),
    }
    if not all(checks.values()):
        raise AssertionError(f"resume d: {checks}; requeued {requeued}; "
                             f"{doc['counts']}; {trials}")
    return {"checks": checks, "first_run_s": first_s,
            "checkpoints_at_kill": landed, "resumed_s": doc["wall_s"],
            "child_s": child_s, "ref_s": doc["ref_wall_s"],
            "counts": doc["counts"], "requeued": requeued,
            "launches": doc["launches"],
            "mape_bit_equal_uninterrupted": all(mape_equal.values()),
            "mape_rel_err_uninterrupted": mape_err}


def _saves_line(saves) -> dict:
    if not saves:
        return {}
    by_rows: dict = {}
    for s in saves:
        by_rows.setdefault(s["rows"], []).append(s)
    return {f"rows={k}": {"saves": len(v), "bytes": v[0]["bytes"],
                          "ms": [round(s["s"] * 1e3, 3) for s in v]}
            for k, v in sorted(by_rows.items(), reverse=True)}


def _vectorized_resume_line(result: dict) -> dict:
    run = result["run"]
    return {"epoch0": run["ckpt"]["epoch0"],
            "ref_s": run["ref"]["wall_s"], "interrupted_s": run["crash_s"],
            "resumed_s": run["resumed"]["wall_s"],
            "overhead_s": run["crash_s"] + run["resumed"]["wall_s"]
            - run["ref"]["wall_s"],
            "load_s": run["load_s"], "saves": _saves_line(run["saves"]),
            "checks": result["checks"],
            **{k: result["same"][k] for k in (
                "records_bit_equal", "params_bit_equal", "params_rel_err",
                "params_worst", "mape_rel_err")}}


def phase_resume():
    from distributed_machine_learning_tpu_torch import tune

    t_start = time.monotonic()
    train, val = headline_data()
    card = smi_line()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        headline = _resume_headline(tune, train, val, root)
        emit("resume", sub="a_headline", card=card,
             rows=HEADLINE["num_trials"], epochs=HEADLINE["num_epochs"],
             compactions=headline["compactions"],
             row_epochs=headline["row_epochs"],
             stop_iterations=sorted(
                 t.training_iteration
                 for t in headline["run"]["resumed"]["analysis"].trials),
             **_vectorized_resume_line(headline),
             total_s=time.monotonic() - t0)
        t0 = time.monotonic()
        flash = _resume_flash(tune, train, val, root)
        emit("resume", sub="b_flash", card=card, rows=RESUME_FLASH["trials"],
             epochs=RESUME_FLASH["epochs"],
             cut="8 x 6, from the headline's 50 x 20",
             launches=flash["launches"], post_resume_step=flash["step"],
             **_vectorized_resume_line(flash),
             total_s=time.monotonic() - t0)
        t0 = time.monotonic()
        pbt = _resume_pbt(tune, root)
        emit("resume", sub="c_pbt", card=card, rows=RESUME_PBT["trials"],
             epochs=RESUME_PBT["epochs"], pbt=pbt["pbt"],
             **_vectorized_resume_line(pbt), total_s=time.monotonic() - t0)
        t0 = time.monotonic()
        run = _resume_run(root)
        emit("resume", sub="d_tune_run", card=card,
             trials=RESUME_RUN["trials"], epochs=RESUME_RUN["epochs"],
             slots=RESUME_RUN["slots"], **run,
             total_s=time.monotonic() - t0)
    emit("resume", card=card, total_s=time.monotonic() - t_start)
    return {"flash_group": flash["launches"], "tune_run": run["launches"]}


# -- phase 11 ---------------------------------------------------------------

# (a) examples/training_knobs.py, uncut: its data, space and run arguments.
KNOBS_DATA = dict(num_samples=512, seq_len=24, num_features=8)
KNOBS_SAMPLES, KNOBS_EPOCHS = 8, 10
# (b) the flagship at the train phase's cut (8 rows a micro-step, 8
# micro-steps an epoch, 2 epochs), accumulating 4 micro-steps a step.
KNOBS_ACCUM = 4
KNOBS_TRAIN = dict(TRAIN, accumulate_grad_batches=KNOBS_ACCUM)
# (run name, optimizer, remat policy or False for remat off)
KNOBS_RUNS = (("lamb", "lamb", "dots_saveable"),
              ("adafactor", "adafactor", "dots_saveable"),
              ("lion", "lion", "dots_saveable"),
              ("adam_off", "adam", False),
              ("adam_dots", "adam", "dots_saveable"),
              ("adam_nothing", "adam", "nothing_saveable"),
              ("adam_everything", "adam", "everything_saveable"))
# Remat recomputes the same values: one optimizer step with remat on must
# give remat off's parameters to this share of their largest entry.
REMAT_PARAM_TOL = 1e-6


def _knobs_config(optimizer: str, policy, **extra) -> dict:
    config = dict(KNOBS_TRAIN, optimizer=optimizer, **extra)
    if policy:
        config.update(remat=True, remat_policy=policy)
    return config


def _knobs_sweep(tune, root: str) -> dict:
    """examples/training_knobs.py through the port's ``tune.run`` on the
    card, spelled with only the package name changed."""
    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )
    from distributed_machine_learning_tpu_torch.utils.tensorboard import (
        read_events,
    )

    train, val = dummy_regression_data(**KNOBS_DATA)
    t0 = time.monotonic()
    analysis = tune.run(
        tune.with_parameters(
            tune.train_regressor, train_data=train, val_data=val
        ),
        {
            "model": "transformer",
            "d_model": tune.choice([16, 32]),
            "num_heads": 4,
            "num_kv_heads": tune.choice([1, 2, 4]),
            "num_layers": 2,
            "dim_feedforward": tune.sample_from(
                lambda cfg: cfg["d_model"] * 2
            ),
            "position_encoding": "rope",
            "optimizer": tune.choice(["adamw", "lion"]),
            "learning_rate": tune.loguniform(1e-4, 1e-2),
            "accumulate_grad_batches": 4,
            "num_epochs": KNOBS_EPOCHS,
            "batch_size": 16,
        },
        metric="validation_loss",
        mode="min",
        num_samples=KNOBS_SAMPLES,
        points_to_evaluate=[
            {"d_model": 32, "num_kv_heads": 4, "optimizer": "adamw",
             "learning_rate": 3e-3}
        ],
        stop=tune.TrialPlateauStopper(
            "validation_loss", std=1e-3, num_results=3, grace_period=3
        ),
        scheduler=tune.ASHAScheduler(
            max_t=KNOBS_EPOCHS, grace_period=2, reduction_factor=2
        ),
        callbacks=[tune.TensorBoardCallback()],
        storage_path=root,
        name="training_knobs",
        verbose=0,
    )
    wall_s = time.monotonic() - t0
    trials = analysis.trials
    bad = {t.trial_id: (t.status.value, (t.error or "")[-800:])
           for t in trials if t.status.value != "TERMINATED"}
    if len(trials) != KNOBS_SAMPLES or bad:
        raise AssertionError(f"knobs: {len(trials)} trials, not all "
                             f"TERMINATED: {bad}")
    events = 0
    for t in trials:
        paths = sorted(os.listdir(os.path.join(analysis.root, "tensorboard",
                                               t.trial_id)))
        logged = [(r["step"], sorted(r["scalars"]))
                  for name in paths
                  for r in read_events(os.path.join(
                      analysis.root, "tensorboard", t.trial_id, name))[1:]
                  if r["step"] > 0]
        want = [(r["training_iteration"],
                 sorted(k for k, v in r.items()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool))) for r in t.results]
        if logged != want:
            raise AssertionError(f"knobs: {t.trial_id}'s event run holds "
                                 f"{logged}, its records {want}")
        events += len(logged)
    import torch

    model = analysis.best_model().to("cuda")
    preds = model(torch.from_numpy(val.x[:4]).to("cuda"))
    if tuple(preds.shape) != (4, 1) or not bool(preds.isfinite().all()):
        raise AssertionError(f"knobs: best_model() predicts {preds}")
    return {"wall_s": wall_s, "trials": len(trials), "events": events,
            "stop_iterations": {t.trial_id: [t.config["optimizer"],
                                             t.training_iteration]
                                for t in trials},
            "best_config": {k: analysis.best_config[k] for k in (
                "d_model", "num_kv_heads", "optimizer", "learning_rate")},
            "best_validation_loss": analysis.best_result["validation_loss"]}


def _knobs_run(tune, train, val, config: dict, check: dict | None) -> dict:
    """One flagship ``train_regressor`` run of ``config`` on the card: its
    records, launches, peak memory and optimizer state's bytes; ``check``
    receives :func:`_checking`'s record of every attention call."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    records, ckpts = [], []
    trainable = tune.with_parameters(tune.train_regressor, train_data=train,
                                     val_data=val)
    saved = fa.flash_forward, fa.flash_backward
    if check is not None:
        fa.flash_forward, fa.flash_backward = _checking(check)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counters = _reset_counters()
    try:
        with tune.session.standalone(
                devices=[torch.device("cuda", 0)],
                report_fn=lambda m, c: (records.append(m), ckpts.append(c))):
            t0 = time.monotonic()
            trainable(config)
            wall_s = time.monotonic() - t0
    finally:
        fa.flash_forward, fa.flash_backward = saved
    torch.cuda.synchronize()
    return {"records": records, "opt_state": ckpts[-1]["opt_state"],
            "params": ckpts[-1]["params"], "wall_s": wall_s,
            "launches": {c.name: c.count for c in counters},
            "peak_bytes": torch.cuda.max_memory_allocated() - base}


def _knobs_steps(train, config: dict, micro_steps: int,
                 check: dict | None = None):
    """``micro_steps`` single-batch epochs of ``config`` (the flagship from
    the seeded weights of :func:`_flagship_step_setup`, its dropout drawn
    from one seeded generator) through the port's epoch program and
    ``make_optimizer``: the parameters after each micro-step, the host ms
    of each, and a function that runs one more."""
    import torch

    from distributed_machine_learning_tpu_torch.models.convert import (
        flax_leaf_axes,
    )
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops.losses import mse_loss
    from distributed_machine_learning_tpu_torch.ops.optimizers import (
        make_optimizer,
    )
    from distributed_machine_learning_tpu_torch.tune._regression_program import (
        make_epoch_fn,
    )

    model, x, y = _flagship_step_setup(train, config["compute_dtype"],
                                       config)
    params = dict(model.named_parameters())
    tx = make_optimizer(config["optimizer"], config["learning_rate"],
                        accumulate_grad_batches=config.get(
                            "accumulate_grad_batches", 1),
                        leaf_axes=flax_leaf_axes(params))
    opt = tx.init(params)
    step = make_epoch_fn(model, tx, mse_loss, 8, 1, 8)
    perm = torch.arange(8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = fa.flash_forward, fa.flash_backward
    if check is not None:
        fa.flash_forward, fa.flash_backward = _checking(check)
    after, host_ms = [], []
    try:
        for _ in range(micro_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(opt, x, y, perm, gen))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            after.append({k: p.detach().clone() for k, p in params.items()})
    finally:
        fa.flash_forward, fa.flash_backward = saved
    return after, host_ms, (lambda: float(step(opt, x, y, perm, gen)))


def _max_share(a: dict, b: dict) -> float:
    """max |a - b| over max |b|, across every parameter."""
    top = max(t.abs().max().item() for t in b.values())
    return max((a[k] - b[k]).abs().max().item() for k in b) / top


def phase_knobs():
    import torch

    from distributed_machine_learning_tpu_torch import tune
    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )
    from distributed_machine_learning_tpu_torch.models.flagship import (
        param_opt_bytes,
        tree_nbytes,
    )
    from distributed_machine_learning_tpu_torch.ops.schedules import (
        get_schedule,
    )
    from distributed_machine_learning_tpu_torch.tune._regression_program import (
        stage_data,
    )

    t_start = time.monotonic()
    card = smi_line()
    # (a) the example's sweep.
    with tempfile.TemporaryDirectory() as root:
        sweep = _knobs_sweep(tune, root)
    emit("knobs", sub="a_training_knobs", card=card,
         samples=KNOBS_SAMPLES, epochs=KNOBS_EPOCHS, cut=None, **sweep)

    # (b) the flagship with each optimizer and remat setting.
    train, val = dummy_regression_data(num_samples=TRAIN_ROWS,
                                       seq_len=TRAIN["max_seq_length"],
                                       num_features=FEATURES)
    layers_n = KNOBS_TRAIN["num_layers"]
    epochs = KNOBS_TRAIN["num_epochs"]
    data = stage_data(train, val, KNOBS_TRAIN["batch_size"], torch.bfloat16,
                      torch.device("cpu"))
    micro = data.num_batches * epochs
    evals = layers_n * data.n_val_blocks * epochs
    opt_steps = epochs * (data.num_batches // KNOBS_ACCUM)
    shape = get_schedule(KNOBS_TRAIN["lr_schedule"], learning_rate=1.0,
                         warmup_steps=0, total_steps=opt_steps)
    want_lr = [KNOBS_TRAIN["learning_rate"]
               * shape(min((e + 1) * data.num_batches // KNOBS_ACCUM,
                           opt_steps)) for e in range(epochs)]
    params_bytes = param_opt_bytes(KNOBS_TRAIN, FEATURES, "sgd")
    runs, checks, total = {}, {}, {}
    for name, optimizer, policy in KNOBS_RUNS:
        check = (checks.setdefault(name, {}) if not name.startswith("adam")
                 else None)
        run = _knobs_run(tune, train, val, _knobs_config(optimizer, policy),
                         check)
        launches = run["launches"]
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        fwd_train = launches["flash_fwd"] - evals
        want_fwd = (2 if policy else 1) * layers_n * micro
        if (fwd_train != want_fwd
                or launches["flash_bwd_dkdv"] != layers_n * micro
                or launches["flash_bwd_dq"] != layers_n * micro):
            raise AssertionError(
                f"knobs: {name} launched {launches}; want flash_fwd "
                f"{want_fwd} + {evals} eval and {layers_n * micro} of each "
                f"backward")
        records = run["records"]
        lrs = [r["lr"] for r in records]
        if lrs != want_lr or [r["steps"] for r in records] != [
                data.num_batches * (e + 1) for e in range(epochs)]:
            raise AssertionError(f"knobs: {name} logged lr {lrs} (want "
                                 f"{want_lr}, by optimizer steps)")
        state = tree_nbytes(run["opt_state"])
        priced = param_opt_bytes(KNOBS_TRAIN, FEATURES, optimizer) \
            - params_bytes
        # MultiSteps keeps a running mean of the gradients besides the
        # optimizer's own state.
        if abs(state - (priced + params_bytes)) > 0.01 * state:
            raise AssertionError(f"knobs: {name}'s optimizer state holds "
                                 f"{state} bytes, priced {priced} + "
                                 f"{params_bytes} accumulated")
        if not all(np.isfinite(r["train_loss"]) for r in records):
            raise AssertionError(f"knobs: {name} non-finite loss {records}")
        runs[name] = {
            "optimizer": optimizer, "remat_policy": policy or None,
            # The checked runs' peaks hold the plain versions' buffers too.
            "checked": check is not None,
            "launches": launches, "peak_bytes": run["peak_bytes"],
            "opt_state_bytes": state, "param_opt_bytes_state": priced,
            "accumulator_bytes": params_bytes, "lr": lrs,
            "train_loss": [r["train_loss"] for r in records],
            "epoch_time_s": [r["epoch_time_s"] for r in records],
            "wall_s": run["wall_s"]}
    tol16 = KERNEL_TOL["bfloat16"]
    for name, record in checks.items():
        calls = record.get("calls", 0)
        if calls != layers_n * micro or not max(
                record[n] for n in ("out", "dq", "dk", "dv")) <= tol16:
            raise AssertionError(f"knobs: a bf16 attention call of {name} "
                                 f"off its plain version: {record} (tol "
                                 f"{tol16}, {layers_n * micro} backward "
                                 f"calls)")
    peak = {n: runs[n]["peak_bytes"] for n in runs if n.startswith("adam")}
    if not peak["adam_nothing"] < peak["adam_off"]:
        raise AssertionError(f"knobs: peak memory under nothing_saveable "
                             f"is not below remat off: {peak}")

    # One optimizer step (4 micro-steps), dropout 0.1 on one seed: remat
    # on against off, the parameters still between updates, and each
    # micro-step's host and device ms.
    off, _, _ = _knobs_steps(train, _knobs_config("adam", False,
                                                  dropout=0.1),
                             2 * KNOBS_ACCUM)
    moved = [_max_share(off[i], off[i - 1]) > 0
             for i in range(1, len(off))]
    if moved != [i % KNOBS_ACCUM == KNOBS_ACCUM - 1
                 for i in range(1, len(off))]:
        raise AssertionError(f"knobs: parameters moved at micro-steps "
                             f"{moved}, not every {KNOBS_ACCUM}th")
    remat_err = {}
    for policy in ("dots_saveable", "nothing_saveable",
                   "everything_saveable"):
        on, _, _ = _knobs_steps(train, _knobs_config("adam", policy,
                                                     dropout=0.1),
                                KNOBS_ACCUM)
        remat_err[policy] = _max_share(on[-1], off[KNOBS_ACCUM - 1])
    if not max(remat_err.values()) <= REMAT_PARAM_TOL:
        raise AssertionError(f"knobs: remat-on parameters after one step "
                             f"off remat off's: {remat_err}")
    timing = {}
    for name, optimizer, policy in KNOBS_RUNS:
        _, host_ms, one = _knobs_steps(
            train, _knobs_config(optimizer, policy), KNOBS_ACCUM)
        timing[name] = {"step_host_ms": host_ms,
                        "micro_step_device_ms": device_ms(one, KNOBS_ACCUM)}
    emit("knobs", sub="b_flagship", card=card,
         config={k: KNOBS_TRAIN[k] for k in (
             "d_model", "num_heads", "num_layers", "dim_feedforward",
             "max_seq_length", "compute_dtype", "batch_size",
             "accumulate_grad_batches")},
         micro_steps=micro, optimizer_steps=opt_steps, eval_launches=evals,
         runs=runs, checks=checks, remat_param_rel_err=remat_err,
         timing=timing)

    # (c) one f32 step with remat and adafactor: the three f32 kernels
    # under remat against their plain versions.
    check32 = {}
    counters = _reset_counters()
    config32 = _knobs_config("adafactor", "dots_saveable",
                             compute_dtype="float32",
                             accumulate_grad_batches=1)
    _knobs_steps(train, config32, 1, check=check32)
    launches32 = {c.name: c.count for c in counters}
    tol32 = KERNEL_TOL["float32"]
    if (launches32 != {"flash_fwd": 2 * layers_n,
                       "flash_bwd_dkdv": layers_n, "flash_bwd_dq": layers_n}
            or check32.get("calls") != layers_n
            or not max(check32[n] for n in ("out", "dq", "dk", "dv"))
            <= tol32):
        raise AssertionError(f"knobs: the f32 remat step launched "
                             f"{launches32}, checks {check32} (tol {tol32})")
    emit("knobs", sub="c_f32_step", card=card, launches=launches32,
         checks=check32)
    emit("knobs", card=card, total_s=time.monotonic() - t_start)
    return {"flagship_bf16": total, "f32_step": launches32}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port's smoke test runs on a card",
              file=sys.stderr)
        return 2
    # Plain references run in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build = phase_build()
    timings = {"flash_fwd": phase_kernel(), **phase_kernel_bwd()}
    timings_f32 = phase_kernel_f32(build)
    phase_serve("serve", FLAGSHIP, FLAGSHIP["max_seq_length"],
                n_requests=32, atol=3e-2)
    phase_serve("serve_gqa", GQA_ROPE, 96, n_requests=16, atol=2e-4)
    launches, launches_f32 = phase_train()
    launches_tune = phase_tune()
    flash_population = phase_vectorized()
    launches_pbt = phase_pbt()
    launches_resume = phase_resume()
    launches_knobs = phase_knobs()

    sources = {
        "flash_fwd": ("flash_fwd.cu", "pallas_attention.py:53"),
        "flash_bwd_dkdv": ("flash_bwd.cu", "pallas_attention.py:279"),
        "flash_bwd_dq": ("flash_bwd.cu", "pallas_attention.py:343"),
    }
    f32_build = _f32_build(build)
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timings[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"distributed_machine_learning_tpu_torch/csrc/{source}",
            "replaces": f"distributed_machine_learning_tpu/ops/{replaces}",
            "launches": launches[name],
            # The tune phase's count: the README quickstart's sweep (f32).
            "launches_tune": launches_tune[name],
            # The vectorized phase's flash group (f32, D = 16, S = 96, the
            # population folded into the batch): its sweep, and one
            # population step of 8 rows and of 1.
            "launches_population": {
                "flash_sweep": flash_population["launches"][name],
                **{f"per_step_{k}": v[name] for k, v in
                   flash_population["launches_per_step"].items()}},
            # The pbt phase: the flash PBT population (16 x 12, compiled)
            # and the respawned flash trials of tune.run.
            "launches_pbt": {k: v[name] for k, v in launches_pbt.items()},
            # The resume phase, after each resume: the flash population
            # (8 x 6 from its epoch-2 checkpoint) and the resumed tune.run
            # of the quickstart's widths with flash.
            "launches_resume": {k: v[name]
                                for k, v in launches_resume.items()},
            # The knobs phase: the flagship's seven bf16 runs (lamb,
            # adafactor, lion and adam under remat settings; the forward
            # twice per layer per micro-step under remat), and the one f32
            # remat step with adafactor.
            "launches_knobs": {k: v[name]
                               for k, v in launches_knobs.items()},
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "tflops")},
            "bound_share": t["bound_ms"] / t["ms"],
            # The same function's f32 kernel (on the tensor cores as split
            # bf16), launched by the profiled f32 step; its bound at its
            # own rate (F32_RATE), its share of the f32 CUDA-core bound,
            # and each instantiation's registers, spills and HGMMA count.
            "f32": {"kernel": F32_KERNELS[name][1].rstrip("<,"),
                    "launches_f32_step": launches_f32[name],
                    "build": f32_build[name],
                    **{k: timings_f32[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "tflops", "bound_share",
                        "cuda_core_bound_share")}},
        })
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
