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

The last lines are the card's name and power limit, a JSON object of
per-kernel measurements, and ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import json
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


def _flagship_step_setup(train, compute_dtype: str = "bfloat16"):
    """The flagship model with seeded weights (the same for every compute
    dtype: parameters are f32) and one 8-row batch."""
    import torch

    from distributed_machine_learning_tpu_torch.models import (
        build_model,
        compute_dtype_of,
        init_parameters,
    )

    config = dict(TRAIN, compute_dtype=compute_dtype)
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
