#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one output line each (a failed phase raises and the script exits
nonzero; nothing is caught and passed over):

1. build  — the card's name and power limit; every CUDA kernel compiled
   from the sources in the checkout (one nvcc per source, all at once).
2. kernel — each kernel held against its plain PyTorch version on the card
   over a grid of dtypes, causal flags, grouped-kv layouts, head dims,
   sequence lengths and scales; then timed at the serving shape beside its
   plain version and the PyTorch library call that computes the same
   function.
3. serve  — the bench flagship transformer (d_model 512, 8 heads, 4
   layers, seq 2048, bf16, flash attention) written as a bundle with
   seeded weights, loaded back and served over HTTP by the port's
   PredictionServer; ~32 concurrent /predict requests, each answer held
   against the plain-PyTorch forward with the same weights, and the
   kernel's launch counter read around the run.
4. serve_gqa — the same for the GQA + RoPE transformer (8 q heads, 4 kv
   heads) at a cut depth, in f32.

The last lines are the card's name and power limit, a JSON object of
per-kernel measurements, and ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense FLOP/s
# per input type (bf16 on the tensor cores, f32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

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


# -- phase 1 ----------------------------------------------------------------


def phase_build():
    from distributed_machine_learning_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    seconds = _build.build(names)
    ptxas = {
        name: [line.strip() for line in _build.build_log(name).splitlines()
               if "registers" in line or "spill" in line]
        for name in names
    }
    emit("build", card=smi_line(), kernels=names, seconds=seconds,
         ptxas=ptxas)


# -- phase 2 ----------------------------------------------------------------


def _qkv(B, S, H, Hkv, D, dtype, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    mk = lambda h: torch.randn(B, S, h, D, generator=gen).to("cuda", dtype)
    return mk(H), mk(Hkv), mk(Hkv)


def _compare(q, k, v, scale, causal):
    """max |err| of the kernel's (out, lse) against the plain version."""
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
    return err_o, err_l


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from distributed_machine_learning_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        flash_forward,
    )

    tol_out = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    tol_lse = 1e-3
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for H, Hkv in ((8, 8), (8, 4), (8, 1)):
                for D in (16, 64, 128):
                    for S in (96, 2048):
                        cases.append((dtype, causal, H, Hkv, D, S, None))
            # A non-default scale, odd head dims and the largest head dim.
            cases.append((dtype, causal, 8, 4, 64, 96, 0.37))
            cases.append((dtype, causal, 8, 2, 40, 130, 0.2))
            cases.append((dtype, causal, 4, 4, 256, 200, None))
    worst = {"out": 0.0, "lse": 0.0}
    for i, (dtype, causal, H, Hkv, D, S, scale) in enumerate(cases):
        B = 2 if S >= 1024 else 3
        q, k, v = _qkv(B, S, H, Hkv, D, dtype, seed=i)
        err_o, err_l = _compare(q, k, v, scale, causal)
        if err_o > tol_out[dtype] or err_l > tol_lse:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version: dtype={dtype} "
                f"causal={causal} H={H} Hkv={Hkv} D={D} S={S} scale={scale}: "
                f"|out err| {err_o} (tol {tol_out[dtype]}), |lse err| {err_l}"
            )
        worst["out"] = max(worst["out"], err_o)
        worst["lse"] = max(worst["lse"], err_l)

    # The serving shape: one layer's attention at the flagship bucket.
    B, S, H, D = 8, FLAGSHIP["max_seq_length"], FLAGSHIP["num_heads"], 64
    dtype = torch.bfloat16
    q, k, v = _qkv(B, S, H, H, D, dtype, seed=1234)
    err_o, _ = _compare(q, k, v, None, False)
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
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    timing = {
        "shape": [B, S, H, D], "dtype": "bfloat16", "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "max_abs_err": err_o, "gflop": flops / 1e9,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }
    emit("kernel", card=torch.cuda.get_device_name(0), cases=len(cases),
         max_err_out=worst["out"], max_err_lse=worst["lse"],
         kernels=["flash_fwd"], **timing)
    return timing


# -- phases 3 and 4 -----------------------------------------------------------


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

    counter = flash_attention.launches
    counter.reset()
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
    launches = counter.count
    forwards = metrics["compile"]["per_replica"][0]["forwards"]
    layers_n = config["num_layers"]
    if launches < layers_n * forwards:
        raise AssertionError(
            f"{name}: flash_fwd launched {launches} times for {forwards} "
            f"bucket forwards of {layers_n} layers"
        )

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port's smoke test runs on a card",
              file=sys.stderr)
        return 2
    # Plain references run in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    timing = phase_kernel()
    launches = phase_serve("serve", FLAGSHIP, FLAGSHIP["max_seq_length"],
                           n_requests=32, atol=3e-2)
    phase_serve("serve_gqa", GQA_ROPE, 96, n_requests=16, atol=2e-4)

    print(smi_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "distributed_machine_learning_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "distributed_machine_learning_tpu/ops/pallas_attention.py:53",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
