#!/usr/bin/env python3
"""Variants of the port's flash kernels on one NVIDIA GPU: what each tile,
precision and loading choice costs, and how it moves a training step.

    python3 chip_flash_study.py      # from the repository root; one card

The sources in ``distributed_machine_learning_tpu_torch/csrc/`` are the
baseline ("shipped").  Each variant is the same sources with a few text
edits (a tile, a launch bound, the ring depth, the forward's split of P,
the dQ kernel's split of dS, the always-on mask and ``exp2f``; for the
f32 split-precision kernels, ``f32_*``: the f32 staging tile against
splitting straight from global memory, the blocks per SM, the q or kv
tile and three parts instead of two), built with nvcc into
``_build/study/`` and swapped in under the port's wrappers.  Every
variant is held against the plain PyTorch version at KERNEL_TOL of its
dtype, timed in turns with the others of its kind at the flagship shape
(B=8, S=2048, H=8, D=64, bf16 or f32; ``f32_dq_d256_*`` at D = 256, the
head dim whose tile they change), and read on one
flagship training step of its dtype (chip_smoke.py's ``_step_grads``, per
parameter against the plain step; f32 variants must stay within
STEP_TOL["float32"]).  Forward variants
are also held against the plain bf16 and f32 forwards on that step's own
attention inputs.  A last part mixes kernel, plain and rounded-plain
attention in the step, to show which rounding point moves it.

One JSON line per measurement, then the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import chip_smoke as cs

# {name: (source, {file in csrc/: [(old, new), ...]})}.
_P_ROUNDED = ("        Wgmma<NCH>::rs(o, a_lo[kk], dv);\n", "")
_FWD_D64 = "return launch_wgmma<64, 64, 2>("
_ONE_BLOCK = ("__launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)",
              "__launch_bounds__(128 * NWG, 1)")
_MASK_ALWAYS = ("if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * wg))",
                "if (true)")
_FWD_EXP2F = [("fast_exp2(s[", "exp2f(s["),
              ("corr[r] = fast_exp2(", "corr[r] = exp2f(")]
_STAGES3 = {"hopper.cuh": [("constexpr int STAGES = 2;",
                            "constexpr int STAGES = 3;")]}


_DQ_ONE_BLOCK = ("__launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)\n"
                 "    flash_bwd_dq_kernel_wgmma(",
                 "__launch_bounds__(128 * NWG, 1)\n"
                 "    flash_bwd_dq_kernel_wgmma(")
_DQ_BK64 = ("return launch_dq_wgmma<64, 32, 2>(a, st);",
            "return launch_dq_wgmma<64, 64, 2>(a, st);")


def _fwd_tile(bk: int):
    return (_FWD_D64, f"return launch_wgmma<64, {bk}, 2>(")


# A 128-column kv tile needs ~184 registers a thread (one block per SM);
# under the two-block launch bound it spills.
_BK128 = [_fwd_tile(128), _ONE_BLOCK]


# f32: the K/V tiles split straight from global memory each step (plain
# loads, latency exposed) instead of landing by cp.async in the staging
# tile while the previous tile computes; the lines of the forward's and
# the dQ kernel's K/V staging, in flash_fwd.cu or flash_bwd.cu.
_F32_UNSTAGED = [
    ("  stage_kv(0);\n", ""),
    ("    if (t + 1 < n_kv) stage_kv(t + 1);\n", ""),
    ("    split_tile_staged<DMAX, BK, NT>(sK, sKf, tid);\n"
     "    split_tile_staged<DMAX, BK, NT>(sV, sVf, tid);\n",
     "    split_tile_global<DMAX, BK, NT>(sK, kb, ks.s, t * BK, S, D, tid);"
     "\n"
     "    split_tile_global<DMAX, BK, NT>(sV, vb, vs.s, t * BK, S, D, tid);"
     "\n")]
# f32: each operand as three bf16 parts and each product as the six part
# products Ai Bj with i + j < 3 (about 2^-24 per operand); the forward's
# tiles then take 129 KB, one block per SM.
_F32_THREE_PARTS = ("constexpr int kSplitParts = 2;",
                    "constexpr int kSplitParts = 3;")
_F32_FWD_ONE_BLOCK = ("__launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)\n"
                      "    flash_fwd_kernel_wgmma_f32",
                      "__launch_bounds__(128 * NWG, 1)\n"
                      "    flash_fwd_kernel_wgmma_f32")
_F32_DQ_ONE_BLOCK = ("__launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)\n"
                     "    flash_bwd_dq_kernel_wgmma_f32(",
                     "__launch_bounds__(128 * NWG, 1)\n"
                     "    flash_bwd_dq_kernel_wgmma_f32(")
# The f32 dQ without its staging tiles: their shared memory dropped too,
# so that a 32-column kv tile fits at D = 256.
_F32_DQ_UNSTAGED = [*_F32_UNSTAGED, ("(size_t)8 * BK * DMAX + 1024;", "1024;")]


def _f32_dq_tile(dmax: int, old: str, new: str):
    return (f"return launch_dq_wgmma_f32<{dmax}, {old}>(a, st);",
            f"return launch_dq_wgmma_f32<{dmax}, {new}>(a, st);")



VARIANTS = {
    "fwd_shipped": ("flash_fwd", {}),
    "fwd_p_rounded": ("flash_fwd", {"flash_fwd.cu": [_P_ROUNDED]}),
    "fwd_p_rounded_bk128": ("flash_fwd", {"flash_fwd.cu": [
        _P_ROUNDED, *_BK128]}),
    "fwd_p_rounded_bk128_masked_exp2f": ("flash_fwd", {"flash_fwd.cu": [
        _P_ROUNDED, *_BK128, _MASK_ALWAYS, *_FWD_EXP2F]}),
    "fwd_bk128": ("flash_fwd", {"flash_fwd.cu": _BK128}),
    "fwd_bk32": ("flash_fwd", {"flash_fwd.cu": [_fwd_tile(32)]}),
    "fwd_one_block_per_sm": ("flash_fwd", {"flash_fwd.cu": [_ONE_BLOCK]}),
    "fwd_stages3": ("flash_fwd", _STAGES3),
    "dkdv_shipped": ("flash_bwd", {}),
    "dkdv_masked_exp2f": ("flash_bwd", {"flash_bwd.cu": [
        ("hopper::fast_exp2(sT", "exp2f(sT"),
        ("if (qt0 + BQ > S || (causal && k0 + 64 * kv_sub + 63 > qt0))",
         "if (true)")]}),
    "dkdv_bq32": ("flash_bwd", {"flash_bwd.cu": [
        ("return launch_dkdv_wgmma<64, 64, 1>(a, st);",
         "return launch_dkdv_wgmma<64, 32, 1>(a, st);")]}),
    "dkdv_stages3": ("flash_bwd", _STAGES3),
    "dq_shipped": ("flash_bwd", {}),
    # dS carried into dS K as a bf16 high and low part, as the forward
    # carries P: two register-A wgmmas per kv tile.
    "dq_ds_split": ("flash_bwd", {"flash_bwd.cu": [
        ("    uint32_t ads[BK / 16][4];\n    to_a_fragments<BK>(dp, ads);\n",
         "    uint32_t ads[BK / 16][4], ads_lo[BK / 16][4];\n"
         "    to_a_fragments<BK>(dp, ads);\n"
         "    low_fragments<BK>(dp, ads, ads_lo);\n"),
        ("        Wgmma<NCH>::rs(o, ads[kk], dk);\n",
         "        Wgmma<NCH>::rs(o, ads[kk], dk);\n"
         "        Wgmma<NCH>::rs(o, ads_lo[kk], dk);\n")]}),
    # The first design: one block an SM and a 64-column kv tile at D <= 64
    # (159 registers); and two blocks with the 64-column tile (it spills
    # under the 128-register bound).
    "dq_one_block_bk64": ("flash_bwd", {"flash_bwd.cu": [
        _DQ_ONE_BLOCK, _DQ_BK64]}),
    "dq_two_blocks_bk64": ("flash_bwd", {"flash_bwd.cu": [_DQ_BK64]}),
    "f32_fwd_shipped": ("flash_fwd", {}),
    "f32_fwd_unstaged": ("flash_fwd", {"flash_fwd.cu": _F32_UNSTAGED}),
    "f32_fwd_one_block_per_sm": ("flash_fwd", {"flash_fwd.cu": [
        _F32_FWD_ONE_BLOCK]}),
    "f32_fwd_three_parts": ("flash_fwd", {
        "hopper.cuh": [_F32_THREE_PARTS],
        "flash_fwd.cu": [_F32_FWD_ONE_BLOCK]}),
    "f32_dkdv_shipped": ("flash_bwd", {}),
    "f32_dkdv_bq32": ("flash_bwd", {"flash_bwd.cu": [
        ("return launch_dkdv_wgmma_f32<64, 64, 1>(a, st);",
         "return launch_dkdv_wgmma_f32<64, 32, 1>(a, st);")]}),
    "f32_dkdv_three_parts": ("flash_bwd", {"hopper.cuh": [_F32_THREE_PARTS]}),
    "f32_dq_shipped": ("flash_bwd", {}),
    # One block an SM with a 64-column kv tile (129 KB), as the bf16 dQ's
    # first design.
    "f32_dq_one_block_bk64": ("flash_bwd", {"flash_bwd.cu": [
        _F32_DQ_ONE_BLOCK, _f32_dq_tile(64, "32, 2", "64, 2")]}),
    "f32_dq_unstaged": ("flash_bwd", {"flash_bwd.cu": _F32_DQ_UNSTAGED}),
    "f32_dq_three_parts": ("flash_bwd", {
        "hopper.cuh": [_F32_THREE_PARTS],
        "flash_bwd.cu": [_F32_DQ_ONE_BLOCK]}),
    # D = 256: the shipped 16-column kv tile with staging, against a
    # 32-column tile split straight from global memory (both 193 KB).
    "f32_dq_d256_shipped": ("flash_bwd", {}),
    "f32_dq_d256_unstaged_bk32": ("flash_bwd", {"flash_bwd.cu": [
        *_F32_DQ_UNSTAGED, _f32_dq_tile(256, "16, 1", "32, 1")]}),
}


def _kind(name: str):
    """(kernel kind "fwd", "dkdv" or "dq", dtype) of a variant."""
    f32 = name.startswith("f32_")
    return (name.removeprefix("f32_").split("_")[0],
            "float32" if f32 else "bfloat16")


def _head_dim(name: str) -> int:
    """The head dim a variant is checked and timed at."""
    return 256 if "_d256_" in name else 64


def build_variants() -> dict:
    """{variant: loaded library}, all nvcc processes at once."""
    from distributed_machine_learning_tpu_torch.ops import _build

    root = _build.BUILD_DIR / "study"
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        for path in _build.CSRC_DIR.iterdir():
            text = path.read_text()
            for old, new in edits.get(path.name, ()):
                if old not in text:
                    raise AssertionError(f"{name}: {old!r} not in {path.name}")
                text = text.replace(old, new)
            (out / path.name).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{source}.so"), str(out / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"{name}: nvcc failed\n{stderr[-3000:]}")
        ptxas = {k: v for k, v in cs._ptxas_by_kernel(stdout + stderr).items()
                 if f"<{_head_dim(name)}," in k and "_wgmma" in k}
        cs.emit("study_build", variant=name, ptxas=ptxas)
        source = VARIANTS[name][0]
        libs[name] = ctypes.CDLL(str(root / name / f"lib{source}.so"))
    return libs


class Swapped:
    """The port's wrappers launch ``lib`` for ``source`` inside the block."""

    def __init__(self, source: str, lib):
        from distributed_machine_learning_tpu_torch.ops import _build

        self._loaded, self.source, self.lib = _build._loaded, source, lib

    def __enter__(self):
        self.saved = self._loaded[self.source]
        self._loaded[self.source] = self.lib

    def __exit__(self, *exc):
        self._loaded[self.source] = self.saved


def _check(name: str) -> float:
    """The variant against the plain version at KERNEL_TOL of its dtype on
    the flagship shape, causal, and a ragged grouped-kv shape, at its head
    dim."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    kind, dtype = _kind(name)
    D = _head_dim(name)
    worst = 0.0
    for B, S, H, Hkv, causal in ((8, 2048, 8, 8, False), (2, 2048, 8, 8, True),
                                 (2, 130, 8, 1, True)):
        q, k, v, do, lse, delta = cs._bwd_inputs(B, S, H, Hkv, D,
                                                 getattr(torch, dtype), None,
                                                 causal, S + H)
        s = D ** -0.5
        if kind == "fwd":
            got = fa.flash_forward(q, k, v, s, causal)
            want = fa.flash_attention_reference(q, k, v, s, causal)[0]
            errs = [cs._rel_err(got, want)]
        elif kind == "dq":
            got = fa.flash_bwd_dq(q, k, v, lse, do, delta, s, causal)
            want = fa.flash_bwd_dq_reference(q, k, v, lse, do, delta, s,
                                             causal)
            errs = [cs._rel_err(got, want)]
        else:
            got = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, s, causal)
            want = fa.flash_bwd_dkdv_reference(q, k, v, lse, do, delta, s,
                                               causal)
            errs = [cs._rel_err(g, w) for g, w in zip(got, want)]
        torch.cuda.synchronize()
        worst = max(worst, *errs)
    if not worst <= cs.KERNEL_TOL[dtype]:
        raise AssertionError(f"{name} off its plain version: {worst}")
    return worst


def _timings(libs: dict) -> dict:
    """Each variant's ms at the flagship shape in its dtype and head dim,
    in turns (forward, dK/dV and dQ variants each with their own kind)."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    B, S, H = 8, 2048, 8
    calls = {}
    for dtype, D in {(_kind(n)[1], _head_dim(n)) for n in libs}:
        q, k, v, do, lse, delta = cs._bwd_inputs(
            B, S, H, H, D, getattr(torch, dtype), None, False, 4321)
        args = (q, k, v, lse, do, delta, D ** -0.5, False)
        calls[dtype, D] = {
            "fwd": lambda q=q, k=k, v=v: fa.flash_forward(q, k, v),
            "dkdv": lambda args=args: fa.flash_bwd_dkdv(*args),
            "dq": lambda args=args: fa.flash_bwd_dq(*args),
        }
    times = {name: [] for name in libs}
    names = list(libs)
    for order in (names, names[::-1], names):
        for name in order:
            kind, dtype = _kind(name)
            with Swapped(VARIANTS[name][0], libs[name]):
                times[name].append(cs.cuda_ms(
                    calls[dtype, _head_dim(name)][kind], iters=30))
    return times


def _rounded_forward(q, k, v, scale, causal):
    """The plain forward with P (max-shifted, unnormalised) rounded to
    bf16 before P V, as the kernel does without the split."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    B, S, H, Hkv, D = fa._check_shapes(q, k, v)
    g = H // Hkv
    qf = q.float().reshape(B, S, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(),
                       v.float()) / den.permute(0, 3, 1, 2, 4)
    return (out.reshape(B, S, H, D).to(q.dtype),
            (m + torch.log(den)).reshape(B * H, 1, S))


def _rounded_backward(q, k, v, lse, do, delta, scale, causal):
    """The plain backward with P^T and dS^T rounded to bf16 before the
    dV and dK products, and dS before the dQ product, where the dK/dV and
    dQ kernels round them."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    qf, kf, dof, p, ds = fa._recompute_reference(q, k, v, lse, do, delta,
                                                 scale, causal)
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    dv = torch.einsum("bhgqk,bqhgd->bkhd", r(p), dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", r(ds), qf)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", r(ds), kf).reshape(q.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mixed(fwd: str, bwd: str):
    """flash_attention with the forward and the backward each taken from
    the kernels, the plain versions or the rounded plain versions."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    forwards = {
        "kernel": lambda q, k, v, s, c: fa.flash_forward(q, k, v, s, c,
                                                         with_lse=True),
        "plain": fa.flash_attention_reference,
        "rounded": _rounded_forward,
    }

    def kernel_backward(q, k, v, lse, do, delta, s, c):
        dk, dv = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, s, c)
        return fa.flash_bwd_dq(q, k, v, lse, do, delta, s, c), dk, dv

    backwards = {"kernel": kernel_backward,
                 "plain": fa.flash_attention_backward_reference,
                 "rounded": _rounded_backward}

    class Mixed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale, causal):
            s = q.shape[-1] ** -0.5 if scale is None else scale
            out, lse = forwards[fwd](q, k, v, s, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (s, causal)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            s, causal = ctx.args
            grads = backwards[bwd](q, k, v, lse, do, fa.backward_delta(out, do),
                                   s, causal)
            return (*grads, None, None)

    return lambda q, k, v, scale=None, causal=False: Mixed.apply(
        q, k, v, scale, causal)


def _step_reading(train, plain, attention=None,
                  dtype: str = "bfloat16") -> dict:
    """One flagship step in ``dtype`` against the plain step ``plain``
    (_grad_err)."""
    from distributed_machine_learning_tpu_torch.models import layers

    saved = layers.flash_attention
    if attention is not None:
        layers.flash_attention = attention
    try:
        grads = cs._step_grads(train, dtype)
    finally:
        layers.flash_attention = saved
    err = cs._grad_err(grads, plain)
    return {k: err[k] for k in ("worst", "param", "whole")}


def _captured_inputs(train) -> list:
    """(q, k, v, scale, causal) of every attention call of one step."""
    from distributed_machine_learning_tpu_torch.models import layers
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    calls = []

    def capture(q, k, v, scale=None, causal=False):
        calls.append((q.detach().clone(), k.detach().clone(),
                      v.detach().clone(), scale, causal))
        return fa.flash_attention(q, k, v, scale, causal)

    saved = layers.flash_attention
    layers.flash_attention = capture
    try:
        cs._step_grads(train, "bfloat16")
    finally:
        layers.flash_attention = saved
    return calls


def _per_call(calls, forward) -> dict:
    """``forward(q, k, v, scale, causal)`` on the step's own inputs
    against the plain bf16 and f32 forwards: the largest
    ||out - ref|| / ||ref|| over the calls."""
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    fro = lambda a, b: ((a.float() - b.float()).norm()  # noqa: E731
                        / b.float().norm()).item()
    worst = {"fro_vs_plain_bf16": 0.0, "fro_vs_f32": 0.0}
    for q, k, v, scale, causal in calls:
        s = q.shape[-1] ** -0.5 if scale is None else scale
        out = forward(q, k, v, s, causal)
        ref16 = fa.flash_attention_reference(q, k, v, s, causal)[0]
        ref32 = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             s, causal)[0]
        worst["fro_vs_plain_bf16"] = max(worst["fro_vs_plain_bf16"],
                                         fro(out, ref16))
        worst["fro_vs_f32"] = max(worst["fro_vs_f32"], fro(out, ref32))
    return worst


def main() -> int:
    import torch

    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("error: the study runs on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.build_kernels()
    libs = build_variants()
    for name, lib in libs.items():
        with Swapped(VARIANTS[name][0], lib):
            cs.emit("study_check", variant=name, max_rel_err=_check(name))
    times = _timings(libs)

    train, _ = dummy_regression_data(num_samples=cs.TRAIN_ROWS,
                                     seq_len=cs.TRAIN["max_seq_length"],
                                     num_features=cs.FEATURES)
    plain16 = cs._step_grads(train, "bfloat16", plain=True)
    plain32 = cs._step_grads(train, "float32", plain=True)
    err = cs._grad_err(plain16, plain32)
    worst = plain16[err["param"]]
    cs.emit("study_step", run="plain_bf16_vs_f32",
            **{k: err[k] for k in ("worst", "param", "whole")},
            param_entries=worst.numel(),
            param_zero_entries=int((worst == 0).sum()))
    calls = _captured_inputs(train)
    kernel = lambda q, k, v, s, c: fa.flash_forward(q, k, v, s, c)  # noqa: E731
    for name, forward in (
            ("plain_bf16", lambda *a: fa.flash_attention_reference(*a)[0]),
            ("rounded", lambda *a: _rounded_forward(*a)[0])):
        cs.emit("study_per_call", forward=name, **_per_call(calls, forward))
    for name, lib in libs.items():
        source = VARIANTS[name][0]
        kind, dtype = _kind(name)
        with Swapped(source, lib):
            if dtype == "float32":
                step = _step_reading(train, plain32, dtype=dtype)
                if not step["worst"] <= cs.STEP_TOL[dtype]:
                    raise AssertionError(f"{name}: f32 step {step} (tol "
                                         f"{cs.STEP_TOL[dtype]})")
                extra = {}
            else:
                step = _step_reading(train, plain16)
                extra = _per_call(calls, kernel) if kind == "fwd" else {}
            cs.emit("study_variant", variant=name, ms=times[name],
                    step=step, **extra)
    for fwd, bwd in (("kernel", "plain"), ("plain", "kernel"),
                     ("rounded", "plain"), ("plain", "rounded")):
        cs.emit("study_step", run=f"forward_{fwd}+backward_{bwd}",
                **_step_reading(train, plain16, _mixed(fwd, bwd)))
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
