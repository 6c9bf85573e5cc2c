"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip on a machine without one.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

``chip_smoke.py`` drives the same kernel over a larger grid and the whole
serving path at full width.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel_err(got, want):
    """max |err| over max |want|.  Outputs and gradients shrink as S grows,
    so a tolerance is a share of the largest entry, never absolute."""
    want = want.float()
    top = want.abs().max().item()
    return (got.float() - want).abs().max().item() / (top if top > 0 else 1.0)


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 64, 2048), (8, 4, 16, 96),
                                       (8, 1, 128, 200), (4, 2, 256, 70)])
def test_kernel_matches_plain_version(card, dtype, rtol, causal, H, Hkv, D, S):
    gen = torch.Generator().manual_seed(S + D)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(2, S, h, D, generator=gen).to(card, dt)
               for h in (H, Hkv, Hkv))
    before = fa.launches.count
    out, lse = fa.flash_forward(q, k, v, 0.3, causal, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, 0.3, causal)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    assert out.dtype == dt and lse.shape == (2 * H, 1, S)
    assert _rel_err(out, ref_out) <= rtol
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_kernel_reads_strided_inputs(card):
    """q/k/v as views of a fused [B, S, 3, H, D] projection: no copies."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 100, 3, 4, 32, generator=gen).to(card)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = fa.flash_forward(q, k, v)
    ref, _ = fa.flash_attention_reference(q, k, v, 32 ** -0.5, False)
    assert (out - ref).abs().max().item() <= 2e-4


# Relative to the largest entry (_rel_err).  f32: the kernels take each
# product as three bf16 products of split parts (each operand to 2**-16,
# 1e-5 to 4e-5 of the largest entry).  bf16: both
# sides accumulate in f32 and round each entry to bf16 once, so an entry
# differs by at most one bf16 ulp, at most 2**-7 of the largest entry.
@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 64, 512), (8, 4, 16, 96),
                                       (8, 1, 128, 200), (4, 2, 256, 70),
                                       (2, 2, 40, 130)])
def test_backward_kernels_match_plain_version(card, dtype, rtol, causal, H,
                                              Hkv, D, S):
    gen = torch.Generator().manual_seed(S + D + 1)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(2, S, h, D, generator=gen).to(card, dt)
                   for h in (H, Hkv, Hkv, H))
    out, lse = fa.flash_forward(q, k, v, 0.3, causal, with_lse=True)
    before = (fa.dkdv_launches.count, fa.dq_launches.count)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, 0.3, causal)
    ref = fa.flash_attention_backward_reference(
        q, k, v, lse, do, fa.backward_delta(out, do), 0.3, causal)
    torch.cuda.synchronize()
    assert (fa.dkdv_launches.count, fa.dq_launches.count) == (
        before[0] + 1, before[1] + 1)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.dtype == dk.dtype == dv.dtype == dt
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert _rel_err(got, want) <= rtol, name


# bf16 runs the tensor-core (wgmma) forward and dK/dV kernels: ragged S,
# every head-dim bucket, grouped kv and causal masking.  Tolerances as
# above (KERNEL_TOL in chip_smoke.py): the forward carries P as two bf16
# parts and the dK/dV kernel rounds P^T and dS^T to bf16, well within one
# bf16 ulp of the largest entry.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,D,S", [(8, 8, 16, 130), (8, 1, 40, 130),
                                       (8, 8, 64, 130), (8, 1, 64, 1000),
                                       (4, 2, 128, 130), (2, 2, 256, 130)])
def test_bf16_tensor_core_kernels_match_plain_version(card, causal, H, Hkv,
                                                      D, S):
    gen = torch.Generator().manual_seed(S + D + 2)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(2, S, h, D, generator=gen).to(card, bf)
                   for h in (H, Hkv, Hkv, H))
    out, lse = fa.flash_forward(q, k, v, 0.3, causal, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, 0.3, causal)
    delta = fa.backward_delta(out, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, 0.3, causal)
    ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(q, k, v, lse, do, delta,
                                                 0.3, causal)
    dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, 0.3, causal)
    torch.cuda.synchronize()
    assert out.dtype == dk.dtype == dv.dtype == bf
    assert _rel_err(out, ref_out) <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert _rel_err(dk, ref_dk) <= 2e-2 and _rel_err(dv, ref_dv) <= 2e-2
    # No atomics: the same bits on a rerun.
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _stored_transposed(t):
    """The values of ``t`` [B, S, H, D] stored as [B, H, D, S]."""
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


# The tensor-core dQ kernel: every head-dim bucket, ragged S, grouped kv,
# causal masking, D = 33 and inputs stored [B, H, D, S] (both through the
# wrapper's conforming copy).  It rounds dS to bf16 before dS K, within
# KERNEL_TOL (2e-2 of the largest entry) as the dK/dV kernel's rounding of
# dS^T is.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,D,S,layout", [
    (8, 8, 64, 130, "dense"), (8, 1, 64, 1000, "dense"),
    (8, 2, 33, 130, "dense"), (8, 4, 64, 200, "transposed"),
    (4, 2, 128, 130, "dense"), (4, 1, 33, 300, "transposed"),
    (2, 2, 256, 130, "dense")])
def test_bf16_dq_kernel_matches_plain_version(card, causal, H, Hkv, D, S,
                                              layout):
    gen = torch.Generator().manual_seed(S + D + 3)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(2, S, h, D, generator=gen).to(card, bf)
                   for h in (H, Hkv, Hkv, H))
    if layout == "transposed":
        q, k, v, do = (_stored_transposed(x) for x in (q, k, v, do))
        assert q.stride(-1) != 1
    out, lse = fa.flash_forward(q, k, v, 0.3, causal, with_lse=True)
    delta = fa.backward_delta(out, do)
    before = fa.dq_launches.count
    dq = fa.flash_bwd_dq(q, k, v, lse, do, delta, 0.3, causal)
    dq2 = fa.flash_bwd_dq(q, k, v, lse, do, delta, 0.3, causal)
    ref = fa.flash_bwd_dq_reference(q, k, v, lse, do, delta, 0.3, causal)
    torch.cuda.synchronize()
    assert fa.dq_launches.count == before + 2
    assert dq.shape == q.shape and dq.dtype == bf
    assert _rel_err(dq, ref) <= 2e-2
    # No atomics: the same bits on a rerun.
    assert torch.equal(dq, dq2)


# The f32 kernels run on the tensor cores with each operand split into
# bf16 high and low parts: every head-dim bucket, ragged S, grouped kv,
# causal masking, D = 33 and inputs stored [B, H, D, S] (both through the
# wrapper's conforming copy), at the f32 tolerance (2e-4 of the largest
# entry); dK/dV and dQ have no atomics, so a rerun gives the same bits.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,D,S,layout", [
    (8, 8, 64, 130, "dense"), (8, 1, 64, 1000, "dense"),
    (8, 2, 33, 130, "dense"), (8, 4, 64, 200, "transposed"),
    (4, 2, 128, 130, "dense"), (2, 2, 256, 130, "dense")])
def test_f32_tensor_core_kernels_match_plain_version(card, causal, H, Hkv,
                                                     D, S, layout):
    gen = torch.Generator().manual_seed(S + D + 4)
    q, k, v, do = (torch.randn(2, S, h, D, generator=gen).to(card)
                   for h in (H, Hkv, Hkv, H))
    if layout == "transposed":
        q, k, v, do = (_stored_transposed(x) for x in (q, k, v, do))
    before = (fa.launches.count, fa.dkdv_launches.count,
              fa.dq_launches.count)
    out, lse = fa.flash_forward(q, k, v, 0.3, causal, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, 0.3, causal)
    delta = fa.backward_delta(out, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, 0.3, causal)
    dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, lse, do, delta, 0.3, causal)
    ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(q, k, v, lse, do, delta,
                                                 0.3, causal)
    dq = fa.flash_bwd_dq(q, k, v, lse, do, delta, 0.3, causal)
    dq2 = fa.flash_bwd_dq(q, k, v, lse, do, delta, 0.3, causal)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, lse, do, delta, 0.3, causal)
    torch.cuda.synchronize()
    assert (fa.launches.count, fa.dkdv_launches.count,
            fa.dq_launches.count) == (before[0] + 1, before[1] + 2,
                                      before[2] + 2)
    assert out.dtype == dk.dtype == dv.dtype == dq.dtype == torch.float32
    assert dq.shape == q.shape
    assert _rel_err(out, ref_out) <= 2e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert _rel_err(dk, ref_dk) <= 2e-4 and _rel_err(dv, ref_dv) <= 2e-4
    assert _rel_err(dq, ref_dq) <= 2e-4
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq2)


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_kernels_take_batch_times_heads_past_65535(card, dtype, rtol):
    """B*H = 65544 blocks on the grid's x axis, through all three kernels
    (dK/dV at B*Hkv = 32772), against the plain versions."""
    gen = torch.Generator().manual_seed(65544)
    dt = getattr(torch, dtype)
    B, S, H, Hkv, D = 8193, 24, 8, 4, 16
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen).to(card, dt)
                   for h in (H, Hkv, Hkv, H))
    out, lse = fa.flash_forward(q, k, v, None, True, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, D ** -0.5, True)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, None, True)
    ref = fa.flash_attention_backward_reference(
        q, k, v, lse, do, fa.backward_delta(out, do), D ** -0.5, True)
    torch.cuda.synchronize()
    assert _rel_err(out, ref_out) <= rtol
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert _rel_err(got, want) <= rtol, name


def test_bf16_kernels_take_conforming_copies(card):
    """D = 33 and q/k/v stored [B, H, D, S] (D not innermost), with the
    stride-0 dO that .sum().backward() hands in: the wrapper copies and
    pads them for the tensor-core kernels and slices the results back."""
    gen = torch.Generator().manual_seed(11)
    leaf = torch.randn(3, 2, 4, 33, 150, generator=gen).to(card,
                                                           torch.bfloat16)
    split = lambda t: (x.permute(0, 3, 1, 2) for x in t.unbind(0))  # noqa: E731
    qkv = leaf.clone().requires_grad_()
    q, k, v = split(qkv)
    assert q.stride(-1) != 1
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    ref_qkv = leaf.float().clone().requires_grad_()
    rq, rk, rv = split(ref_qkv)
    fa.flash_attention_reference(rq, rk, rv, 33 ** -0.5, True)[0].sum() \
        .backward()
    torch.cuda.synchronize()
    assert qkv.grad.shape == leaf.shape
    assert _rel_err(qkv.grad, ref_qkv.grad) <= 2e-2


def test_tensor_core_kernels_run_hgmma(card):
    """Every kernel (bf16 forward, dK/dV and dQ; the same three in f32
    as split bf16) is a tensor-core kernel and compiles to Hopper's
    warpgroup MMA (HGMMA in the SASS), where the toolkit has cuobjdump to
    show it: no library holds a CUDA-core kernel."""
    from distributed_machine_learning_tpu_torch.ops import _build

    fa.build_kernels()
    expected = {
        fa.KERNEL_NAME: {"flash_fwd_kernel_wgmma",
                         "flash_fwd_kernel_wgmma_f32"},
        fa.BACKWARD_SOURCE: {"flash_bwd_dkdv_kernel_wgmma",
                             "flash_bwd_dq_kernel_wgmma",
                             "flash_bwd_dkdv_kernel_wgmma_f32",
                             "flash_bwd_dq_kernel_wgmma_f32"},
    }
    for name in (fa.KERNEL_NAME, fa.BACKWARD_SOURCE):
        counts = _build.sass_counts(name)
        if counts is None:
            pytest.skip("the toolkit has no cuobjdump")
        assert counts and all(c["HGMMA"] > 0 for c in counts.values())
        assert {k.split("<")[0] for k in counts} == expected[name]


@pytest.mark.parametrize("layout", ["fused_qkv", "heads_first"])
def test_autograd_runs_the_backward_kernels(card, layout):
    """loss.backward() through flash_attention on the card: a stride-0
    dO (from .sum()) and q/k/v read in place from a fused [B, S, 3, H, D]
    projection or from dense [B, H, S, D] tensors seen as [B, S, H, D]."""
    gen = torch.Generator().manual_seed(7)
    if layout == "fused_qkv":
        leaf = torch.randn(2, 150, 3, 4, 32, generator=gen).to(card)
        split = lambda t: t.unbind(2)  # noqa: E731
    else:
        leaf = torch.randn(3, 2, 4, 150, 32, generator=gen).to(card)
        split = lambda t: (x.transpose(1, 2) for x in t.unbind(0))  # noqa: E731
    qkv = leaf.clone().requires_grad_()
    before = (fa.dkdv_launches.count, fa.dq_launches.count)
    fa.flash_attention(*split(qkv), causal=True).sum().backward()
    torch.cuda.synchronize()
    assert (fa.dkdv_launches.count, fa.dq_launches.count) == (
        before[0] + 1, before[1] + 1)
    ref_qkv = leaf.clone().requires_grad_()
    rq, rk, rv = split(ref_qkv)
    fa.flash_attention_reference(rq, rk, rv, 32 ** -0.5, True)[0].sum() \
        .backward()
    assert _rel_err(qkv.grad, ref_qkv.grad) <= 2e-4


def test_engine_serves_on_the_card(card, tmp_path):
    from distributed_machine_learning_tpu_torch.models import build_model
    from distributed_machine_learning_tpu_torch.models.convert import (
        to_flax_params,
    )
    from distributed_machine_learning_tpu_torch.serve import (
        InferenceEngine,
        load_bundle,
        write_bundle,
    )

    config = {"model": "transformer", "d_model": 64, "num_heads": 4,
              "num_layers": 2, "attention_type": "flash", "dropout": 0.0,
              "compute_dtype": "bfloat16", "max_seq_length": 128}
    torch.manual_seed(0)
    model = build_model(config, 16)
    write_bundle(str(tmp_path), {"bundle_version": 1, "config": config},
                 {"params": to_flax_params(model.state_dict())})
    engine = InferenceEngine(load_bundle(str(tmp_path)), max_bucket=4,
                             device=card)
    x = np.random.default_rng(0).normal(size=(3, 128, 16)).astype(np.float32)
    before = fa.launches.count
    out = engine.predict(x)
    assert fa.launches.count - before == config["num_layers"]
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).float().numpy()  # CPU, plain
    np.testing.assert_allclose(out, ref, atol=3e-2)


def test_train_regressor_runs_on_the_card(card):
    """A small flash transformer trains on the card: every step's backward
    runs both kernels once per layer, and the losses are finite."""
    from distributed_machine_learning_tpu_torch import tune
    from distributed_machine_learning_tpu_torch.data import (
        dummy_regression_data,
    )

    config = {"model": "transformer", "d_model": 64, "num_heads": 4,
              "num_layers": 2, "attention_type": "flash", "dropout": 0.1,
              "compute_dtype": "bfloat16", "max_seq_length": 128,
              "learning_rate": 1e-3, "num_epochs": 2, "batch_size": 8}
    train, val = dummy_regression_data(num_samples=40, seq_len=128,
                                       num_features=16)
    records = []
    counters = (fa.launches, fa.dkdv_launches, fa.dq_launches)
    before = [c.count for c in counters]
    with tune.session.standalone(devices=[card],
                                 report_fn=lambda m, c: records.append(m)):
        tune.train_regressor(config, train_data=train, val_data=val)
    fwd, dkdv, dq = (c.count - b for c, b in zip(counters, before))
    steps = records[-1]["steps"]  # 32 rows / batch 8 = 4 steps an epoch
    assert steps == 8 and dkdv == dq == 2 * steps
    assert fwd == 2 * (steps + 2)  # + one 8-row eval block per epoch
    assert all(np.isfinite(r["train_loss"]) for r in records)
    assert records[-1]["device_bytes_in_use"] > 0

