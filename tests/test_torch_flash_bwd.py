"""The port's flash-attention backward against the JAX package's Pallas
backward kernels.

On the CPU the port's wrapper takes its plain backward
(``flash_attention_backward_reference``); the JAX gradients come from
``jax.vjp`` of ``flash_attention(..., interpret=True)``, which runs the
Pallas ``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel`` in interpret mode, as
tests/test_pallas_attention.py runs them.  Same numpy inputs and cotangent
into both; f32 agrees to 2e-5.  The CUDA kernels are held against the
same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from distributed_machine_learning_tpu.ops.pallas_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from distributed_machine_learning_tpu_torch.ops import flash_attention as port  # noqa: E402

# Shapes and cases of tests/test_torch_flash.py.
B, S, H, D = 1, 32, 2, 8
BQ = BK = 16

CASES = {
    "f32": dict(),
    "f32_causal": dict(causal=True),
    "gqa": dict(H=4, Hkv=2),
    "mqa_causal": dict(H=4, Hkv=1, causal=True),
    "custom_scale": dict(scale=0.21),
    "seq_not_multiple_of_block": dict(S=40, causal=True),
    "batch2": dict(B=2, H=4, Hkv=2),
}


def _inputs(seed, S=S, H=H, Hkv=H, D=D, B=B):
    """q, k, v and a cotangent dO, from one numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D))
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def _case(name):
    case = dict(CASES[name])
    return case.pop("causal", False), case.pop("scale", None), case


def _port_grads(q, k, v, do, scale, causal, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = port.flash_attention(tq, tk, tv, scale=scale, causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_pallas_kernels(name):
    causal, scale, shape = _case(name)
    q, k, v, do = _inputs(11, **shape)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(
            a, b, c, scale=scale, causal=causal, block_q=BQ, block_k=BK,
            interpret=True,
        ),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = vjp(jnp.asarray(do))
    got = _port_grads(q, k, v, do, scale, causal)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=label)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd_in_f64(name):
    """The plain backward (from the saved lse) against torch.autograd
    through the plain forward, both in float64."""
    causal, scale, shape = _case(name)
    q, k, v, do = _inputs(12, **shape)
    s = q.shape[-1] ** -0.5 if scale is None else scale
    got = _port_grads(q, k, v, do, scale, causal, dtype=torch.float64)
    tq, tk, tv = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    out, _ = port.flash_attention_reference(tq, tk, tv, s, causal)
    want = torch.autograd.grad(out, (tq, tk, tv),
                               torch.from_numpy(do).double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_bf16_matches_pallas_kernels(causal):
    """bf16 inputs: both sides recompute in f32 and round each gradient to
    bf16 once, so they sit within a few bf16 ulps of the gradient's size."""
    q, k, v, do = _inputs(13, H=4, Hkv=2)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(
            a, b, c, causal=causal, block_q=BQ, block_k=BK, interpret=True),
        bf(q), bf(k), bf(v),
    )
    want = vjp(bf(do))
    got = _port_grads(*(np.asarray(bf(a), np.float32) for a in (q, k, v, do)),
                      None, causal, dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=2e-2 * max(1.0, np.abs(w).max()))


def test_q_side_reuses_a_precomputed_delta():
    """The ``q_side`` entry (``(q, do, delta)``) gives the gradients of
    the plain entry, with neither O nor dO passed separately."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(14, H=4, Hkv=2))
    out, lse = port.flash_forward(q, k, v, causal=True, with_lse=True)
    want = port.flash_backward(q, k, v, out, lse, do, causal=True)
    delta = port.backward_delta(out, do)
    assert delta.shape == lse.shape
    got = port.flash_backward(None, k, v, None, lse, None, causal=True,
                              q_side=(q, do, delta))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fully_masked_rows_get_zero_gradient():
    """A row whose lse is -inf (no live column) contributes P = 0."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(15))
    out, lse = port.flash_forward(q, k, v, with_lse=True)
    lse = lse.clone()
    lse[:, :, 3] = float("-inf")
    dq, dk, dv = port.flash_backward(q, k, v, out, lse, do)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert torch.equal(dq[:, 3], torch.zeros_like(dq[:, 3]))


def test_backward_tile_is_checked_before_the_forward_runs():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(16, S=8, D=256))
    q.requires_grad_()
    # f32: (64, 32) is the forward's tile at head_dim 256; the dK/dV
    # kernel's is (16, 64), so asking for gradients with block_k=32 raises
    # at once.
    with pytest.raises(ValueError, match="flash_bwd kernels are compiled"):
        port.flash_attention(q, k, v, block_k=32)
    out = port.flash_attention(q.detach(), k, v, block_k=32)
    assert out.shape == q.shape
    # bf16: the tensor-core forward's tile is (64, 32); the dK/dV kernel's
    # is (32, 64) and the dQ kernel's (64, 32), so no block_k serves all.
    qb, kb, vb = (t.detach().to(torch.bfloat16) for t in (q, k, v))
    with pytest.raises(ValueError, match="flash_bwd kernels are compiled"):
        port.flash_attention(qb.requires_grad_(), kb, vb, block_k=32)
    out = port.flash_attention(qb.detach(), kb, vb, block_k=32)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


# The f32 kernels on the card split each f32 operand x into bf16 parts
# hi = bf16(x), lo = bf16(x - hi) and take each product A B as
# Ahi Bhi + Ahi Blo + Alo Bhi in an f32 accumulator (the lo lo term
# dropped): Q K^T, P V (P the max-shifted exponentials), K Q^T, V dO^T,
# P^T dO, dS^T Q, and in the dQ kernel Q K^T, dO V^T and dS K.  The tests
# below emulate that scheme in
# plain PyTorch and hold it against the JAX package's Pallas kernels
# (interpret mode) at the f32 tolerance of the card (KERNEL_TOL["float32"]
# in chip_smoke.py: 2e-4 of the largest entry), so the scheme is shown to
# meet the limit before any card runs it.
F32_KERNEL_TOL = 2e-4


def _split(t):
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _split_einsum(eq, a, b, terms=("hh", "hl", "lh")):
    """``einsum(eq, a, b)`` from the named products of split parts."""
    parts = {"h": 0, "l": 1}
    sa, sb = _split(a), _split(b)
    return sum(torch.einsum(eq, sa[parts[x]], sb[parts[y]]) for x, y in terms)


def _split_attention(q, k, v, do, scale, causal, terms=("hh", "hl", "lh"),
                     dq_terms=None):
    """The f32 kernels' arithmetic, densely: (out, dk, dv, dq), with lse
    and delta from the emulated forward, as the backward on the card takes
    them from the forward kernel.  dQ = sum dSi Kj reads K at each q
    head's kv head; ``dq_terms`` (default ``terms``) names the part
    products of dS K alone."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    mm = lambda eq, a, b: _split_einsum(eq, a, b, terms)  # noqa: E731
    qf, dof = q.reshape(B, S, Hkv, g, D), do.reshape(B, S, Hkv, g, D)
    logits = mm("bqhgd,bkhd->bhgqk", qf, k) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    den = p.sum(-1, keepdim=True)
    out = mm("bhgqk,bkhd->bqhgd", p, v) / den.permute(0, 3, 1, 2, 4)
    lse = m + torch.log(den)  # [B, Hkv, g, S, 1]
    delta = (dof * out).sum(-1).permute(0, 2, 3, 1).unsqueeze(-1)
    p = torch.exp(logits - lse)
    ds = p * (mm("bqhgd,bkhd->bhgqk", dof, v) - delta) * scale
    dv = mm("bhgqk,bqhgd->bkhd", p, dof)
    dk = mm("bhgqk,bqhgd->bkhd", ds, qf)
    dq = _split_einsum("bhgqk,bkhd->bqhgd", ds, k,
                       terms if dq_terms is None else dq_terms)
    return out.reshape(B, S, H, D), dk, dv, dq.reshape(B, S, H, D)


def _pallas_out_and_grads(q, k, v, do, scale, causal):
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(
            a, b, c, scale=scale, causal=causal, block_q=BQ, block_k=BK,
            interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    dq, dk, dv = vjp(jnp.asarray(do))
    return tuple(np.asarray(t) for t in (out, dk, dv, dq))


def _rel_err(got, want):
    """max |err| over max |want| (chip_smoke.py's _rel_err)."""
    return float(np.abs(got - want).max() / np.abs(want).max())


SPLIT_CASES = {
    "mha": dict(H=2, Hkv=2),
    "causal": dict(H=2, Hkv=2, causal=True),
    "gqa_causal": dict(H=4, Hkv=2, causal=True),
    "mqa_scale": dict(H=4, Hkv=1, scale=0.37),
}


@functools.lru_cache(maxsize=None)
def _split_case(name, D):
    """(emulated, Pallas) (out, dk, dv, dq) of SPLIT_CASES[name] at head
    dim D (S = 50, B = 2), computed once for the tests that read it."""
    case = dict(SPLIT_CASES[name])
    causal = case.pop("causal", False)
    scale = case.pop("scale", None)
    q, k, v, do = _inputs(17 + D, S=50, D=D, B=2, **case)
    s = D ** -0.5 if scale is None else scale
    want = _pallas_out_and_grads(q, k, v, do, scale, causal)
    got = _split_attention(*(torch.from_numpy(a) for a in (q, k, v, do)), s,
                           causal)
    return tuple(g.numpy() for g in got), want


@pytest.mark.parametrize("D", [8, 33, 64])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_precision_scheme_meets_the_f32_limit(name, D):
    """The split scheme's forward, dK and dV within 2e-4 of the largest
    entry of the Pallas kernels' (S = 50, B = 2)."""
    got, want = _split_case(name, D)
    for label, g, w in zip(("out", "dk", "dv"), got, want):
        assert g.shape == w.shape, label
        assert _rel_err(g, w) <= F32_KERNEL_TOL, label


@pytest.mark.parametrize("D", [8, 33, 64])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_precision_dq_meets_the_f32_limit(name, D):
    """The split scheme's dQ (S and dP as split products, dS split again
    into parts for dS K) within 2e-4 of the largest entry of the Pallas
    kernels' dQ, from the same vjp."""
    got, want = _split_case(name, D)
    assert got[3].shape == want[3].shape
    assert _rel_err(got[3], want[3]) <= F32_KERNEL_TOL


def _shared_value_rows(seed, B=2, S=96, H=4, Hkv=2, D=16):
    """Inputs like a trained layer's (PERF.md §6): peaked attention
    and value rows that share a large common part, a small cotangent."""
    rng = np.random.default_rng(seed)
    q = 2 * rng.normal(size=(B, S, H, D))
    k = rng.normal(size=(B, S, Hkv, D))
    v = (12 * rng.normal(size=(B, 1, Hkv, D))
         + 0.25 * rng.normal(size=(B, S, Hkv, D)))
    do = 1e-3 * rng.normal(size=(B, S, H, D))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (q, k, v, do))


def _split_dq_dk(q, k, v, lse, do, delta, scale):
    """The f32 kernels' dQ and dK (every product split, dS split again)
    from the lse and delta they are handed."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf, dof = q.reshape(B, S, Hkv, g, D), do.reshape(B, S, Hkv, g, D)
    rows = lambda t: t.reshape(B, Hkv, g, S, 1)  # noqa: E731
    p = torch.exp(_split_einsum("bqhgd,bkhd->bhgqk", qf, k) * scale
                  - rows(lse))
    ds = p * (_split_einsum("bqhgd,bkhd->bhgqk", dof, v) - rows(delta)) * scale
    return (_split_einsum("bhgqk,bkhd->bqhgd", ds, k).reshape(q.shape),
            _split_einsum("bhgqk,bqhgd->bkhd", ds, qf))


@pytest.mark.parametrize("seed", [1, 2])
def test_centered_values_keep_the_split_dq_within_the_f32_limit(seed):
    """On value rows with a large common part the split dP = dO v^T
    leaves dQ outside 2e-4 of the plain backward; with the v and delta of
    ``center_values``, which the f32 backward hands its kernels, dQ and
    dK are well inside it, and the plain backward does not move."""
    scale = 16 ** -0.5

    def backward(q, k, v, do, center):
        out, lse = port.flash_attention_reference(q, k, v, scale, False)
        delta = port.backward_delta(out, do)
        if center:
            v, delta = port.center_values(v, do, delta)
        return (v, lse, delta), port.flash_attention_backward_reference(
            q, k, v, lse, do, delta, scale, False)

    # The identity, in float64: centering changes no gradient.
    inputs64 = [t.double() for t in _shared_value_rows(seed)]
    (vc, _, _), got = backward(*inputs64, center=True)
    _, want = backward(*inputs64, center=False)
    assert float(vc.mean(dim=1).abs().max()) < 1e-12
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), w.numpy()) <= 1e-12
    # The split scheme against the plain f32 backward, as on the card.
    q, k, v, do = _shared_value_rows(seed)
    (_, lse, delta), want = backward(q, k, v, do, center=False)
    vc, delta_c = port.center_values(v, do, delta)
    raw_dq, _ = _split_dq_dk(q, k, v, lse, do, delta, scale)
    assert _rel_err(raw_dq.numpy(), want[0].numpy()) > F32_KERNEL_TOL
    dq, dk = _split_dq_dk(q, k, vc, lse, do, delta_c, scale)
    assert _rel_err(dq.numpy(), want[0].numpy()) <= F32_KERNEL_TOL / 4
    assert _rel_err(dk.numpy(), want[1].numpy()) <= F32_KERNEL_TOL / 4


def test_one_bf16_product_misses_the_f32_limit():
    """The emulation can fail: taking each product as one bf16 product
    (hi hi only, what a plain bf16 or tf32-like rounding of the f32
    operands gives) lands outside 2e-4 on the same inputs, and so does dQ
    with dS rounded to bf16 once (dShi Khi + dShi Klo, every other product
    split), as the bf16 dQ kernel rounds it."""
    q, k, v, do = _inputs(81, S=50, D=64, B=2, H=4, Hkv=2)
    want = _pallas_out_and_grads(q, k, v, do, None, True)
    inputs = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = _split_attention(*inputs, 64 ** -0.5, True, terms=("hh",))
    assert max(_rel_err(g.numpy(), w) for g, w in zip(got, want)) > \
        F32_KERNEL_TOL
    assert _rel_err(got[3].numpy(), want[3]) > F32_KERNEL_TOL
    dq = _split_attention(*inputs, 64 ** -0.5, True,
                          dq_terms=("hh", "hl"))[3]
    assert _rel_err(dq.numpy(), want[3]) > F32_KERNEL_TOL
