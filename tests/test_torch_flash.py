"""The port's flash-attention forward against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain version
(``flash_attention_reference``); the JAX kernel runs in Pallas interpret
mode, as tests/test_pallas_attention.py runs it.  Same numpy inputs into
both; f32 agrees to 1e-5.  The CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from distributed_machine_learning_tpu.ops.pallas_attention import (  # noqa: E402
    _flash_forward,
    flash_attention as jax_flash_attention,
)
from distributed_machine_learning_tpu_torch.ops import flash_attention as port  # noqa: E402

# Shapes of tests/test_pallas_attention.py.
B, S, H, D = 1, 32, 2, 8
BQ = BK = 16


def _inputs(seed, S=S, H=H, Hkv=H, D=D, B=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


CASES = {
    "f32": dict(),
    "f32_causal": dict(causal=True),
    "gqa": dict(H=4, Hkv=2),
    "mqa_causal": dict(H=4, Hkv=1, causal=True),
    "custom_scale": dict(scale=0.21),
    "seq_not_multiple_of_block": dict(S=40, causal=True),
    "batch2": dict(B=2, H=4, Hkv=2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_pallas_kernel(name):
    case = dict(CASES[name])
    causal = case.pop("causal", False)
    scale = case.pop("scale", None)
    q, k, v = _inputs(1, **case)
    s = q.shape[-1] ** -0.5 if scale is None else scale
    ref_out, ref_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s, causal, BQ, BK,
        True, with_lse=True,
    )
    jax_out = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, block_q=BQ, block_k=BK, interpret=True,
    )
    out, lse = port.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), s,
        causal,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    assert lse.shape == ref_lse.shape
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_pallas_kernel_bf16(causal):
    q, k, v = _inputs(2, H=4, Hkv=2)
    to_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    jax_out, jax_lse = _flash_forward(
        to_bf16(q), to_bf16(k), to_bf16(v), D ** -0.5, causal, BQ, BK, True,
        with_lse=True,
    )
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = port.flash_attention_reference(tq, tk, tv, D ** -0.5, causal)
    assert out.dtype == torch.bfloat16
    # Both compute in f32 from the same bf16 inputs and round once at the
    # end: at most one bf16 ulp apart.
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(jax_out, np.float32), atol=1e-2
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), atol=1e-5)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, H=4, Hkv=2))
    before = port.launches.count
    out, lse = port.flash_forward(q, k, v, causal=True, with_lse=True)
    ref_out, ref_lse = port.flash_attention_reference(q, k, v, D ** -0.5, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert torch.equal(port.flash_attention(q, k, v, causal=True), ref_out)
    assert port.launches.count == before


def test_backward_takes_plain_version_only_on_cpu():
    """CPU tensors take the plain backward and count no kernel launch."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(4))
    before = (port.dkdv_launches.count, port.dq_launches.count)
    port.flash_attention(q, k, v).sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (q, k, v))
    assert (port.dkdv_launches.count, port.dq_launches.count) == before


def test_backward_raises_instead_of_a_silent_plain_gradient():
    """A tensor on neither the card nor the CPU raises: no device falls
    back to the plain backward."""
    mq, mk, mv = (torch.from_numpy(a).to("meta") for a in _inputs(4))
    lse = torch.empty((B * H, 1, S), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.flash_backward(mq, mk, mv, mq, lse, mq)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.flash_bwd_dq(mq, mk, mv, lse, mq, lse, 0.1, False)


def test_fixed_kernel_tile_and_shape_checks():
    bf16 = torch.bfloat16
    # f32: the split-precision tensor-core tiles of every kernel (a 16-row
    # q tile for dK/dV and a 16-column kv tile for dQ at D > 128).
    assert port._default_blocks(2048, 64) == (128, 64)
    assert port._default_blocks(2048, 256) == (64, 32)
    assert port._default_blocks(96, 16, block_q=128) == (128, 64)
    assert port._default_blocks(2048, 64, backward=True) == {
        "flash_bwd_dkdv": (64, 128), "flash_bwd_dq": (128, 32)}
    assert port._default_blocks(2048, 128, backward=True) == {
        "flash_bwd_dkdv": (32, 64), "flash_bwd_dq": (128, 32)}
    assert port._default_blocks(2048, 256, backward=True) == {
        "flash_bwd_dkdv": (16, 64), "flash_bwd_dq": (64, 16)}
    with pytest.raises(ValueError, match="flash_bwd kernels are compiled"):
        port._default_blocks(2048, 256, block_k=64, backward=True)
    with pytest.raises(ValueError, match="compiled for tiles"):
        port._default_blocks(2048, 64, block_q=64)
    # bf16: the tensor-core tiles (64 q rows per warpgroup) of every
    # kernel.
    assert port._default_blocks(2048, 64, dtype=bf16) == (128, 64)
    assert port._default_blocks(2048, 40, block_q=128, dtype=bf16) == (128,
                                                                      64)
    assert port._default_blocks(2048, 128, dtype=bf16) == (128, 64)
    assert port._default_blocks(2048, 256, dtype=bf16) == (64, 32)
    assert port._default_blocks(2048, 64, backward=True, dtype=bf16) == {
        "flash_bwd_dkdv": (64, 128), "flash_bwd_dq": (128, 32)}
    assert port._default_blocks(2048, 128, backward=True, dtype=bf16) == {
        "flash_bwd_dkdv": (64, 64), "flash_bwd_dq": (128, 64)}
    assert port._default_blocks(2048, 256, backward=True, dtype=bf16) == {
        "flash_bwd_dkdv": (32, 64), "flash_bwd_dq": (64, 32)}
    assert port._default_blocks(2048, 128, block_k=64, backward=True,
                                dtype=bf16)["flash_bwd_dkdv"] == (64, 64)
    with pytest.raises(ValueError, match="compiled for tiles"):
        port._default_blocks(2048, 64, block_q=64, dtype=bf16)
    # No block_q or block_k serves both backward kernels at bf16, D <= 64.
    with pytest.raises(ValueError, match="flash_bwd kernels are compiled"):
        port._default_blocks(2048, 64, block_q=64, backward=True, dtype=bf16)
    for block_k in (32, 64, 128):
        with pytest.raises(ValueError, match="flash_bwd kernels are compiled"):
            port._default_blocks(2048, 64, block_k=block_k, backward=True,
                                 dtype=bf16)
    with pytest.raises(ValueError, match="head_dim"):
        port._default_blocks(64, 512)
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, H=3, Hkv=2))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port.flash_forward(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(5))
    with pytest.raises(ValueError, match="incompatible"):
        port.flash_forward(q, k[:, :-1], v[:, :-1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.flash_forward(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_inputs_take_batch_times_heads_past_65535():
    """The kernels put (batch, head) on the grid's x axis, so B*H = 65536
    passes the wrapper's checks (meta tensors: shapes only, no memory);
    only a sequence with more than 65535 tiles on the y axis is refused."""
    bf16 = torch.bfloat16
    for dtype in (torch.float32, bf16):
        q = torch.empty(8192, 24, 8, 16, device="meta", dtype=dtype)
        kv = torch.empty(8192, 24, 4, 16, device="meta", dtype=dtype)
        assert port._check_kernel_inputs(q, kv, kv) == (8192, 24, 8, 4, 16)
        port._check_dout(q, q)
        for name in (port.KERNEL_NAME, "flash_bwd_dkdv", "flash_bwd_dq"):
            port._check_grid(name, 24, 16, dtype)
    # The y axis: 65535 tiles of the kernel's own rows per block.
    port._check_grid("flash_bwd_dq", 65535 * 128, 64, bf16)
    with pytest.raises(ValueError, match="65536 tiles"):
        port._check_grid("flash_bwd_dq", 65535 * 128 + 1, 64, bf16)
    port._check_grid("flash_bwd_dkdv", 65535 * 64, 256, torch.float32)
    with pytest.raises(ValueError, match="kernel grid"):
        port._check_grid("flash_bwd_dkdv", 65535 * 64 + 1, 256,
                         torch.float32)
    port._check_grid(port.KERNEL_NAME, 65535 * 64, 256, bf16)
    with pytest.raises(ValueError, match="kernel grid"):
        port._check_grid(port.KERNEL_NAME, 65535 * 64 + 1, 256, bf16)


def _stored_transposed(t):
    """The values of ``t`` [B, S, H, D] stored as [B, H, D, S]."""
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", ["d33", "stride0_dout", "transposed_q",
                                  "unaligned_k"])
def test_tensor_core_operands_pad_and_copy_without_changing_results(case):
    """The kernels' conforming copy: inputs they cannot read in place
    (D not a multiple of 8, a stride-0 dO, D not innermost, an unaligned
    base) become contiguous copies zero-padded in D to a multiple of 8;
    the plain forward and backward on the copies, at the original D's
    scale, equal the originals' once sliced back."""
    D = 33 if case == "d33" else 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, H=4, Hkv=2, D=D))
    do = torch.from_numpy(
        np.random.default_rng(7).normal(size=q.shape).astype(np.float32))
    if case == "stride0_dout":
        do = torch.tensor(0.7).expand(q.shape)  # what .sum().backward() gives
    elif case == "transposed_q":
        q = _stored_transposed(q)
    elif case == "unaligned_k":
        k = torch.cat([torch.zeros(1), k.flatten()])[1:].view(k.shape)
    originals = (q, k, v, do)
    copies = port.tensor_core_operands(*originals)
    d_pad = -(-D // 8) * 8
    for t, c in zip(originals, copies):
        assert port._conforms(c) and c.shape[-1] == d_pad
        assert torch.equal(c[..., :D], t)
        assert not c[..., D:].any()
        # Only what does not conform is copied.
        assert (c is t) == (d_pad == D and port._conforms(t))
    assert sum(c is not t for t, c in zip(originals, copies)) == (
        4 if case == "d33" else 1)

    qc, kc, vc, doc = copies
    scale = D ** -0.5
    out, lse = port.flash_attention_reference(q, k, v, scale, True)
    out_c, lse_c = port.flash_attention_reference(qc, kc, vc, scale, True)
    torch.testing.assert_close(port._unpad(out_c, D), out, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_c, lse, rtol=0, atol=1e-6)
    delta = port.backward_delta(out, do)
    delta_c = port.backward_delta(out_c, doc)
    torch.testing.assert_close(delta_c, delta, rtol=0, atol=1e-6)
    grads = port.flash_attention_backward_reference(q, k, v, lse, do, delta,
                                                    scale, True)
    grads_c = port.flash_attention_backward_reference(qc, kc, vc, lse_c, doc,
                                                      delta_c, scale, True)
    for g, gc in zip(grads, grads_c):
        assert not gc[..., D:].any()
        torch.testing.assert_close(port._unpad(gc, D), g, rtol=0, atol=1e-6)
