"""The port's attention primitives and position encodings against the JAX
package's (ops/attention.py, models/layers.py), on the same numpy inputs."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from distributed_machine_learning_tpu.models import layers as jax_layers  # noqa: E402
from distributed_machine_learning_tpu.ops import attention as jax_attn  # noqa: E402
from distributed_machine_learning_tpu_torch.models import layers  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import attention  # noqa: E402

ATOL = 1e-5


def _qkv(seed, B=2, S=16, H=4, Hkv=4, D=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention(masked):
    q, k, v = _qkv(0)
    S = q.shape[1]
    mask = np.tril(np.ones((S, S), bool))[None, None] if masked else None
    ref = jax_attn.dot_product_attention(
        *_j(q, k, v), mask=None if mask is None else jnp.asarray(mask),
        scale=0.3,
    )
    out = attention.dot_product_attention(
        *_t(q, k, v), mask=None if mask is None else torch.from_numpy(mask),
        scale=0.3,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal,Hkv", [(False, 4), (True, 4), (True, 2),
                                        (False, 1)])
def test_blockwise_attention(causal, Hkv):
    q, k, v = _qkv(1, Hkv=Hkv)
    ref = jax_attn.blockwise_attention(*_j(q, k, v), block_size=4,
                                       causal=causal)
    out = attention.blockwise_attention(*_t(q, k, v), block_size=4,
                                        causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal,Hkv", [(False, 4), (True, 4), (False, 2),
                                        (True, 1)])
def test_linear_attention(causal, Hkv):
    q, k, v = _qkv(2, Hkv=Hkv)
    ref = jax_attn.linear_attention(*_j(q, k, v), causal=causal)
    out = attention.linear_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("S,target", [(64, 128), (96, 40), (7, 3), (16, 0)])
def test_largest_divisor_block(S, target):
    assert (attention.largest_divisor_block(S, target)
            == jax_attn.largest_divisor_block(S, target))


def test_apply_rope():
    q, _, _ = _qkv(3, D=16)
    ref = jax_layers.apply_rope(jnp.asarray(q))
    out = layers.apply_rope(torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    pos = np.arange(16, dtype=np.float32)[::-1].copy()
    ref = jax_layers.apply_rope(jnp.asarray(q), positions=jnp.asarray(pos))
    out = layers.apply_rope(torch.from_numpy(q), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    with pytest.raises(ValueError, match="even head dim"):
        layers.apply_rope(torch.zeros(1, 2, 1, 3))


def test_sincos_position_table():
    np.testing.assert_allclose(
        layers.sincos_position_table(50, 24),
        jax_layers.sincos_position_table(50, 24), atol=ATOL,
    )
