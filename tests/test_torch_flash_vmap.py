"""Flash attention under ``torch.func``: the port's ``vmap(grad(...))``
against the JAX package's ``jax.vmap(jax.grad(...))`` of the Pallas
kernels, and against a loop over the rows.

A population of K rows, each its own (q, k, v) from one numpy seed, goes
through ``vmap(grad(loss))`` in both packages; on the CPU the port's
wrappers take their plain versions and the JAX side runs
``flash_attention(..., interpret=True)``, as tests/test_torch_flash_bwd.py
does.  f32 agrees to 2e-5 (that file's tolerance).  The vmap rules fold
the K rows into the batch of ONE forward and ONE backward call; the calls
are counted here, and on the card the kernels' launch counters show the
same (chip_smoke.py, phase ``vectorized``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.func import grad, vmap  # noqa: E402

from distributed_machine_learning_tpu.ops.pallas_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from distributed_machine_learning_tpu_torch.ops import flash_attention as port  # noqa: E402

K, B, S, D = 3, 2, 16, 8
BQ = BK = 16
TOL = 2e-5

CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "gqa": dict(H=4, Hkv=2),
    "mqa_causal": dict(H=4, Hkv=1, causal=True),
    "custom_scale": dict(scale=0.21),
}


def _case(name):
    case = dict(CASES[name])
    causal, scale = case.pop("causal", False), case.pop("scale", None)
    H = case.get("H", 2)
    return causal, scale, H, case.get("Hkv", H)


def _inputs(seed, H, Hkv, k_rows=K):
    """K rows of q, k, v and a weight w for the loss, from one seed."""
    rng = np.random.default_rng(seed)
    shapes = ((k_rows, B, S, H, D), (k_rows, B, S, Hkv, D),
              (k_rows, B, S, Hkv, D), (k_rows, B, S, H, D))
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def _port_loss(scale, causal):
    def loss(q, k, v, w):
        return (torch.sin(port.flash_attention(q, k, v, scale=scale,
                                               causal=causal)) * w).sum()
    return loss


def _jax_grads(q, k, v, w, scale, causal):
    def loss(a, b, c, ww):
        out = jax_flash_attention(a, b, c, scale=scale, causal=causal,
                                  block_q=BQ, block_k=BK, interpret=True)
        return (jnp.sin(out) * ww).sum()

    return jax.vmap(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v, w)))


class _Calls:
    """Counts the wrapper calls the vmap rules make."""

    def __init__(self, monkeypatch):
        self.fwd, self.bwd, self.rows = 0, 0, []
        fwd, bwd = port.flash_forward, port.flash_backward

        def counted_fwd(q, *args, **kwargs):
            self.fwd += 1
            self.rows.append(q.shape[0])
            return fwd(q, *args, **kwargs)

        def counted_bwd(q, *args, **kwargs):
            self.bwd += 1
            return bwd(q, *args, **kwargs)

        monkeypatch.setattr(port, "flash_forward", counted_fwd)
        monkeypatch.setattr(port, "flash_backward", counted_bwd)


@pytest.mark.parametrize("name", sorted(CASES))
def test_vmap_grad_matches_jax_vmap_grad_and_a_row_loop(name, monkeypatch):
    causal, scale, H, Hkv = _case(name)
    q, k, v, w = _inputs(21, H, Hkv)
    want = _jax_grads(q, k, v, w, scale, causal)
    calls = _Calls(monkeypatch)
    loss = _port_loss(scale, causal)
    got = vmap(grad(loss, argnums=(0, 1, 2)), randomness="error")(
        *(torch.from_numpy(a) for a in (q, k, v, w)))
    # One forward and one backward call for all K rows, on the folded batch.
    assert (calls.fwd, calls.bwd, calls.rows) == (1, 1, [K * B])
    for label, g, ww in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == tuple(ww.shape), label
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=TOL,
                                   err_msg=label)
    for r in range(K):
        row = [torch.from_numpy(a[r]).requires_grad_() for a in (q, k, v)]
        loop = torch.autograd.grad(loss(*row, torch.from_numpy(w[r])), row)
        for label, g, gl in zip(("dq", "dk", "dv"), got, loop):
            np.testing.assert_allclose(g[r].numpy(), gl.numpy(), atol=1e-6,
                                       err_msg=f"row {r} {label}")


def test_lse_unfolds_to_each_rows_layout():
    """The forward's lse ``[B*H, 1, S]`` per row: the fold's rows
    ``k*(B*H) + b*H + h`` unfold to ``[K, B*H, 1, S]``."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(22, 4, 2))
    out, lse = vmap(lambda a, b, c: port._FlashForward.apply(
        a, b, c, None, True, None, None))(q, k, v)
    assert lse.shape == (K, B * 4, 1, S)
    for r in range(K):
        o, ls = port.flash_forward(q[r], k[r], v[r], causal=True,
                                   with_lse=True)
        np.testing.assert_allclose(out[r].numpy(), o.numpy(), atol=1e-6)
        np.testing.assert_allclose(lse[r].numpy(), ls.numpy(), atol=1e-6)


def test_unbatched_and_moved_inputs(monkeypatch):
    """kv shared by every row (``in_dims`` None) is expanded, and a
    vmapped dim that is not the first is moved to the front."""
    q, k, v, w = _inputs(23, 2, 2)
    loss = _port_loss(None, False)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    got = vmap(grad(loss), in_dims=(1, None, None, 0))(
        tq.movedim(0, 1), tk[0], tv[0], tw)
    for r in range(K):
        row = tq[r].clone().requires_grad_()
        want, = torch.autograd.grad(loss(row, tk[0], tv[0], tw[r]), row)
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), atol=1e-6)
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        out = vmap(lambda a: port.flash_attention(a, tk[0], tv[0]))(tq)
    assert out.shape == tq.shape and (calls.fwd, calls.bwd) == (1, 0)


def test_plain_call_runs_one_forward_and_one_backward(monkeypatch):
    """Outside any transform nothing goes through a vmap rule: one
    forward call and one backward call, on the unfolded batch."""
    q, k, v, _ = _inputs(24, 4, 2)
    tq, tk, tv = (torch.from_numpy(a[0]).requires_grad_() for a in (q, k, v))
    calls = _Calls(monkeypatch)
    port.flash_attention(tq, tk, tv, causal=True).sum().backward()
    assert (calls.fwd, calls.bwd, calls.rows) == (1, 1, [B])
    assert tq.grad is not None and tk.grad.shape == tk.shape
