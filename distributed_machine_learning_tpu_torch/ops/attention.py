"""Attention primitives over ``[B, S, H, D]`` tensors, in plain PyTorch.

Port of ``distributed_machine_learning_tpu/ops/attention.py``: the same
einsum math in the same dtypes, so a model carried over from the JAX
package gives the same answers.

* :func:`dot_product_attention` — softmax attention, logits in the input
  dtype, the ``finfo.min`` mask and an f32 softmax.
* :func:`linear_attention` — O(n) kernelized attention with the elu+1
  feature map, causal or bidirectional, grouped kv native.
* :func:`blockwise_attention` — kv-blocked attention with an online
  softmax; memory O(S * block) instead of O(S^2).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention. q,k,v: [B, S, H, D] -> [B, S, H, D]."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = torch.where(
            mask, logits,
            torch.tensor(torch.finfo(logits.dtype).min, dtype=logits.dtype,
                         device=logits.device),
        )
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def linear_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Kernelized linear attention (Katharopoulos et al. 2020).

    out_i = phi(q_i) . sum_j phi(k_j) v_j^T / (phi(q_i) . sum_j phi(k_j)).
    k, v may carry fewer heads than q (``H % Hkv == 0``): the per-kv-head
    state is shared across each query group, never repeated."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"num_heads {H} must be a multiple of kv heads {Hkv}")
    g = H // Hkv
    qf = _elu_feature_map(q).reshape(B, S, Hkv, g, D)
    kf = _elu_feature_map(k)
    E = v.shape[-1]
    if not causal:
        kv = torch.einsum("bshd,bshe->bhde", kf, v)
        z = torch.einsum("bshgd,bhd->bshg", qf, kf.sum(dim=1)).reshape(B, S, H)
        out = torch.einsum("bshgd,bhde->bshge", qf, kv).reshape(B, S, H, E)
        return out / (z[..., None] + eps)
    # Causal: prefix sums of the kv outer products.
    kv_prefix = torch.cumsum(torch.einsum("bshd,bshe->bshde", kf, v), dim=1)
    k_prefix = torch.cumsum(kf, dim=1)
    z = torch.einsum("bshgd,bshd->bshg", qf, k_prefix).reshape(B, S, H)
    out = torch.einsum("bshgd,bshde->bshge", qf, kv_prefix).reshape(B, S, H, E)
    return out / (z[..., None] + eps)


def largest_divisor_block(S: int, target: int) -> int:
    """Largest divisor of S not exceeding ``target``."""
    bs = min(max(int(target), 1), S)
    while S % bs:
        bs -= 1
    return bs


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_size: int = 128,
    causal: bool = False,
) -> torch.Tensor:
    """Blockwise softmax attention with online renormalization.

    Walks key/value blocks keeping running (max, sum, acc) statistics per
    query block, so peak memory is O(S * block).  Grouped kv is consumed
    through grouped einsums, never repeated."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"num_heads {H} must be a multiple of kv heads {Hkv}")
    group = H // Hkv
    if S % block_size != 0:
        raise ValueError(
            f"seq len {S} must be a multiple of block_size {block_size}"
        )
    nb = S // block_size
    scale = D ** -0.5
    ids = torch.arange(S, device=q.device).reshape(nb, block_size)
    outs = []
    for qi in range(nb):
        q_block = q[:, qi * block_size:(qi + 1) * block_size]
        qg = q_block.reshape(B, block_size, Hkv, group, D)
        m = torch.full((B, block_size, H), float("-inf"), device=q.device)
        l = torch.zeros((B, block_size, H), device=q.device)
        acc = torch.zeros((B, block_size, H, D), device=q.device)
        for ki in range(nb):
            k_block = k[:, ki * block_size:(ki + 1) * block_size]
            v_block = v[:, ki * block_size:(ki + 1) * block_size]
            logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_block).float()
            logits = logits.reshape(B, block_size, H, -1) * scale
            if causal:
                cmask = ids[qi][None, :, None, None] >= ids[ki][None, None, None, :]
                logits = logits.masked_fill(~cmask, float("-inf"))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # Guard fully masked rows (m_new == -inf) from producing NaNs.
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(logits - m_safe[..., None])
            p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum(
                "bqhgk,bkhd->bqhgd",
                p.reshape(B, block_size, Hkv, group, -1),
                v_block.float(),
            ).reshape(B, block_size, H, D)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)
