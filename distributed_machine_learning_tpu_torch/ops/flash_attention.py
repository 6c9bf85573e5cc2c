"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Port of ``distributed_machine_learning_tpu/ops/pallas_attention.py``.  The
TPU kernel ``_flash_kernel`` (launched by ``_flash_forward``) becomes
``csrc/flash_fwd.cu``, compiled for ``sm_90a`` at first use
(``ops/_build.py``).  :func:`flash_forward` dispatches on the tensor's
device: a CUDA tensor launches the kernel, a CPU tensor takes
:func:`flash_attention_reference`, the plain PyTorch version of the same
function.  Nothing falls back from one to the other.

Shapes follow the JAX package: q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]``
with ``H % Hkv == 0`` (grouped-query attention; kv is never repeated),
O ``[B, S, H, D]`` in q's dtype, lse ``[B*H, 1, S]`` in f32.

The backward kernels (``_bwd_dkdv_kernel``, ``_bwd_dq_kernel``) are not
ported yet: :func:`flash_attention` is an autograd function whose backward
raises rather than differentiating the plain version behind the caller's
back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

KERNEL_NAME = "flash_fwd"

# (block_q, block_k) per head-dim bucket, as compiled in csrc/flash_fwd.cu.
# Untuned: the first tiles that are right and fit Hopper's shared memory.
# The TPU package's VMEM-derived caps (_default_blocks there) do not apply.
KERNEL_TILES = ((32, (64, 64)), (64, (64, 64)), (128, (64, 64)),
                (256, (32, 64)))
MAX_HEAD_DIM = 256


class LaunchCounter:
    """Thread-safe count of kernel launches (the proof that a path ran
    through the kernel and not its plain version)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0

    def add(self) -> None:
        with self._lock:
            self._count += 1

    def reset(self) -> None:
        with self._lock:
            self._count = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


launches = LaunchCounter(KERNEL_NAME)


def _default_blocks(S: int, D: int, block_q=None, block_k=None):
    """The kernel's fixed (block_q, block_k) for head dim ``D``.

    The tile is compiled into the kernel, so an explicit block size must
    name it; any other value raises instead of being silently ignored."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside the kernel's 1..{MAX_HEAD_DIM}")
    tile = next(t for dmax, t in KERNEL_TILES if D <= dmax)
    for name, want, have in (("block_q", block_q, tile[0]),
                             ("block_k", block_k, tile[1])):
        if want is not None and int(want) != have:
            raise ValueError(
                f"{name}={want}: the CUDA kernel is compiled for tiles "
                f"{tile} at head_dim {D}"
            )
    return tile


def _check_shapes(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got shape {tuple(q.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != S
            or k.shape[3] != D):
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} incompatible "
            f"with q {tuple(q.shape)}"
        )
    if H % Hkv != 0:
        raise ValueError(f"num_heads {H} must be a multiple of kv heads {Hkv}")
    return B, S, H, Hkv, D


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash forward: ``(out, lse)``.

    The kernel's function written densely: f32 logits ``q k^T * scale``,
    causal positions above the diagonal at -inf, a softmax against a safe
    row max, O in q's dtype and lse ``[B*H, 1, S]`` in f32, with fully
    masked rows giving O = 0 and lse = -inf."""
    B, S, H, Hkv, D = _check_shapes(q, k, v)
    group = H // Hkv
    qf = q.float().reshape(B, S, Hkv, group, D)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe)
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf) / denom.permute(
        0, 3, 1, 2, 4
    )
    lse = torch.where(
        torch.isfinite(m), m + torch.log(denom),
        torch.full_like(m, float("-inf")),
    )
    out = out.reshape(B, S, H, D).to(q.dtype)
    return out, lse.reshape(B * H, 1, S)


def _launch(q, k, v, scale: float, causal: bool):
    """The CUDA kernel on ``q``'s device and current stream."""
    B, S, H, Hkv, D = _check_shapes(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if B * H > 65535:
        raise ValueError(f"batch*heads {B * H} exceeds the kernel grid")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    if B * S * H * D == 0:
        return out, lse
    from distributed_machine_learning_tpu_torch.ops import _build

    lib = _build.load(KERNEL_NAME)
    fn = lib.dml_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, Hkv, D,
            *q.stride(), *k.stride(), *v.stride(),
            float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        lib.dml_cuda_error_string.restype = ctypes.c_char_p
        lib.dml_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.dml_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} ({err})")
    launches.add()
    return out, lse


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None, causal: bool = False,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
    *, with_lse: bool = False,
):
    """Forward only: O, or ``(O, lse)`` with ``with_lse``.

    CUDA tensors run the kernel; CPU tensors run the plain version."""
    s = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    _default_blocks(q.shape[1], q.shape[-1], block_q, block_k)
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, s, causal)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, s, causal)
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return (out, lse) if with_lse else out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        return flash_forward(q, k, v, scale, causal, block_q, block_k)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash attention backward is not ported yet: the TPU kernels "
            "_bwd_dkdv_kernel and _bwd_dq_kernel (ops/pallas_attention.py) "
            "come with the trainer, next on ROADMAP.md queue A"
        )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None, causal: bool = False,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash softmax attention. q: [B, S, H, D] -> [B, S, H, D].

    k, v: [B, S, Hkv, D] with ``H % Hkv == 0``.  ``scale`` defaults to
    1/sqrt(D).  Differentiating through it raises (backward not ported)."""
    return _FlashAttention.apply(q, k, v, scale, causal, block_q, block_k)
