"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of ``distributed_machine_learning_tpu/ops/pallas_attention.py``.  The
TPU kernel ``_flash_kernel`` (launched by ``_flash_forward``) becomes
``csrc/flash_fwd.cu``; the backward kernels ``_bwd_dkdv_kernel`` and
``_bwd_dq_kernel`` (launched by ``_flash_backward``) become the two kernels
of ``csrc/flash_bwd.cu``.  All are compiled for ``sm_90a`` at first use
(``ops/_build.py``).  :func:`flash_forward` and :func:`flash_backward`
dispatch on the tensor's device: a CUDA tensor launches the kernels, a CPU
tensor takes :func:`flash_attention_reference` /
:func:`flash_attention_backward_reference`, the plain PyTorch versions of
the same functions.  Nothing falls back from one to the other.

On the card every kernel picks its code by dtype.  bf16 runs on the
tensor cores (``wgmma``).  The f32 kernels run there too, each f32
operand split into a bf16 high and low part and each product taken as
three bf16 products (hi hi + hi lo + lo hi), which keeps f32 precision;
the f32 backward hands them V centered on its mean over the sequence
(:func:`center_values`).  The kernels read rows with 16-byte copies, so :func:`tensor_core_operands`
first copies any input whose layout they cannot read.

Shapes follow the JAX package: q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]``
with ``H % Hkv == 0`` (grouped-query attention; kv is never repeated),
O ``[B, S, H, D]`` in q's dtype, lse ``[B*H, 1, S]`` in f32; dK and dV come
back at ``Hkv`` heads.  :func:`flash_attention` is the autograd function:
its forward saves O and lse, its backward runs :func:`flash_backward`.

Under a non-reentrant ``torch.utils.checkpoint`` (remat,
``models/layers.py::remat_call``) the forward runs again inside the
backward to give back what it saved, and launches the kernel again (a
ctypes launch is no operator a selective policy can keep), so each
launch counter counts what the card ran: two forwards per remat block.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

KERNEL_NAME = "flash_fwd"
BACKWARD_SOURCE = "flash_bwd"

# (head-dim bucket, (block_q, block_k)) per kernel and dtype, as compiled
# in csrc/flash_fwd.cu and csrc/flash_bwd.cu.  The tensor-core code has
# block_q = 64 rows per warpgroup, and the dK/dV kernel's block_k is the
# kv rows one block owns; the bf16 tiles are each the fastest of the
# variants that chip_flash_study.py measured (PERF.md).  The f32 forward
# takes the bf16 forward's tiles, the f32 dK/dV the bf16 ones but for
# smaller q tiles at D > 64 (32 rows at D = 128, where 64 spill; 16 at
# D = 256, what fits shared memory with the hi/lo and staging tiles), and
# the f32 dQ 32-column kv tiles (16 at D = 256) for the same reason.  The
# TPU package's VMEM-derived caps (_default_blocks there) do not apply.
_TENSOR_CORE_FORWARD = ((64, (128, 64)), (128, (128, 64)), (256, (64, 32)))
KERNEL_TILES = {
    "float32": _TENSOR_CORE_FORWARD,
    "bfloat16": _TENSOR_CORE_FORWARD,
}
BACKWARD_TILES = {
    "flash_bwd_dkdv": {
        "float32": ((64, (64, 128)), (128, (32, 64)), (256, (16, 64))),
        "bfloat16": ((64, (64, 128)), (128, (64, 64)), (256, (32, 64))),
    },
    "flash_bwd_dq": {"float32": ((64, (128, 32)), (128, (128, 32)),
                                 (256, (64, 16))),
                     "bfloat16": ((64, (128, 32)), (128, (128, 64)),
                                  (256, (64, 32)))},
}
MAX_HEAD_DIM = 256
# Every launch puts (batch, head) on gridDim.x, which takes 2**31 - 1
# blocks, and its q or kv tile on gridDim.y, which takes at most 65535.
MAX_GRID_TILES = 65535


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
dkdv_launches = LaunchCounter("flash_bwd_dkdv")
dq_launches = LaunchCounter("flash_bwd_dq")


def _default_blocks(S: int, D: int, block_q=None, block_k=None,
                    backward: bool = False, dtype=torch.float32):
    """The kernels' fixed (block_q, block_k) for head dim ``D`` and
    ``dtype``: the forward's tile, or with ``backward`` a dict of each
    backward kernel's tile.

    The tiles are compiled into the kernels, so an explicit block size
    must name the tile of every kernel that will run; any other value
    raises instead of being silently ignored."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside the kernel's 1..{MAX_HEAD_DIM}")
    key = "bfloat16" if dtype == torch.bfloat16 else "float32"
    tables = ({name: t[key] for name, t in BACKWARD_TILES.items()}
              if backward else {KERNEL_NAME: KERNEL_TILES[key]})
    tiles = {name: next(t for dmax, t in table if D <= dmax)
             for name, table in tables.items()}
    source, compiled = ((BACKWARD_SOURCE, tiles) if backward
                        else (KERNEL_NAME, tiles[KERNEL_NAME]))
    for tile in tiles.values():
        for name, want, have in (("block_q", block_q, tile[0]),
                                 ("block_k", block_k, tile[1])):
            if want is not None and int(want) != have:
                raise ValueError(
                    f"{name}={want}: the CUDA {source} kernels are compiled "
                    f"for tiles {compiled} at head_dim {D} in {key}"
                )
    return compiled


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


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 for f32 and bf16 (the kernels' accumulation type); f64 stays."""
    return torch.promote_types(t.dtype, torch.float32)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash forward: ``(out, lse)``.

    The kernel's function written densely: f32 logits ``q k^T * scale``,
    causal positions above the diagonal at -inf, a softmax against a safe
    row max, O in q's dtype and lse ``[B*H, 1, S]`` in f32, with fully
    masked rows giving O = 0 and lse = -inf.  (float64 inputs, which the
    kernel does not take, are computed in float64 for gradient checks.)"""
    B, S, H, Hkv, D = _check_shapes(q, k, v)
    group = H // Hkv
    acc = _acc_dtype(q)
    qf = q.to(acc).reshape(B, S, Hkv, group, D)
    kf, vf = k.to(acc), v.to(acc)
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


def _check_kernel_inputs(q, k, v):
    """What the CUDA kernels take; returns the shape."""
    B, S, H, Hkv, D = _check_shapes(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    return B, S, H, Hkv, D


def _check_grid(kernel: str, S: int, D: int, dtype: torch.dtype) -> None:
    """Refuse a sequence with more tiles than ``gridDim.y`` takes
    (:data:`MAX_GRID_TILES`; more than 2 M rows).  Batch x heads has no
    cap short of ``gridDim.x``'s 2**31 - 1, which the C side checks."""
    if kernel == KERNEL_NAME:
        rows = _default_blocks(S, D, dtype=dtype)[0]
    else:
        block_q, block_k = _default_blocks(S, D, backward=True,
                                           dtype=dtype)[kernel]
        # A dK/dV block owns block_k kv rows, a dQ block block_q q rows.
        rows = block_k if kernel == "flash_bwd_dkdv" else block_q
    n = -(-S // rows)
    if n > MAX_GRID_TILES:
        raise ValueError(f"{kernel}: S = {S} needs {n} tiles, more than the "
                         f"kernel grid's {MAX_GRID_TILES}")


def _conforms(t: torch.Tensor) -> bool:
    """Whether the tensor-core kernels read ``t`` ([..., D]) in place:
    they copy each row with 16-byte loads into tiles of 8-column bf16
    chunks, so D must be a multiple of 8 with unit stride, every other
    stride a multiple of 16 bytes (8 bf16 or 4 f32 elements) and the base
    16-byte aligned."""
    align = 16 // t.element_size()
    return (t.shape[-1] % 8 == 0 and t.stride(-1) == 1
            and all(st % align == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def tensor_core_operands(*tensors: torch.Tensor):
    """``tensors`` (all [..., D]) as the tensor-core kernels read them.
    Each one that does not conform (:func:`_conforms`: a layout with D not
    innermost, autograd's stride-0 dO, D not a multiple of 8, an unaligned
    base) becomes one contiguous copy, zero-padded in D to the next
    multiple of 8; the others are passed through.  Zero columns add
    nothing to Q K^T or dO V^T and come out as zero columns of O, dK and
    dV, which the caller slices off; the caller keeps the original D's
    scale."""
    D = tensors[0].shape[-1]
    d_pad = -(-D // 8) * 8
    out = []
    for t in tensors:
        if d_pad == D and _conforms(t):
            out.append(t)
            continue
        c = t.new_zeros(*t.shape[:-1], d_pad)
        c[..., :D] = t
        out.append(c)
    return out


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    """``t`` cut back to head dim ``D`` (contiguous, as callers view it)."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        lib.dml_cuda_error_string.restype = ctypes.c_char_p
        lib.dml_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.dml_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _launch(q, k, v, scale: float, causal: bool):
    """The CUDA kernel on ``q``'s device and current stream."""
    B, S, H, Hkv, D = _check_kernel_inputs(q, k, v)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    if B * S * H * D == 0:
        return torch.empty((B, S, H, D), dtype=q.dtype, device=q.device), lse
    q, k, v = tensor_core_operands(q, k, v)
    d_run = q.shape[-1]
    _check_grid(KERNEL_NAME, S, d_run, q.dtype)
    out = torch.empty((B, S, H, d_run), dtype=q.dtype, device=q.device)
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
            lse.data_ptr(), B, S, H, Hkv, d_run,
            *q.stride(), *k.stride(), *v.stride(),
            float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream,
        )
    _raise_on_error(lib, err, KERNEL_NAME)
    launches.add()
    return _unpad(out, D), lse


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None, causal: bool = False,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
    *, with_lse: bool = False,
):
    """Forward only: O, or ``(O, lse)`` with ``with_lse``.

    CUDA tensors run the kernel; CPU tensors run the plain version."""
    s = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    _default_blocks(q.shape[1], q.shape[-1], block_q, block_k, dtype=q.dtype)
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, s, causal)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, s, causal)
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return (out, lse) if with_lse else out


def build_kernels() -> None:
    """Compile (or load) the forward and backward kernels now, both nvcc
    processes at once, instead of at their first launch."""
    from distributed_machine_learning_tpu_torch.ops import _build

    _build.build([KERNEL_NAME, BACKWARD_SOURCE])
    _build.load(KERNEL_NAME)
    _build.load(BACKWARD_SOURCE)


def backward_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, laid out as lse: ``[B*H, 1, S]``."""
    B, S, H, _ = out.shape
    acc = _acc_dtype(out)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)  # [B, S, H]
    return delta.permute(0, 2, 1).reshape(B * H, 1, S)


def center_values(v: torch.Tensor, do: torch.Tensor, delta: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(v - c, delta - dO . c)``, c each (batch, kv head)'s mean value
    row over the sequence: ``dS = P (dO v^T - delta)`` is the same for
    any c.  The f32 kernels take ``dO v^T`` as split bf16 products, each
    rounded to about 2**-16 of ``|dO| |v|``.  Trained value rows share a
    large common part, rounded differently in every row, while dS keeps
    only what differs from row to row; centered, the rounding scales with
    the differences (PERF.md §6: on an H100 the f32 dQ of a trained
    population step read 3.7e-4 of its largest entry uncentered and
    4.8e-5 centered)."""
    B, S, Hkv, D = v.shape
    H = do.shape[2]
    c = v.mean(dim=1, keepdim=True)
    dc = (do.reshape(B, S, Hkv, H // Hkv, D) * c.unsqueeze(3)).sum(-1)
    return v - c, delta - dc.reshape(B, S, H).permute(0, 2, 1).reshape(
        delta.shape)


def _recompute_reference(q, k, v, lse, do, delta, scale: float,
                         causal: bool):
    """``_bwd_recompute`` written densely, in the accumulation type:
    returns (q, k, dO) as [B, S, Hkv, group, D] / [B, S, Hkv, D] and P, dS
    as [B, Hkv, group, S_q, S_k]."""
    B, S, H, Hkv, D = _check_shapes(q, k, v)
    group = H // Hkv
    acc = _acc_dtype(q)
    qf = q.to(acc).reshape(B, S, Hkv, group, D)
    dof = do.to(acc).reshape(B, S, Hkv, group, D)
    kf, vf = k.to(acc), v.to(acc)
    rows = lambda t: t.to(acc).reshape(B, Hkv, group, S, 1)  # noqa: E731
    lse_r, delta_r = rows(lse), rows(delta)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    live = torch.isfinite(logits) & torch.isfinite(lse_r)
    lse_safe = torch.where(torch.isfinite(lse_r), lse_r,
                           torch.zeros_like(lse_r))
    p = torch.where(live, torch.exp(logits - lse_safe), torch.zeros_like(logits))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta_r) * scale
    return qf, kf, dof, p, ds


def flash_bwd_dkdv_reference(q, k, v, lse, do, delta, scale: float,
                             causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel dkdv: dV = P^T dO and dK = dS^T q, the q
    heads of a group summed into their kv head; in k's and v's dtypes."""
    qf, _, dof, p, ds = _recompute_reference(q, k, v, lse, do, delta, scale,
                                             causal)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, lse, do, delta, scale: float,
                           causal: bool) -> torch.Tensor:
    """Plain version of kernel dq: dQ = dS k, in q's dtype."""
    _, kf, _, _, ds = _recompute_reference(q, k, v, lse, do, delta, scale,
                                           causal)
    return torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape) \
        .to(q.dtype)


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, delta: torch.Tensor, scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash backward: ``(dq, dk, dv)``.

    ``_bwd_recompute``'s math written densely: P = exp(q k^T * scale - lse)
    in f32 with causal and fully masked (lse = -inf) entries at 0,
    dS = P * (dO v^T - delta) * scale, then the two kernels' products."""
    dk, dv = flash_bwd_dkdv_reference(q, k, v, lse, do, delta, scale, causal)
    dq = flash_bwd_dq_reference(q, k, v, lse, do, delta, scale, causal)
    return dq, dk, dv


_BWD_TAIL = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check_dout(q, do) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"dout {tuple(do.shape)}/{do.dtype} must match q "
            f"{tuple(q.shape)}/{q.dtype} on one device"
        )


def _launch_bwd(fn_name: str, counter: LaunchCounter, q, k, v, lse, do,
                delta, scale: float, causal: bool, outs):
    """One backward kernel on ``q``'s device and current stream, writing
    into ``outs`` (allocated by the caller)."""
    B, S, H, Hkv, D = _check_kernel_inputs(q, k, v)
    _check_dout(q, do)
    if B * S * H * D == 0:
        return
    _check_grid(counter.name, S, D, q.dtype)
    # [B*H, S] f32 rows, contiguous, as the kernels index them.
    lse = lse.to(torch.float32).reshape(B * H, S).contiguous()
    delta = delta.to(torch.float32).reshape(B * H, S).contiguous()
    from distributed_machine_learning_tpu_torch.ops import _build

    lib = _build.load(BACKWARD_SOURCE)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (6 + len(outs)) + _BWD_TAIL
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *do.stride()
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            B, S, H, Hkv, D, ctypes.addressof(strides), float(scale),
            int(bool(causal)), int(q.dtype == torch.bfloat16), stream,
        )
    _raise_on_error(lib, err, counter.name)
    counter.add()


def _on_device(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def flash_bwd_dkdv(q, k, v, lse, do, delta, scale: float,
                   causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel dkdv: ``(dk, dv)`` at Hkv heads.  ``delta`` is
    :func:`backward_delta`.  CUDA tensors run the kernel; CPU tensors run
    the plain version."""
    if _on_device(q) == "cpu":
        return flash_bwd_dkdv_reference(q, k, v, lse, do, delta, scale, causal)
    _check_kernel_inputs(q, k, v)
    _check_dout(q, do)
    D = k.shape[-1]
    q, k, v, do = tensor_core_operands(q, k, v, do)
    # Contiguous, as the kernel writes them (empty_like would keep a
    # permuted layout of k).
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dml_flash_bwd_dkdv", dkdv_launches, q, k, v, lse, do, delta,
                scale, causal, (dk, dv))
    return _unpad(dk, D), _unpad(dv, D)


def flash_bwd_dq(q, k, v, lse, do, delta, scale: float,
                 causal: bool) -> torch.Tensor:
    """Kernel dq: ``dq``.  ``delta`` is :func:`backward_delta`.  CUDA
    tensors run the kernel; CPU tensors run the plain version."""
    if _on_device(q) == "cpu":
        return flash_bwd_dq_reference(q, k, v, lse, do, delta, scale, causal)
    _check_kernel_inputs(q, k, v)
    _check_dout(q, do)
    D = q.shape[-1]
    q, k, v, do = tensor_core_operands(q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dml_flash_bwd_dq", dq_launches, q, k, v, lse, do, delta,
                scale, causal, (dq,))
    return _unpad(dq, D)


def flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    out: Optional[torch.Tensor], lse: torch.Tensor, do: Optional[torch.Tensor],
    scale: Optional[float] = None, causal: bool = False,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
    *, q_side: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of flash attention; dk/dv at Hkv heads.
    The dK/dV kernel runs first, then the dQ kernel, as in
    ``_flash_backward``.  On the card both read one conforming copy
    (:func:`tensor_core_operands`) of whatever input needs one, such as
    autograd's stride-0 dO; in f32 they take V and delta centered
    (:func:`center_values`).

    ``q_side``: optional precomputed ``(q, do, delta)`` (delta from
    :func:`backward_delta`), as in the JAX package's ``_flash_backward``:
    a caller that runs the backward per k/v chunk against the same q side
    reduces delta once; ``out`` and ``do`` may then be None."""
    if q_side is not None:
        q, do, delta = q_side
    else:
        _on_device(q)
        delta = backward_delta(out, do)
    s = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    D = q.shape[-1]
    _default_blocks(q.shape[1], D, block_q, block_k, backward=True,
                    dtype=q.dtype)
    if _on_device(q) == "cuda":
        q, k, v, do = tensor_core_operands(q, k, v, do)
        if q.dtype == torch.float32 and v.numel():
            v, delta = center_values(v, do, delta)
    dk, dv = flash_bwd_dkdv(q, k, v, lse, do, delta, s, causal)
    dq = flash_bwd_dq(q, k, v, lse, do, delta, s, causal)
    return _unpad(dq, D), _unpad(dk, D), _unpad(dv, D)


def _fold(info, in_dims, tensors):
    """The vmapped arguments of a flash call with the population axis
    folded into the batch: each batched tensor's vmapped dim moved to 0,
    each unbatched one expanded to ``info.batch_size`` rows, then
    ``[K, B, ...]`` -> ``[K*B, ...]``."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = (t.expand(info.batch_size, *t.shape) if d is None
             else t.movedim(d, 0))
        out.append(t.reshape(-1, *t.shape[2:]))
    return out


class _FlashForward(torch.autograd.Function):
    """``(out, lse)`` of :func:`flash_forward`; differentiable in q, k, v
    through :class:`_FlashBackward`.  The ``setup_context`` form and the
    ``vmap`` rule make it work under ``torch.func`` (``vmap``, ``grad``,
    ``vmap(grad(...))``), and a ``vmap`` of K rows runs as ONE kernel
    launch on the folded batch of K*B, not K launches."""

    @staticmethod
    def forward(q, k, v, scale, causal, block_q, block_k):
        return flash_forward(q, k, v, scale, causal, block_q, block_k,
                             with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, causal, block_q, block_k = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, block_q, block_k)
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, grad_out, _grad_lse):
        if grad_out is None:
            return (None,) * 7
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBackward.apply(q, k, v, out, lse, grad_out,
                                          *ctx.args)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, causal, block_q, block_k):
        K = info.batch_size
        qf, kf, vf = _fold(info, in_dims[:3], (q, k, v))
        out, lse = _FlashForward.apply(qf, kf, vf, scale, causal, block_q,
                                       block_k)
        # lse rows are b*H + h; folded, (k*B + b)*H + h = k*(B*H) + b*H + h.
        return ((out.reshape(K, -1, *out.shape[1:]),
                 lse.reshape(K, -1, *lse.shape[1:])), (0, 0))


class _FlashBackward(torch.autograd.Function):
    """``(dq, dk, dv)`` of :func:`flash_backward`, as a Function of its
    own so that the backward too has a ``vmap`` rule: under
    ``vmap(grad(...))`` autograd hands the backward batched tensors, which
    the kernels' ctypes launch cannot take, and the rule folds them as
    the forward's does."""

    @staticmethod
    def forward(q, k, v, out, lse, do, scale, causal, block_q, block_k):
        return flash_backward(q, k, v, out, lse, do, scale, causal, block_q,
                              block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, do, scale, causal, block_q,
             block_k):
        K = info.batch_size
        qf, kf, vf, of, lsef, dof = _fold(info, in_dims[:6],
                                          (q, k, v, out, lse, do))
        grads = _FlashBackward.apply(qf, kf, vf, of, lsef, dof, scale,
                                     causal, block_q, block_k)
        return tuple(g.reshape(K, -1, *g.shape[1:]) for g in grads), (0, 0, 0)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None, causal: bool = False,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash softmax attention. q: [B, S, H, D] -> [B, S, H, D].

    k, v: [B, S, Hkv, D] with ``H % Hkv == 0``.  ``scale`` defaults to
    1/sqrt(D).  Differentiable: the backward runs the dK/dV and dQ kernels
    (:func:`flash_backward`).  Works under ``torch.func`` transforms; a
    ``vmap`` over K rows folds them into the batch of one launch.

    Why ``autograd.Function`` with ``setup_context`` and ``vmap`` rules
    rather than ``torch.library.custom_op``: the forward and backward stay
    plain Python around the ctypes launch (no operator schema to register
    once per process, no fake-tensor kernel to keep in step), and a plain
    call runs exactly the launches it ran before."""
    if (block_q is not None or block_k is not None) and \
            torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
        # Refuse a tile the backward is not compiled for now, not after
        # the forward has run.
        _default_blocks(q.shape[1], q.shape[-1], block_q, block_k,
                        backward=True, dtype=q.dtype)
    return _FlashForward.apply(q, k, v, scale, causal, block_q, block_k)[0]
