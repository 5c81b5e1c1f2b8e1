"""Dense GQA flash attention, forward and backward: the CUDA kernel
wrappers (port of ``repro/kernels/flash_attention.py``; kernels in
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``).

The forward returns the output and the per-row log-sum-exp ``lse``
(B, H, Sq), +inf for a row with no valid key; the backward recomputes
each probability tile from (q, k, lse) and takes ``delta = rowsum(dO *
O)`` computed here, outside the kernels, as the reference does.
``q_offset`` and ``kv_len`` are int32 scalars in device memory.

All three kernels run their products on tensor cores (``csrc/mma_sm90.cuh``;
float32 as 3xTF32) but for the float32 scores S and the backward's dP =
dO Vᵀ, which are f32 FMAs on CUDA cores (at the score sizes of a
randomly initialised model the tensor cores' sums left the float32
tolerance), and take head dims ``HEAD_DIMS`` and 16-byte aligned
inputs. A forward block holds ``FWD_ROWS`` query rows of whole GQA
groups, so the forward takes groups of up to 64 heads. The backward
kernels see a kv head's queries as one run of Sq * G rows (position x
head): dq takes 64 rows a block against 32-key tiles; dk/dv takes 64
keys a block against q tiles of 32 rows, summing the group inside the
block; so they take any group.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel

FWD_ROWS = 64  # query rows (position x head) of a forward block
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are built for

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("flash_attention", "flash_attention_fwd",
                [_P] * 7 + [_I] * 9 + [_P])
KERNEL_DQ = Kernel("flash_attention_dq", "flash_attention_dq",
                   [_P] * 9 + [_I] * 8 + [_P], source="flash_attention_bwd")
KERNEL_DKV = Kernel("flash_attention_dkv", "flash_attention_dkv",
                    [_P] * 10 + [_I] * 8 + [_P],
                    source="flash_attention_bwd")


def pick_fwd_q_tile(group: int, dh: int, *,
                    name: str = "flash attention kernel") -> int:
    """Query positions per forward block (the paged prefill tiles its
    chunk rows the same way): its FWD_ROWS rows hold whole GQA groups of
    ``group`` heads."""
    if group > FWD_ROWS or dh not in HEAD_DIMS:
        raise ValueError(f"{name}: GQA group {group} > "
                         f"{FWD_ROWS} or head_dim {dh} not in "
                         f"{HEAD_DIMS}")
    return FWD_ROWS // group


def scalar_i32(x, device) -> torch.Tensor:
    """``q_offset`` / ``kv_len`` as a (1,) int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([int(x)], dtype=torch.int32, device=device)


def _check(name, q, k, v, *rest):
    B, Sq, H, dh = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if v.shape != k.shape or H % k.shape[2]:
        raise ValueError(f"{name}: v {tuple(v.shape)} must match k and "
                         f"H {H} be a multiple of Kh {k.shape[2]}")
    for t in (q, k, v, *rest):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor "
                             "on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share a dtype")


def flash_attention_fwd_cuda(q, k, v, q_offset, kv_len, *, causal: bool):
    """q (B, Sq, H, dh), k/v (B, Skv, Kh, dh); q_offset, kv_len (1,)
    int32 on the card. Returns (o (B, Sq, H, dh) in q's dtype,
    lse (B, H, Sq) float32)."""
    _check("flash attention kernel", q, k, v, q_offset, kv_len)
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    bq = pick_fwd_q_tile(H // Kh, dh)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention kernel: q, k and v must be "
                         "16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B * Sq * H == 0:
        return o, lse
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Sq, Skv, H, Kh, dh, bq, int(causal),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta, q_offset, kv_len):
    """The backward kernels' inputs: as the forward's, plus ``do`` like
    q, lse and delta float32 (B, H, Sq), a head dim in HEAD_DIMS and
    q, k, v, do 16-byte aligned. Any GQA group is taken."""
    _check(name, q, k, v, do, lse, delta, q_offset, kv_len)
    B, Sq, H, dh = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.shape != (B, H, Sq):
            raise ValueError(f"{name}: lse and delta must be float32 "
                             f"(B, H, Sq) = {(B, H, Sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError(f"{name}: q, k, v and do must be 16-byte aligned")


def attention_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) as (B, H, Sq) float32: elementwise, taken
    outside the backward kernels as the reference does."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_dq_cuda(q, k, v, do, lse, delta, q_offset, kv_len, *,
                            causal: bool):
    """dq of :func:`flash_attention_fwd_cuda` for the output cotangent
    ``do``, given its ``lse`` and ``delta`` (B, H, Sq) float32: one
    block per 64 rows of a kv head's run, walking its live 32-key
    tiles."""
    _check_bwd("flash attention dq kernel", q, k, v, do, lse, delta,
               q_offset, kv_len)
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if B * Sq * H == 0 or Skv == 0:
        return dq.zero_()
    KERNEL_DQ.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), dq.data_ptr(), B, Sq, Skv, H, Kh, dh,
        int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, q_offset, kv_len, *,
                             causal: bool):
    """(dk, dv) of :func:`flash_attention_fwd_cuda`, each summed over its
    kv head's query heads inside the kernel: one block per 64 keys,
    walking the q tiles that see them."""
    _check_bwd("flash attention dk/dv kernel", q, k, v, do, lse, delta,
               q_offset, kv_len)
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B * Sq * H == 0 or Skv == 0:
        return dk.zero_(), dv.zero_()
    KERNEL_DKV.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, Kh,
        dh, int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, o, lse, do, q_offset, kv_len, *,
                             causal: bool):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd_cuda` for the
    output cotangent ``do``: delta outside, then the dq and dk/dv
    kernels."""
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, q_offset, kv_len)
    dq = flash_attention_dq_cuda(*args, causal=causal)
    dk, dv = flash_attention_dkv_cuda(*args, causal=causal)
    return dq, dk, dv
