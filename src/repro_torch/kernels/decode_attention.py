"""Paged GQA single-query flash-decode: the CUDA kernel wrapper (port of
``repro/kernels/decode_attention.py``; kernel in
``csrc/decode_attention.cu``).

One thread block per (slot, kv head) walks only the slot's
``ceil(length / bs)`` live table entries with an online softmax; a slot
of length 0 gives exact zeros. Query head h reads kv head h // (H / Kh).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel

MAX_GROUP_DIM = 512  # G * dh the kernel's per-thread accumulators hold

KERNEL = Kernel(
    "decode_attention", "paged_decode_attention",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)


def check_paged_inputs(name, q, k_pool, v_pool, tables, int_args):
    """Shared wrapper checks of the two paged attention kernels."""
    for t in (q, k_pool, v_pool, tables, *int_args):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor "
                             "on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (tables, *int_args):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: tables/lengths must be int32")
    ok = (torch.float32, torch.bfloat16)
    if q.dtype not in ok or k_pool.dtype not in ok:
        raise ValueError(f"{name}: q and pools must be float32 or bfloat16")
    if v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: k and v pools must match")
    H, dh = q.shape[-2:]
    P, bs, Kh, dh_kv = k_pool.shape
    if dh != dh_kv or H % Kh:
        raise ValueError(f"{name}: q heads {H}x{dh} do not fit pools "
                         f"{tuple(k_pool.shape)}")


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, lengths):
    """q: (B, H, dh); pools: (P, bs, Kh, dh); block_tables: (B, nb)
    int32; lengths: (B,) int32 valid tokens per slot. Returns (B, H, dh)
    in q's dtype."""
    B, H, dh = q.shape
    P, bs, Kh, _ = k_pool.shape
    check_paged_inputs("decode attention kernel", q, k_pool, v_pool,
                       block_tables, (lengths,))
    if (H // Kh) * dh > MAX_GROUP_DIM:
        raise ValueError(f"decode attention kernel: GQA group x head_dim "
                         f"{(H // Kh) * dh} exceeds {MAX_GROUP_DIM}")
    nb = block_tables.shape[1]
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("decode attention kernel: tables/lengths must "
                         "have one row per slot")
    out = torch.empty_like(q)
    if B == 0:
        return out
    KERNEL.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, Kh, dh, bs, nb,
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out
