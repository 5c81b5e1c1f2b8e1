"""Paged chunked-prefill attention: the CUDA kernel wrapper (port of
``repro/kernels/paged_prefill.py``; kernel in ``csrc/paged_prefill.cu``).

One thread block per (chunk lane, kv head, q tile): row i of lane c
attends pool positions ``<= starts[c] + i``, the block walk stops at the
tile's causal limit, and rows ``i >= lens[c]`` are exact zeros. The
chunk's own k/v are already in the pool when it runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.decode_attention import check_paged_inputs

TILE_ROWS = 2048  # bq * G * dh the kernel's per-thread accumulators hold

KERNEL = Kernel(
    "paged_prefill", "paged_prefill_attention",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)


def pick_q_tile(chunk_tokens: int, group_dim: int) -> int:
    """Largest power-of-two divisor of the chunk length whose tile of
    ``bq * group_dim`` (group_dim = G * dh) values fits the kernel's
    accumulators."""
    if chunk_tokens <= 0:
        raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
    bq = chunk_tokens & -chunk_tokens
    while bq > 1 and bq * group_dim > TILE_ROWS:
        bq //= 2
    if bq * group_dim > TILE_ROWS:
        raise ValueError(f"paged prefill kernel: GQA group x head_dim "
                         f"{group_dim} exceeds {TILE_ROWS}")
    return bq


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_tables, starts,
                                 lens):
    """q: (NC, C, H, dh); pools: (P, bs, Kh, dh) with the chunks' k/v
    already written; block_tables: (NC, nb) int32; starts/lens: (NC,)
    int32. Returns (NC, C, H, dh) in q's dtype."""
    NC, C, H, dh = q.shape
    P, bs, Kh, _ = k_pool.shape
    check_paged_inputs("paged prefill kernel", q, k_pool, v_pool,
                       block_tables, (starts, lens))
    nb = block_tables.shape[1]
    if (block_tables.shape[0] != NC or starts.shape != (NC,)
            or lens.shape != (NC,)):
        raise ValueError("paged prefill kernel: tables/starts/lens must "
                         "have one row per chunk lane")
    bq = pick_q_tile(C, (H // Kh) * dh)
    out = torch.empty_like(q)
    if NC * C == 0:
        return out
    KERNEL.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
        out.data_ptr(),
        NC, C, H, Kh, dh, bs, nb, bq,
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out
