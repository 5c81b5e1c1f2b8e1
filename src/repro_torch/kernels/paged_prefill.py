"""Paged chunked-prefill attention: the CUDA kernel wrapper (port of
``repro/kernels/paged_prefill.py``; kernel in ``csrc/paged_prefill.cu``).

One thread block per (chunk lane, kv head, q tile of 64 // G chunk rows,
as the flash forward tiles its rows): row i of lane c attends pool
positions ``<= starts[c] + i``, the block walk stops at the tile's
causal limit, and rows ``i >= lens[c]`` are exact zeros. The chunk's own
k/v are already in the pool when it runs. P V on tensor cores (float32
as 3xTF32); the scores on tensor cores for a bfloat16 output and as
float32 FMAs for a float32 one (``csrc/flash_tile.cuh``); head dims and
GQA groups as the flash forward's.
When those blocks would leave SMs idle, each walk is split over several
blocks (:func:`pick_splits`) whose partial sums a second launch combines.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.decode_attention import (
    check_paged_inputs,
    sm_count,
)
from repro_torch.kernels.flash_attention import pick_fwd_q_tile

KERNEL = Kernel(
    "paged_prefill", "paged_prefill_attention",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)
KV_TILE = 32  # keys a kernel block stages at a time


def pick_splits(blocks: int, kv_tiles: int, sms: int) -> int:
    """Runs to cut each block's kv walk into: enough blocks to give every
    SM one, and at least two ``KV_TILE``-key tiles a run at the tables'
    capacity of ``kv_tiles`` tiles."""
    return max(1, min(-(-sms // blocks), kv_tiles // 2))


def buffers(q, k_pool, nb: int, splits: int | None = None):
    """The wrapper's buffers, in the order it allocates them: (out like
    ``q``, the float32 split partials (None for one run), the q tile,
    the runs a walk: :func:`pick_splits`'s unless given; 0 for no rows,
    which launches nothing)."""
    NC, C, H, dh = q.shape
    bs, Kh = k_pool.shape[1], k_pool.shape[2]
    bq = pick_fwd_q_tile(H // Kh, dh, name="paged prefill kernel")
    out = torch.empty_like(q)
    if NC * C == 0:
        return out, None, bq, 0
    if splits is None:
        splits = pick_splits(-(-C // bq) * Kh * NC, -(-nb * bs // KV_TILE),
                             sm_count(q.device))
    part = (torch.empty(splits * NC * C * H * (dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    return out, part, bq, splits


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_tables, starts,
                                 lens, *, splits: int | None = None):
    """q: (NC, C, H, dh); pools: (P, bs, Kh, dh) with the chunks' k/v
    already written; block_tables: (NC, nb) int32; starts/lens: (NC,)
    int32; q and the pools 16-byte aligned. ``splits``: runs of each
    kv walk (default :func:`pick_splits`'s). Returns (NC, C, H, dh) in
    q's dtype."""
    NC, C, H, dh = q.shape
    P, bs, Kh, _ = k_pool.shape
    check_paged_inputs("paged prefill kernel", q, k_pool, v_pool,
                       block_tables, (starts, lens))
    nb = block_tables.shape[1]
    if (block_tables.shape[0] != NC or starts.shape != (NC,)
            or lens.shape != (NC,)):
        raise ValueError("paged prefill kernel: tables/starts/lens must "
                         "have one row per chunk lane")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged prefill kernel: q and the pools must be "
                         "16-byte aligned")
    out, part, bq, splits = buffers(q, k_pool, nb, splits)
    if splits == 0:
        return out
    KERNEL.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        NC, C, H, Kh, dh, bs, nb, bq, splits,
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
        work=lambda: tiling.prefill_work(
            NC, C, H, Kh, dh, bs, P, block_tables, starts, lens,
            itemsize=q.element_size(), kv_itemsize=k_pool.element_size()),
    )
    return out


def paged_prefill_attention_meta(q, k_pool, v_pool, block_tables, starts,
                                 lens):
    """:func:`paged_prefill_attention_cuda` on the meta device: its
    buffers (:func:`buffers`, the partials dropped at return) and the
    work of full lanes ending at their tables' capacity over distinct
    blocks (the starts, lengths and tables are unknown there). Returns
    the output (empty, of its shape and dtype)."""
    NC, C, H, dh = q.shape
    bs, Kh = k_pool.shape[1], k_pool.shape[2]
    nb = block_tables.shape[1]
    out, part, _, splits = buffers(q, k_pool, nb)
    if splits:
        KERNEL.record(lambda: tiling.prefill_work(
            NC, C, H, Kh, dh, bs, NC * nb,
            torch.arange(NC * nb).reshape(NC, nb),
            [max(nb * bs - C, 0)] * NC, [min(C, nb * bs)] * NC,
            itemsize=q.element_size(), kv_itemsize=k_pool.element_size()))
    return out
