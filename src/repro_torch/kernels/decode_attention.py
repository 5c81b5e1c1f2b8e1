"""Paged GQA single-query flash-decode: the CUDA kernel wrapper (port of
``repro/kernels/decode_attention.py``; kernel in
``csrc/decode_attention.cu``).

Each (slot, kv head) walk over only the slot's ``ceil(length / bs)``
live table entries is split into runs of pool blocks, one thread block
a run (:func:`pick_splits`), whose partial softmax sums a second launch
combines in a fixed order (flash-decoding). Within a run four warps read
pool blocks in turn as 16-byte chunks, scores and P V as float32 FMAs
with an online softmax; a slot of length 0 gives exact zeros. Query head
h reads kv head h // (H / Kh); GQA groups up to ``MAX_GROUP``, head dims
``flash_attention.HEAD_DIMS``, as the paged prefill takes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.flash_attention import HEAD_DIMS

MAX_GROUP = 64  # GQA group (H / Kh) the kernel takes
WARPS = 4       # pool blocks a kernel block reads at once

KERNEL = Kernel(
    "decode_attention", "paged_decode_attention",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SMs; on the meta device (the dry run) the H100 SXM's
    (``launch/mesh.SM_COUNT``), whose split walks it allocates for."""
    if device.type == "meta":
        from repro_torch.launch.mesh import SM_COUNT

        return SM_COUNT
    return torch.cuda.get_device_properties(device).multi_processor_count


def pick_splits(walks: int, nb: int, sms: int) -> int:
    """Runs to cut each walk into (``walks`` = slots x kv heads x query
    head tiles): enough blocks for four an SM, and at least ``WARPS``
    pool blocks a run at the tables' capacity of ``nb`` entries."""
    return max(1, min(-(-4 * sms // walks), nb // WARPS))


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


def buffers(q, k_pool, nb: int, splits: int | None = None):
    """The wrapper's buffers, in the order it allocates them: (out like
    ``q``, the float32 split partials (None for one run), the runs a
    walk: :func:`pick_splits`'s unless given; 0 for no slot, which
    launches nothing)."""
    B, H, dh = q.shape
    Kh = k_pool.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out, None, 0
    if splits is None:
        tiles = -(-(H // Kh) // (32 * k_pool.element_size() // 16))
        splits = pick_splits(B * Kh * tiles, nb, sm_count(q.device))
    part = (torch.empty(splits * B * H * (dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    return out, part, splits


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                                *, splits: int | None = None):
    """q: (B, H, dh); pools: (P, bs, Kh, dh), 16-byte aligned;
    block_tables: (B, nb) int32; lengths: (B,) int32 valid tokens per
    slot. ``splits``: runs of each walk (default :func:`pick_splits`'s).
    Returns (B, H, dh) in q's dtype."""
    B, H, dh = q.shape
    P, bs, Kh, _ = k_pool.shape
    name = "decode attention kernel"
    if H % Kh or H // Kh > MAX_GROUP or dh not in HEAD_DIMS:
        raise ValueError(f"{name}: {H} heads over {Kh} kv heads (GQA group "
                         f"at most {MAX_GROUP}) of head_dim {dh} (one of "
                         f"{HEAD_DIMS}) not supported")
    check_paged_inputs(name, q, k_pool, v_pool, block_tables, (lengths,))
    nb = block_tables.shape[1]
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"{name}: tables/lengths must have one row per "
                         "slot")
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError(f"{name}: the pools must be 16-byte aligned")
    out, part, splits = buffers(q, k_pool, nb, splits)
    if splits == 0:
        return out
    KERNEL.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        B, H, Kh, dh, bs, nb, splits,
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
        work=lambda: tiling.decode_work(
            B, H, Kh, dh, bs, lengths, itemsize=q.element_size(),
            kv_itemsize=k_pool.element_size()),
    )
    return out


def paged_decode_attention_meta(q, k_pool, v_pool, block_tables, lengths):
    """:func:`paged_decode_attention_cuda` on the meta device: its
    buffers (:func:`buffers`, the partials dropped at return) and the
    work of slots whose lengths fill their tables (the lengths are
    unknown there). Returns the output (empty, of its shape and
    dtype)."""
    B, H, dh = q.shape
    bs, Kh = k_pool.shape[1], k_pool.shape[2]
    out, part, splits = buffers(q, k_pool, block_tables.shape[1])
    full = [block_tables.shape[1] * bs] * B
    if splits:
        KERNEL.record(lambda: tiling.decode_work(
            B, H, Kh, dh, bs, full, itemsize=q.element_size(),
            kv_itemsize=k_pool.element_size()))
    return out
