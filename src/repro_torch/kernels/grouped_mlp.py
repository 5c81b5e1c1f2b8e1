"""Grouped-GEMM expert FFN over the sorted ragged token buffer: layout
helpers and the CUDA kernel wrapper (port of
``repro/kernels/grouped_mlp.py``; kernel in ``csrc/grouped_mlp.cu``).

Layout contract (shared with core/moe.py): tokens arrive as an
expert-sorted stream ``xs (G, M, d)`` in which expert e's valid rows
occupy one contiguous segment, padded to a multiple of the row block
``bm`` and holding at least one block (an empty expert still owns one
block); padded and tail rows are zero. ``M = (ceil(N/bm) + E) * bm``
for N assignments, independent of the capacity factor.

The kernel's row block is :data:`ROW_BLOCK`; results do not depend on
it, so the port lays the buffer out at the kernel's tile.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel

ROW_BLOCK = 16  # rows per CUDA thread block (BM in csrc/grouped_mlp.cu)
_ACTS = {"silu": 0, "gelu": 1}
SMEM_OPTIN = 232_448  # dynamic shared memory a block may opt into, sm_90

KERNEL = Kernel(
    "grouped_mlp", "grouped_mlp",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)


# ---------------------------------------------------------------------------
# ragged layout helpers (the contract between core/moe.py and the kernel)
# ---------------------------------------------------------------------------


def ragged_buffer_rows(n_assignments: int, num_experts: int, bm: int) -> int:
    """Static row count M of the block-aligned ragged buffer."""
    return (-(-n_assignments // bm) + num_experts) * bm


def _ceil_div(x, bm: int):
    return (x + bm - 1) // bm


def ragged_row_offsets(group_sizes: torch.Tensor, bm: int):
    """group_sizes (..., E) -> (row_off (..., E+1), valid_off (..., E+1)):
    aligned segment starts and cumulative valid counts."""
    blocks = torch.clamp(_ceil_div(group_sizes, bm), min=1)
    zero = torch.zeros_like(group_sizes[..., :1])
    row_off = torch.cat([zero, torch.cumsum(blocks * bm, -1)], -1)
    valid_off = torch.cat([zero, torch.cumsum(group_sizes, -1)], -1)
    return row_off, valid_off


def ragged_destinations(key: torch.Tensor, num_experts: int, block: int):
    """Stable-sort each row of ``key (G, N)`` (expert id per assignment,
    ``num_experts`` marking invalid ones) and compute every assignment's
    destination row in the block-aligned ragged buffer.

    Returns ``(perm, key_s, counts, dest, M)`` exactly as the reference:
    the sort permutation, sorted keys, per-expert valid counts (G, E),
    destination rows in sorted order (M = trash row for invalid
    assignments) and the static row count.
    """
    G, N = key.shape
    key_s, perm = torch.sort(key, dim=1, stable=True)
    experts = torch.arange(num_experts, device=key.device)
    counts = (key_s[..., None] == experts).sum(1).to(torch.int32)
    M = ragged_buffer_rows(N, num_experts, block)
    row_off, valid_off = ragged_row_offsets(counts, block)
    k = key_s.long()
    iota = torch.arange(N, device=key.device, dtype=torch.int32)[None]
    rank = iota - torch.gather(valid_off, 1, k)
    dest = torch.where(key_s < num_experts,
                       torch.gather(row_off, 1, k) + rank,
                       torch.full_like(rank, M))
    return perm, key_s, counts, dest, M


def block_tables(group_sizes: torch.Tensor, bm: int, nb: int):
    """(block_expert (G, nb) int32 — owner of row-block m, tail blocks
    clamped to E-1; block_live (G, nb) int32 — 1 iff the block holds at
    least one valid row)."""
    G, E = group_sizes.shape
    blocks = torch.clamp(_ceil_div(group_sizes, bm), min=1)
    live_blocks = _ceil_div(group_sizes, bm)
    bend = torch.cumsum(blocks, -1)
    b = torch.arange(nb, device=group_sizes.device)
    be = (b[None, :, None] >= bend[:, None, :]).sum(-1)
    be = torch.clamp(be, max=E - 1)
    bstart = torch.cat([torch.zeros_like(bend[:, :1]), bend[:, :-1]], -1)
    rel = b[None, :] - torch.gather(bstart, 1, be)
    bl = rel < torch.gather(live_blocks, 1, be)
    return be.to(torch.int32), bl.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def grouped_mlp_cuda(xs, wi, wg, wo, group_sizes, *, act: str = "silu",
                     block: int = ROW_BLOCK):
    """xs: (G, M, d) expert-sorted block-aligned rows -> (G, M, d), on
    the card. wi/wg: (E, d, f) (wg may be None), wo: (E, f, d); all of
    xs' dtype (float32 or bfloat16); group_sizes (G, E) valid rows per
    expert. The kernel walks row blocks of :data:`ROW_BLOCK` rows, so
    the buffer must be laid out at that block."""
    if block != ROW_BLOCK:
        raise ValueError(
            f"the CUDA grouped MLP walks {ROW_BLOCK}-row blocks; lay the "
            f"ragged buffer out with block={ROW_BLOCK} (got {block})"
        )
    if act not in _ACTS:
        raise ValueError(f"grouped MLP kernel: unsupported act {act!r}")
    G, M, d = xs.shape
    E, _, f = wi.shape
    ws = [w for w in (wi, wg, wo) if w is not None]
    for t in (xs, *ws, group_sizes):
        if not t.is_cuda or t.device != xs.device:
            raise ValueError("grouped MLP kernel: every input must be a "
                             "CUDA tensor on one device")
        if not t.is_contiguous():
            raise ValueError("grouped MLP kernel: inputs must be "
                             "contiguous")
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grouped MLP kernel: dtype {xs.dtype} not "
                         "supported (float32, bfloat16)")
    if any(w.dtype != xs.dtype for w in ws):
        raise ValueError("grouped MLP kernel: weights must share xs' dtype")
    if (wi.shape != (E, d, f) or wo.shape != (E, f, d)
            or (wg is not None and wg.shape != (E, d, f))
            or group_sizes.shape != (G, E)):
        raise ValueError(
            f"grouped MLP kernel: shapes xs {tuple(xs.shape)}, wi "
            f"{tuple(wi.shape)}, wo {tuple(wo.shape)}, group_sizes "
            f"{tuple(group_sizes.shape)} disagree"
        )
    if M % block:
        raise ValueError(f"ragged rows ({M}) must be a multiple of {block}")
    smem = ROW_BLOCK * (d + f) * 4  # x tile + hidden tile, f32
    if smem > SMEM_OPTIN:
        raise ValueError(
            f"grouped MLP kernel: d + f = {d + f} needs {smem} bytes of "
            f"shared memory per block; sm_90 allows {SMEM_OPTIN}"
        )
    out = torch.empty_like(xs)
    nb = M // block
    if G * nb == 0:
        return out
    be, bl = block_tables(group_sizes, block, nb)
    KERNEL.launch(
        xs.data_ptr(), wi.data_ptr(),
        wg.data_ptr() if wg is not None else None,
        wo.data_ptr(), be.data_ptr(), bl.data_ptr(), out.data_ptr(),
        G, M, d, f, E, _ACTS[act], int(xs.dtype == torch.bfloat16),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    return out
