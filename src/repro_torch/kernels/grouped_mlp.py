"""Grouped-GEMM expert FFN over the sorted ragged token buffer: layout
helpers and the CUDA kernel wrappers (port of
``repro/kernels/grouped_mlp.py``; forward kernel in
``csrc/grouped_mlp.cu``, the dx and dW kernels in
``csrc/grouped_mlp_bwd.cu``; all three run on the tensor-core GEMM of
``csrc/expert_gemm.cuh``).

Layout contract (shared with core/moe.py): tokens arrive as an
expert-sorted stream ``xs (G, M, d)`` in which expert e's valid rows
occupy one contiguous segment, padded to a multiple of the row block
``bm`` and holding at least one block (an empty expert still owns one
block); padded and tail rows are zero. ``M = (ceil(N/bm) + E) * bm``
for N assignments, independent of the capacity factor.

The layout block is :data:`ROW_BLOCK` (16 rows). The kernels' row tile
is another thing: a thread block covers up to ``bm / 16`` consecutive
live blocks of one segment (:func:`row_tile` picks ``bm`` in 16, 64 or
128 from static shapes), finding its tile from the group sizes on the
device. Results do not depend on either.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.build import Kernel

ROW_BLOCK = 16  # the ragged layout's block (kRowBlock in csrc/expert_gemm.cuh)
ROW_TILES = (16, 64, 128)  # the kernels' row tiles
DX_ROW_TILES = (16, 64)  # the dx kernel's row tiles
# The most experts the kernels take: the tile table of the slots that
# zero-fill dead blocks lives in the smallest ring (16-row tiles, bf16,
# 29,952 bytes), one int32 an expert and one more.
MAX_EXPERTS = 7487
_ACTS = {"silu": 0, "gelu": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("grouped_mlp", "grouped_mlp", [_P] * 7 + [_I] * 9 + [_P])
KERNEL_DX = Kernel("grouped_mlp_dx", "grouped_mlp_dx",
                   [_P] * 10 + [_I] * 9 + [_P], source="grouped_mlp_bwd")
KERNEL_DW = Kernel("grouped_mlp_dw", "grouped_mlp_dw",
                   [_P] * 10 + [_I] * 6 + [_P], source="grouped_mlp_bwd")


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
    least one valid row). The kernels find their tiles on the device, so
    this layout table serves the tests and the comparison with the JAX
    package's."""
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
# the kernels' row tiles (ragged_tile in csrc/expert_gemm.cuh)
# ---------------------------------------------------------------------------


def row_tile(M: int, E: int, tiles=ROW_TILES) -> int:
    """A kernel's row tile from static shapes only: by the average rows
    an expert, (M - 16 E) / E (M holds every expert's one block besides
    the valid rows rounded up), as the expert kernels pick theirs by
    capacity: the forward 16 rows at decode-sized segments, 64 in
    between, else 128; the dx kernel (``tiles`` :data:`DX_ROW_TILES`)
    16 or 64, as the expert dx, since 128-row tiles timed slower than 64
    at the training shape."""
    avg = (M - ROW_BLOCK * E) / E
    return next((bm for bm in tiles[:-1] if avg <= bm), tiles[-1])


def tile_slots(M: int, E: int, bm: int) -> int:
    """Thread blocks a group along the grid's row axis: an upper bound on
    the live row tiles, ceil(M / bm) + E (every segment's last tile
    ragged)."""
    return -(-M // bm) + E


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, xs, wi, wg, wo, group_sizes, act, block, *extra):
    if block != ROW_BLOCK:
        raise ValueError(
            f"the CUDA grouped MLP reads a ragged buffer of {ROW_BLOCK}-row "
            f"blocks; lay it out with block={ROW_BLOCK} (got {block})"
        )
    if act not in _ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")
    G, M, d = xs.shape
    E, _, f = wi.shape
    ws = [w for w in (wi, wg, wo) if w is not None]
    for t in (xs, *ws, group_sizes, *extra):
        if not t.is_cuda or t.device != xs.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor "
                             "on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {xs.dtype} not supported "
                         "(float32, bfloat16)")
    if any(w.dtype != xs.dtype for w in (*ws, *extra)):
        raise ValueError(f"{name}: weights (and dy) must share xs' dtype")
    if (wi.shape != (E, d, f) or wo.shape != (E, f, d)
            or (wg is not None and wg.shape != (E, d, f))
            or group_sizes.shape != (G, E)
            or any(t.shape != xs.shape for t in extra)):
        raise ValueError(
            f"{name}: shapes xs {tuple(xs.shape)}, wi {tuple(wi.shape)}, "
            f"wo {tuple(wo.shape)}, group_sizes "
            f"{tuple(group_sizes.shape)} disagree"
        )
    if M % block:
        raise ValueError(f"ragged rows ({M}) must be a multiple of {block}")
    if E > MAX_EXPERTS:
        raise ValueError(f"{name}: {E} experts; the kernels take at most "
                         f"{MAX_EXPERTS}")


def _tiling(M: int, E: int, tiles=ROW_TILES):
    bm = row_tile(M, E, tiles)
    return bm, tile_slots(M, E, bm)


def fwd_buffers(xs, f: int, group_sizes):
    """The forward's buffers, in the order the wrapper allocates them:
    (out like ``xs``, the int32 group sizes, the float32 (G, M, f)
    scratch ``h``); the last two None for an empty buffer, which
    launches nothing."""
    G, M, _ = xs.shape
    out = torch.empty_like(xs)
    if G * M == 0:
        return out, None, None
    sizes = group_sizes.to(torch.int32).contiguous()
    return out, sizes, torch.empty((G, M, f), dtype=torch.float32,
                                   device=xs.device)


def dx_buffers(xs, f: int, gated: bool, group_sizes):
    """The dx kernel's buffers, in order: (dx like ``xs``, the float32
    (G, M, f) da, dg (None ungated) and h, the int32 group sizes (None
    for an empty buffer))."""
    G, M, _ = xs.shape
    dx = torch.empty_like(xs)
    da = torch.empty((G, M, f), dtype=torch.float32, device=xs.device)
    dg = torch.empty_like(da) if gated else None
    h = torch.empty_like(da)
    if G * M == 0:
        return dx, da, dg, h, None
    return dx, da, dg, h, group_sizes.to(torch.int32).contiguous()


def dw_buffers(xs, f: int, gated: bool, group_sizes, block: int):
    """The dW kernel's buffers, in order: the float32 (dwi, dwg (None
    ungated), dwo) and the int32 aligned segment starts (None, and the
    sums zeros, for an empty buffer: every (tile, expert) block writes
    its whole tile; no rows, no launch)."""
    G, M, d = xs.shape
    E = group_sizes.shape[1]
    empty = G * M == 0
    alloc = torch.zeros if empty else torch.empty
    kw = dict(dtype=torch.float32, device=xs.device)
    dwi = alloc((E, d, f), **kw)
    dwg = alloc((E, d, f), **kw) if gated else None
    dwo = alloc((E, f, d), **kw)
    if empty:
        return dwi, dwg, dwo, None
    row_off, _ = ragged_row_offsets(group_sizes, block)
    return dwi, dwg, dwo, row_off.to(torch.int32).contiguous()


def grouped_mlp_cuda(xs, wi, wg, wo, group_sizes, *, act: str = "silu",
                     block: int = ROW_BLOCK):
    """xs: (G, M, d) expert-sorted block-aligned rows -> (G, M, d), on
    the card. wi/wg: (E, d, f) (wg may be None), wo: (E, f, d); all of
    xs' dtype (float32 or bfloat16); group_sizes (G, E) valid rows per
    expert, read on the device only. The buffer must be laid out at
    :data:`ROW_BLOCK`; the row tile is :func:`row_tile`'s. The kernel's
    two passes meet in a float32 (G, M, f) scratch,
    alive for the call only; every output row is written (dead blocks
    zero)."""
    name = "grouped MLP kernel"
    _check(name, xs, wi, wg, wo, group_sizes, act, block)
    G, M, d = xs.shape
    E, _, f = wi.shape
    out, sizes, h = fwd_buffers(xs, f, group_sizes)
    if h is None:
        return out
    bm, slots = _tiling(M, E)
    KERNEL.launch(
        xs.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
        sizes.data_ptr(), h.data_ptr(), out.data_ptr(),
        G, M, d, f, E, _ACTS[act], int(xs.dtype == torch.bfloat16), bm,
        slots, torch.cuda.current_stream(xs.device).cuda_stream,
        work=lambda: tiling.grouped_work(
            "fwd", G, M, d, f, E, *tiling.grouped_rows(sizes),
            gated=wg is not None, itemsize=xs.element_size()),
    )
    return out


def grouped_mlp_dx_cuda(xs, wi, wg, wo, dy, group_sizes, *,
                        act: str = "silu", block: int = ROW_BLOCK):
    """dx of :func:`grouped_mlp_cuda` for the output cotangent ``dy (G,
    M, d)``, on the card; dead blocks give dx = 0. The kernel recomputes
    each live tile's hidden products on tensor cores and also returns
    the float32 (G, M, f) da, dg (None when wg is) and h of the live
    blocks' rows — the dW kernel's inputs; their rows in dead blocks are
    left unwritten. The row tile is :func:`row_tile`'s from
    :data:`DX_ROW_TILES`. Returns (dx, da, dg, h)."""
    name = "grouped MLP dx kernel"
    _check(name, xs, wi, wg, wo, group_sizes, act, block, dy)
    G, M, d = xs.shape
    E, _, f = wi.shape
    dev = xs.device
    dx, da, dg, h, sizes = dx_buffers(xs, f, wg is not None, group_sizes)
    if sizes is None:
        return dx, da, dg, h
    bm, slots = _tiling(M, E, DX_ROW_TILES)
    KERNEL_DX.launch(
        xs.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
        dy.data_ptr(), sizes.data_ptr(), dx.data_ptr(), da.data_ptr(),
        _ptr(dg), h.data_ptr(),
        G, M, d, f, E, _ACTS[act], int(xs.dtype == torch.bfloat16), bm,
        slots, torch.cuda.current_stream(dev).cuda_stream,
        work=lambda: tiling.grouped_work(
            "dx", G, M, d, f, E, *tiling.grouped_rows(sizes),
            gated=wg is not None, itemsize=xs.element_size()),
    )
    return dx, da, dg, h


def grouped_mlp_dw_cuda(xs, dy, da, dg, h, group_sizes, *,
                        block: int = ROW_BLOCK):
    """float32 dW of :func:`grouped_mlp_cuda`, summed over the groups, on
    the card: one thread block per (128 x 128 output tile, expert) walks
    the expert's segment of valid rows in every group over ``da``, ``dg``
    (None when ungated) and ``h`` from :func:`grouped_mlp_dx_cuda`, on
    tensor cores, and writes each sum once (the TPU kernel writes
    per-group outputs, summed outside it). Returns (dwi, dwg, dwo) of
    shapes (E, d, f) / (E, f, d); an expert with no rows gets zeros."""
    name = "grouped MLP dW kernel"
    G, M, d = xs.shape
    E, f = group_sizes.shape[1], da.shape[-1]
    for t in (xs, dy, da, dg, h, group_sizes):
        if t is not None and (not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{name}: inputs must be contiguous CUDA "
                             "tensors")
    if (dy.shape != xs.shape or dy.dtype != xs.dtype
            or da.shape != (G, M, f) or h.shape != da.shape
            or (dg is not None and dg.shape != da.shape)
            or any(t.dtype != torch.float32 for t in (da, dg, h)
                   if t is not None)
            or group_sizes.shape[0] != G or group_sizes.dtype != torch.int32
            or M % block or block != ROW_BLOCK):
        raise ValueError(f"{name}: xs {tuple(xs.shape)}, dy "
                         f"{tuple(dy.shape)}, float32 da/dg/h "
                         f"{tuple(da.shape)} and int32 group_sizes "
                         f"{tuple(group_sizes.shape)} disagree")
    dev = xs.device
    dwi, dwg, dwo, row_off = dw_buffers(xs, f, dg is not None, group_sizes,
                                        block)
    if row_off is None:
        return dwi, dwg, dwo
    KERNEL_DW.launch(
        xs.data_ptr(), dy.data_ptr(), da.data_ptr(), _ptr(dg),
        h.data_ptr(), row_off.data_ptr(), group_sizes.data_ptr(),
        dwi.data_ptr(), _ptr(dwg), dwo.data_ptr(),
        G, M, d, f, E, int(xs.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
        work=lambda: tiling.grouped_work(
            "dw", G, M, d, f, E, *tiling.grouped_rows(group_sizes),
            gated=dg is not None, itemsize=xs.element_size()),
    )
    return dwi, dwg, dwo


def grouped_mlp_bwd_cuda(xs, wi, wg, wo, dy, group_sizes, *,
                         act: str = "silu", block: int = ROW_BLOCK):
    """Gradients (dx, dwi, dwg, dwo) of :func:`grouped_mlp_cuda`: the dx
    kernel, then the dW kernel, whose float32 sums over the groups are
    cast to the weights' dtype. dwg is None when wg is."""
    dx, da, dg, h = grouped_mlp_dx_cuda(xs, wi, wg, wo, dy, group_sizes,
                                        act=act, block=block)
    dwi, dwg, dwo = grouped_mlp_dw_cuda(xs, dy, da, dg, h, group_sizes,
                                        block=block)
    return (dx, dwi.to(wi.dtype), None if dwg is None else dwg.to(wg.dtype),
            dwo.to(wo.dtype))


# ---------------------------------------------------------------------------
# the shape-only route on the meta device (the dry run)
# ---------------------------------------------------------------------------


def _meta_work(kind, xs, wi, wg, max_rows):
    """The capacity-full work of a grouped call on the meta device,
    where the group sizes are unknown: ``max_rows`` valid rows a group
    (default M - E * ROW_BLOCK, at least the assignments the buffer was
    laid out for) and every expert live."""
    G, M, d = xs.shape
    E, _, f = wi.shape
    rows = M - E * ROW_BLOCK
    if max_rows is not None:
        rows = min(rows, max_rows)
    return lambda: tiling.grouped_work(
        kind, G, M, d, f, E, G * rows, E, gated=wg is not None,
        itemsize=xs.element_size())


def grouped_mlp_meta(xs, wi, wg, wo, group_sizes, *, max_rows=None):
    """:func:`grouped_mlp_cuda` on the meta device: its buffers
    (:func:`fwd_buffers`, the scratch dropped at return) and the
    forward's capacity-full work (``max_rows`` valid rows a group).
    Returns the output (empty, of its shape and dtype)."""
    out, _, h = fwd_buffers(xs, wi.shape[-1], group_sizes)
    if h is not None:
        KERNEL.record(_meta_work("fwd", xs, wi, wg, max_rows))
    return out


def grouped_mlp_bwd_meta(xs, wi, wg, wo, dy, group_sizes, *,
                         max_rows=None, block: int = ROW_BLOCK):
    """:func:`grouped_mlp_bwd_cuda` on the meta device: the dx and dW
    kernels' buffers in its order (:func:`dx_buffers`,
    :func:`dw_buffers`; the float32 sums cast to the weights' dtype
    while the scratch lives) and their capacity-full work."""
    f, gated = wi.shape[-1], wg is not None
    dx, da, dg, h, sizes = dx_buffers(xs, f, gated, group_sizes)
    if sizes is not None:
        KERNEL_DX.record(_meta_work("dx", xs, wi, wg, max_rows))
    dwi, dwg, dwo, row_off = dw_buffers(xs, f, gated, group_sizes, block)
    if row_off is not None:
        KERNEL_DW.record(_meta_work("dw", xs, wi, wg, max_rows))
    return (dx, dwi.to(wi.dtype), None if dwg is None else dwg.to(wg.dtype),
            dwo.to(wo.dtype))


def _ptr(t):
    return None if t is None else t.data_ptr()
