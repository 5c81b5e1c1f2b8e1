"""Work models of the twelve CUDA kernels: the bytes each call must move
and the FLOPs it must do, and the least time the card could take for
them (port of ``repro/kernels/tiling.py``).

Every model returns ``(bytes, flops)`` for one call under one
convention: each input read once and each output written once, whatever
the kernel reads again; the live (query, key) pairs of a causal mask
only; the valid rows of a ragged buffer only (dead blocks read nothing,
though the forward and dx still write their zero rows); the keys below
each slot's length, not whole blocks. The kernels' bounds in
``chip_smoke.py``'s per-kernel line, the work counters of
``kernels/build.py`` (``count_work``) and the dry run
(``launch/dryrun.py``) all read these models, so a kernel's roofline
reads the same work whatever implements it.

Arguments are the call's tensor shapes and its host-known arguments.
Where the work depends on the data (a grouped call's valid rows and live
experts, a decode slot's length, a prefill lane's start and length),
the model takes those values as Python ints or as int64 tensors; given
device tensors it returns device scalars, computed on the device
without a host read (:func:`grouped_rows` gives the grouped kernels'
from the group sizes).

:func:`bound_ms` turns the work into the least time on an H100 from the
data sheet's rates (``launch/mesh.py``).

The reference's byte models walk the TPU kernels' block grids: a
grouped block streams its owner's whole weight set, a decode slot reads
whole KV blocks, a prefill q tile re-reads every KV block below its
causal limit. Their ports here (:func:`grouped_walk_fwd_bytes`,
:func:`paged_decode_fwd_bytes`, :func:`paged_prefill_fwd_bytes`) keep
the names and follow the once-each convention above, so they count
less than the TPU models for the same call. ``decode_attention_flops``
and ``paged_prefill_flops`` give the reference's values.

The TPU tile tuners (``clamp_tile``, ``check_mxu_alignment``,
``tune_expert_tiles``, ``tune_attention_tiles`` and the VMEM models
behind them) have no counterpart: they fit Pallas blocks into a TPU
core's VMEM and the MXU's 128 lanes. The CUDA kernels pick their tiles
where they are launched (``grouped_mlp.row_tile``,
``flash_attention.pick_fwd_q_tile``, ``decode_attention.pick_splits``,
``paged_prefill.pick_splits``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import (
    HBM_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_F32,
    PEAK_FLOPS_TF32,
)

# The peak FLOP/s a call's dtype names (CUDA cores for float32).
PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}
# Kernels whose float32 products run on tensor cores as three TF32
# products (csrc/mma_sm90.cuh): their float32 bound is 3 x FLOPs over
# the TF32 rate (or the bytes), with the CUDA-core bound beside it.
TF32X3_KERNELS = ("flash_attention", "flash_attention_dq",
                  "flash_attention_dkv", "expert_mlp", "expert_mlp_dx",
                  "expert_mlp_dw", "paged_prefill", "grouped_mlp",
                  "grouped_mlp_dx", "grouped_mlp_dw")


def bound_ms(name: str, nbytes, flops, dtype: str = "float32"):
    """The least ms the card could take for ``nbytes`` and ``flops`` of
    kernel ``name`` in ``dtype``: max(bytes / HBM rate, FLOPs / the
    dtype's peak); for a float32 call of a :data:`TF32X3_KERNELS`
    kernel, max(bytes, 3 x FLOPs / the TF32 rate). Returns ``(bound_ms,
    bound_by, cuda_core_bound_ms)``: ``bound_by`` "bytes" or
    "operations"; the CUDA-core bound (FLOPs over the float32 rate) for
    a TF32X3 float32 call, else None."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if name in TF32X3_KERNELS and dtype == "float32":
        t_tc = 3 * flops / PEAK_FLOPS_TF32 * 1e3
        return (max(t_bytes, t_tc),
                "bytes" if t_bytes >= t_tc else "operations",
                max(t_bytes, t_ops))
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", None)


def _ints(x) -> torch.Tensor:
    """int64 view of a sequence of ints or a tensor (on its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(x, dtype=torch.int64)


def _out(x):
    """A host result as a Python int; a device scalar stays on its
    device (read once, by the caller)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return int(x)
    return x


# ---------------------------------------------------------------------------
# the serve kernels
# ---------------------------------------------------------------------------


def decode_work(B: int, H: int, Kh: int, dh: int, block_size: int, lengths,
                *, itemsize: int, kv_itemsize: int | None = None):
    """One paged decode call (``decode_attention.paged_decode_attention_cuda``),
    q (B, H, dh) over pools (P, block_size, Kh, dh) at slot ``lengths``
    (B,): bytes (q read and o written in ``itemsize``; each slot's keys
    and values below its length in ``kv_itemsize``, default the same;
    the lengths and the live blocks' table entries as int32) and FLOPs
    (qk^T and pv: 4 H dh a key)."""
    kv_isz = itemsize if kv_itemsize is None else kv_itemsize
    lens = _ints(lengths)
    total = lens.sum()
    blocks = ((lens + block_size - 1) // block_size).sum()
    nbytes = (2 * B * H * dh * itemsize + 2 * total * Kh * dh * kv_isz
              + 4 * (B + blocks))
    return _out(nbytes), _out(4 * H * dh * total)


def prefill_work(NC: int, C: int, H: int, Kh: int, dh: int, block_size: int,
                 num_blocks: int, tables, starts, lens, *, itemsize: int,
                 kv_itemsize: int | None = None):
    """One paged prefill call (``paged_prefill.paged_prefill_attention_cuda``),
    q (NC, C, H, dh) over pools of ``num_blocks`` blocks, lanes with
    block ``tables`` (NC, nb), ``starts`` and ``lens`` (NC,): bytes (q
    and o in ``itemsize``; the keys and values of each pool block up to
    the last position a lane reads in it, a block shared by lanes once,
    in ``kv_itemsize``; the touched blocks' table entries and the
    starts and lengths as int32) and FLOPs (row i of lane c attends
    start + i + 1 keys, 4 H dh each)."""
    kv_isz = itemsize if kv_itemsize is None else kv_itemsize
    tab = _ints(tables)
    st, ln = _ints(starts), _ints(lens)
    dev = tab.device
    ends = (st + ln)[:, None]
    b = torch.arange(tab.shape[1], device=dev, dtype=torch.int64)[None]
    need = torch.clamp(ends - b * block_size, 0, block_size)
    keys = torch.zeros(num_blocks, dtype=torch.int64, device=dev)
    keys = keys.scatter_reduce(0, tab.reshape(-1), need.reshape(-1), "amax")
    touched = (keys > 0).sum()
    nbytes = (2 * NC * C * H * dh * itemsize
              + 2 * keys.sum() * Kh * dh * kv_isz + 4 * (touched + 2 * NC))
    pairs = (ln * st + ln * (ln + 1) // 2).sum()
    return _out(nbytes), _out(4 * H * dh * pairs)


def decode_attention_flops(lengths, n_heads: int, head_dim: int) -> int:
    """Single-query GQA decode FLOPs: qk^T + pv = 4*H*len*dh per slot
    (the reference's)."""
    return sum(4 * n_heads * int(n) * head_dim for n in lengths)


def paged_prefill_flops(start: int, chunk_len: int, n_heads: int,
                        head_dim: int) -> int:
    """Chunk GQA attention FLOPs: row i attends start + i + 1 positions,
    qk^T + pv = 4*H*dh per (query, key) pair (the reference's)."""
    total_kv = chunk_len * start + chunk_len * (chunk_len + 1) // 2
    return 4 * n_heads * head_dim * total_kv


def paged_decode_fwd_bytes(lengths, block_size: int, kv_heads: int,
                           head_dim: int, *, n_heads: int, itemsize: int = 2,
                           q_itemsize: int = 4) -> int:
    """Bytes of one paged decode step over a slot batch, the port's
    once-each count (:func:`decode_work`): the keys and values below
    each length, where the reference's TPU walk reads whole live blocks
    (``ceil(len / bs) * bs`` rows); plus the int32 lengths and live
    table entries, which the reference leaves out. Pass ``lengths =
    [max_len] * B`` for a dense cache's read."""
    return decode_work(len(lengths), n_heads, kv_heads, head_dim,
                       block_size, lengths, itemsize=q_itemsize,
                       kv_itemsize=itemsize)[0]


def paged_prefill_fwd_bytes(start: int, chunk_len: int, block_size: int,
                            kv_heads: int, head_dim: int, *, n_heads: int,
                            itemsize: int = 2, q_itemsize: int = 4) -> int:
    """Bytes of ONE chunk through the paged prefill, the port's
    once-each count (:func:`prefill_work` of one lane over distinct
    blocks): the keys and values up to ``start + chunk_len`` once, where
    the reference's TPU model re-reads every block below each q tile's
    causal limit (so it takes a ``q_tile``, which this count does not
    need); plus the chunk's q read and o write and the int32 table
    entries, start and length."""
    keys = start + chunk_len
    blocks = -(-keys // block_size)
    return (2 * chunk_len * n_heads * head_dim * q_itemsize
            + 2 * keys * kv_heads * head_dim * itemsize + 4 * (blocks + 2))


# ---------------------------------------------------------------------------
# the ragged grouped FFN and the padded expert FFN
# ---------------------------------------------------------------------------


def grouped_rows(group_sizes: torch.Tensor):
    """(valid rows, live experts) of a grouped call's ``group_sizes``
    (G, E), as int64 scalars on its device: the rows summed over the
    groups, and the experts with a row in some group."""
    return (group_sizes.sum(dtype=torch.int64),
            (group_sizes > 0).any(0).sum())


def grouped_work(kind: str, G: int, M: int, d: int, f: int, E: int, rows,
                 live, *, gated: bool, itemsize: int):
    """One grouped kernel call over xs (G, M, d), E experts of (d, f):
    ``kind`` "fwd" (``grouped_mlp_cuda``), "dx" or "dw"; ``rows`` valid
    rows summed over the groups, ``live`` experts with rows (ints or
    device scalars, :func:`grouped_rows`). xs, dy, the weights and
    dx in ``itemsize``; the hidden scratch (da, [dg,] h) and the dW sums
    in float32.

    fwd: the valid rows, the live experts' weights, every output row
    written and the int32 sizes; FLOPs x wi [, x wg], h wo.
    dx: x and dy's valid rows, the live weights, every dx row written
    and da [, dg], h of the valid rows; FLOPs a [, g], dh, dx.
    dw: x, dy, da [, dg], h of the valid rows read and every expert's
    dW sums written once; FLOPs dwi [, dwg], dwo."""
    nw = 3 if gated else 2
    if kind == "fwd":
        nbytes = (rows * d + live * nw * d * f + G * M * d) * itemsize \
            + 4 * G * E
        return _out(nbytes), _out(2 * nw * rows * d * f)
    if kind == "dx":
        nbytes = ((2 * rows * d + live * nw * d * f + G * M * d) * itemsize
                  + nw * rows * f * 4)
        return _out(nbytes), _out((4 * nw - 2) * rows * d * f)
    if kind == "dw":
        nbytes = 2 * rows * d * itemsize + (nw * rows * f + nw * E * d * f) * 4
        return _out(nbytes), _out(2 * nw * rows * d * f)
    raise ValueError(f"unknown grouped kernel kind {kind!r}")


def grouped_walk_fwd_bytes(rows, live_experts, G: int, M: int, E: int,
                           d: int, f: int, n_weights: int = 3, *,
                           itemsize: int = 2):
    """Forward bytes of the grouped FFN, the port's once-each count
    (:func:`grouped_work`): each live expert's weights once and each
    valid row once, where the reference's TPU block walk streams the
    owner's whole weight set again for every live row block and reads
    whole blocks; every output row written, as there; plus the int32
    group sizes."""
    return grouped_work("fwd", G, M, d, f, E, rows, live_experts,
                        gated=n_weights == 3, itemsize=itemsize)[0]


def expert_work(kind: str, G: int, E: int, cap: int, d: int, f: int, *,
                gated: bool, itemsize: int):
    """One expert-FFN kernel call over every row of the padded buffer xe
    (G, E, cap, d) (the kernels compute every slot, filled or not):
    ``kind`` "fwd" (``expert_ffn_cuda``), "dx" or "dw". x, dy, the
    weights and dx in ``itemsize``; da [, dg], h and the dW sums in
    float32. fwd: x, w* -> y; dx: x, dy, w* -> dx, da [, dg], h; dw: x,
    dy, da [, dg], h -> dwi [, dwg], dwo."""
    nw = 3 if gated else 2
    rows = G * E * cap
    if kind == "fwd":
        return (2 * rows * d * itemsize + nw * E * d * f * itemsize,
                2 * nw * rows * d * f)
    if kind == "dx":
        return (3 * rows * d * itemsize + nw * E * d * f * itemsize
                + nw * rows * f * 4, (4 * nw - 2) * rows * d * f)
    if kind == "dw":
        return (2 * rows * d * itemsize + nw * rows * f * 4
                + nw * E * d * f * 4, 2 * nw * rows * d * f)
    raise ValueError(f"unknown expert kernel kind {kind!r}")


# ---------------------------------------------------------------------------
# flash attention and WKV-6
# ---------------------------------------------------------------------------


def flash_pairs(Sq: int, Skv: int, *, causal: bool, q_offset=0,
                kv_len=None):
    """Live (query, key) pairs of one (batch, head): query row i sits at
    ``q_offset + i`` and attends keys ``< kv_len`` (default Skv) and,
    when causal, ``<= q_offset + i``. Ints, or device scalars for tensor
    ``q_offset`` / ``kv_len``."""
    kv = Skv if kv_len is None else kv_len
    if isinstance(kv, torch.Tensor):  # int64: products pass 2^31
        kv = kv.to(torch.int64).reshape(())
    if not causal:
        return Sq * kv
    if isinstance(q_offset, torch.Tensor) or isinstance(kv, torch.Tensor):
        dev = (q_offset if isinstance(q_offset, torch.Tensor) else kv).device
        a, kv = (torch.as_tensor(x, device=dev).to(torch.int64).reshape(())
                 for x in (q_offset, kv))
        a = a + 1
        t = torch.clamp(kv - a + 1, 0, Sq)
        return torch.clamp(t * a + t * (t - 1) // 2 + (Sq - t) * kv, min=0)
    a = q_offset + 1  # keys of row 0
    t = min(max(kv - a + 1, 0), Sq)  # rows below the kv_len cap
    return max(t * a + t * (t - 1) // 2 + (Sq - t) * kv, 0)


def flash_work(kind: str, B: int, Sq: int, Skv: int, H: int, Kh: int,
               dh: int, *, causal: bool, itemsize: int, q_offset=0,
               kv_len=None):
    """One flash call, q (B, Sq, H, dh) and k/v (B, Skv, Kh, dh):
    ``kind`` "fwd" (q, k, v -> o, lse: QK^T and PV), "dq" (q, k, v, dO,
    lse, delta -> dq: QK^T, dO V^T, dS K) or "dkv" (+ dS^T Q and P^T dO,
    writing dk and dv); lse and delta float32; FLOPs over the live
    (query, key) pairs only (:func:`flash_pairs`)."""
    pairs = B * H * flash_pairs(Sq, Skv, causal=causal, q_offset=q_offset,
                                kv_len=kv_len)
    q_b, kv_b, row_b = (B * Sq * H * dh * itemsize,
                        B * Skv * Kh * dh * itemsize, B * H * Sq * 4)
    if kind == "fwd":
        return 2 * q_b + 2 * kv_b + row_b, _out(4 * dh * pairs)
    if kind == "dq":
        return 3 * q_b + 2 * kv_b + 2 * row_b, _out(6 * dh * pairs)
    if kind == "dkv":
        return 2 * q_b + 4 * kv_b + 2 * row_b, _out(8 * dh * pairs)
    raise ValueError(f"unknown flash kernel kind {kind!r}")


def wkv_work(B: int, T: int, H: int, K: int, V: int, *, itemsize: int,
             state_in: bool):
    """One WKV-6 call (``rwkv6.rwkv6_cuda``): bytes (r, k, v read and o
    written in ``itemsize``, w and u float32, the float32 state read if
    given and written once) and FLOPs (about 4 K V a (b, t, h): r^T S
    and the state update)."""
    state = B * H * K * V * 4
    nbytes = (B * T * H * ((2 * K + 2 * V) * itemsize + 4 * K)
              + state * (2 if state_in else 1) + H * K * 4)
    return nbytes, 4 * B * T * H * K * V
