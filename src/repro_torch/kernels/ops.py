"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Every op takes ``implementation``:

* ``"auto"``  — the CUDA kernel for CUDA tensors, the plain PyTorch
                version for CPU tensors (decided by where the tensor
                lies, never by a fallback);
* ``"cuda"``  — the hand-written kernel; CPU tensors raise;
* ``"eager"`` — the plain version (kernels/ref.py), only when asked for.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import grouped_mlp as _gm
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import ref as _ref

IMPLEMENTATIONS = ("auto", "cuda", "eager")
KERNELS = (_da.KERNEL, _pp.KERNEL, _gm.KERNEL)


def resolve(implementation: str, x: torch.Tensor) -> str:
    if implementation == "auto":
        return "cuda" if x.is_cuda else "eager"
    if implementation == "cuda":
        if not x.is_cuda:
            raise ValueError(
                "implementation='cuda' needs CUDA tensors; got a tensor on "
                f"{x.device} (use 'auto' or 'eager' on the CPU)"
            )
        return "cuda"
    if implementation == "eager":
        return "eager"
    raise ValueError(
        f"unknown implementation {implementation!r} {IMPLEMENTATIONS}"
    )


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                     implementation="auto"):
    """Paged single-query GQA attention. q: (B, 1, H, dh);
    pools (P, bs, Kh, dh); block_tables (B, nb); lengths (B,) valid kv
    tokens per slot (0 = free slot -> exact zeros). Returns
    (B, 1, H, dh)."""
    qq = q[:, 0]
    if resolve(implementation, q) == "eager":
        y = _ref.decode_attention_ref(qq, k_pool, v_pool, block_tables,
                                      lengths)
    else:
        y = _da.paged_decode_attention_cuda(
            qq.contiguous(), k_pool, v_pool,
            block_tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(),
        )
    return y[:, None]


def prefill_attention(q, k_pool, v_pool, block_tables, starts, lens, *,
                      implementation="auto"):
    """Paged chunked-prefill GQA attention. q: (NC, C, H, dh); pools
    with the chunks' k/v already written; block_tables (NC, nb); starts
    (NC,) absolute position of q[c, 0]; lens (NC,) valid rows (0 = dead
    lane -> exact zeros). Row i of chunk c attends pool positions
    ``<= starts[c] + i``. Returns (NC, C, H, dh)."""
    if resolve(implementation, q) == "eager":
        return _ref.prefill_attention_ref(q, k_pool, v_pool, block_tables,
                                          starts, lens)
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return _pp.paged_prefill_attention_cuda(
        q.contiguous(), k_pool, v_pool, i32(block_tables), i32(starts),
        i32(lens),
    )


def grouped_mlp(xs, wi, wg, wo, group_sizes, *, act: str = "silu",
                block: int = _gm.ROW_BLOCK, implementation="auto"):
    """Grouped expert FFN over the sorted ragged buffer (the
    ``dispatch="sorted"`` hot path). xs: (G, M, d) expert-sorted rows,
    each expert's segment padded to a multiple of ``block``;
    group_sizes (G, E) valid rows per expert."""
    if resolve(implementation, xs) == "eager":
        return _ref.grouped_mlp_ref(xs, wi, wg, wo, group_sizes,
                                    block=block, act=act)
    return _gm.grouped_mlp_cuda(
        xs.contiguous(), wi, wg, wo, group_sizes.to(torch.int32).contiguous(),
        act=act, block=block,
    )
