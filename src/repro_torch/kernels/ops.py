"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Every op takes ``implementation``:

* ``"auto"``  — the CUDA kernel for CUDA tensors, the plain PyTorch
                version for CPU tensors (decided by where the tensor
                lies, never by a fallback);
* ``"cuda"``  — the hand-written kernel; CPU tensors raise;
* ``"eager"`` — the plain version (kernels/ref.py), only when asked for.

``flash_attention``, ``grouped_mlp`` and ``expert_ffn`` are
differentiable: each is a ``torch.autograd.Function`` whose backward
runs the backward kernels (or, on "eager", the plain backward versions)
and which saves only its inputs plus O(rows) statistics, as the
reference's ``custom_vjp``s do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import expert_mlp as _em
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_mlp as _gm
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import ref as _ref

IMPLEMENTATIONS = ("auto", "cuda", "eager")
KERNELS = (_da.KERNEL, _pp.KERNEL, _gm.KERNEL, _fa.KERNEL, _fa.KERNEL_DQ,
           _fa.KERNEL_DKV, _gm.KERNEL_DX, _gm.KERNEL_DW, _em.KERNEL,
           _em.KERNEL_DX, _em.KERNEL_DW)


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


class _GroupedMLP(torch.autograd.Function):
    """Grouped expert FFN with its backward kernels (port of
    ``_make_grouped_mlp_vjp``): saves the inputs and the int32 group
    sizes only; the backward recomputes the hidden tiles."""

    @staticmethod
    def forward(ctx, xs, wi, wg, wo, group_sizes, act, block, impl):
        ctx.save_for_backward(xs, wi, wg, wo, group_sizes)
        ctx.act, ctx.block, ctx.impl = act, block, impl
        if impl == "eager":
            return _ref.grouped_mlp_ref(xs, wi, wg, wo, group_sizes,
                                        block=block, act=act)
        return _gm.grouped_mlp_cuda(xs, wi, wg, wo, group_sizes, act=act,
                                    block=block)

    @staticmethod
    def backward(ctx, dy):
        xs, wi, wg, wo, group_sizes = ctx.saved_tensors
        bwd = (_ref.grouped_mlp_bwd_ref if ctx.impl == "eager"
               else _gm.grouped_mlp_bwd_cuda)
        dx, dwi, dwg, dwo = bwd(xs, wi, wg, wo, dy.contiguous(),
                                group_sizes, block=ctx.block, act=ctx.act)
        return dx, dwi, dwg, dwo, None, None, None, None


def grouped_mlp(xs, wi, wg, wo, group_sizes, *, act: str = "silu",
                block: int = _gm.ROW_BLOCK, implementation="auto"):
    """Grouped expert FFN over the sorted ragged buffer (the
    ``dispatch="sorted"`` hot path), differentiable in xs and the
    weights. xs: (G, M, d) expert-sorted rows, each expert's segment
    padded to a multiple of ``block``; group_sizes (G, E) valid rows per
    expert."""
    impl = resolve(implementation, xs)
    if impl == "cuda":
        xs = xs.contiguous()
    return _GroupedMLP.apply(xs, wi, wg, wo,
                             group_sizes.to(torch.int32).contiguous(), act,
                             block, impl)


class _ExpertFFN(torch.autograd.Function):
    """Expert FFN over the padded capacity buffer with its backward
    kernels (port of ``_make_expert_ffn_vjp``): saves the inputs only
    (``wg`` None when ungated); the backward recomputes the hidden
    tiles."""

    @staticmethod
    def forward(ctx, xe, wi, wg, wo, act, impl):
        ctx.save_for_backward(xe, wi, wg, wo)
        ctx.act, ctx.impl = act, impl
        if impl == "eager":
            return _ref.expert_ffn_ref(xe, wi, wg, wo, act=act)
        return _em.expert_ffn_cuda(xe, wi, wg, wo, act=act)

    @staticmethod
    def backward(ctx, dy):
        xe, wi, wg, wo = ctx.saved_tensors
        bwd = (_ref.expert_ffn_bwd_ref if ctx.impl == "eager"
               else _em.expert_ffn_bwd_cuda)
        dx, dwi, dwg, dwo = bwd(xe, wi, wg, wo, dy.contiguous(),
                                act=ctx.act)
        return dx, dwi, dwg, dwo, None, None


def expert_ffn(xe, wi, wg, wo, *, act: str = "silu", implementation="auto"):
    """Expert FFN over the padded capacity buffer (the gather and einsum
    dispatches' hot path), differentiable in xe and the weights. xe:
    (G, E, cap, d) or (E, cap, d); wi/wg (E, d, f) (wg may be None), wo
    (E, f, d). The weight gradients are summed over G, as the
    reference's vmap over G sums them."""
    impl = resolve(implementation, xe)
    squeeze = xe.dim() == 3
    if squeeze:
        xe = xe[None]
    if impl == "cuda":
        xe, wi, wo = xe.contiguous(), wi.contiguous(), wo.contiguous()
        wg = None if wg is None else wg.contiguous()
    y = _ExpertFFN.apply(xe, wi, wg, wo, act, impl)
    return y[0] if squeeze else y


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernels (port of
    ``_make_flash_vjp``): saves q, k, v, o and the per-row lse."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, impl):
        if impl == "eager":
            o, lse = _ref.flash_attention_ref(
                q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
        else:
            o, lse = _fa.flash_attention_fwd_cuda(q, k, v, q_offset, kv_len,
                                                  causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, q_offset, kv_len)
        ctx.causal, ctx.impl = causal, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_offset, kv_len = ctx.saved_tensors
        do = do.contiguous()
        if ctx.impl == "eager":
            dq, dk, dv = _ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=ctx.causal, q_offset=q_offset,
                kv_len=kv_len)
        else:
            dq, dk, dv = _fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, q_offset, kv_len, causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    kv_len=None, implementation="auto"):
    """Dense GQA attention, differentiable in q, k and v. q: (B, Sq, H,
    dh); k, v: (B, Skv, Kh, dh); query row i sits at position
    ``q_offset + i`` and attends keys ``< kv_len`` (default Skv) and,
    when causal, ``<= q_offset + i``; a row with no valid key gives
    zeros. Returns (B, Sq, H, dh)."""
    impl = resolve(implementation, q)
    if kv_len is None:
        kv_len = k.shape[1]
    qo = _fa.scalar_i32(q_offset, q.device)
    kl = _fa.scalar_i32(kv_len, q.device)
    if impl == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, qo, kl, bool(causal), impl)
