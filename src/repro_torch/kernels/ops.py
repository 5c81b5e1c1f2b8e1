"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Every op takes ``implementation``:

* ``"auto"``  — the CUDA kernel for CUDA tensors, the plain PyTorch
                version for CPU tensors (decided by where the tensor
                lies, never by a fallback);
* ``"cuda"``  — the hand-written kernel; CPU tensors raise;
* ``"eager"`` — the plain version (kernels/ref.py), only when asked for.

On the meta device ``"auto"`` and ``"cuda"`` take the kernels'
shape-only route (``"meta"``, the dry run's path, ``launch/dryrun.py``):
each op returns empty outputs of the kernel's shapes and dtypes and
records the kernel's work model in an open ``build.count_work`` block.
Where the work depends on data the meta device does not hold, it
records an upper bound: the grouped kernels' capacity-full rows
(``max_rows``), decode slots and prefill lanes that fill their tables.
A CUDA tensor still gets its kernel or an error, a CPU tensor its plain
version; ``"eager"`` runs the plain version on any device.

``flash_attention``, ``grouped_mlp`` and ``expert_ffn`` are
differentiable: each is a ``torch.autograd.Function`` whose backward
runs the backward kernels (or, on "eager", the plain backward versions)
and which saves only its inputs plus O(rows) statistics, as the
reference's ``custom_vjp``s do. ``rwkv6`` is forward-only on "cuda", as
the reference's kernel is; its "eager" version is differentiable by
autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import expert_mlp as _em
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_mlp as _gm
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6 as _wkv

IMPLEMENTATIONS = ("auto", "cuda", "eager")
KERNELS = (_da.KERNEL, _pp.KERNEL, _gm.KERNEL, _fa.KERNEL, _fa.KERNEL_DQ,
           _fa.KERNEL_DKV, _gm.KERNEL_DX, _gm.KERNEL_DW, _em.KERNEL,
           _em.KERNEL_DX, _em.KERNEL_DW, _wkv.KERNEL)


def resolve(implementation: str, x: torch.Tensor) -> str:
    if implementation in ("auto", "cuda") and x.is_meta:
        return "meta"
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
    impl = resolve(implementation, q)
    if impl == "eager":
        y = _ref.decode_attention_ref(qq, k_pool, v_pool, block_tables,
                                      lengths)
    else:
        kernel = (_da.paged_decode_attention_meta if impl == "meta"
                  else _da.paged_decode_attention_cuda)
        y = kernel(qq.contiguous(), k_pool, v_pool,
                   block_tables.to(torch.int32).contiguous(),
                   lengths.to(torch.int32).contiguous())
    return y[:, None]


def prefill_attention(q, k_pool, v_pool, block_tables, starts, lens, *,
                      implementation="auto"):
    """Paged chunked-prefill GQA attention. q: (NC, C, H, dh); pools
    with the chunks' k/v already written; block_tables (NC, nb); starts
    (NC,) absolute position of q[c, 0]; lens (NC,) valid rows (0 = dead
    lane -> exact zeros). Row i of chunk c attends pool positions
    ``<= starts[c] + i``. Returns (NC, C, H, dh)."""
    impl = resolve(implementation, q)
    if impl == "eager":
        return _ref.prefill_attention_ref(q, k_pool, v_pool, block_tables,
                                          starts, lens)
    kernel = (_pp.paged_prefill_attention_meta if impl == "meta"
              else _pp.paged_prefill_attention_cuda)
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return kernel(q.contiguous(), k_pool, v_pool, i32(block_tables),
                  i32(starts), i32(lens))


class _GroupedMLP(torch.autograd.Function):
    """Grouped expert FFN with its backward kernels (port of
    ``_make_grouped_mlp_vjp``): saves the inputs and the int32 group
    sizes only; the backward recomputes the hidden tiles."""

    @staticmethod
    def forward(ctx, xs, wi, wg, wo, group_sizes, act, block, impl,
                max_rows):
        ctx.save_for_backward(xs, wi, wg, wo, group_sizes)
        ctx.act, ctx.block, ctx.impl = act, block, impl
        ctx.max_rows = max_rows
        if impl == "eager":
            return _ref.grouped_mlp_ref(xs, wi, wg, wo, group_sizes,
                                        block=block, act=act)
        if impl == "meta":
            return _gm.grouped_mlp_meta(xs, wi, wg, wo, group_sizes,
                                        max_rows=max_rows)
        return _gm.grouped_mlp_cuda(xs, wi, wg, wo, group_sizes, act=act,
                                    block=block)

    @staticmethod
    def backward(ctx, dy):
        xs, wi, wg, wo, group_sizes = ctx.saved_tensors
        if ctx.impl == "meta":
            grads = _gm.grouped_mlp_bwd_meta(xs, wi, wg, wo, dy.contiguous(),
                                             group_sizes, block=ctx.block,
                                             max_rows=ctx.max_rows)
            return (*grads, None, None, None, None, None)
        bwd = (_ref.grouped_mlp_bwd_ref if ctx.impl == "eager"
               else _gm.grouped_mlp_bwd_cuda)
        dx, dwi, dwg, dwo = bwd(xs, wi, wg, wo, dy.contiguous(),
                                group_sizes, block=ctx.block, act=ctx.act)
        return dx, dwi, dwg, dwo, None, None, None, None, None


def grouped_mlp(xs, wi, wg, wo, group_sizes, *, act: str = "silu",
                block: int = _gm.ROW_BLOCK, implementation="auto",
                max_rows: int | None = None):
    """Grouped expert FFN over the sorted ragged buffer (the
    ``dispatch="sorted"`` hot path), differentiable in xs and the
    weights. xs: (G, M, d) expert-sorted rows, each expert's segment
    padded to a multiple of ``block``; group_sizes (G, E) valid rows per
    expert. ``max_rows``: the most valid rows a group can hold (the
    routing's capacity), read by the meta route only."""
    impl = resolve(implementation, xs)
    if impl in ("cuda", "meta"):
        xs = xs.contiguous()
    return _GroupedMLP.apply(xs, wi, wg, wo,
                             group_sizes.to(torch.int32).contiguous(), act,
                             block, impl, max_rows)


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
        if impl == "meta":
            return _em.expert_ffn_meta(xe, wi, wg, wo)
        return _em.expert_ffn_cuda(xe, wi, wg, wo, act=act)

    @staticmethod
    def backward(ctx, dy):
        xe, wi, wg, wo = ctx.saved_tensors
        if ctx.impl == "meta":
            return (*_em.expert_ffn_bwd_meta(xe, wi, wg, wo, dy.contiguous()),
                    None, None)
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
    if impl in ("cuda", "meta"):
        xe, wi, wo = xe.contiguous(), wi.contiguous(), wo.contiguous()
        wg = None if wg is None else wg.contiguous()
    y = _ExpertFFN.apply(xe, wi, wg, wo, act, impl)
    return y[0] if squeeze else y


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernels (port of
    ``_make_flash_vjp``): saves q, k, v, o, the per-row lse and the
    offsets as (1,) int32 tensors. On the meta device ``offsets`` holds
    them as host ints as well (a meta tensor holds no value)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, impl, offsets):
        ctx.causal, ctx.impl, ctx.offsets = causal, impl, offsets
        if impl == "eager":
            o, lse = _ref.flash_attention_ref(
                q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
        elif impl == "meta":
            o, lse = _fa.flash_attention_fwd_meta(q, k, v, *offsets,
                                                  causal=causal)
        else:
            o, lse = _fa.flash_attention_fwd_cuda(q, k, v, q_offset, kv_len,
                                                  causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, q_offset, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_offset, kv_len = ctx.saved_tensors
        do = do.contiguous()
        if ctx.impl == "eager":
            dq, dk, dv = _ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=ctx.causal, q_offset=q_offset,
                kv_len=kv_len)
        elif ctx.impl == "meta":
            dq, dk, dv = _fa.flash_attention_bwd_meta(
                q, k, v, o, do, *ctx.offsets, causal=ctx.causal)
        else:
            dq, dk, dv = _fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, q_offset, kv_len, causal=ctx.causal)
        return dq, dk, dv, None, None, None, None, None


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
    # Host ints on the meta device, where a tensor holds no value.
    offsets = (int(q_offset), int(kv_len)) if impl == "meta" else None
    qo = _fa.scalar_i32(q_offset, q.device)
    kl = _fa.scalar_i32(kv_len, q.device)
    if impl in ("cuda", "meta"):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, qo, kl, bool(causal), impl,
                                 offsets)


def rwkv6(r, k, v, w, u, *, initial_state=None, chunk: int = 64,
          implementation="auto"):
    """RWKV-6 WKV: o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T), S_t =
    diag(w_t) S_{t-1} + k_t v_t^T. r, k, w: (B, T, H, K); v: (B, T, H,
    V); u: (H, K); initial_state (B, H, K, V) or None (zeros). Returns
    (o (B, T, H, V) in v's dtype, final state float32).

    "eager" runs the plain chunked version (``chunk`` steps a chunk; the
    reference's default XLA path), differentiable by autograd; "cuda"
    runs the step-by-step kernel, which has no chunk. The kernel is
    forward-only, as the reference's is: asking autograd for a gradient
    through it raises."""
    impl = resolve(implementation, r)
    if impl == "eager":
        return _ref.rwkv6_chunked_ref(r, k, v, w, u,
                                      initial_state=initial_state,
                                      chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, w, u, initial_state)):
        raise NotImplementedError(
            "the WKV-6 kernel is forward-only (the reference's Pallas "
            "kernel has no custom_vjp either): train rwkv stacks with "
            "mixer_impl='eager' (autograd through the plain chunked "
            "version); a backward kernel is queued in ROADMAP.md")
    kernel = _wkv.rwkv6_meta if impl == "meta" else _wkv.rwkv6_cuda
    f32 = torch.float32
    return kernel(
        r.contiguous(), k.contiguous(), v.contiguous(),
        w.to(f32).contiguous(), u.to(f32).contiguous(),
        None if initial_state is None
        else initial_state.to(f32).contiguous(),
    )
