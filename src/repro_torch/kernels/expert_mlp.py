"""Expert FFN over the padded capacity buffer: the CUDA kernel wrappers
(port of ``repro/kernels/expert_mlp.py``; forward kernel in
``csrc/expert_mlp.cu``, the dx and dW kernels in
``csrc/expert_mlp_bwd.cu``; all three run on the tensor-core GEMM of
``csrc/expert_gemm.cuh``).

Layout contract (shared with core/moe.py's gather and einsum
dispatches): ``xe (G, E, cap, d)`` holds, for every group g and expert
e, the cap rows expert e processes in group g (zero rows for unfilled
slots); the weights are per expert, ``wi``/``wg (E, d, f)``, ``wo (E,
f, d)``. The kernels treat the buffer as G*E*cap rows, row r belonging
to expert ``(r // cap) % E``; cap need not be a multiple of any tile.
The reference vmaps its TPU kernel over G; here G is a grid axis, and
dW sums over G inside the dW kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.build import Kernel

_ACTS = {"silu": 0, "gelu": 1, "sqrelu": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("expert_mlp", "expert_mlp", [_P] * 6 + [_I] * 7 + [_P])
KERNEL_DX = Kernel("expert_mlp_dx", "expert_mlp_dx", [_P] * 9 + [_I] * 7
                   + [_P], source="expert_mlp_bwd")
KERNEL_DW = Kernel("expert_mlp_dw", "expert_mlp_dw", [_P] * 8 + [_I] * 6
                   + [_P], source="expert_mlp_bwd")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, xe, wi, wg, wo, act, *extra):
    if act not in _ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")
    if xe.dim() != 4:
        raise ValueError(f"{name}: xe must be (G, E, cap, d), got "
                         f"{tuple(xe.shape)}")
    G, E, cap, d = xe.shape
    f = wi.shape[-1]
    ws = [w for w in (wi, wg, wo) if w is not None]
    for t in (xe, *ws, *extra):
        if not t.is_cuda or t.device != xe.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor "
                             "on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if xe.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {xe.dtype} not supported "
                         "(float32, bfloat16)")
    if any(w.dtype != xe.dtype for w in (*ws, *extra)):
        raise ValueError(f"{name}: weights (and dy) must share xe's dtype")
    if (wi.shape != (E, d, f) or wo.shape != (E, f, d)
            or (wg is not None and wg.shape != (E, d, f))
            or any(t.shape != xe.shape for t in extra)):
        raise ValueError(
            f"{name}: shapes xe {tuple(xe.shape)}, wi {tuple(wi.shape)}, "
            f"wo {tuple(wo.shape)} disagree")
    return G, E, cap, d, f


def _work(kind, xe, f, gated):
    """The call's work model (``tiling.expert_work``) as a thunk."""
    G, E, cap, d = xe.shape
    return lambda: tiling.expert_work(kind, G, E, cap, d, f, gated=gated,
                                      itemsize=xe.element_size())


def fwd_buffers(xe, f: int):
    """The forward's buffers, in the order the wrapper allocates them:
    (out like ``xe``, the float32 (G, E, cap, f) scratch ``h``; None
    for an empty buffer, which launches nothing)."""
    G, E, cap, _ = xe.shape
    out = torch.empty_like(xe)
    if out.numel() == 0:
        return out, None
    return out, torch.empty((G, E, cap, f), dtype=torch.float32,
                            device=xe.device)


def dx_buffers(xe, f: int, gated: bool):
    """The dx kernel's buffers, in order: (dx like ``xe``, the float32
    (G, E, cap, f) da, dg (None ungated) and h)."""
    G, E, cap, _ = xe.shape
    dx = torch.empty_like(xe)
    da = torch.empty((G, E, cap, f), dtype=torch.float32, device=xe.device)
    dg = torch.empty_like(da) if gated else None
    return dx, da, dg, torch.empty_like(da)


def dw_buffers(xe, f: int, gated: bool):
    """The dW kernel's float32 (dwi, dwg (None ungated), dwo)."""
    E, d = xe.shape[1], xe.shape[3]
    f32 = torch.float32
    dwi = torch.empty((E, d, f), dtype=f32, device=xe.device)
    dwg = torch.empty_like(dwi) if gated else None
    return dwi, dwg, torch.empty((E, f, d), dtype=f32, device=xe.device)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def expert_ffn_cuda(xe, wi, wg, wo, *, act: str = "silu"):
    """y = act(xe wi) [* xe wg] wo per expert, on the card. xe: (G, E,
    cap, d); wi/wg (E, d, f) (wg may be None), wo (E, f, d); all of xe's
    dtype (float32 or bfloat16), accumulated in float32. The kernel's
    two passes meet in a float32 (G, E, cap, f) scratch, alive for the
    call only. Returns (G, E, cap, d)."""
    G, E, cap, d, f = _check("expert FFN kernel", xe, wi, wg, wo, act)
    out, h = fwd_buffers(xe, f)
    if h is None:
        return out
    KERNEL.launch(xe.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
                  h.data_ptr(), out.data_ptr(), G, E, cap, d, f, _ACTS[act],
                  int(xe.dtype == torch.bfloat16), _stream(xe),
                  work=_work("fwd", xe, f, wg is not None))
    return out


def expert_ffn_dx_cuda(xe, wi, wg, wo, dy, *, act: str = "silu"):
    """dx of :func:`expert_ffn_cuda` for the output cotangent ``dy (G,
    E, cap, d)``, on the card, recomputing the hidden tiles on tensor
    cores: the hidden products leave the float32 (G, E, cap, f) da, dg
    (None when wg is) and h — the dW kernel's inputs — and dx is taken
    from them. Returns (dx, da, dg, h)."""
    G, E, cap, d, f = _check("expert FFN dx kernel", xe, wi, wg, wo, act,
                             dy)
    dx, da, dg, h = dx_buffers(xe, f, wg is not None)
    if dx.numel() == 0:
        return dx, da, dg, h
    KERNEL_DX.launch(xe.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
                     dy.data_ptr(), dx.data_ptr(), da.data_ptr(), _ptr(dg),
                     h.data_ptr(), G, E, cap, d, f, _ACTS[act],
                     int(xe.dtype == torch.bfloat16), _stream(xe),
                     work=_work("dx", xe, f, wg is not None))
    return dx, da, dg, h


def expert_ffn_dw_cuda(xe, dy, da, dg, h):
    """float32 dW of :func:`expert_ffn_cuda`, on the card: dwi [dwg] =
    x^T da [x^T dg] and dwo = h^T dy as tensor-core GEMMs (float32 as
    3xTF32, bfloat16 x/dy against the float32 scratch as two TF32
    products) with x^T and h^T read transposed from the buffer. One
    thread block per (128 x 128 tile, expert) sums over all G * cap rows
    of the expert, group after group, from :func:`expert_ffn_dx_cuda`'s
    ``da``, ``dg`` (None when ungated) and ``h``, each entry in one fixed
    order (no atomics: two calls agree bit for bit). Returns (dwi, dwg,
    dwo) of shapes (E, d, f) / (E, f, d)."""
    name = "expert FFN dW kernel"
    G, E, cap, d = xe.shape
    f = da.shape[-1]
    for t in (xe, dy, da, dg, h):
        if t is not None and (not t.is_cuda or not t.is_contiguous()
                              or t.device != xe.device):
            raise ValueError(f"{name}: inputs must be contiguous CUDA "
                             "tensors on one device")
    if (dy.shape != xe.shape or dy.dtype != xe.dtype
            or xe.dtype not in (torch.float32, torch.bfloat16)
            or da.shape != (G, E, cap, f) or h.shape != da.shape
            or (dg is not None and dg.shape != da.shape)
            or any(t.dtype != torch.float32 for t in (da, dg, h)
                   if t is not None)):
        raise ValueError(f"{name}: xe {tuple(xe.shape)}, dy "
                         f"{tuple(dy.shape)} and float32 da/dg/h "
                         f"{tuple(da.shape)} disagree")
    dwi, dwg, dwo = dw_buffers(xe, f, dg is not None)
    if xe.numel() == 0:
        for t in (dwi, dwg, dwo):
            if t is not None:
                t.zero_()
        return dwi, dwg, dwo
    KERNEL_DW.launch(xe.data_ptr(), dy.data_ptr(), da.data_ptr(), _ptr(dg),
                     h.data_ptr(), dwi.data_ptr(), _ptr(dwg), dwo.data_ptr(),
                     G, E, cap, d, f, int(xe.dtype == torch.bfloat16),
                     _stream(xe), work=_work("dw", xe, f, dg is not None))
    return dwi, dwg, dwo


def expert_ffn_bwd_cuda(xe, wi, wg, wo, dy, *, act: str = "silu"):
    """Gradients (dx, dwi, dwg, dwo) of :func:`expert_ffn_cuda`: the dx
    kernel, then the dW kernel, its float32 sums cast to the weights'
    dtype. The float32 scratch da/dg/h lives between the two launches
    only. dwg is None when wg is."""
    dx, da, dg, h = expert_ffn_dx_cuda(xe, wi, wg, wo, dy, act=act)
    dwi, dwg, dwo = expert_ffn_dw_cuda(xe, dy, da, dg, h)
    del da, dg, h
    return (dx, dwi.to(wi.dtype),
            None if dwg is None else dwg.to(wg.dtype), dwo.to(wo.dtype))


# ---------------------------------------------------------------------------
# the shape-only route on the meta device (the dry run)
# ---------------------------------------------------------------------------


def expert_ffn_meta(xe, wi, wg, wo):
    """:func:`expert_ffn_cuda` on the meta device: its buffers
    (:func:`fwd_buffers`, the scratch dropped at return) and the
    forward's work, which the buffer's shape sets (every slot is
    computed). Returns the output (empty, of its shape and dtype)."""
    out, h = fwd_buffers(xe, wi.shape[-1])
    if h is not None:
        KERNEL.record(_work("fwd", xe, wi.shape[-1], wg is not None))
    return out


def expert_ffn_bwd_meta(xe, wi, wg, wo, dy):
    """:func:`expert_ffn_bwd_cuda` on the meta device: the dx and dW
    kernels' buffers in its order (:func:`dx_buffers`,
    :func:`dw_buffers`; the scratch dropped after the dW kernel, the
    float32 sums cast to the weights' dtype) and their work."""
    f, gated = wi.shape[-1], wg is not None
    dx, da, dg, h = dx_buffers(xe, f, gated)
    KERNEL_DX.record(_work("dx", xe, f, gated))
    dwi, dwg, dwo = dw_buffers(xe, f, gated)
    KERNEL_DW.record(_work("dw", xe, f, gated))
    del da, dg, h
    return (dx, dwi.to(wi.dtype), None if dwg is None else dwg.to(wg.dtype),
            dwo.to(wo.dtype))
