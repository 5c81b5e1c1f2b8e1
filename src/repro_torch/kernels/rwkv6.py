"""RWKV-6 WKV forward: the CUDA kernel wrapper (port of
``repro/kernels/rwkv6_kernel.py``; the kernel is ``csrc/rwkv6.cu``).

    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);   S_t = diag(w_t) S_{t-1} + k_t v_t^T

The TPU kernel walks chunks of the sequence and turns them into matmuls;
this one runs the recurrence step by step on CUDA cores, one thread
block per (b, h, 64 value columns), each state column's K rows split
over 4 lanes of a warp (2 at K = 8) whose partial sums meet by shuffles,
the bonus term factored out as one scalar a step, and the next tile of
steps staged while the current one is walked; no chunking and no
padding. It is forward-only, as the reference's is (``ops.rwkv6``
raises when autograd would need its gradient).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("rwkv6", "rwkv6_fwd", [_P] * 8 + [_I] * 6 + [_P])
HEAD_SIZES = (8, 16, 32, 64)  # the kernel's K template instances
MAX_V = 1024  # value columns the kernel takes


def buffers(r, v):
    """The wrapper's outputs, in order: (o (B, T, H, V) in v's dtype, the
    float32 final state (B, H, K, V))."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    return (torch.empty((B, T, H, V), dtype=v.dtype, device=r.device),
            torch.empty((B, H, K, V), dtype=torch.float32, device=r.device))


def rwkv6_cuda(r, k, v, w, u, initial_state=None):
    """WKV-6 on the card. r, k (B, T, H, K) and v (B, T, H, V) in one
    dtype (float32 or bfloat16); w (B, T, H, K), u (H, K) and
    initial_state (B, H, K, V) (or None: zeros) in float32; all
    contiguous CUDA tensors on one device. Returns (o (B, T, H, V) in
    v's dtype, final state (B, H, K, V) float32)."""
    name = "WKV-6 kernel"
    B, T, H, K = r.shape
    V = v.shape[-1]
    ins = [t for t in (r, k, v, w, u, initial_state) if t is not None]
    for t in ins:
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor on "
                             "one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {r.dtype} not supported "
                         "(float32, bfloat16)")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"{name}: r, k and v must share one dtype")
    if any(t.dtype != torch.float32 for t in (w, u, initial_state)
           if t is not None):
        raise ValueError(f"{name}: w, u and the state must be float32")
    if (k.shape != r.shape or w.shape != r.shape
            or v.shape[:3] != (B, T, H) or u.shape != (H, K)
            or (initial_state is not None
                and initial_state.shape != (B, H, K, V))):
        raise ValueError(
            f"{name}: shapes r {tuple(r.shape)}, v {tuple(v.shape)}, w "
            f"{tuple(w.shape)}, u {tuple(u.shape)} disagree")
    if K not in HEAD_SIZES or not 1 <= V <= MAX_V:
        raise ValueError(f"{name}: head size K={K} (want one of "
                         f"{HEAD_SIZES}) or V={V} (1..{MAX_V}) not supported")
    o, s_out = buffers(r, v)
    if B * H == 0:
        return o, s_out
    KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(),
                  None if initial_state is None else initial_state.data_ptr(),
                  o.data_ptr(), s_out.data_ptr(), B, T, H, K, V,
                  int(r.dtype == torch.bfloat16),
                  torch.cuda.current_stream(r.device).cuda_stream,
                  work=lambda: tiling.wkv_work(
                      B, T, H, K, V, itemsize=r.element_size(),
                      state_in=initial_state is not None))
    return o, s_out


def rwkv6_meta(r, k, v, w, u, initial_state=None):
    """:func:`rwkv6_cuda`'s (o, final state) on the meta device
    (:func:`buffers`, empty); records the call's work."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    KERNEL.record(lambda: tiling.wkv_work(
        B, T, H, K, V, itemsize=r.element_size(),
        state_in=initial_state is not None))
    return buffers(r, v)
