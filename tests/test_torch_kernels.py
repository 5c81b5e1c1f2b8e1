"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped without one). This file imports no JAX,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

float32 tolerance atol/rtol 1e-5: both sides accumulate in f32 and
differ only in summation order; bfloat16 outputs may differ by one
bf16 rounding (2^-8 relative), so they use 1e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.grouped_mlp import (
    ROW_BLOCK,
    ragged_buffer_rows,
    ragged_row_offsets,
)

BS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-2, rtol=1e-2)


def _paged(rng, dev, dtype, rows, H, Kh, dh, nb):
    P = 1 + rows * nb
    kp = torch.tensor(rng.normal(size=(P, BS, Kh, dh)), dtype=dtype, device=dev)
    vp = torch.tensor(rng.normal(size=(P, BS, Kh, dh)), dtype=dtype, device=dev)
    tab = torch.tensor(rng.permutation(np.arange(1, P)).reshape(rows, nb),
                       dtype=torch.int32, device=dev)
    return kp, vp, tab


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Kh", [(16, 8), (8, 1), (4, 4)])
def test_decode_kernel_matches_plain(cuda, dtype, H, Kh):
    rng = np.random.default_rng(H + Kh)
    kp, vp, tab = _paged(rng, cuda, dtype, 5, H, Kh, 64, 6)
    lengths = torch.tensor([0, 1, BS, BS + 1, 6 * BS], dtype=torch.int32,
                           device=cuda)
    q = torch.tensor(rng.normal(size=(5, 1, H, 64)), dtype=dtype, device=cuda)
    y = ops.decode_attention(q, kp, vp, tab, lengths, implementation="cuda")
    want = ops.decode_attention(q, kp, vp, tab, lengths,
                                implementation="eager")
    torch.testing.assert_close(y, want, **_tol(dtype))
    assert torch.equal(y[0], torch.zeros_like(y[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 12])
def test_prefill_kernel_matches_plain(cuda, dtype, C):
    rng = np.random.default_rng(C)
    kp, vp, tab = _paged(rng, cuda, dtype, 3, 16, 8, 64, 8)
    starts = torch.tensor([0, 37, 5], dtype=torch.int32, device=cuda)
    lens = torch.tensor([C, C - 3, 0], dtype=torch.int32, device=cuda)
    q = torch.tensor(rng.normal(size=(3, C, 16, 64)), dtype=dtype,
                     device=cuda)
    y = ops.prefill_attention(q, kp, vp, tab, starts, lens,
                              implementation="cuda")
    want = ops.prefill_attention(q, kp, vp, tab, starts, lens,
                                 implementation="eager")
    torch.testing.assert_close(y, want, **_tol(dtype))
    assert torch.equal(y[2], torch.zeros_like(y[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_grouped_kernel_matches_plain(cuda, dtype, act, gated):
    rng = np.random.default_rng(3)
    G, E, d, f = 2, 5, 128, 96
    counts = np.array([[3, 0, 40, 17, 1], [0, 0, 0, 0, 33]], np.int32)
    M = ragged_buffer_rows(int(counts.sum(-1).max()), E, ROW_BLOCK)
    row_off, _ = ragged_row_offsets(torch.tensor(counts), ROW_BLOCK)
    xs = np.zeros((G, M, d), np.float32)
    for g in range(G):
        for e in range(E):
            s, c = int(row_off[g, e]), int(counts[g, e])
            xs[g, s:s + c] = rng.normal(size=(c, d))
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    w = lambda *s: t(rng.normal(size=s) * 0.1)  # noqa: E731
    args = (t(xs), w(E, d, f), w(E, d, f) if gated else None, w(E, f, d),
            torch.tensor(counts, device=cuda))
    got = ops.grouped_mlp(*args, act=act, implementation="cuda")
    want = ops.grouped_mlp(*args, act=act, implementation="eager")
    torch.testing.assert_close(got, want, **_tol(dtype))
