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


# ---------------------------------------------------------------------------
# training kernels: flash attention forward/backward, grouped backward
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, Kh, dh, causal, q_offset, kv_len)
FLASH_CASES = [
    (2, 64, 64, 16, 8, 64, True, 0, None),     # granite's heads, causal
    (1, 37, 50, 4, 2, 16, True, 13, 45),       # ragged tiles, offset
    (2, 70, 70, 8, 1, 64, False, 0, 51),       # non-causal, kv_len mask
    (1, 20, 40, 4, 4, 32, True, -10, 40),      # rows with no valid key
    (2, 196, 196, 12, 12, 64, False, 0, None),  # ViT-B/16: non-causal MHA
]


def _flash_inputs(rng, dev, dtype, B, Sq, Skv, H, Kh, dh):
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=dtype,  # noqa
                                device=dev)
    return t(B, Sq, H, dh), t(B, Skv, Kh, dh), t(B, Skv, Kh, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, case):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, Sq, Skv, H, Kh, dh, causal, qoff, kvlen = case
    rng = np.random.default_rng(Sq)
    q, k, v = _flash_inputs(rng, cuda, dtype, B, Sq, Skv, H, Kh, dh)
    kvlen = Skv if kvlen is None else kvlen
    qo, kl = fa.scalar_i32(qoff, cuda), fa.scalar_i32(kvlen, cuda)
    kw = dict(causal=causal, q_offset=qo, kv_len=kl)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, qo, kl, causal=causal)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(o, o_ref, **_tol(dtype))
    torch.testing.assert_close(lse, lse_ref, **_tol(torch.float32))
    dead = torch.isinf(lse_ref)
    if qoff < 0:
        assert bool(dead.any())
    assert torch.equal(torch.isinf(lse), dead)
    dead_rows = dead.transpose(1, 2)[..., None].expand_as(o)
    assert bool((o[dead_rows] == 0).all())
    do = torch.tensor(rng.normal(size=o.shape), dtype=dtype, device=cuda)
    got = fa.flash_attention_bwd_cuda(q, k, v, o_ref, lse_ref, do, qo, kl,
                                      causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(dtype))


@pytest.mark.cuda
def test_flash_autograd_cuda_matches_eager(cuda):
    rng = np.random.default_rng(7)
    q, k, v = _flash_inputs(rng, cuda, torch.float32, 2, 48, 48, 16, 8, 64)
    do = torch.tensor(rng.normal(size=q.shape), dtype=torch.float32,
                      device=cuda)
    outs = {}
    for impl in ("cuda", "eager"):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*xs, causal=True, implementation=impl)
        outs[impl] = (o, *torch.autograd.grad(o, xs, do))
    for a, b in zip(outs["cuda"], outs["eager"]):
        torch.testing.assert_close(a, b, **_tol(torch.float32))


def _ragged(rng, dev, dtype, counts, E, d):
    counts = np.asarray(counts, np.int32)
    G = counts.shape[0]
    M = ragged_buffer_rows(int(counts.sum(-1).max()), E, ROW_BLOCK)
    row_off, _ = ragged_row_offsets(torch.tensor(counts), ROW_BLOCK)
    xs = np.zeros((G, M, d), np.float32)
    dy = np.zeros((G, M, d), np.float32)
    for g in range(G):
        for e in range(E):
            s, c = int(row_off[g, e]), int(counts[g, e])
            xs[g, s:s + c] = rng.normal(size=(c, d))
            dy[g, s:s + c] = rng.normal(size=(c, d))
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return t(xs), t(dy), torch.tensor(counts, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated,d,f", [("silu", True, 128, 96),
                                          ("gelu", False, 128, 96),
                                          ("silu", True, 1024, 512)])
def test_grouped_backward_kernels_match_plain(cuda, dtype, act, gated, d, f):
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    E = 5
    xs, dy, counts = _ragged(rng, cuda, dtype,
                             [[3, 0, 40, 17, 1], [0, 0, 0, 0, 33]], E, d)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    # Weights at fan-in scale, as the model initialises them.
    wi, wo = t(rng.normal(size=(E, d, f)) / d ** 0.5), \
        t(rng.normal(size=(E, f, d)) / f ** 0.5)
    wg = t(rng.normal(size=(E, d, f)) / d ** 0.5) if gated else None
    got = gm.grouped_mlp_bwd_cuda(xs, wi, wg, wo, dy, counts, act=act)
    want = ref.grouped_mlp_bwd_ref(xs, wi, wg, wo, dy, counts,
                                   block=ROW_BLOCK, act=act)
    tol = _tol(dtype)
    if dtype == torch.float32 and d > 128:
        # dW sums, over a segment's rows, products whose factors are
        # themselves sums over d = 1024 terms in another order.
        tol = dict(atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, **tol)
    # Dead blocks (tail blocks, empty experts) give dx = 0; an expert
    # with no rows in any group gets zero dW.
    nb = xs.shape[1] // ROW_BLOCK
    _, bl = gm.block_tables(counts.to(torch.int32), ROW_BLOCK, nb)
    dead = (bl == 0).repeat_interleave(ROW_BLOCK, 1)
    assert bool((got[0][dead] == 0).all())
    assert bool((got[1][1] == 0).all()) and bool((got[3][1] == 0).all())


@pytest.mark.cuda
def test_grouped_autograd_cuda_matches_eager(cuda):
    rng = np.random.default_rng(11)
    E, d, f = 4, 64, 32
    xs, dy, counts = _ragged(rng, cuda, torch.float32,
                             [[20, 0, 5, 31], [16, 2, 0, 0]], E, d)
    w = lambda *s: torch.tensor(rng.normal(size=s) * 0.1,  # noqa: E731
                                dtype=torch.float32, device=cuda)
    wi, wg, wo = w(E, d, f), w(E, d, f), w(E, f, d)
    outs = {}
    for impl in ("cuda", "eager"):
        ps = [p.clone().requires_grad_() for p in (xs, wi, wg, wo)]
        y = ops.grouped_mlp(*ps, counts, implementation=impl)
        outs[impl] = (y, *torch.autograd.grad(y, ps, dy))
    for a, b in zip(outs["cuda"], outs["eager"]):
        torch.testing.assert_close(a, b, **_tol(torch.float32))


# ---------------------------------------------------------------------------
# expert FFN kernels over the padded capacity buffer
# ---------------------------------------------------------------------------

# (G, E, cap, d, f): cap not a multiple of the 32-row block, f not a
# multiple of the 256-column tile; the last case has d > 768, so the
# forward and dx kernels make two passes over the output columns.
EXPERT_CASES = [(2, 3, 37, 64, 96), (1, 2, 70, 200, 300),
                (2, 2, 33, 1024, 260)]


def _expert_inputs(rng, dev, dtype, G, E, cap, d, f, gated):
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    xe = rng.normal(size=(G, E, cap, d))
    xe[0, 0, -3:] = 0.0  # unfilled slots arrive as zero rows
    dy = rng.normal(size=(G, E, cap, d))
    # Weights at fan-in scale, as the model initialises them.
    wi = rng.normal(size=(E, d, f)) / d ** 0.5
    wg = rng.normal(size=(E, d, f)) / d ** 0.5 if gated else None
    wo = rng.normal(size=(E, f, d)) / f ** 0.5
    return t(xe), t(wi), None if wg is None else t(wg), t(wo), t(dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True)])
@pytest.mark.parametrize("case", EXPERT_CASES)
def test_expert_kernels_match_plain(cuda, dtype, act, gated, case):
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import ref

    G, E, cap, d, f = case
    rng = np.random.default_rng(cap + d)
    xe, wi, wg, wo, dy = _expert_inputs(rng, cuda, dtype, *case, gated)
    tol = _tol(dtype)
    if dtype == torch.float32 and d > 128:
        # Sums of products whose factors are themselves sums over d terms,
        # taken in another order (as in the grouped backward test).
        tol = dict(atol=1e-4, rtol=1e-4)
    y = em.expert_ffn_cuda(xe, wi, wg, wo, act=act)
    torch.testing.assert_close(y, ref.expert_ffn_ref(xe, wi, wg, wo,
                                                     act=act), **tol)
    assert bool((y[0, 0, -3:] == 0).all())  # zero rows give zeros
    got = em.expert_ffn_dx_cuda(xe, wi, wg, wo, dy, act=act)
    want = ref.expert_ffn_dx_ref(xe, wi, wg, wo, dy, act=act)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, **tol)
    scratch = [None if t is None else t.contiguous() for t in want[1:]]
    got = em.expert_ffn_dw_cuda(xe, dy, *scratch)
    for g, w in zip(got, ref.expert_ffn_dw_ref(xe, dy, *scratch)):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, **tol)
    # A zero row adds nothing to dW: dropping its scratch rows changes
    # no weight gradient.
    da, dg, h = (None if t is None else t.clone() for t in scratch)
    for t in (da, dg, h):
        if t is not None:
            t[0, 0, -3:] = 0.0
    for g, w in zip(got, em.expert_ffn_dw_cuda(xe, dy, da, dg, h)):
        if g is not None:
            torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_expert_autograd_cuda_matches_eager(cuda, gated):
    rng = np.random.default_rng(13)
    xe, wi, wg, wo, dy = _expert_inputs(rng, cuda, torch.float32, 2, 4, 40,
                                        96, 160, gated)
    act = "silu" if gated else "gelu"
    for squeeze in (False, True):
        x, gy = (xe[0], dy[0]) if squeeze else (xe, dy)
        outs = {}
        for impl in ("cuda", "eager"):
            ps = [p.clone().requires_grad_() for p in (x, wi, wo)]
            pg = wg.clone().requires_grad_() if gated else None
            y = ops.expert_ffn(ps[0], ps[1], pg, ps[2], act=act,
                               implementation=impl)
            outs[impl] = (y, *torch.autograd.grad(
                y, ps + ([pg] if gated else []), gy))
        for a, b in zip(outs["cuda"], outs["eager"]):
            torch.testing.assert_close(a, b, **_tol(torch.float32))
