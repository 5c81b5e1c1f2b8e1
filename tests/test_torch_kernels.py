"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped without one). This file imports no JAX,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

float32 tolerance atol/rtol 1e-5: both sides accumulate in f32 and
differ only in summation order; bfloat16 outputs may differ by one
bf16 rounding (2^-8 relative), so they use 1e-2."""
import re
from pathlib import Path

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


def _paged(rng, dev, dtype, rows, H, Kh, dh, nb, bs=BS):
    P = 1 + rows * nb
    kp = torch.tensor(rng.normal(size=(P, bs, Kh, dh)), dtype=dtype, device=dev)
    vp = torch.tensor(rng.normal(size=(P, bs, Kh, dh)), dtype=dtype, device=dev)
    tab = torch.tensor(rng.permutation(np.arange(1, P)).reshape(rows, nb),
                       dtype=torch.int32, device=dev)
    return kp, vp, tab


# (H, Kh, dh, bs, nb) of the decode cases: granite's heads at 16-token
# blocks; GQA groups 1, 5 (qwen2.5-14b), 8 (yi-9b) and 64; dh 16, 32, 64
# and 128; blocks of 8, 16 and 48 tokens.
DECODE_CASES = [(16, 8, 64, 16, 6), (8, 8, 32, 8, 9), (40, 8, 128, 16, 5),
                (32, 4, 128, 48, 4), (64, 1, 64, 16, 4), (8, 1, 16, 16, 4)]
DTYPE_PAIRS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32)]


def _decode_lengths(bs, nb, dev):
    """A free slot, one key, one and a bit more than one block, and walks
    of 3 and 4 blocks (run boundaries at 1..4 runs) up to the tables'
    capacity."""
    return torch.tensor([0, 1, bs, bs + 1, 3 * bs, 4 * bs - 1, nb * bs],
                        dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, q_dtype, kv_dtype, case):
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_cuda,
    )

    H, Kh, dh, bs, nb = case
    rng = np.random.default_rng(H + Kh + dh + bs)
    kp, vp, tab = _paged(rng, cuda, kv_dtype, 7, H, Kh, dh, nb, bs)
    lengths = _decode_lengths(bs, nb, cuda)
    q = torch.tensor(rng.normal(size=(7, 1, H, dh)), dtype=q_dtype,
                     device=cuda)
    y = ops.decode_attention(q, kp, vp, tab, lengths, implementation="cuda")
    want = ops.decode_attention(q, kp, vp, tab, lengths,
                                implementation="eager")
    # The output is in q's dtype; a bf16 pool is exact in float32.
    torch.testing.assert_close(y, want, **_tol(q_dtype))
    assert torch.equal(y[0], torch.zeros_like(y[0]))
    # Each walk in one block, and split into 2, 3 and nb runs.
    for splits in (1, 2, 3, nb):
        y = paged_decode_attention_cuda(q[:, 0], kp, vp, tab, lengths,
                                        splits=splits)
        torch.testing.assert_close(y, want[:, 0], **_tol(q_dtype))
        assert torch.equal(y[0], torch.zeros_like(y[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_holds_large_scores(cuda, kv_dtype):
    """q and k of the sizes a randomly initialised model gives them (|q|,
    |k| ~ 20-40 at granite's reference init), where exp() turns a score's
    rounding into the output's: the float32 output holds the float32
    tolerance (the scores are f32 FMAs)."""
    rng = np.random.default_rng(7)
    kp, vp, tab = _paged(rng, cuda, torch.float32, 7, 16, 8, 64, 7)
    kp, vp = (10 * t for t in (kp, vp))
    kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    lengths = _decode_lengths(BS, 7, cuda)
    q = torch.tensor(10 * rng.normal(size=(7, 1, 16, 64)),
                     dtype=torch.float32, device=cuda)
    y = ops.decode_attention(q, kp, vp, tab, lengths, implementation="cuda")
    want = ops.decode_attention(q, kp, vp, tab, lengths,
                                implementation="eager")
    torch.testing.assert_close(y, want, **_tol(torch.float32))


def test_decode_split_covers_the_card():
    """The decode walk's run count (CPU): the serve shapes' 64 walks (8
    slots x 8 kv heads, 32-entry tables) are cut into 8 runs of at most
    four pool blocks, one a warp; a batch that fills the card four times
    over, or tables of under eight entries, walk unsplit."""
    from repro_torch.kernels.decode_attention import pick_splits

    assert pick_splits(64, 32, 132) == 8
    assert pick_splits(128, 32, 132) == 5
    assert pick_splits(528, 32, 132) == 1
    assert pick_splits(64, 7, 132) == 1
    assert pick_splits(1, 1024, 132) == 256


def test_prefill_split_covers_the_card():
    """The split walk's run count (CPU): the serve shapes' 32 blocks
    (2 lanes x 8 kv heads x 2 q tiles, 512-token tables) are cut into 5
    runs for 132 SMs; a grid that fills the card, or tables of under four
    32-key tiles, walk unsplit."""
    from repro_torch.kernels.paged_prefill import pick_splits

    assert pick_splits(32, 16, 132) == 5
    assert pick_splits(132, 16, 132) == 1
    assert pick_splits(500, 64, 132) == 1
    assert pick_splits(24, 3, 132) == 1
    assert pick_splits(1, 8, 132) == 4


# (C, H, Kh, dh, bs, starts) of three chunk lanes with lens (C, C - 3,
# 0): granite's heads at 16-token blocks, a full and a partial chunk;
# GQA groups 1, 5 (a 60-row tile) and 8; dh 128 and 32; blocks of 8 and
# 48 tokens; starts off the block and the 32-key tile grid.
PREFILL_CASES = [
    (64, 16, 8, 64, 16, (0, 37, 5)),
    (12, 16, 8, 64, 16, (0, 37, 5)),
    (64, 4, 4, 64, 8, (3, 45, 77)),
    (40, 10, 2, 128, 48, (13, 100, 0)),
    (33, 16, 2, 32, 16, (50, 7, 90)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_kernel_matches_plain(cuda, q_dtype, kv_dtype, case):
    C, H, Kh, dh, bs, starts = case
    rng = np.random.default_rng(C + H + bs)
    nb = -(-(max(starts) + C) // bs)
    kp, vp, tab = _paged(rng, cuda, kv_dtype, 3, H, Kh, dh, nb, bs)
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    lens = torch.tensor([C, C - 3, 0], dtype=torch.int32, device=cuda)
    q = torch.tensor(rng.normal(size=(3, C, H, dh)), dtype=q_dtype,
                     device=cuda)
    y = ops.prefill_attention(q, kp, vp, tab, starts, lens,
                              implementation="cuda")
    want = ops.prefill_attention(q, kp, vp, tab, starts, lens,
                                 implementation="eager")
    # The output is in q's dtype; a bf16 pool is exact in float32.
    torch.testing.assert_close(y, want, **_tol(q_dtype))
    assert torch.equal(y[2], torch.zeros_like(y[2]))
    assert torch.equal(y[1, C - 3:], torch.zeros_like(y[1, C - 3:]))
    # Each walk in one block, and split over three.
    from repro_torch.kernels.paged_prefill import paged_prefill_attention_cuda
    for splits in (1, 3):
        y = paged_prefill_attention_cuda(q, kp, vp, tab, starts, lens,
                                         splits=splits)
        torch.testing.assert_close(y, want, **_tol(q_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_holds_large_scores(cuda, kv_dtype):
    """q and k of the sizes a randomly initialised model gives them (|q|,
    |k| ~ 20-40 at granite's reference init), where exp() turns a score's
    rounding into the output's: a float32 output holds the float32
    tolerance (its scores are f32 FMAs, csrc/flash_tile.cuh)."""
    rng = np.random.default_rng(7)
    kp, vp, tab = _paged(rng, cuda, torch.float32, 3, 16, 8, 64, 7)
    kp, vp = (10 * t for t in (kp, vp))
    kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    starts = torch.tensor([0, 37, 5], dtype=torch.int32, device=cuda)
    lens = torch.tensor([64, 61, 0], dtype=torch.int32, device=cuda)
    q = torch.tensor(10 * rng.normal(size=(3, 64, 16, 64)),
                     dtype=torch.float32, device=cuda)
    y = ops.prefill_attention(q, kp, vp, tab, starts, lens,
                              implementation="cuda")
    want = ops.prefill_attention(q, kp, vp, tab, starts, lens,
                                 implementation="eager")
    torch.testing.assert_close(y, want, **_tol(torch.float32))


# Ragged buffers that break the grouped kernels' row tiles, (counts (G,
# E), d, f): short segments and an empty expert in one group, one expert
# holding all rows in the other (the original case); a segment of 300
# rows (several tiles, the last ragged), counts that are multiples of 16
# and empty experts; a group with every block dead; d and f not
# multiples of the 128-column tile; d = 97 and f = 130, whose rows are
# not 16-byte aligned (staged element by element); the serve step's skew
# (32 experts, two empty; see _serve_counts) at granite's widths.
GROUPED_CASES = [
    ([[3, 0, 40, 17, 1], [0, 0, 0, 0, 33]], 128, 96),
    ([[300, 0, 16, 5], [32, 48, 0, 7]], 64, 96),
    ([[0, 0, 0, 0], [20, 0, 64, 1]], 128, 64),
    ([[70, 0, 130, 3], [0, 200, 9, 0]], 200, 300),
    ([[40, 0, 17], [3, 90, 0]], 97, 130),
    ("serve", 1024, 512),
]


def _serve_counts():
    """The serve step's routing: 1,088 assignments over 32 experts,
    skewed, experts 5 and 17 empty (chip_smoke.grouped_case)."""
    rng = np.random.default_rng(1)
    w = rng.random(32) ** 3
    w[[5, 17]] = 0.0
    c = np.floor(w / w.sum() * 1088).astype(np.int32)
    c[0] += 1088 - c.sum()
    return [c.tolist()]


def _poison(like, dtype=None):
    """Leave NaNs in the caching allocator's next block of this size, so
    a row the kernel does not write shows as NaN."""
    torch.full_like(like, float("nan"), dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
@pytest.mark.parametrize("bm", [16, 64, 128])
@pytest.mark.parametrize("case", GROUPED_CASES)
def test_grouped_kernel_matches_plain(cuda, monkeypatch, dtype, act, gated,
                                      bm, case):
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    # Each row tiling on every case, whatever row_tile would pick.
    monkeypatch.setattr(gm, "row_tile", lambda *_: bm)
    counts, d, f = case
    counts = _serve_counts() if counts == "serve" else counts
    rng = np.random.default_rng(3)
    E = len(counts[0])
    xs, _, counts = _ragged(rng, cuda, dtype, counts, E, d)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    # Weights at fan-in scale, as the model initialises them.
    wi, wo = t(rng.normal(size=(E, d, f)) / d ** 0.5), \
        t(rng.normal(size=(E, f, d)) / f ** 0.5)
    wg = t(rng.normal(size=(E, d, f)) / d ** 0.5) if gated else None
    _poison(xs)
    got = gm.grouped_mlp_cuda(xs, wi, wg, wo, counts, act=act)
    want = ref.grouped_mlp_ref(xs, wi, wg, wo, counts, block=ROW_BLOCK,
                               act=act)
    tol = _tol(dtype)
    if dtype == torch.float32 and d > 128:
        # Sums of products whose factors are themselves sums over d terms,
        # in another order (as in the expert kernels' test).
        tol = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    # Every row is written: the dead blocks' rows are zero.
    nb = xs.shape[1] // ROW_BLOCK
    _, bl = gm.block_tables(counts, ROW_BLOCK, nb)
    assert bool((got[(bl == 0).repeat_interleave(ROW_BLOCK, 1)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_grouped_kernel_through_ops(cuda, act, gated):
    rng = np.random.default_rng(3)
    E, d, f = 5, 128, 96
    xs, _, counts = _ragged(rng, cuda, torch.float32,
                            [[3, 0, 40, 17, 1], [0, 0, 0, 0, 33]], E, d)
    w = lambda *s: torch.tensor(rng.normal(size=s) * 0.1,  # noqa: E731
                                dtype=torch.float32, device=cuda)
    args = (xs, w(E, d, f), w(E, d, f) if gated else None, w(E, f, d),
            counts)
    got = ops.grouped_mlp(*args, act=act, implementation="cuda")
    want = ops.grouped_mlp(*args, act=act, implementation="eager")
    torch.testing.assert_close(got, want, **_tol(torch.float32))


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


# Shapes that break the forward's tilings (B, Sq, Skv, H, Kh, dh, causal,
# q_offset, kv_len): the ViT's 196 positions (a ragged last kv tile), G =
# 1, 2, 4; a causal chunk at q_offset > 0 with kv_len < Skv, as the
# static prefill calls it; rows with no valid key; every head dim the
# forward is built for.
FLASH_FWD_CASES = [
    (2, 196, 196, 12, 12, 64, False, 0, None),
    (1, 130, 200, 16, 8, 64, True, 50, 170),
    (2, 77, 77, 16, 4, 64, True, 0, None),
    (1, 40, 64, 8, 2, 128, True, -12, 50),
    (1, 33, 90, 16, 16, 16, False, 0, 70),
    (2, 45, 45, 8, 4, 32, True, 0, 30),
]


def _flash_inputs(rng, dev, dtype, B, Sq, Skv, H, Kh, dh):
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=dtype,  # noqa
                                device=dev)
    return t(B, Sq, H, dh), t(B, Skv, Kh, dh), t(B, Skv, Kh, dh)


# The largest GQA group the kernels take (the forward's 64 heads a kv
# head), at the old backward's limit G * dh = 2048.
FLASH_MAX_GROUP_CASE = (1, 24, 40, 64, 1, 32, True, 8, 36)
# The backward at every forward tiling too: dh 128, G = 1-4, q_offset >
# 0 with kv_len < Skv, rows with no valid key.
FLASH_BWD_CASES = FLASH_CASES + [c for c in FLASH_FWD_CASES
                                 if c not in FLASH_CASES] + \
    [FLASH_MAX_GROUP_CASE]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
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
@pytest.mark.parametrize("S,H,Kh,causal", [(48, 16, 8, True),     # granite
                                           (196, 12, 12, False)])  # ViT
def test_flash_autograd_cuda_matches_eager(cuda, S, H, Kh, causal):
    rng = np.random.default_rng(7)
    q, k, v = _flash_inputs(rng, cuda, torch.float32, 2, S, S, H, Kh, 64)
    do = torch.tensor(rng.normal(size=q.shape), dtype=torch.float32,
                      device=cuda)
    outs = {}
    for impl in ("cuda", "eager"):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*xs, causal=causal, implementation=impl)
        outs[impl] = (o, *torch.autograd.grad(o, xs, do))
    for a, b in zip(outs["cuda"], outs["eager"]):
        torch.testing.assert_close(a, b, **_tol(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_FWD_CASES)
def test_flash_forward_tilings(cuda, dtype, case):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, Sq, Skv, H, Kh, dh, causal, qoff, kvlen = case
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = _flash_inputs(rng, cuda, dtype, B, Sq, Skv, H, Kh, dh)
    kvlen = Skv if kvlen is None else kvlen
    qo, kl = fa.scalar_i32(qoff, cuda), fa.scalar_i32(kvlen, cuda)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, qo, kl, causal=causal)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                             q_offset=qo, kv_len=kl)
    torch.testing.assert_close(o, o_ref, **_tol(dtype))
    torch.testing.assert_close(lse, lse_ref, **_tol(torch.float32))
    dead = torch.isinf(lse_ref)
    assert bool(dead.any()) == (qoff < 0)
    assert torch.equal(torch.isinf(lse), dead)
    assert bool((o[dead.transpose(1, 2)[..., None].expand_as(o)] == 0).all())


# (B, S, H, Kh, causal): causal at granite's heads, non-causal at the
# ViT's (196 positions, a ragged last kv tile); dh 64.
LARGE_SCORE_CASES = [(2, 128, 16, 8, True), (2, 196, 12, 12, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LARGE_SCORE_CASES)
def test_flash_kernels_hold_large_scores(cuda, case):
    """q and k of the sizes granite's reference init gives them (|q| up
    to 31, |k| up to 42), where exp() turns a score's rounding into the
    output's, and ds = p (dP - delta) cancels where p is near one-hot:
    the float32 forward, dq and dk/dv each hold the float32 tolerance of
    their plain versions (S, and the backward's dP, are f32 FMAs:
    csrc/flash_tile.cuh, csrc/flash_attention_bwd.cu)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, Kh, causal = case
    rng = np.random.default_rng(S)
    q, k, v = _flash_inputs(rng, cuda, torch.float32, B, S, S, H, Kh, 64)
    q, k = 10 * q, 10 * k
    qo, kl = fa.scalar_i32(0, cuda), fa.scalar_i32(S, cuda)
    kw = dict(causal=causal, q_offset=qo, kv_len=kl)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, qo, kl, causal=causal)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, **kw)
    assert float(q.abs().max()) > 30 and float(k.abs().max()) > 30
    torch.testing.assert_close(o, o_ref, **_tol(torch.float32))
    torch.testing.assert_close(lse, lse_ref, **_tol(torch.float32))
    do = torch.tensor(rng.normal(size=o.shape), dtype=torch.float32,
                      device=cuda)
    delta = fa.attention_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta, qo, kl)
    got = (fa.flash_attention_dq_cuda(*args, causal=causal),
           *fa.flash_attention_dkv_cuda(*args, causal=causal))
    want = ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, **_tol(torch.float32),
                                   msg=lambda m, n=name: f"{n}: {m}")


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
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("case", GROUPED_CASES + [
    ([[3, 0, 40, 17, 1], [0, 0, 0, 0, 33]], 1024, 512)])
def test_grouped_backward_kernels_match_plain(cuda, monkeypatch, dtype, act,
                                              gated, bm, case):
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    # Each of the dx kernel's row tilings on every case.
    monkeypatch.setattr(gm, "row_tile", lambda *_: bm)
    counts, d, f = case
    counts = _serve_counts() if counts == "serve" else counts
    rng = np.random.default_rng(5)
    E = len(counts[0])
    xs, dy, counts = _ragged(rng, cuda, dtype, counts, E, d)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    # Weights at fan-in scale, as the model initialises them.
    wi, wo = t(rng.normal(size=(E, d, f)) / d ** 0.5), \
        t(rng.normal(size=(E, f, d)) / f ** 0.5)
    wg = t(rng.normal(size=(E, d, f)) / d ** 0.5) if gated else None
    _poison(xs)
    dx, da, dg, h = gm.grouped_mlp_dx_cuda(xs, wi, wg, wo, dy, counts,
                                           act=act)
    dw = gm.grouped_mlp_dw_cuda(xs, dy, da, dg, h, counts)
    got = (dx, *(None if w is None else w.to(dtype) for w in dw))
    want = ref.grouped_mlp_bwd_ref(xs, wi, wg, wo, dy, counts,
                                   block=ROW_BLOCK, act=act)
    tol = _tol(dtype)
    if dtype == torch.float32 and d > 128:
        # dx sums over f products whose factors are themselves sums over
        # d terms, in another order (as in the forward's test).
        tol = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dx, want[0], **tol)
    if dtype == torch.float32:
        # dW against the float64 sums of the same inputs (the dx kernel's
        # scratch), so that only the dW kernel's order is held. A float32
        # sum over a segment deeper than 128 rows (300 here; the serve
        # skew's largest) may part from float64 by more than the float32
        # tolerance, as a row-after-row float32 sum in numpy does on these
        # inputs: such cases take 1e-4.
        row_off, _ = ragged_row_offsets(counts, ROW_BLOCK)
        x64, dy64 = xs.double(), dy.double()

        def dw64(a, b):
            out = torch.zeros((E, a.shape[-1], b.shape[-1]),
                              dtype=torch.float64, device=cuda)
            for g_, row in enumerate(counts.tolist()):
                for e, n in enumerate(row):
                    s = int(row_off[g_, e])
                    out[e] += a[g_, s:s + n].T @ b[g_, s:s + n]
            return out

        want = (None, dw64(x64, da.double()),
                None if dg is None else dw64(x64, dg.double()),
                dw64(h.double(), dy64))
        tol = (_tol(dtype) if int(counts.max()) <= 128
               else dict(atol=1e-4, rtol=1e-4))
    for g, w in zip(got[1:], want[1:]):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g.to(w.dtype), w, **tol)
    # The scratch the dW kernel reads, on the live blocks' rows.
    nb = xs.shape[1] // ROW_BLOCK
    _, bl = gm.block_tables(counts, ROW_BLOCK, nb)
    live = (bl == 1).repeat_interleave(ROW_BLOCK, 1)
    _, da_r, dg_r, h_r = ref.grouped_mlp_dx_ref(xs, wi, wg, wo, dy, counts,
                                                block=ROW_BLOCK, act=act)
    for g, w in ((da, da_r), (dg, dg_r), (h, h_r)):
        if w is not None:
            torch.testing.assert_close(g[live], w[live],
                                       **_tol(torch.float32) if d <= 128
                                       else dict(atol=1e-4, rtol=1e-4))
    # Dead blocks (tail blocks, empty experts) give dx = 0; an expert
    # with no rows in any group gets zero dW.
    assert bool((dx[~live] == 0).all())
    idle = (counts == 0).all(0)
    for w in got[1:]:
        if w is not None:
            assert bool((w[idle] == 0).all())


# (counts (G, E), d, f) for the dW kernel's walk over each expert's
# segments in every group: segments around the 64-row slab (63, 64, 65,
# 200 rows in each group); an expert empty in every group, experts live
# in one group only; three groups, rows not 16-byte aligned (d 97, f
# 130: staged element by element) and an expert empty everywhere.
GROUPED_DW_CASES = [
    ([[63, 64, 65, 200], [200, 65, 64, 63]], 128, 96),
    ([[0, 70, 0, 5], [0, 0, 130, 0]], 96, 160),
    ([[33, 0, 64], [0, 0, 1], [17, 0, 0]], 97, 130),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("case", GROUPED_DW_CASES)
def test_grouped_dw_kernel_walks_segments(cuda, dtype, gated, case):
    """The dW kernel sums every group's segment of an expert in one
    block: against float64 sums over the valid rows, with every other
    row of its inputs NaN (a row read past a segment shows); zeros for an
    expert with no rows; two calls give the same bits."""
    from repro_torch.kernels import grouped_mlp as gm

    counts, d, f = case
    rng = np.random.default_rng(9)
    E = len(counts[0])
    xs, dy, counts = _ragged(rng, cuda, dtype, counts, E, d)
    G, M, _ = xs.shape
    row_off, _ = ragged_row_offsets(counts, ROW_BLOCK)
    valid = torch.zeros(G, M, dtype=torch.bool, device=cuda)
    for g_, row in enumerate(counts.tolist()):
        for e, n in enumerate(row):
            s = int(row_off[g_, e])
            valid[g_, s:s + n] = True
    nan = float("nan")
    xs, dy = (t.masked_fill(~valid[..., None], nan) for t in (xs, dy))
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=cuda).masked_fill(~valid[..., None],
                                                        nan)
    da, h = t(rng.normal(size=(G, M, f))), t(rng.normal(size=(G, M, f)))
    dg = t(rng.normal(size=(G, M, f))) if gated else None
    dw = gm.grouped_mlp_dw_cuda(xs, dy, da, dg, h, counts)
    again = gm.grouped_mlp_dw_cuda(xs, dy, da, dg, h, counts)

    def dw64(a, b):
        out = torch.zeros((E, a.shape[-1], b.shape[-1]),
                          dtype=torch.float64, device=cuda)
        for g_, row in enumerate(counts.tolist()):
            for e, n in enumerate(row):
                s = int(row_off[g_, e])
                out[e] += a[g_, s:s + n].double().T @ b[g_, s:s + n].double()
        return out

    want = (dw64(xs, da), None if dg is None else dw64(xs, dg),
            dw64(h, dy))
    # As test_grouped_backward_kernels_match_plain holds the f32 dW.
    tol = (_tol(torch.float32) if int(counts.max()) <= 128
           else dict(atol=1e-4, rtol=1e-4))
    idle = (counts == 0).all(0)
    for got, rep, w in zip(dw, again, want):
        if w is None:
            assert got is None and rep is None
            continue
        assert got.dtype == torch.float32 and got.shape == w.shape
        torch.testing.assert_close(got.double(), w, **tol)
        assert torch.equal(got, rep)
        assert bool((got[idle] == 0).all())


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

# (G, E, cap, d, f) for the dx kernel's tilings (as the forward's: 16-,
# 64- or 128-row tiles by cap, gated at most 64, 128-column tiles of f in
# the hidden pass and of d in the out pass): cap 9 (one 16-row tile), 37
# and 33 (64-row tiles), 70 (one 128-row tile; two of 64 gated); d and f
# not multiples of the 128-column tile; d = 97 and f = 130, whose rows
# are not 16-byte aligned (staged element by element).
EXPERT_CASES = [(2, 3, 37, 64, 96), (1, 2, 70, 200, 300),
                (2, 2, 33, 1024, 260), (2, 3, 9, 128, 200),
                (1, 2, 20, 97, 130)]


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
@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("sqrelu", False)])
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


# (G, E, cap, d, f) of dW cases. The depth, an expert's G * cap rows,
# walks the groups in 64-row slabs. cap 37 and 9 over 3 groups and cap 48
# over 5 are not multiples of 64, so slabs cross group boundaries (each
# chunk finds its row); cap 64 over 2 groups and 128 over 3 are, so each
# slab lies in one group (staged as one run of rows), with d and f not
# multiples of the 128-column tile, and d = 97 in rows that are not
# 16-byte aligned (staged element by element).
DW_CASES = [(3, 2, 37, 64, 96), (3, 2, 9, 128, 200), (5, 2, 48, 96, 160),
            (2, 2, 64, 96, 160), (3, 2, 128, 97, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("case", DW_CASES)
def test_expert_dw_kernel_crosses_groups(cuda, dtype, gated, case):
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import ref

    G, E, cap, d, f = case
    rng = np.random.default_rng(G * cap + d)
    xe, wi, wg, wo, dy = _expert_inputs(rng, cuda, dtype, *case, gated)
    act = "silu" if gated else "gelu"
    scratch = [None if t is None else t.contiguous() for t in
               ref.expert_ffn_dx_ref(xe, wi, wg, wo, dy, act=act)[1:]]
    got = em.expert_ffn_dw_cuda(xe, dy, *scratch)
    if dtype == torch.float32:
        # The plain version's sums in float64: at depth 3 x 128 the float32
        # plain version's own rounding reaches the float32 tolerance.
        x, gy, da, dg, h = (None if t is None else t.double()
                            for t in (xe, dy, *scratch))
        dw = lambda a, b: torch.einsum("gecm,gecn->emn", a, b)  # noqa
        want = (dw(x, da), None if dg is None else dw(x, dg), dw(h, gy))
    else:
        want = ref.expert_ffn_dw_ref(xe, dy, *scratch)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g.to(w.dtype), w, **_tol(dtype))
    # Each entry is summed in one fixed order: two calls agree bit for bit.
    for g, w in zip(got, em.expert_ffn_dw_cuda(xe, dy, *scratch)):
        if g is not None:
            assert torch.equal(g, w)


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


# (G, E, cap, d, f) for the forward's tilings: cap 1, 4 and 8 (one
# 16-row tile, rows past cap masked), 17 (two), 70 (64-row tiles) and
# 256 (128-row tiles); d and f not multiples of the 128-column tile;
# d = 97, whose rows are not 16-byte aligned (staged element by element).
EXPERT_FWD_CASES = [(1, 3, 1, 768, 300), (2, 2, 4, 1024, 512),
                    (1, 4, 8, 1000, 260), (2, 3, 17, 97, 130),
                    (1, 2, 70, 200, 300), (1, 2, 256, 768, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("sqrelu", False)])
@pytest.mark.parametrize("case", EXPERT_FWD_CASES)
def test_expert_forward_tilings(cuda, dtype, act, gated, case):
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import ref

    G, E, cap, d, f = case
    rng = np.random.default_rng(cap * d)
    xe, wi, wg, wo, _ = _expert_inputs(rng, cuda, dtype, *case, gated)
    xe[-1, -1, -1:] = 0.0  # the last slot unfilled as well
    tol = _tol(dtype)
    if dtype == torch.float32 and d > 128:
        tol = dict(atol=1e-4, rtol=1e-4)  # as test_expert_kernels_match_plain
    y = em.expert_ffn_cuda(xe, wi, wg, wo, act=act)
    torch.testing.assert_close(y, ref.expert_ffn_ref(xe, wi, wg, wo,
                                                     act=act), **tol)
    assert bool((y[0, 0, -min(3, cap):] == 0).all())
    assert bool((y[-1, -1, -1] == 0).all())


# B, T, H, K, V, with_state: T not a multiple of the staged tile (16
# steps) and crossing two or more, V != K (and V not a multiple of a
# warp; V = 12 and bf16 V = 300 rows not 16-byte aligned: plain loads),
# T = 1 (a decode step), every head size the kernel is built for (K = 8:
# 2 lanes a column, else 4), V > 256 and V = 1024 (several 64-column
# blocks, the last one partial at V = 300).
RWKV_CASES = [
    (2, 37, 2, 8, 8, False),
    (1, 64, 4, 16, 16, True),
    (2, 33, 2, 8, 12, True),
    (3, 1, 2, 64, 64, True),
    (1, 70, 1, 32, 40, False),
    (2, 40, 2, 8, 64, True),
    (1, 20, 2, 16, 300, True),
    (1, 5, 1, 64, 1024, True),
]


def _wkv_inputs(rng, dev, dtype, B, T, H, K, V, with_state):
    t = lambda a, dt=torch.float32: torch.tensor(  # noqa: E731
        a, dtype=dt, device=dev)
    r, k = (t(0.5 * rng.normal(size=(B, T, H, K)), dtype) for _ in range(2))
    v = t(0.5 * rng.normal(size=(B, T, H, V)), dtype)
    w = t(0.6 / (1 + np.exp(-rng.normal(size=(B, T, H, K)))) + 0.3)
    u = t(0.3 * rng.normal(size=(H, K)))
    s0 = t(0.2 * rng.normal(size=(B, H, K, V))) if with_state else None
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_kernel_matches_plain(cuda, dtype, case):
    """The WKV-6 kernel against the sequential oracle (same recurrence,
    another summation order: the f32 tolerance) and against the chunked
    plain version (the reference's tolerance, 2e-4). The final state is
    float32 whatever the inputs' dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6 as wkv

    rng = np.random.default_rng(sum(case))
    args = _wkv_inputs(rng, cuda, dtype, *case)
    before = wkv.KERNEL.launches
    o, s = wkv.rwkv6_cuda(*args)
    torch.cuda.synchronize()
    assert wkv.KERNEL.launches == before + 1
    assert o.dtype == dtype and s.dtype == torch.float32
    so, ss = ref.rwkv6_ref(*args[:5], initial_state=args[5])
    torch.testing.assert_close(o, so, **_tol(dtype))
    torch.testing.assert_close(s, ss, **_tol(torch.float32))
    co, cs = ref.rwkv6_chunked_ref(*args[:5], initial_state=args[5])
    chunked = dict(atol=2e-4, rtol=2e-4) if dtype == torch.float32 else \
        _tol(dtype)
    torch.testing.assert_close(o, co, **chunked)
    torch.testing.assert_close(s, cs, atol=2e-4, rtol=2e-4)
    # ops.rwkv6 on CUDA tensors launches the kernel.
    o2, s2 = ops.rwkv6(*args[:5], initial_state=args[5])
    assert wkv.KERNEL.launches == before + 2
    torch.testing.assert_close(o2, o, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_kernel_repeats_its_bits(cuda, dtype, case):
    """Every sum of the WKV kernel (the lanes' partial sums, their
    shuffle tree, the bonus scalar) has one fixed order."""
    from repro_torch.kernels import rwkv6 as wkv

    rng = np.random.default_rng(sum(case) + 1)
    args = _wkv_inputs(rng, cuda, dtype, *case)
    first = wkv.rwkv6_cuda(*args)
    for a, b in zip(first, wkv.rwkv6_cuda(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rwkv6_cuda_refuses_autograd(cuda):
    rng = np.random.default_rng(3)
    r, k, v, w, u, _ = _wkv_inputs(rng, cuda, torch.float32, 1, 8, 2, 8, 8,
                                   False)
    with pytest.raises(NotImplementedError, match="mixer_impl='eager'"):
        ops.rwkv6(r.requires_grad_(), k, v, w, u)
    with torch.no_grad():
        ops.rwkv6(r, k, v, w, u)
    o, _ = ops.rwkv6(r, k, v, w, u, implementation="eager")
    assert o.requires_grad


# ---------------------------------------------------------------------------
# kernel names, as launch/profile_step.py assigns trace time (CPU)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)\s*\(")


def _global_names(path):
    return GLOBAL.findall(path.read_text())


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_kernel_names_match_one_profile_entry(source):
    """profile_step charges a device kernel to every PORT_KERNELS entry
    whose symbol its name contains: each kernel of the port's sources
    matches exactly one, so no kernel's time is charged to another."""
    from repro_torch.launch.profile_step import PORT_KERNELS

    names = _global_names(CSRC / source)
    assert names, f"no __global__ kernel found in {source}"
    for name in names:
        hits = [k for k, sym in PORT_KERNELS.items() if sym in name]
        assert len(hits) == 1, (source, name, hits)


def test_every_profile_entry_names_a_kernel():
    from repro_torch.launch.profile_step import PORT_KERNELS

    names = [n for p in CSRC.glob("*.cu") for n in _global_names(p)]
    for key, sym in PORT_KERNELS.items():
        assert any(sym in n for n in names), (key, sym)
