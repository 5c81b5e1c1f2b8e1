#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository checkout beside this file; exits non-zero otherwise, and on
any failure, before printing its result line. It

1. prints the card's name and power limit, builds the eight CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once) and prints the build seconds and each kernel's
   registers;
2. holds each kernel against its plain PyTorch version on the card —
   the serve kernels at the serve shapes below in float32 and bfloat16,
   the training kernels (flash attention forward, dq, dk/dv; grouped
   dx, dW) at the training shapes in float32 — and times on the
   device's clock the kernel, the plain version and (where one exists)
   a single PyTorch library call computing the same function;
3. builds granite-moe-1b-a400m at full width with the package's own
   ``init_params`` (random weights from a seeded generator, dropless
   routing) and runs one mixed step through the kernels with every
   kernel call held against its plain version on that call's inputs;
4. serves the model, its attention projections rescaled to fan-in d
   (see ``condition_attention``), through ``ServeEngine``: 12
   staggered requests, three sharing a 128-token prefix; counts every
   kernel's launches in that run and checks the single step signature
   and that no KV block leaked;
5. serves the same traffic through the plain versions and requires
   token-identical greedy outputs, times both paths over interleaved
   repeats, and compares one mixed step through both paths;
6. trains at full width through the kernels: granite's dense parent
   takes 2 Adafactor steps, is upcycled (``expert_init="copy"``) into
   granite-moe-1b-a400m, which takes 4 steps with ``dispatch="sorted"``
   (batch 16 x 512 tokens, two routing groups); counts every kernel's
   launches in that run, then holds the first MoE step's loss and
   gradient norm against the same step through the plain versions and
   witnesses every kernel call of it against its plain version;
7. prints one JSON line of per-kernel numbers, then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "bfloat16": 989e12}

# Serve settings (the cell): max_batch 8, 16-token blocks, two 64-token
# chunk lanes per mixed step, 512-token sequences.
SERVE = dict(max_batch=8, max_len=512, block_size=16, chunk_size=64,
             chunks_per_step=2)
N_REQUESTS, MAX_NEW, PREFIX = 12, 32, 128
# Timed serve runs per path (kernels, plain), interleaved on one card:
# host-clock readings vary from run to run.
SERVE_RUNS = 3

# |kernel - plain| <= ATOL + RTOL * |plain|. float32: both sides compute
# in f32 and differ only in summation order (~1e-6 relative over
# d = 1024 terms). bfloat16 outputs: both accumulate in f32 and round
# once to bf16, so they may differ by one bf16 ulp (2^-8 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# One mixed step, kernels vs plain, on the logits: f32 summation-order
# differences compounded through 24 layers stay near 1e-5.
STEP_ATOL = 1e-3
# A greedy divergence between the two serve runs is accepted only at a
# near-tie of the top-2 logits.
TIE_GAP = 1e-4

# Training (the train cell): global batch 16 x 512 tokens = two routing
# groups of 4096; 2 dense-parent steps, then 4 steps of the upcycled MoE
# at the config's own capacity factor. The data task covers the first
# TASK_VOCAB ids (repro_torch.launch.train).
TRAIN = dict(batch=16, seq=512, dense_steps=2, moe_steps=4, peak_lr=0.01,
             warmup=100)
# First MoE step, kernels vs plain: the loss within 1e-4 relative, the
# global gradient norm within 1e-3 relative (f32 summation order through
# 24 layers of forward and backward, on conditioned weights).
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 1e-3

SERVE_KERNELS = ("decode_attention", "paged_prefill", "grouped_mlp")
TRAIN_KERNELS = ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv", "grouped_mlp", "grouped_mlp_dx",
                 "grouped_mlp_dw")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms() -> float:
    """Clock cycles per millisecond of ``torch.cuda._sleep``'s spin."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    return 10 ** 7 / a.elapsed_time(b)


def _queued_ms(body, n: int, spin: int):
    """Device ms of ``n`` calls of ``body`` queued behind a spin kernel of
    ``spin`` cycles, and whether the device reached the first event
    before the host had queued the last call (then host gaps may lie
    inside the reading)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    a.record()
    for _ in range(n):
        body()
    b.record()
    late = a.query()
    b.synchronize()
    return a.elapsed_time(b), late


def time_synced_ms(fn, *, flush, iters: int = 20) -> float:
    """Milliseconds of one call of ``fn`` that reads device values on
    the host (it cannot be queued ahead of the device): an event pair
    around each call after a synchronize, L2 flushed before it. The
    reading includes the host's gaps between the call's launches."""
    import torch

    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def time_ms(fn, *, flush, iters: int = 20) -> float:
    """Device milliseconds of one call of ``fn`` with L2 flushed before
    it (the serve path finds every layer's weights and pools cold: 24
    layers outgrow the 50 MB L2).

    The host queues ``iters`` (flush, call) pairs behind a spin kernel,
    so the device runs them back to back and the event pair around them
    holds device time only, not the host's time in the wrapper; the
    flushes alone, queued the same way, are subtracted. The spin grows
    until the host has queued every call before the device starts."""
    import torch

    for _ in range(3):
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        flush.zero_()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    spin = int((2 * iters * host_ms + 2) * _spin_cycles_per_ms())

    def pair():
        flush.zero_()
        fn()

    for _ in range(4):
        both, late_a = _queued_ms(pair, iters, spin)
        only, late_b = _queued_ms(flush.zero_, iters, spin)
        if not (late_a or late_b):
            return (both - only) / iters
        spin *= 4
    fail("could not queue the timed calls ahead of the device")


# ---------------------------------------------------------------------------
# kernel inputs at the serve shapes, and what the work needs
# ---------------------------------------------------------------------------


def attention_case(cfg, dtype, device, gen):
    """Pools, decode rows and chunk lanes at the serve shapes: 8 decode
    slots of ragged lengths (one free) and 2 chunk lanes of one
    mid-prompt request over the 257-block pool."""
    import torch

    bs, nb = SERVE["block_size"], SERVE["max_len"] // SERVE["block_size"]
    B, NC, C = SERVE["max_batch"], SERVE["chunks_per_step"], SERVE["chunk_size"]
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    P = 1 + B * nb
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    kp = rnd(P, bs, Kh, dh).to(dtype)
    vp = rnd(P, bs, Kh, dh).to(dtype)
    tables = (1 + torch.randperm(P - 1, generator=gen, device=device)
              ).reshape(B, nb).to(torch.int32)
    lengths = torch.tensor([0, 1, 17, 64, 130, 257, 400, 511],
                           dtype=torch.int32, device=device)
    q_dec = rnd(B, H, dh).to(dtype)
    # Chunk lanes: one request at positions 192..319 (the second lane is
    # a partial chunk of 50 rows), on slot 3's table.
    ctab = tables[3:4].repeat(NC, 1).contiguous()
    starts = torch.tensor([192, 256], dtype=torch.int32, device=device)
    lens = torch.tensor([C, 50], dtype=torch.int32, device=device)
    q_ch = rnd(NC, C, H, dh).to(dtype)
    return dict(kp=kp, vp=vp, tables=tables, lengths=lengths, q_dec=q_dec,
                ctab=ctab, starts=starts, lens=lens, q_ch=q_ch)


def grouped_case(cfg, dtype, device, gen):
    """A ragged buffer as the mixed step lays it out: 136 rows x top-8 =
    1088 assignments over 32 experts, skewed, with empty experts."""
    import torch

    from repro_torch.kernels.grouped_mlp import (
        ROW_BLOCK,
        ragged_buffer_rows,
        ragged_row_offsets,
    )

    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    n_assign = (SERVE["max_batch"] + SERVE["chunks_per_step"]
                * SERVE["chunk_size"]) * cfg.moe.top_k
    w = torch.rand(E, generator=gen, device=device) ** 3
    w[[5, 17]] = 0.0
    counts = torch.floor(w / w.sum() * n_assign).to(torch.int32)
    counts[0] += n_assign - int(counts.sum())
    M = ragged_buffer_rows(n_assign, E, ROW_BLOCK)
    row_off, _ = ragged_row_offsets(counts[None], ROW_BLOCK)
    xs = torch.zeros(1, M, d, device=device)
    for e in range(E):
        s, n = int(row_off[0, e]), int(counts[e])
        xs[0, s:s + n] = torch.randn(n, d, generator=gen, device=device)
    mk = lambda *s, fan: (torch.randn(*s, generator=gen, device=device)  # noqa
                          / fan ** 0.5)
    return dict(xs=xs.to(dtype), wi=mk(E, d, f, fan=d).to(dtype),
                wg=mk(E, d, f, fan=d).to(dtype),
                wo=mk(E, f, d, fan=f).to(dtype), counts=counts[None])


def decode_work(c, itemsize):
    """Bytes (inputs read once, output written once, only the live KV
    blocks) and FLOPs of the decode call on these inputs."""
    B, H, dh = c["q_dec"].shape
    bs, Kh = c["kp"].shape[1], c["kp"].shape[2]
    lens = [int(x) for x in c["lengths"]]
    blocks = sum(-(-n // bs) for n in lens)
    kv = 2 * blocks * bs * Kh * dh * itemsize
    nbytes = 2 * B * H * dh * itemsize + kv + 4 * (B + blocks)
    flops = sum(4 * H * dh * n for n in lens)
    return nbytes, flops


def prefill_work(c, itemsize):
    NC, C, H, dh = c["q_ch"].shape
    bs, Kh = c["kp"].shape[1], c["kp"].shape[2]
    blocks, flops = set(), 0
    for lane in range(NC):
        st, ln = int(c["starts"][lane]), int(c["lens"][lane])
        for b in range(-(-(st + ln) // bs)):
            blocks.add(int(c["ctab"][lane, b]))
        flops += sum(4 * H * dh * (st + i + 1) for i in range(ln))
    kv = 2 * len(blocks) * bs * Kh * dh * itemsize
    nbytes = 2 * NC * C * H * dh * itemsize + kv + 4 * (len(blocks) + 2 * NC)
    return nbytes, flops


def grouped_work(c, itemsize):
    G, M, d = c["xs"].shape
    E, _, f = c["wi"].shape
    counts = c["counts"][0]
    rows = int(counts.sum())
    live = int((counts > 0).sum())
    nbytes = (rows * d + live * 3 * d * f + M * d) * itemsize + 4 * E
    return nbytes, 6 * rows * d * f


def check_kernels(cfg, device):
    """Every kernel against its plain version, f32 and bf16, with times.
    Returns the per-kernel JSON records (float32, the serve dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        item = torch.tensor([], dtype=dtype).element_size()
        gen = torch.Generator(device=device).manual_seed(1)
        a = attention_case(cfg, dtype, device, gen)
        g = grouped_case(cfg, dtype, device, gen)
        i32 = lambda t: t.to(torch.int32)  # noqa: E731
        nb, bs = a["tables"].shape[1], a["kp"].shape[1]
        Kh, dh = a["kp"].shape[2], a["kp"].shape[3]

        def dense_kv(tab):
            # The library call's inputs: each row's blocks gathered into
            # a dense (n, H, T, dh) view, GQA heads expanded (set-up,
            # not timed).
            n, G = tab.shape[0], cfg.n_heads // Kh
            k = a["kp"][tab.long()].reshape(n, nb * bs, Kh, dh)
            v = a["vp"][tab.long()].reshape(n, nb * bs, Kh, dh)
            return (k.transpose(1, 2).repeat_interleave(G, 1).contiguous(),
                    v.transpose(1, 2).repeat_interleave(G, 1).contiguous())

        kd, vd = dense_kv(a["tables"])
        dmask = (torch.arange(nb * bs, device=device)[None]
                 < a["lengths"][:, None])[:, None, None]
        kc, vc = dense_kv(a["ctab"])
        rows = torch.arange(SERVE["chunk_size"], device=device)
        qpos = a["starts"][:, None] + rows[None]
        cmask = (torch.arange(nb * bs, device=device)[None, None]
                 <= qpos[..., None])[:, None]
        qd = a["q_dec"][:, :, None]  # (B, H, 1, dh)
        qc = a["q_ch"].transpose(1, 2)  # (NC, H, C, dh)
        cases = [
            ("decode_attention", da.paged_decode_attention_cuda,
             ref.decode_attention_ref,
             (a["q_dec"], a["kp"], a["vp"], a["tables"], i32(a["lengths"])),
             decode_work(a, item),
             lambda: F.scaled_dot_product_attention(
                 qd, kd, vd, attn_mask=dmask),
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:65"),
            ("paged_prefill", pp.paged_prefill_attention_cuda,
             ref.prefill_attention_ref,
             (a["q_ch"], a["kp"], a["vp"], a["ctab"], a["starts"],
              a["lens"]),
             prefill_work(a, item),
             lambda: F.scaled_dot_product_attention(
                 qc, kc, vc, attn_mask=cmask),
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:66"),
            ("grouped_mlp", gm.grouped_mlp_cuda,
             lambda *x: ref.grouped_mlp_ref(*x, block=gm.ROW_BLOCK),
             (g["xs"], g["wi"], g["wg"], g["wo"], g["counts"]),
             grouped_work(g, item), None,
             "src/repro_torch/kernels/csrc/grouped_mlp.cu",
             "src/repro/kernels/grouped_mlp.py:225"),
        ]
        atol, rtol = TOL[name]
        for (kname, kern, plain, args, (nbytes, flops), lib, src,
             replaces) in cases:
            y = kern(*args)
            torch.cuda.synchronize()
            y_ref = plain(*args)
            err = (y.float() - y_ref.float()).abs()
            max_err = float(err.max())
            bad = err > atol + rtol * y_ref.float().abs()
            if not torch.isfinite(y.float()).all() or bool(bad.any()):
                fail(f"{kname} {name}: max |kernel - plain| = {max_err:.3g} "
                     f"beyond atol {atol} + rtol {rtol}")
            ms = time_ms(lambda: kern(*args), flush=flush)
            # The grouped wrapper builds its block tables with ~15 small
            # PyTorch ops before the launch: their share is timed alone.
            tables_ms = (time_ms(lambda: gm.block_tables(
                g["counts"], gm.ROW_BLOCK, g["xs"].shape[1] // gm.ROW_BLOCK),
                flush=flush) if kname == "grouped_mlp" else None)
            # The grouped plain version reads the group sizes on the host.
            plain_ms = (time_synced_ms if kname == "grouped_mlp"
                        else time_ms)(lambda: plain(*args), flush=flush)
            lib_ms = time_ms(lib, flush=flush) if lib is not None else None
            t_bytes = nbytes / PEAK_BYTES_S * 1e3
            t_ops = flops / PEAK_FLOP_S[name] * 1e3
            rec = {
                "name": kname, "route": "cuda", "source": src,
                "replaces": replaces, "max_abs_err": max_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
            }
            if tables_ms is not None:
                rec["tables_ms"] = tables_ms
            print(f"[kernel] {kname} {name}: max_abs_err={max_err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"tables_ms={tables_ms if tables_ms is None else f'{tables_ms:.4f}'} "
                  f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}: "
                  f"{nbytes} B, {flops} FLOP)", flush=True)
            if dtype == torch.float32:
                records.append(rec)
    return records


def train_cases(cfg, device, gen):
    """Flash attention and grouped-FFN inputs at the training shapes:
    q (16, 512, 16, 64), k/v (16, 512, 8, 64), causal; a ragged buffer of
    two groups of 4096 tokens x top-8 assignments (33280 rows each) with
    each expert's count capped at the capacity (256), as routing leaves
    it, and one expert empty in group 0."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.grouped_mlp import (
        ROW_BLOCK,
        ragged_buffer_rows,
        ragged_row_offsets,
    )

    B, S = TRAIN["batch"], TRAIN["seq"]
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    q, k, v, do = rnd(B, S, H, dh), rnd(B, S, Kh, dh), rnd(B, S, Kh, dh), \
        rnd(B, S, H, dh)
    qo, kl = fa.scalar_i32(0, device), fa.scalar_i32(S, device)

    E, d, f, k_top = cfg.moe.num_experts, cfg.d_model, cfg.d_ff, \
        cfg.moe.top_k
    G, g = 2, cfg.moe.group_size
    n_assign = g * k_top
    cap = -(-int(g * cfg.moe.capacity_factor) // E)
    w = torch.rand(G, E, generator=gen, device=device) + 0.2
    counts = torch.floor(w / w.sum(-1, keepdim=True) * n_assign)
    counts = torch.clamp(counts, max=cap).to(torch.int32)
    counts[0, 7] = 0
    M = ragged_buffer_rows(n_assign, E, ROW_BLOCK)
    row_off, _ = ragged_row_offsets(counts, ROW_BLOCK)
    xs = torch.zeros(G, M, d, device=device)
    dy = torch.zeros(G, M, d, device=device)
    for gi in range(G):
        for e in range(E):
            st, n = int(row_off[gi, e]), int(counts[gi, e])
            xs[gi, st:st + n] = rnd(n, d)
            dy[gi, st:st + n] = rnd(n, d)
    mk = lambda *s, fan: rnd(*s) / fan ** 0.5  # noqa: E731
    return (dict(q=q, k=k, v=v, do=do, qo=qo, kl=kl),
            dict(xs=xs, dy=dy, wi=mk(E, d, f, fan=d), wg=mk(E, d, f, fan=d),
                 wo=mk(E, f, d, fan=f), counts=counts))


def flash_work(a, kind):
    """Bytes (inputs once, outputs once) and FLOPs of one flash call on
    these causal inputs: the live (query, key) pairs only."""
    B, S, H, dh = a["q"].shape
    Kh = a["k"].shape[2]
    pairs = B * H * S * (S + 1) // 2
    q_b, kv_b, row_b = B * S * H * dh * 4, B * S * Kh * dh * 4, B * H * S * 4
    if kind == "fwd":  # q, k, v -> o, lse; QK^T and PV
        return 2 * q_b + 2 * kv_b + row_b, 4 * dh * pairs
    if kind == "dq":  # q, k, v, dO, lse, delta -> dq; QK^T, dO V^T, dS K
        return 3 * q_b + 2 * kv_b + 2 * row_b, 6 * dh * pairs
    # dk/dv: + dS^T Q and P^T dO, writes dk and dv
    return 2 * q_b + 4 * kv_b + 2 * row_b, 8 * dh * pairs


def grouped_bwd_work(c, kind):
    """Bytes and FLOPs of the dx / dW call over the valid rows (dead
    blocks read nothing; dx still writes their zero rows)."""
    G, M, d = c["xs"].shape
    E, _, f = c["wi"].shape
    counts = c["counts"]
    rows = int(counts.sum())
    live = int((counts > 0).any(0).sum())
    if kind == "dx":  # x, dy, 3 weights -> dx, da, dg, h
        nbytes = (2 * rows * d + live * 3 * d * f + G * M * d
                  + 3 * rows * f) * 4
        return nbytes, 10 * rows * d * f
    # dW: x, dy, da, dg, h -> per-group dwi, dwg, dwo
    return (2 * rows * d + 3 * rows * f + 3 * G * E * d * f) * 4, \
        6 * rows * d * f


def _max_err(y, y_ref, atol, rtol):
    """(max |y - y_ref|, max |y - y_ref| / (atol + rtol |y_ref|)) over a
    tensor or a tuple of them; equal infinities count as agreement."""
    import torch

    if isinstance(y, (tuple, list)):
        errs = [_max_err(a, b, atol, rtol) for a, b in zip(y, y_ref)
                if a is not None]
        return max(e for e, _ in errs), max(r for _, r in errs)
    y, y_ref = y.float(), y_ref.float()
    same_inf = torch.isinf(y_ref) & (y == y_ref)
    err = torch.where(same_inf, torch.zeros_like(y), (y - y_ref).abs())
    err = torch.nan_to_num(err, nan=float("inf"))
    lim = atol + rtol * torch.where(same_inf, torch.zeros_like(y),
                                    y_ref.abs())
    return float(err.max()), float((err / lim).max())


def check_train_kernels(cfg, device):
    """The five training kernels against their plain versions at the
    training shapes, float32, with times. Returns their JSON records."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    a, c = train_cases(cfg, device, gen)
    kw = dict(causal=True, q_offset=a["qo"], kv_len=a["kl"])
    o, lse = fa.flash_attention_fwd_cuda(a["q"], a["k"], a["v"], a["qo"],
                                         a["kl"], causal=True)
    delta = fa.attention_delta(o, a["do"])
    bwd_args = (a["q"], a["k"], a["v"], a["do"], lse, delta)
    gargs = (c["xs"], c["wi"], c["wg"], c["wo"], c["dy"], c["counts"])
    _, da, dg, hh = ref.grouped_mlp_dx_ref(*gargs, block=gm.ROW_BLOCK)
    dw_args = (c["xs"], c["dy"], da, dg, hh, c["counts"])

    # The library call's inputs: (B, H, S, dh) layout, GQA expanded
    # (set-up, not timed); its backward runs through autograd.
    G_ = cfg.n_heads // cfg.n_kv_heads
    lq = a["q"].transpose(1, 2).contiguous().requires_grad_()
    lk = a["k"].transpose(1, 2).repeat_interleave(G_, 1).contiguous()
    lv = a["v"].transpose(1, 2).repeat_interleave(G_, 1).contiguous()
    lk.requires_grad_()
    lv.requires_grad_()
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    ldo = a["do"].transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    cases = [
        ("flash_attention",
         lambda: fa.flash_attention_fwd_cuda(a["q"], a["k"], a["v"], a["qo"],
                                             a["kl"], causal=True),
         lambda: ref.flash_attention_ref(a["q"], a["k"], a["v"], **kw),
         flash_work(a, "fwd"), sdpa_fwd,
         "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:94"),
        ("flash_attention_dq",
         lambda: fa.flash_attention_dq_cuda(*bwd_args, a["qo"], a["kl"],
                                            causal=True),
         lambda: ref.flash_attention_dq_ref(*bwd_args, **kw),
         flash_work(a, "dq"), sdpa_bwd,
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention.py:256"),
        ("flash_attention_dkv",
         lambda: fa.flash_attention_dkv_cuda(*bwd_args, a["qo"], a["kl"],
                                             causal=True),
         lambda: ref.flash_attention_dkv_ref(*bwd_args, **kw),
         flash_work(a, "dkv"), sdpa_bwd,
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention.py:285"),
        ("grouped_mlp_dx",
         lambda: gm.grouped_mlp_dx_cuda(*gargs),
         lambda: ref.grouped_mlp_dx_ref(*gargs, block=gm.ROW_BLOCK),
         grouped_bwd_work(c, "dx"), None,
         "src/repro_torch/kernels/csrc/grouped_mlp_bwd.cu",
         "src/repro/kernels/grouped_mlp.py:406"),
        ("grouped_mlp_dw",
         lambda: gm.grouped_mlp_dw_cuda(*dw_args),
         lambda: ref.grouped_mlp_dw_ref(*dw_args, block=gm.ROW_BLOCK),
         grouped_bwd_work(c, "dw"), None,
         "src/repro_torch/kernels/csrc/grouped_mlp_bwd.cu",
         "src/repro/kernels/grouped_mlp.py:476"),
    ]
    atol, rtol = TOL["float32"]
    records = []
    for kname, kern, plain, (nbytes, flops), lib, src, replaces in cases:
        y = kern()
        torch.cuda.synchronize()
        y_ref = plain()
        if kname == "grouped_mlp_dx":
            # da/dg/h rows of dead blocks are left unwritten by the
            # kernel (the dW kernel never reads them): compare live rows.
            live = c["xs"].abs().sum(-1, keepdim=True) > 0
            y = (y[0], *(t * live for t in y[1:]))
            y_ref = (y_ref[0], *(t * live for t in y_ref[1:]))
        max_err, ratio = _max_err(y, y_ref, atol, rtol)
        print(f"[train-kernel] {kname} float32: max |kernel - plain| = "
              f"{max_err:.3e}, max err / limit = {ratio:.3f} (atol {atol}, "
              f"rtol {rtol})", flush=True)
        if not ratio <= 1.0:
            fail(f"{kname}: kernel and plain version differ beyond atol "
                 f"{atol} + rtol {rtol} (ratio {ratio:.3g})")
        ms = time_ms(kern, flush=flush)
        # The grouped plain versions read the group sizes on the host.
        plain_ms = (time_synced_ms if kname.startswith("grouped")
                    else time_ms)(plain, flush=flush)
        lib_ms = time_ms(lib, flush=flush) if lib is not None else None
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOP_S["float32"] * 1e3
        rec = {
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }
        print(f"[train-kernel] {kname} float32: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}: "
              f"{nbytes} B, {flops} FLOP)", flush=True)
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def condition_attention(params, cfg) -> None:
    """Rescale the random attention projections, in place, to fan-in d.

    ``init_params`` copies the reference's rule (fan-in = ``shape[-2]``),
    which for ``wq (d, H, dh)`` and ``wk/wv (d, Kh, dh)`` takes the head
    count as fan-in: q and k elements come out with std ~8 and attention
    scores with std ~64, i.e. near-argmax attention in which any two
    float32 implementations disagree after a few layers (a 1e-6 relative
    perturbation moves the logits by ~0.1 on a 24-layer reduced-width
    model). At fan-in d the same perturbation moves them by ~5e-6, so
    the kernels-vs-plain comparisons below can be held tight."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for seg in params["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            m["wq"] *= (H / d) ** 0.5
            m["wk"] *= (Kh / d) ** 0.5
            m["wv"] *= (Kh / d) ** 0.5


def make_requests(cfg, seed: int = 0):
    """12 requests, prompts of 64..384 tokens, staggered arrivals;
    requests 2, 6 and 7 share a 128-token prefix (6 and 7 arrive in the
    same tick: in-flight sharing; 2 earlier: the prefix index)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, PREFIX).tolist()
    reqs = []
    for rid in range(N_REQUESTS):
        plen = int(rng.integers(64, 385))
        prompt = rng.integers(1, cfg.vocab_size, plen).tolist()
        if rid in (2, 6, 7):
            prompt = prefix + prompt[: max(plen - PREFIX, 16)]
        arrival = {6: 9, 7: 9}.get(rid, 2 * rid)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=MAX_NEW,
                            arrival=arrival))
    return reqs


def serve_once(eng, cfg):
    import torch

    reqs = make_requests(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, finished = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen = sum(len(outs[r.rid]) - len(r.prompt) for r in reqs)
    return outs, finished, gen, wall


def first_divergence(a: dict, b: dict, cfg):
    for r in make_requests(cfg):
        x, y = a[r.rid], b[r.rid]
        for n in range(len(r.prompt), max(len(x), len(y))):
            if n >= len(x) or n >= len(y) or x[n] != y[n]:
                return r.rid, n
    return None


def top2_gap(eng, seq: list) -> float:
    """Replay ``seq`` as one prompt through ``eng`` and return the gap
    between the top-2 logits of the token that follows it."""
    import numpy as np

    from repro_torch.serve import Request

    sess = eng.open_session()
    sess.submit(Request(rid=0, prompt=list(seq), max_new=1))
    row = None
    while sess.tick():
        used = np.nonzero(sess.lanes["clen"])[0]
        if sess.last_logits is not None and used.size:
            row = sess.last_logits[eng.sc.max_batch + int(used[-1])]
    sess.close()
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


@contextlib.contextmanager
def witnessed_kernels():
    """Hold every kernel call made inside the block against its plain
    version on that call's own inputs (for the serve step: the pools as
    the step has just written them). Yields ``{kernel: [calls, max |err|,
    max err/limit]}`` with the float32 limit ``atol + rtol * |plain|``
    of :data:`TOL`."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref

    def flash_plain(q, k, v, qo, kl, *, causal):
        return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=qo,
                                       kv_len=kl)

    def flash_bwd_plain(plain):
        def call(q, k, v, do, lse, delta, qo, kl, *, causal):
            return plain(q, k, v, do, lse, delta, causal=causal,
                         q_offset=qo, kv_len=kl)
        return call

    def dx_plain(*args, act="silu", block=gm.ROW_BLOCK):
        dx, da_, dg, h = ref.grouped_mlp_dx_ref(*args, act=act, block=block)
        return dx, da_, dg, h

    atol, rtol = TOL["float32"]
    stats = {}
    wrapped = [
        (da, "paged_decode_attention_cuda", "decode_attention",
         ref.decode_attention_ref),
        (pp, "paged_prefill_attention_cuda", "paged_prefill",
         ref.prefill_attention_ref),
        (gm, "grouped_mlp_cuda", "grouped_mlp", ref.grouped_mlp_ref),
        (fa, "flash_attention_fwd_cuda", "flash_attention", flash_plain),
        (fa, "flash_attention_dq_cuda", "flash_attention_dq",
         flash_bwd_plain(ref.flash_attention_dq_ref)),
        (fa, "flash_attention_dkv_cuda", "flash_attention_dkv",
         flash_bwd_plain(ref.flash_attention_dkv_ref)),
        (gm, "grouped_mlp_dx_cuda", "grouped_mlp_dx", dx_plain),
        (gm, "grouped_mlp_dw_cuda", "grouped_mlp_dw", ref.grouped_mlp_dw_ref),
    ]

    def witness(kern, plain, name):
        def call(*args, **kw):
            y = kern(*args, **kw)
            y_ref = plain(*args, **kw)
            if name == "grouped_mlp_dx":
                # The dx kernel leaves dead blocks' da/dg/h rows
                # unwritten (never read): hold the rows it wrote.
                xs = args[0]
                live = xs.abs().sum(-1, keepdim=True) > 0
                y_cmp = (y[0], *(None if t is None else t * live
                                 for t in y[1:]))
                ref_cmp = (y_ref[0], *(None if t is None else t * live
                                       for t in y_ref[1:]))
            else:
                y_cmp, ref_cmp = y, y_ref
            first = y_cmp[0] if isinstance(y_cmp, tuple) else y_cmp
            if not torch.isfinite(first.float()).all():
                fail(f"{name}: non-finite output in the witnessed step")
            err, ratio = _max_err(y_cmp, ref_cmp, atol, rtol)
            st = stats.setdefault(name, [0, 0.0, 0.0])
            st[0] += 1
            st[1] = max(st[1], err)
            st[2] = max(st[2], ratio)
            return y
        return call

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in wrapped]
    for mod, attr, name, plain in wrapped:
        setattr(mod, attr, witness(getattr(mod, attr), plain, name))
    try:
        yield stats
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def report_witness(wit, expect) -> None:
    for name, (calls, err, ratio) in sorted(wit.items()):
        print(f"[witness] {name}: {calls} calls, max |kernel - plain| = "
              f"{err:.3e}, max err / limit = {ratio:.3f}", flush=True)
    if sorted(wit) != sorted(expect):
        fail(f"the witnessed step called {sorted(wit)}, not {sorted(expect)}")
    if any(ratio > 1.0 for _, _, ratio in wit.values()):
        fail(f"a kernel call left its tolerance in the witnessed step: {wit}")


def compare_mixed_step(params, cfg, device):
    """One mixed step on identical inputs (random pools, 8 decode rows of
    ragged lengths, two chunk lanes) through the kernels, every call
    witnessed, and through the plain versions. Fails if a kernel call
    left its tolerance; returns the max |logit| difference."""
    import torch

    from repro_torch.launch.profile_step import mixed_step_inputs
    from repro_torch.models import model_zoo as zoo

    cache, args = mixed_step_inputs(cfg, device, serve=SERVE)

    def step(impl):
        # Each path writes its own copy of the pools.
        c = {"stack": {"segments": [
            {k: {"mixer": {n: p.clone() for n, p in v["mixer"].items()}}
             for k, v in seg.items()}
            for seg in cache["stack"]["segments"]]}}
        return zoo.paged_mixed_step(
            params, *args[:2], c, *args[3:], cfg,
            ac=zoo.ApplyCfg(moe_impl=impl, attn_impl=impl))[1]

    out = {}
    with witnessed_kernels() as wit:
        out["cuda"] = step("cuda")
        torch.cuda.synchronize()
    out["eager"] = step("eager")
    if not torch.isfinite(out["cuda"]).all():
        fail("mixed step through the kernels gave non-finite logits")
    report_witness(wit, SERVE_KERNELS)
    return float((out["cuda"] - out["eager"]).abs().max())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _sync_ms(t0) -> float:
    import torch

    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def train_path(cfg, device):
    """Dense parent -> upcycle -> MoE, through the kernels, at full
    width. Returns (launches of the run, and the first MoE step's params
    (a copy), batch and metrics)."""
    import torch

    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params, tree_map
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    dense_cfg = cfg.dense_parent()
    opt = adafactor(inverse_sqrt(peak=TRAIN["peak_lr"],
                                 warmup_steps=TRAIN["warmup"]))
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(dense_cfg, global_batch=TRAIN["batch"],
                       seq_len=TRAIN["seq"], task=task)
    gen = torch.Generator(device=device).manual_seed(0)
    params = zoo.init_params(gen, dense_cfg, device=device)
    condition_attention(params, dense_cfg)
    state = init_train_state(None, dense_cfg, opt, params=params)
    ac = zoo.ApplyCfg(dispatch="sorted", moe_impl="cuda", attn_impl="cuda")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    print(f"[train] {dense_cfg.name}: {count_params(params) / 1e9:.3f} B "
          f"params; batch {TRAIN['batch']} x {TRAIN['seq']} = {tokens} "
          f"tokens a step (task vocab {task.vocab_size})", flush=True)
    rows = []

    def run(step_fn, st, batch, tag):
        t0 = time.perf_counter()
        st, m = step_fn(st, batch)
        ms = _sync_ms(t0)
        m = {k: float(v) for k, v in m.items()}
        print(f"[train] {tag} step {int(st['step'])}: loss={m['loss']:.5f} "
              f"ce={m['ce']:.5f} aux={m['aux_loss']:.5f} "
              f"grad_norm={m['grad_norm']:.5f} skipped={m['skipped']:.0f} "
              f"ms={ms:.1f}", flush=True)
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       m.values())):
            fail(f"{tag} step: non-finite metrics {m}")
        if m["skipped"]:
            fail(f"{tag} step was skipped by the non-finite guard")
        rows.append((tag, ms, m))
        return st, m

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    dense_step = make_train_step(dense_cfg, opt, ac=ac)
    for _ in range(TRAIN["dense_steps"]):
        state, _ = run(dense_step, state, next(it), "dense")
    t0 = time.perf_counter()
    sparse = upcycle_params(state["params"], dense_cfg, cfg, gen)
    print(f"[train] upcycled ({cfg.moe.expert_init}) to {cfg.name}: "
          f"{count_params(sparse) / 1e9:.3f} B params in "
          f"{_sync_ms(t0):.0f} ms", flush=True)
    step0 = state["step"]
    del state, params
    first_params = tree_map(torch.clone, sparse)
    sstate = init_train_state(None, cfg, opt, params=sparse)
    sstate["step"] = step0  # the step counter carries over
    moe_step = make_train_step(cfg, opt, ac=ac)
    first_batch = next(it)
    sstate, first = run(moe_step, sstate, first_batch, "moe")
    for _ in range(TRAIN["moe_steps"] - 1):
        sstate, _ = run(moe_step, sstate, next(it), "moe")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moe_ms = [ms for tag, ms, _ in rows if tag == "moe"]
    dense_ms = [ms for tag, ms, _ in rows if tag == "dense"]
    print(f"[train] tokens/s: dense {tokens / (sum(dense_ms) / 1e3 / len(dense_ms)):.0f} "
          f"(steps {', '.join(f'{x:.1f}' for x in dense_ms)} ms), MoE "
          f"{tokens / (sum(moe_ms) / 1e3 / len(moe_ms)):.0f} (steps "
          f"{', '.join(f'{x:.1f}' for x in moe_ms)} ms); MoE after the "
          f"first step {tokens / (sum(moe_ms[1:]) / 1e3 / len(moe_ms[1:])):.0f}; "
          f"peak memory {peak:.1f} GiB", flush=True)
    print(f"[train] launches: {launches}", flush=True)
    missing = [k for k in TRAIN_KERNELS if not launches[k]]
    if missing:
        fail(f"kernels of the training path never launched: {missing}")
    del sstate
    return launches, first_params, first_batch, first


def compare_first_moe_step(cfg, device, params, batch, kernel_mets):
    """The first MoE step's loss and gradient norm through the plain
    versions, against the kernels' (from the main path); then the same
    step through the kernels with every kernel call witnessed."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim.base import global_norm
    from repro_torch.training.train_loop import batch_to, loss_and_grads

    batch = batch_to(batch, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads, m = loss_and_grads(
        params, batch, cfg,
        ac=zoo.ApplyCfg(dispatch="sorted", moe_impl="eager",
                        attn_impl="eager"))
    gn = float(global_norm(grads))
    del grads
    plain_ms = _sync_ms(t0)
    loss = float(m["loss"])
    print(f"[check] first MoE step, plain versions: loss={loss:.6f} "
          f"grad_norm={gn:.6f} ({plain_ms:.0f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)",
          flush=True)
    d_loss = abs(kernel_mets["loss"] - loss) / abs(loss)
    d_gn = abs(kernel_mets["grad_norm"] - gn) / abs(gn)
    print(f"[check] first MoE step, kernels vs plain: loss rel diff "
          f"{d_loss:.3e} (limit {LOSS_RTOL}), grad_norm rel diff {d_gn:.3e} "
          f"(limit {GRAD_NORM_RTOL})", flush=True)
    if not (d_loss <= LOSS_RTOL and d_gn <= GRAD_NORM_RTOL):
        fail("the first MoE step through the kernels and through the "
             "plain versions disagree")
    with witnessed_kernels() as wit:
        grads, _ = loss_and_grads(
            params, batch, cfg,
            ac=zoo.ApplyCfg(dispatch="sorted", moe_impl="cuda",
                            attn_impl="cuda"))
        torch.cuda.synchronize()
    del grads
    report_witness(wit, TRAIN_KERNELS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import build_all
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(card_line(), flush=True)
    secs = build_all(ops.KERNELS)
    print(f"[build] {len(ops.KERNELS)} kernels from "
          f"{len({k.source for k in ops.KERNELS})} sources in {secs:.1f} s",
          flush=True)
    for lib in sorted({k.source.name: k for k in ops.KERNELS}.items()):
        for line in lib[1].build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib[0]}: {line.strip()}")

    full = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=float(full.moe.num_experts)))
    records = check_kernels(cfg, device)
    records += check_train_kernels(full, device)

    t0 = time.perf_counter()
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width: "
          f"{count_params(params) / 1e9:.3f} B params, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    # At the package's own init every kernel call of one mixed step must
    # match its plain version on its own inputs; the step's logits are
    # printed, not held: at this init they part (see condition_attention).
    print("[witness] one mixed step at the reference init:", flush=True)
    raw_err = compare_mixed_step(params, cfg, device)
    print(f"[witness] reference init, one mixed step: max |logit diff| = "
          f"{raw_err:.3e}", flush=True)
    condition_attention(params, cfg)
    sc = ServeConfig(**SERVE)
    eng = ServeEngine(params, cfg, sc, device=device)
    eng.serve(make_requests(cfg)[:1])  # warm-up: cuBLAS, allocator
    ops.reset_launch_counts()
    outs, finished, n_gen, wall = serve_once(eng, cfg)
    launches = ops.launch_counts()
    st = eng.last_stats
    print(f"[serve] kernels: {n_gen} tokens in {wall:.3f} s = "
          f"{n_gen / wall:.1f} tokens/s, mixed_steps={st['mixed_steps']}, "
          f"prefix_hit_frac={st['prefix_hit_frac']:.3f}, "
          f"compile_count={st['compile_count']}, launches={launches}, "
          f"free_blocks_at_close={st['free_blocks_at_close']}", flush=True)
    if st["compile_count"] != 1:
        fail(f"compile_count {st['compile_count']} != 1")
    if any(launches[k] == 0 for k in SERVE_KERNELS):
        fail(f"a kernel of the serve path never launched: {launches}")
    if any(rec["status"] != "completed" for rec in finished.values()):
        fail(f"not every request completed: {finished}")
    if st["prefix_hit_frac"] <= 0:
        fail("the shared prefix never hit the prefix cache")

    eager = ServeEngine(params, cfg, sc, device=device,
                        ac=zoo.ApplyCfg(moe_impl="eager", attn_impl="eager"))
    ops.reset_launch_counts()
    outs_e, _, n_gen_e, wall_e = serve_once(eager, cfg)
    print(f"[serve] plain: {n_gen_e} tokens in {wall_e:.3f} s = "
          f"{n_gen_e / wall_e:.1f} tokens/s, launches="
          f"{ops.launch_counts()}", flush=True)
    div = first_divergence(outs, outs_e, cfg)
    if div is None:
        print("[check] greedy outputs token-identical to the plain run",
              flush=True)
    else:
        rid, n = div
        gap = top2_gap(eng, outs[rid][:n])
        print(f"[check] rid {rid} diverges at token {n}: top-2 logit gap "
              f"{gap:.3e}", flush=True)
        if gap >= TIE_GAP:
            fail(f"greedy divergence at rid {rid} token {n} with top-2 gap "
                 f"{gap:.3e} >= {TIE_GAP}")
    tps = {"kernels": [n_gen / wall], "plain": [n_gen_e / wall_e]}
    for _ in range(SERVE_RUNS - 1):
        for key, e, want in (("kernels", eng, outs), ("plain", eager,
                                                       outs_e)):
            got, _, n, w = serve_once(e, cfg)
            if got != want:
                fail(f"a repeated {key} serve run changed its outputs")
            tps[key].append(n / w)
    for key, v in tps.items():
        print(f"[serve] {key}: tokens/s over {len(v)} runs = "
              f"{', '.join(f'{x:.1f}' for x in v)} (median "
              f"{sorted(v)[len(v) // 2]:.1f})", flush=True)
    step_err = compare_mixed_step(params, cfg, device)
    print(f"[check] one mixed step, kernels vs plain: max |logit diff| = "
          f"{step_err:.3e} (atol {STEP_ATOL})", flush=True)
    if not step_err <= STEP_ATOL:
        fail(f"mixed step logits differ by {step_err:.3e}")

    del eng, eager, params
    torch.cuda.empty_cache()

    # Training: the MoE runs at the config's own capacity factor.
    train_launches, first_params, first_batch, first_mets = train_path(
        full, device)
    compare_first_moe_step(full, device, first_params, first_batch,
                           first_mets)

    for rec in records:
        name = rec["name"]
        by_path = {"serve": launches.get(name, 0),
                   "train": train_launches.get(name, 0)}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
