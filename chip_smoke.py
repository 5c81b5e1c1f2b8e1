#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository checkout beside this file; exits non-zero otherwise, and on
any failure, before printing its result line. It

1. prints the card's name and power limit, builds the eleven CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once) and prints the build seconds and each kernel's
   registers;
2. holds each kernel against its plain PyTorch version on the card —
   the serve kernels at the serve shapes below in float32 and bfloat16,
   the training kernels (flash attention forward, dq, dk/dv; grouped
   dx, dW) at the training shapes in float32, the expert-FFN kernels
   (forward, dx, dW) and the flash kernels without the causal mask at
   the ViT-B/16 shapes — and times on the device's clock the kernel,
   the plain version and (where one exists) a PyTorch library yardstick
   computing the same function;
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
7. trains the paper's vision model the same way at full width:
   ViT-B/16 (``vit-b16-upcycled``'s dense parent, batch 104 images x 196
   patches) takes 2 steps, is upcycled into 32-expert Expert Choice MoE
   layers in its last 6 layers with the Adafactor state carried over,
   and takes 4 steps with ``dispatch="gather"`` through the expert-FFN
   kernels; checks each kernel's launches a step, and holds and
   witnesses the first MoE step as in 6;
8. prints one JSON line of per-kernel numbers, then the result line
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
# at the config's own capacity factor, through the sorted dispatch, with
# fresh optimizer state. The data task covers the first TASK_VOCAB ids
# (repro_torch.launch.train).
TRAIN = dict(arch="granite-moe-1b-a400m", batch=16, seq=512, dense_steps=2,
             moe_steps=4, peak_lr=0.01, warmup=100, dispatch="sorted",
             resume_opt=False)
# The ViT train cell: 104 images x 196 patches = 20,384 tokens, five
# routing groups of 4096 (the last padded with 96 zero tokens); the
# vision recipe's Expert Choice layers through the gather dispatch, the
# dense Adafactor state carried into the MoE (paper §B.6).
VIT_TRAIN = dict(arch="vit-b16-upcycled", batch=104, seq=196, dense_steps=2,
                 moe_steps=4, peak_lr=0.01, warmup=100, dispatch="gather",
                 resume_opt=True)
# First MoE step, kernels vs plain: the loss within 1e-4 relative, the
# global gradient norm within 1e-3 relative (f32 summation order through
# 24 layers of forward and backward, on conditioned weights).
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 1e-3

SERVE_KERNELS = ("decode_attention", "paged_prefill", "grouped_mlp")
FLASH_KERNELS = ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv")
TRAIN_KERNELS = FLASH_KERNELS + ("grouped_mlp", "grouped_mlp_dx",
                                 "grouped_mlp_dw")
EXPERT_KERNELS = ("expert_mlp", "expert_mlp_dx", "expert_mlp_dw")
VIT_KERNELS = FLASH_KERNELS + EXPERT_KERNELS


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


def _record(kname, src, replaces, max_err, ms, plain_ms, nbytes, flops,
            lib_ms, dtype="float32"):
    """One kernel's JSON record; its bound is the larger of the bytes
    over the memory rate and the FLOPs over the dtype's peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return {
        "name": kname, "route": "cuda", "source": src,
        "replaces": replaces, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


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
            rec = _record(kname, src, replaces, max_err, ms, plain_ms, nbytes,
                          flops, lib_ms, dtype=name)
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


def flash_work(a, kind, causal=True):
    """Bytes (inputs once, outputs once) and FLOPs of one flash call on
    these inputs: the live (query, key) pairs only."""
    B, S, H, dh = a["q"].shape
    Kh = a["k"].shape[2]
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
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
        rec = _record(kname, src, replaces, max_err, ms, plain_ms, nbytes,
                      flops, lib_ms)
        print(f"[train-kernel] {kname} float32: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}: "
              f"{nbytes} B, {flops} FLOP)", flush=True)
        records.append(rec)
    return records


def vit_cases(cfg, device, gen):
    """Flash and expert-FFN inputs at the ViT train cell's shapes: q, k,
    v, dO (104, 196, 12, 64), non-causal; the padded capacity buffer
    xe (5, 32, 256, 768) of five routing groups with every Expert Choice
    slot filled, dy, wi/wg (32, 768, 3072) and wo (32, 3072, 768) at
    fan-in scale."""
    import torch

    from repro_torch.core.routing import capacity
    from repro_torch.kernels import flash_attention as fa

    B, S = VIT_TRAIN["batch"], cfg.n_frontend_positions
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    a = dict(q=rnd(B, S, H, dh), k=rnd(B, S, Kh, dh), v=rnd(B, S, Kh, dh),
             do=rnd(B, S, H, dh), qo=fa.scalar_i32(0, device),
             kl=fa.scalar_i32(S, device))
    moe = cfg.moe
    G = -(-B * S // moe.group_size)
    E, cap, d, f = moe.num_experts, capacity(moe.group_size, moe), \
        cfg.d_model, cfg.d_ff
    mk = lambda *s, fan: rnd(*s) / fan ** 0.5  # noqa: E731
    c = dict(xe=rnd(G, E, cap, d), dy=rnd(G, E, cap, d),
             wi=mk(E, d, f, fan=d), wg=mk(E, d, f, fan=d),
             wo=mk(E, f, d, fan=f))
    return a, c


def expert_work(c, kind):
    """Bytes (inputs once, outputs once) and FLOPs of one ungated f32
    expert-FFN kernel call over every row of the buffer (Expert Choice
    fills every slot)."""
    G, E, cap, d = c["xe"].shape
    f = c["wi"].shape[-1]
    rows, wbytes = G * E * cap, 2 * E * d * f * 4
    if kind == "fwd":  # x, wi, wo -> y: x wi, h wo
        return 2 * rows * d * 4 + wbytes, 4 * rows * d * f
    if kind == "dx":  # x, dy, wi, wo -> dx, da, h: a, dh, da wi^T
        return 3 * rows * d * 4 + wbytes + 2 * rows * f * 4, \
            6 * rows * d * f
    # dW: x, dy, da, h -> dwi, dwo
    return 2 * rows * d * 4 + 2 * rows * f * 4 + wbytes, 4 * rows * d * f


def check_vit_kernels(cfg, device):
    """The three expert-FFN kernels (float32, the forward in bfloat16
    too; ungated gelu as the ViT runs them, and gated silu) and the
    flash kernels without the causal mask, at the ViT train cell's
    shapes, against their plain versions, with times. The expert
    kernels' library yardstick is the float32 ``torch.matmul`` chain
    over the same rows (forward: x wi, gelu, @ wo — 3 calls; dx:
    recompute a, dh, gelu's backward, @ wi^T — 4 calls; dW: x^T da and
    h^T dy — 2 calls). Returns (the expert kernels' JSON records, the
    flash kernels' numbers at these shapes by name)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    a, c = vit_cases(cfg, device, gen)
    atol, rtol = TOL["float32"]

    def held(tag, y, y_ref, tol=TOL["float32"]):
        err, ratio = _max_err(y, y_ref, *tol)
        print(f"[vit-kernel] {tag}: max |kernel - plain| = {err:.3e}, "
              f"max err / limit = {ratio:.3f} (atol {tol[0]}, rtol "
              f"{tol[1]})", flush=True)
        if not ratio <= 1.0:
            fail(f"{tag}: kernel and plain version differ beyond their "
                 f"tolerance (ratio {ratio:.3g})")
        return err

    # Checks only: the gated (silu) kernels and the bf16 forward.
    xe, dy, wi, wg, wo = (c[k] for k in ("xe", "dy", "wi", "wg", "wo"))
    held("expert_mlp gated silu float32",
         em.expert_ffn_cuda(xe, wi, wg, wo, act="silu"),
         ref.expert_ffn_ref(xe, wi, wg, wo, act="silu"))
    gdx = em.expert_ffn_dx_cuda(xe, wi, wg, wo, dy, act="silu")
    held("expert_mlp_dx gated silu float32", gdx,
         ref.expert_ffn_dx_ref(xe, wi, wg, wo, dy, act="silu"))
    held("expert_mlp_dw gated silu float32", em.expert_ffn_dw_cuda(
        xe, dy, *gdx[1:]), ref.expert_ffn_dw_ref(xe, dy, *gdx[1:]))
    del gdx
    bf = [t.to(torch.bfloat16) for t in (xe, wi, wo)]
    held("expert_mlp gelu bfloat16",
         em.expert_ffn_cuda(bf[0], bf[1], None, bf[2], act="gelu"),
         ref.expert_ffn_ref(bf[0], bf[1], None, bf[2], act="gelu"),
         TOL["bfloat16"])
    del bf, wg
    torch.cuda.empty_cache()

    # The ViT's own kernels (ungated gelu), checked and timed.
    dxs = em.expert_ffn_dx_cuda(xe, wi, None, wo, dy, act="gelu")
    scratch = (dxs[1], None, dxs[3])
    # The yardstick's inputs: each expert's G * cap rows together (set-up,
    # not timed).
    G, E, cap, d = xe.shape
    xt = xe.transpose(0, 1).reshape(E, G * cap, d).contiguous()
    dyt = dy.transpose(0, 1).reshape(E, G * cap, d).contiguous()
    da_t = dxs[1].transpose(0, 1).reshape(E, G * cap, -1).contiguous()
    h_t = dxs[3].transpose(0, 1).reshape(E, G * cap, -1).contiguous()
    gelu = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731

    def lib_fwd():
        torch.matmul(gelu(torch.matmul(xt, wi)), wo)

    def lib_dx():
        at = torch.matmul(xt, wi)
        dh = torch.matmul(dyt, wo.transpose(1, 2))
        da = torch.ops.aten.gelu_backward(dh, at, approximate="tanh")
        torch.matmul(da, wi.transpose(1, 2))

    def lib_dw():
        torch.matmul(xt.transpose(1, 2), da_t)
        torch.matmul(h_t.transpose(1, 2), dyt)

    cases = [
        ("expert_mlp", lambda: em.expert_ffn_cuda(xe, wi, None, wo,
                                                  act="gelu"),
         lambda: ref.expert_ffn_ref(xe, wi, None, wo, act="gelu"),
         expert_work(c, "fwd"), lib_fwd, 3,
         "src/repro_torch/kernels/csrc/expert_mlp.cu",
         "src/repro/kernels/expert_mlp.py:79"),
        ("expert_mlp_dx", lambda: em.expert_ffn_dx_cuda(xe, wi, None, wo, dy,
                                                        act="gelu"),
         lambda: ref.expert_ffn_dx_ref(xe, wi, None, wo, dy, act="gelu"),
         expert_work(c, "dx"), lib_dx, 4,
         "src/repro_torch/kernels/csrc/expert_mlp_bwd.cu",
         "src/repro/kernels/expert_mlp.py:227"),
        ("expert_mlp_dw", lambda: em.expert_ffn_dw_cuda(xe, dy, *scratch),
         lambda: ref.expert_ffn_dw_ref(xe, dy, *scratch),
         expert_work(c, "dw"), lib_dw, 2,
         "src/repro_torch/kernels/csrc/expert_mlp_bwd.cu",
         "src/repro/kernels/expert_mlp.py:299"),
    ]
    records = []
    for kname, kern, plain, (nbytes, flops), lib, ncalls, src, rep in cases:
        y = kern()
        torch.cuda.synchronize()
        err = held(f"{kname} gelu float32", y, plain())
        del y
        ms = time_ms(kern, flush=flush)
        plain_ms = time_ms(plain, flush=flush)
        lib_ms = time_ms(lib, flush=flush)
        rec = _record(kname, src, rep, err, ms, plain_ms, nbytes, flops,
                      lib_ms)
        rec["library_calls"] = ncalls
        print(f"[vit-kernel] {kname} float32: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"({ncalls} torch calls) bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}: {nbytes} B, {flops} FLOP)", flush=True)
        records.append(rec)
    del dxs, scratch, xt, dyt, da_t, h_t, c, xe, dy, wi, wo
    torch.cuda.empty_cache()

    # Flash attention, non-causal, MHA, S = 196 (a ragged last kv tile).
    kw = dict(causal=False, q_offset=a["qo"], kv_len=a["kl"])
    o, lse = fa.flash_attention_fwd_cuda(a["q"], a["k"], a["v"], a["qo"],
                                         a["kl"], causal=False)
    delta = fa.attention_delta(o, a["do"])
    bwd_args = (a["q"], a["k"], a["v"], a["do"], lse, delta)
    lq, lk, lv = (a[n].transpose(1, 2).contiguous().requires_grad_()
                  for n in ("q", "k", "v"))
    lo = F.scaled_dot_product_attention(lq, lk, lv)
    ldo = a["do"].transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(lq, lk, lv)

    def sdpa_bwd():
        torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    flash = [
        ("flash_attention",
         lambda: fa.flash_attention_fwd_cuda(a["q"], a["k"], a["v"], a["qo"],
                                             a["kl"], causal=False),
         lambda: ref.flash_attention_ref(a["q"], a["k"], a["v"], **kw),
         "fwd", sdpa_fwd),
        ("flash_attention_dq",
         lambda: fa.flash_attention_dq_cuda(*bwd_args, a["qo"], a["kl"],
                                            causal=False),
         lambda: ref.flash_attention_dq_ref(*bwd_args, **kw), "dq",
         sdpa_bwd),
        ("flash_attention_dkv",
         lambda: fa.flash_attention_dkv_cuda(*bwd_args, a["qo"], a["kl"],
                                             causal=False),
         lambda: ref.flash_attention_dkv_ref(*bwd_args, **kw), "dkv",
         sdpa_bwd),
    ]
    at_vit = {}
    for kname, kern, plain, kind, lib in flash:
        y = kern()
        torch.cuda.synchronize()
        err = held(f"{kname} non-causal float32", y, plain())
        nbytes, flops = flash_work(a, kind, causal=False)
        rec = _record(kname, "", "", err, time_ms(kern, flush=flush),
                      time_ms(plain, flush=flush), nbytes, flops,
                      time_ms(lib, flush=flush))
        at_vit[kname] = {k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        print(f"[vit-kernel] {kname} non-causal {tuple(a['q'].shape)} float32: "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']:.4f} bound_ms="
              f"{rec['bound_ms']:.4f} ({rec['bound_by']}: {nbytes} B, "
              f"{flops} FLOP)", flush=True)
    return records, at_vit


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
    from repro_torch.kernels import expert_mlp as em
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
        (em, "expert_ffn_cuda", "expert_mlp", ref.expert_ffn_ref),
        (em, "expert_ffn_dx_cuda", "expert_mlp_dx", ref.expert_ffn_dx_ref),
        (em, "expert_ffn_dw_cuda", "expert_mlp_dw", ref.expert_ffn_dw_ref),
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
            ac=zoo.ApplyCfg(dispatch="sorted", moe_impl=impl,
                            attn_impl=impl))[1]

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


def train_path(cfg, device, spec, kernels):
    """Dense parent -> upcycle -> MoE, through the kernels, at full
    width, as ``spec`` (TRAIN, VIT_TRAIN) sets it out. Every kernel in
    ``kernels`` must launch; in every step each attention kernel runs
    once a layer, and in every MoE step each of the path's expert
    kernels once a MoE layer. Returns (launches of the run, and the
    first MoE step's params (a copy), batch and metrics)."""
    import torch

    from repro_torch.core.upcycle import upcycle_opt_state, upcycle_params
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import stack as stk
    from repro_torch.models.param import count_params, tree_map
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    name = spec["arch"]
    dense_cfg = cfg.dense_parent()
    encoder = cfg.structure == "encoder_only"
    opt = adafactor(inverse_sqrt(peak=spec["peak_lr"],
                                 warmup_steps=spec["warmup"]))
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(dense_cfg, global_batch=spec["batch"],
                       seq_len=spec["seq"], task=task)
    gen = torch.Generator(device=device).manual_seed(0)
    params = zoo.init_params(gen, dense_cfg, device=device)
    condition_attention(params, dense_cfg)
    state = init_train_state(None, dense_cfg, opt, params=params)
    ac = zoo.ApplyCfg(dispatch=spec["dispatch"], moe_impl="cuda",
                      attn_impl="cuda")
    tokens = spec["batch"] * spec["seq"]
    what = "images" if encoder else "sequences"
    print(f"[{name}] {dense_cfg.name}: {count_params(params) / 1e9:.3f} B "
          f"params; batch {spec['batch']} {what} x {spec['seq']} = {tokens} "
          f"tokens a step" + ("" if encoder else
                              f" (task vocab {task.vocab_size})"),
          flush=True)
    n_moe = sum(d.ffn == "moe" for d in stk.layer_descs(cfg))
    moe_kernels = [k for k in kernels if k not in FLASH_KERNELS]
    rows = []

    def run(step_fn, st, batch, tag):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        st, m = step_fn(st, batch)
        ms = _sync_ms(t0)
        m = {k: float(v) for k, v in m.items()}
        per = {k: v - before[k] for k, v in ops.launch_counts().items()}
        ran = {k: v for k, v in per.items() if v}
        print(f"[{name}] {tag} step {int(st['step'])}: loss={m['loss']:.5f} "
              f"ce={m['ce']:.5f} aux={m['aux_loss']:.5f} "
              f"dropped={m['dropped_frac_sum']:.4f} "
              f"grad_norm={m['grad_norm']:.5f} skipped={m['skipped']:.0f} "
              f"ms={ms:.1f} launches={ran}", flush=True)
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       m.values())):
            fail(f"{tag} step: non-finite metrics {m}")
        if m["skipped"]:
            fail(f"{tag} step was skipped by the non-finite guard")
        want = {k: cfg.n_layers for k in FLASH_KERNELS}
        want.update({k: n_moe if tag == "moe" else 0 for k in moe_kernels})
        if any(per[k] != v for k, v in want.items()):
            fail(f"{name} {tag} step launched {per}, expected {want}")
        rows.append((tag, ms, m))
        return st, m

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    dense_step = make_train_step(dense_cfg, opt, ac=ac)
    for _ in range(spec["dense_steps"]):
        state, _ = run(dense_step, state, next(it), "dense")
    t0 = time.perf_counter()
    sparse = upcycle_params(state["params"], dense_cfg, cfg, gen)
    print(f"[{name}] upcycled ({cfg.moe.expert_init}) to {cfg.name}: "
          f"{count_params(sparse) / 1e9:.3f} B params in "
          f"{_sync_ms(t0):.0f} ms", flush=True)
    first_params = tree_map(torch.clone, sparse)
    sstate = init_train_state(None, cfg, opt, params=sparse)
    if spec["resume_opt"]:
        # The Adafactor state carries over, its step counter with it.
        sstate["opt_state"] = upcycle_opt_state(
            sstate["opt_state"], state["opt_state"], dense_cfg, cfg)
    sstate["step"] = state["step"]  # the step counter carries over
    del state, params
    moe_step = make_train_step(cfg, opt, ac=ac)
    first_batch = next(it)
    sstate, first = run(moe_step, sstate, first_batch, "moe")
    for _ in range(spec["moe_steps"] - 1):
        sstate, _ = run(moe_step, sstate, next(it), "moe")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moe_ms = [ms for tag, ms, _ in rows if tag == "moe"]
    dense_ms = [ms for tag, ms, _ in rows if tag == "dense"]
    rate = lambda ms, n: n / (sum(ms) / 1e3 / len(ms))  # noqa: E731
    after = (f"; images/s after the first step "
             f"{rate(moe_ms[1:], spec['batch']):.1f}" if encoder else "")
    print(f"[{name}] tokens/s: dense {rate(dense_ms, tokens):.0f} "
          f"(steps {', '.join(f'{x:.1f}' for x in dense_ms)} ms), MoE "
          f"{rate(moe_ms, tokens):.0f} (steps "
          f"{', '.join(f'{x:.1f}' for x in moe_ms)} ms); MoE after the "
          f"first step {rate(moe_ms[1:], tokens):.0f} ms/step "
          f"{sum(moe_ms[1:]) / len(moe_ms[1:]):.1f}{after}; peak memory "
          f"{peak:.1f} GiB ({torch.cuda.max_memory_allocated()} B)",
          flush=True)
    print(f"[{name}] launches: {launches}", flush=True)
    missing = [k for k in kernels if not launches[k]]
    if missing:
        fail(f"kernels of the {name} training path never launched: "
             f"{missing}")
    del sstate
    return launches, first_params, first_batch, first


def compare_first_moe_step(cfg, device, params, batch, kernel_mets, spec,
                           kernels):
    """The first MoE step's loss and gradient norm through the plain
    versions, against the kernels' (from the main path); then the same
    step through the kernels with every kernel call witnessed."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim.base import global_norm
    from repro_torch.training.train_loop import batch_to, loss_and_grads

    from repro_torch.kernels import ops

    name = spec["arch"]
    batch = batch_to(batch, device)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    grads, m = loss_and_grads(
        params, batch, cfg,
        ac=zoo.ApplyCfg(dispatch=spec["dispatch"], moe_impl="eager",
                        attn_impl="eager"))
    gn = float(global_norm(grads))
    del grads
    plain_ms = _sync_ms(t0)
    if any(ops.launch_counts().values()):
        fail(f"the plain step launched kernels: {ops.launch_counts()}")
    loss = float(m["loss"])
    print(f"[check] {name} first MoE step, plain versions (no kernel "
          f"launched): loss={loss!r} grad_norm={gn!r}; kernels: "
          f"loss={kernel_mets['loss']!r} grad_norm="
          f"{kernel_mets['grad_norm']!r} ({plain_ms:.0f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)",
          flush=True)
    d_loss = abs(kernel_mets["loss"] - loss) / abs(loss)
    d_gn = abs(kernel_mets["grad_norm"] - gn) / abs(gn)
    print(f"[check] {name} first MoE step, kernels vs plain: loss rel diff "
          f"{d_loss:.3e} (limit {LOSS_RTOL}), grad_norm rel diff {d_gn:.3e} "
          f"(limit {GRAD_NORM_RTOL})", flush=True)
    if not (d_loss <= LOSS_RTOL and d_gn <= GRAD_NORM_RTOL):
        fail(f"the {name} first MoE step through the kernels and through "
             "the plain versions disagree")
    with witnessed_kernels() as wit:
        grads, _ = loss_and_grads(
            params, batch, cfg,
            ac=zoo.ApplyCfg(dispatch=spec["dispatch"], moe_impl="cuda",
                            attn_impl="cuda"))
        torch.cuda.synchronize()
    del grads
    report_witness(wit, kernels)


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
    vit = get_config(VIT_TRAIN["arch"])
    records = check_kernels(cfg, device)
    records += check_train_kernels(full, device)
    vit_records, flash_at_vit = check_vit_kernels(vit, device)
    records += vit_records
    for rec in records:
        if rec["name"] in flash_at_vit:
            rec["at_vit_shapes"] = flash_at_vit[rec["name"]]

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
        full, device, TRAIN, TRAIN_KERNELS)
    compare_first_moe_step(full, device, first_params, first_batch,
                           first_mets, TRAIN, TRAIN_KERNELS)
    del first_params, first_batch
    torch.cuda.empty_cache()

    # The paper's vision model: Expert Choice through the gather
    # dispatch and the expert-FFN kernels.
    vit_launches, first_params, first_batch, first_mets = train_path(
        vit, device, VIT_TRAIN, VIT_KERNELS)
    compare_first_moe_step(vit, device, first_params, first_batch,
                           first_mets, VIT_TRAIN, VIT_KERNELS)
    del first_params, first_batch

    for rec in records:
        name = rec["name"]
        by_path = {"serve": launches.get(name, 0),
                   "granite_train": train_launches.get(name, 0),
                   "vit_train": vit_launches.get(name, 0)}
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
