#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository checkout beside this file; exits non-zero otherwise, and on
any failure, before printing its result line. It

1. prints the card's name and power limit, builds the twelve CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all at once) and prints the build seconds and each kernel's
   registers and spill bytes;
2. holds each kernel against its plain PyTorch version on the card —
   the serve kernels at the serve shapes below in float32 and bfloat16,
   the training kernels (flash attention forward, dq, dk/dv; grouped
   forward, dx, dW) at the training shapes in float32 (the flash kernels
   also at the score sizes of granite's reference init), the expert-FFN
   kernels (forward, dx, dW) and the flash kernels without the causal
   mask at the ViT-B/16 shapes — and times on the device's clock the kernel,
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
8. serves granite (as in 4) through the static engine,
   ``ServeEngine(paged=False)``, right after 5: 4 prompts of 64..128
   tokens, 16 new each, through the kernels (the flash forward at
   prefill, the expert FFN under the gather dispatch) and through the
   plain versions, token-identical, each kernel's launches counted and
   one prefill and decode step witnessed; then holds and times the
   flash forward at the prefill's shape and the expert FFN at the
   prefill's and a decode step's buffer (the model's own expert
   weights);
9. holds the WKV-6 kernel against the chunked plain version and the
   sequential oracle at the rwkv serve shapes (prefill 8 x 512 and a
   decode step, 64 heads of 64, f32 and bf16), requires two calls to
   give the same bits (as of the grouped dW in 2), and times it;
10. builds rwkv6-7b at full width and depth (7.5 B params, float32) and
    serves 8 prompts of 256..512 tokens, 64 new tokens each, through the
    static engine, through the kernels and the plain versions twice
    each, interleaved: token-identical, exactly 32 x 64 WKV launches a
    run, prefill and decode tokens/s and peak memory, one prefill and
    decode step witnessed;
11. upcycles rwkv6-7b's dense parent at full width and 4 layers into
    its channel-mix MoE (32 experts, top-2, every other layer, 8.7 B
    params) and serves 8 prompts of 128 tokens, 16 new, the same way
    (the WKV and expert-FFN kernels); then holds and times the expert
    FFN at the prefill's (cap 1024) and a decode step's (cap 8) buffer
    with one MoE layer's weights;
12. runs the paper's chain through the port's checkpoints, Trainer and
    launchers at full width and depth, in a temporary directory: granite's
    dense parent trains 4 steps through the ``Trainer`` from the
    reference init (batch 8 x 512, checkpoints every 2 steps); the same
    run is killed after step 3 and resumes from step 2 (the restored
    state bit-identical to the state saved, the replayed losses within
    LOSS_RTOL); ``launch.train.upcycle_from`` restores the dense params
    bit for bit from the full train-state checkpoint and upcycles them
    into granite-moe-1b-a400m, which trains 2 steps (sorted dispatch) to
    a checkpoint; ``launch.serve.load_params`` restores it bit for bit
    and the 12 requests of 4 are served from it and from the Trainer's
    in-memory params (both conditioned as in 4), token-identical; then ``launch.train.main --upcycle-from``
    and ``launch.serve.main --ckpt-dir --paged`` run once each. Every
    step's launches are counted; every save and restore is timed (bytes,
    seconds, GB/s);
13. prints one JSON line of per-kernel numbers (all twelve kernels),
    then the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TF32_S = 495e12
# Kernels whose float32 products run on tensor cores as three TF32
# products (csrc/mma_sm90.cuh): their bound is 3 x FLOPs over the TF32
# rate (or the bytes), with the CUDA-core bound recorded beside it.
TF32X3_KERNELS = ("flash_attention", "flash_attention_dq",
                  "flash_attention_dkv", "expert_mlp", "expert_mlp_dx",
                  "expert_mlp_dw", "paged_prefill", "grouped_mlp",
                  "grouped_mlp_dx", "grouped_mlp_dw")

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

# The rwkv serve cells, static engine, greedy, float32 caches. Dense
# rwkv6-7b at full width and depth: 8 prompts of 256..512 tokens from
# the seed, 64 new tokens each, served through the kernels and through
# the plain versions RWKV_RUNS times each, interleaved. The upcycled
# channel-mix MoE (rwkv6_7b.upcycled(): 32 experts, top-2, every other
# layer) at full width and RWKV_MOE_LAYERS layers (the full depth would
# be 263 GB in float32), dropless: 8 prompts of 128 tokens, 16 new.
RWKV_SERVE = dict(max_batch=8, max_len=576)
RWKV_PROMPTS, RWKV_PLEN, RWKV_NEW, RWKV_RUNS = 8, (256, 512), 64, 2
RWKV_MOE_LAYERS, RWKV_MOE_PLEN, RWKV_MOE_NEW = 4, 128, 16
# The rwkv cells' near-tie bound. Even conditioned (condition_rwkv), a
# random 32-layer rwkv6 amplifies float32 rounding into its logits: fed
# the same tokens, the kernels' path and the plain path part by ~1e-3
# over a 463-token prefill and 63 decode steps (printed by each run, as
# is the same drift against the WKV's sequential oracle), while every WKV
# call agrees with its plain versions to ~1e-6 of its largest output.
# Across 512 greedy tokens, near-ties narrower than that may flip. A
# divergence is accepted only at a top-2 gap below RWKV_TIE_GAP, and only
# if the two paths' logits, fed the same tokens, never part by more than
# RWKV_TIE_GAP; a wrong kernel parts them by O(1) (each run prints the
# drift at the reference init too, where the model is chaotic).
RWKV_TIE_GAP = 1e-2
# The static attention path on granite: 4 prompts of 64..128 tokens, 16
# new tokens each.
GRANITE_STATIC = dict(prompts=4, plen=(64, 128), max_new=16)
# The WKV kernel against a plain version: max |kernel - plain| over the
# call's output (and, apart, its final state) within WKV_RTOL times the
# largest |plain| there. A WKV sum mixes terms of very different sizes
# (decays from ~1e-9 to ~1 a step), so an element's rounding follows the
# call's largest terms, not its own size. Against the sequential oracle
# (the same recurrence, other summation order) float32 rounding only;
# against the chunked version (the reference's XLA path, the port's
# eager one) that version's own error: its decay ratios are differences
# of cumulative log sums, exact to 2^-24 * sum |log w| (|log w| up to
# e^3.5 a step over a 64-step chunk), 10x the oracle's distance at the
# prefill shape; bfloat16 outputs round once more (2^-8).
WKV_RTOL = {"oracle": 1e-5, "chunked": 2e-4, "bfloat16": 1e-2}

SERVE_KERNELS = ("decode_attention", "paged_prefill", "grouped_mlp")
FLASH_KERNELS = ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv")
TRAIN_KERNELS = FLASH_KERNELS + ("grouped_mlp", "grouped_mlp_dx",
                                 "grouped_mlp_dw")
EXPERT_KERNELS = ("expert_mlp", "expert_mlp_dx", "expert_mlp_dw")
VIT_KERNELS = FLASH_KERNELS + EXPERT_KERNELS


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ptxas_usage(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel in an ``nvcc -Xptxas -v`` log, the kernel by its mangled
    name."""
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out.append((fn, int(m.group(1)), *spill))
            fn = None
    return out


def sass_hmma(kernel) -> dict:
    """Tensor-core instructions (HMMA) in the SASS of a kernel's library,
    by ``__global__`` name of its source (``cuobjdump -sass``)."""
    from repro_torch.kernels.build import nvcc_path

    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\s*\(", kernel.source.read_text())
    tool = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(kernel.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts = dict.fromkeys(names, 0)
    for part in sass.split("Function : ")[1:]:
        fn = part.split(maxsplit=1)[0]
        for n in names:
            if f"{len(n)}{n}" in fn:
                counts[n] += part.count("HMMA")
    return counts


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


class HostBound(RuntimeError):
    """The timed call waits on the device from the host, so it cannot be
    queued ahead of it (time it with time_synced_ms)."""


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
    raise HostBound("could not queue the timed calls ahead of the device")


# Launches the host queues behind the spin kernel at most: a stream
# holds a bounded number of pending launches, and a host that fills it
# waits for the device, so a longer batch cannot be queued (HostBound).
QUEUED_LAUNCHES = 512


def time_library_ms(lib, *, flush, iters: int = 20):
    """(ms, chain) of a library yardstick, on the device clock (time_ms)
    as the kernels are timed. ``lib`` is one call (chain None), or the
    grouped kernels' chains [(label, call, torch calls)] in order of
    preference (grouped_library): the first whose calls can be queued
    ahead of the device is timed, ``iters`` calls in batches of at most
    QUEUED_LAUNCHES launches, and returned as ``chain``; (None, None),
    with the reason printed, where none can."""
    if callable(lib):
        return time_ms(lib, flush=flush, iters=iters), None
    for chain in lib:
        n = max(1, min(iters, QUEUED_LAUNCHES // (chain[2] + 1)))
        reps = -(-iters // n)
        try:
            return sum(time_ms(chain[1], flush=flush, iters=n)
                       for _ in range(reps)) / reps, chain
        except HostBound:
            print(f"[library] the {chain[0]} chain ({chain[2]} torch calls) "
                  f"cannot be queued ahead of the device (it reads device "
                  f"values on the host, or fills the launch queue)",
                  flush=True)
    print("[library] library_ms null: no chain could be queued", flush=True)
    return None, None


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
    """Bytes (inputs read once, output written once: each slot's keys
    and values below its length, the lengths and the live blocks' table
    entries) and FLOPs of the decode call on these inputs."""
    B, H, dh = c["q_dec"].shape
    bs, Kh = c["kp"].shape[1], c["kp"].shape[2]
    lens = [int(x) for x in c["lengths"]]
    blocks = sum(-(-n // bs) for n in lens)
    kv = 2 * sum(lens) * Kh * dh * itemsize
    nbytes = 2 * B * H * dh * itemsize + kv + 4 * (B + blocks)
    flops = sum(4 * H * dh * n for n in lens)
    return nbytes, flops


def prefill_work(c, itemsize):
    """Bytes (as decode_work's: the keys and values of each pool block
    up to the last position a lane reads in it, a block shared by lanes
    once) and FLOPs of the prefill call on these inputs."""
    NC, C, H, dh = c["q_ch"].shape
    bs, Kh = c["kp"].shape[1], c["kp"].shape[2]
    keys, flops = {}, 0
    for lane in range(NC):
        st, ln = int(c["starts"][lane]), int(c["lens"][lane])
        for b in range(-(-(st + ln) // bs)):
            blk = int(c["ctab"][lane, b])
            keys[blk] = max(keys.get(blk, 0), min(bs, st + ln - b * bs))
        flops += sum(4 * H * dh * (st + i + 1) for i in range(ln))
    kv = 2 * sum(keys.values()) * Kh * dh * itemsize
    nbytes = 2 * NC * C * H * dh * itemsize + kv + 4 * (len(keys) + 2 * NC)
    return nbytes, flops


def grouped_work(c, itemsize):
    """Bytes (the valid rows and the live experts' weights read once,
    every output row written, the sizes) and FLOPs (gated: 6 d f a valid
    row) of the grouped forward on these inputs."""
    G, M, d = c["xs"].shape
    E, _, f = c["wi"].shape
    counts = c["counts"]
    rows = int(counts.sum())
    live = int((counts > 0).any(0).sum())
    nbytes = (rows * d + live * 3 * d * f + G * M * d) * itemsize + 4 * G * E
    return nbytes, 6 * rows * d * f


def grouped_library(c, kind, tag):
    """The grouped kernels' library yardsticks over the same segments,
    gated silu as granite runs it, in order of preference (see
    time_library_ms): a ``torch._grouped_mm`` chain, one a group (group
    g's experts end at ``row_off[g, 1:]``; padded rows are zero, the
    tail past the last segment is not read), and a chain of per-expert
    ``torch.matmul`` over each live segment's valid rows, which stands
    in where the first cannot be queued (``_grouped_mm``'s float32 path
    reads its offsets on the host). forward: x wi, x wg, silu, *, h wo
    (5 calls a group or segment); dx: a = x wi, g = x wg, dh = dy wo^T,
    silu(a), dh g, silu's backward, dh silu(a), da wi^T, dg wg^T, + (10
    calls a group; 9 a segment, the sum by addmm). Segment bounds are
    read once here, as set-up. Returns [(label, call, calls), ...]; a
    call returns the forward's y or dx: a list of each group's segments
    (the first row_off[g, -1] rows; the kernels also write the tail's
    zero rows) or the (G, M, d) buffer. Where this PyTorch lacks
    ``_grouped_mm`` or refuses the dtype, prints why, under ``tag``.
    dW (``kind`` "dw", over the dx's scratch ``c["da"]``, ``c["dg"]``,
    ``c["h"]``): the per-expert chain only, x^T da, x^T dg and h^T dy
    over each live segment, the groups summed by ``addmm`` (3 calls a
    segment); it returns (dwi, dwg, dwo)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_row_offsets

    xs, wi, wg, wo = (c[k] for k in ("xs", "wi", "wg", "wo"))
    G, M, d = xs.shape
    row_off, _ = ragged_row_offsets(c["counts"], ROW_BLOCK)
    segs = [(g, e, s, n) for g, (so, cn) in enumerate(zip(
        row_off.tolist(), c["counts"].tolist()))
        for e, (s, n) in enumerate(zip(so, cn)) if n > 0]
    if kind == "dw":
        E, f = wi.shape[0], wi.shape[-1]
        dws = (torch.zeros(E, d, f, device=xs.device),
               torch.zeros(E, d, f, device=xs.device),
               torch.zeros(E, f, d, device=xs.device))
        seen, firsts = set(), set()  # each expert's first segment
        for g, e, _, _ in segs:
            if e not in seen:
                seen.add(e)
                firsts.add((g, e))

        def dw_seg():
            for g, e, s, n in segs:
                x, gy = xs[g, s:s + n], c["dy"][g, s:s + n]
                for dst, a, b in ((dws[0][e], x, c["da"][g, s:s + n]),
                                  (dws[1][e], x, c["dg"][g, s:s + n]),
                                  (dws[2][e], c["h"][g, s:s + n], gy)):
                    if (g, e) in firsts:
                        torch.matmul(a.T, b, out=dst)
                    else:
                        dst.addmm_(a.T, b)
            return dws

        return [("per-expert torch.matmul", dw_seg, 3 * len(segs))]
    out = torch.zeros_like(xs)  # the rows no segment writes stay zero

    def fwd_seg():
        for g, e, s, n in segs:
            x = xs[g, s:s + n]
            h = F.silu(x @ wi[e]) * (x @ wg[e])
            torch.matmul(h, wo[e], out=out[g, s:s + n])
        return out

    def dx_seg():
        for g, e, s, n in segs:
            x, gy = xs[g, s:s + n], c["dy"][g, s:s + n]
            a, gt = x @ wi[e], x @ wg[e]
            dh = gy @ wo[e].T
            sa = F.silu(a)
            da = torch.ops.aten.silu_backward(dh * gt, a)
            dg = dh * sa
            torch.matmul(da, wi[e].T, out=out[g, s:s + n])
            out[g, s:s + n].addmm_(dg, wg[e].T)
        return out

    per_expert = (("per-expert torch.matmul", fwd_seg, 5 * len(segs))
                  if kind == "fwd" else
                  ("per-expert torch.matmul", dx_seg, 9 * len(segs)))
    if not hasattr(torch, "_grouped_mm"):
        print(f"{tag}: torch._grouped_mm is missing", flush=True)
        return [per_expert]
    offs = row_off[:, 1:].to(torch.int32).contiguous()
    ends = [int(e) for e in row_off[:, -1]]
    mm = torch._grouped_mm

    def fwd():
        ys = []
        for g in range(G):
            x, o = xs[g, :ends[g]], offs[g]
            h = F.silu(mm(x, wi, offs=o)) * mm(x, wg, offs=o)
            ys.append(mm(h, wo, offs=o))
        return ys

    def dx():
        dxs = []
        for g in range(G):
            x, gy, o = xs[g, :ends[g]], c["dy"][g, :ends[g]], offs[g]
            a, gt = mm(x, wi, offs=o), mm(x, wg, offs=o)
            dh = mm(gy, wo.transpose(1, 2), offs=o)
            sa = F.silu(a)
            da = torch.ops.aten.silu_backward(dh * gt, a)
            dg = dh * sa
            dxs.append(mm(da, wi.transpose(1, 2), offs=o)
                       + mm(dg, wg.transpose(1, 2), offs=o))
        return dxs

    call, calls = (fwd, 5 * G) if kind == "fwd" else (dx, 10 * G)
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError) as err:
        print(f"{tag}: torch._grouped_mm refused {xs.dtype}: "
              f"{str(err).splitlines()[0]}", flush=True)
        return [per_expert]
    return [("torch._grouped_mm", call, calls), per_expert]


def _record(kname, src, replaces, max_err, ms, plain_ms, nbytes, flops,
            lib_ms, dtype="float32"):
    """One kernel's JSON record; its bound is the larger of the bytes
    over the memory rate and the FLOPs over the dtype's peak: for a
    float32 call of a kernel in TF32X3_KERNELS, 3 x FLOPs over the TF32
    tensor-core rate, with the CUDA-core bound as ``cuda_core_bound_ms``."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    rec = {
        "name": kname, "route": "cuda", "source": src,
        "replaces": replaces, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }
    if kname in TF32X3_KERNELS and dtype == "float32":
        t_tc = 3 * flops / PEAK_TF32_S * 1e3
        rec.update(bound_ms=max(t_bytes, t_tc),
                   bound_by="bytes" if t_bytes >= t_tc else "operations",
                   cuda_core_bound_ms=max(t_bytes, t_ops))
    return rec


@contextlib.contextmanager
def forced_row_tile(bm):
    """The grouped wrappers launch with row tile ``bm``, whatever
    row_tile would pick from the shapes."""
    from repro_torch.kernels import grouped_mlp as gm

    pick = gm.row_tile
    gm.row_tile = lambda *_: bm
    try:
        yield
    finally:
        gm.row_tile = pick


def grouped_extras(tag, label, rec, call, tiles, chain, y_ref, flush):
    """Add the grouped kernels' own numbers to their record and print
    them: the kernel's ms at each of its row tiles (``call()`` launches
    it; the wrapper picks a tile from static shapes), and the library
    chain timed (time_library_ms): its label, calls and max |library -
    plain| against ``y_ref``."""
    times = {}
    for bm in tiles:
        with forced_row_tile(bm):
            times[bm] = time_ms(call, flush=flush)
    rec["ms_by_row_tile"] = times
    rec["library_chain"], _, rec["library_calls"] = chain or (None,) * 3
    print(f"[{tag}] {label}: ms by row tile: " + ", ".join(
        f"{bm}: {ms:.4f}" for bm, ms in times.items())
        + (f"; library: the {chain[0]} chain of {chain[2]} torch calls, "
           f"queued, max |library - plain| = "
           f"{library_err(chain[1](), y_ref):.3e}" if chain else ""),
        flush=True)


def library_err(ys, y_ref) -> float:
    """max |library - plain| over each group's rows that the library
    chain returns (grouped_library) against the plain version's (G, M,
    d)."""
    return max(float((y.float() - y_ref[g, :len(y)].float()).abs().max())
               for g, y in enumerate(ys))


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
        grouped_lib = grouped_library(g, "fwd", f"[kernel] grouped_mlp {name}")
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
             grouped_work(g, item), grouped_lib,
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
            # The paged walks split over blocks, against one block a
            # walk (splits=1) on the same inputs.
            unsplit_ms = (time_ms(lambda: kern(*args, splits=1),
                                  flush=flush)
                          if kname in ("decode_attention", "paged_prefill")
                          else None)
            # The grouped plain version reads the group sizes on the host.
            plain_ms = (time_synced_ms if kname == "grouped_mlp"
                        else time_ms)(lambda: plain(*args), flush=flush)
            lib_ms, chain = (time_library_ms(lib, flush=flush)
                             if lib is not None else (None, None))
            rec = _record(kname, src, replaces, max_err, ms, plain_ms, nbytes,
                          flops, lib_ms, dtype=name)
            if kname == "grouped_mlp":
                grouped_extras("kernel", f"grouped_mlp {name}", rec,
                               lambda: kern(*args), gm.ROW_TILES, chain,
                               y_ref, flush)
            if unsplit_ms is not None:
                rec["unsplit_ms"] = unsplit_ms
                print(f"[kernel] {kname} {name}: unsplit_ms="
                      f"{unsplit_ms:.4f}", flush=True)
            print(f"[kernel] {kname} {name}: max_abs_err={max_err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"{_bounds_text(rec)} ({nbytes} B, {flops} FLOP)",
                  flush=True)
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
    """Bytes and FLOPs of the gated dx / dW call over the valid rows
    (dead blocks read nothing; dx still writes their zero rows)."""
    G, M, d = c["xs"].shape
    E, _, f = c["wi"].shape
    counts = c["counts"]
    rows = int(counts.sum())
    live = int((counts > 0).any(0).sum())
    if kind == "dx":  # x, dy, 3 weights -> dx, da, dg, h
        nbytes = (2 * rows * d + live * 3 * d * f + G * M * d
                  + 3 * rows * f) * 4
        return nbytes, 10 * rows * d * f
    # dW: x, dy, da, dg, h -> dwi, dwg, dwo summed over the groups
    return (2 * rows * d + 3 * rows * f + 3 * E * d * f) * 4, \
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


def wkv_err(y, y_ref, rtol):
    """(max |y - y_ref|, its largest ratio to ``rtol * max |y_ref|``)
    over the WKV's output and, apart, its final state: see WKV_RTOL."""
    import torch

    errs = []
    for a, b in zip(y, y_ref):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            return float("inf"), float("inf")
        e = float((a - b).abs().max())
        errs.append((e, e / (rtol * max(float(b.abs().max()), 1e-30))))
    return max(e for e, _ in errs), max(r for _, r in errs)


# The flash kernels at the score sizes of granite's reference init (q
# and k of 10 N(0, 1) elements: |q|, |k| ~ 30-40), held at the card
# tests' float32 tolerance (tests/test_torch_kernels.py::
# test_flash_kernels_hold_large_scores): (B, S, H, Kh, causal).
LARGE_SCORE_CASES = ((2, 128, 16, 8, True), (2, 196, 12, 12, False))
LARGE_SCORE_TOL = (1e-5, 1e-5)


def check_flash_large_scores(device) -> None:
    """The flash forward, dq and dk/dv against their plain versions at
    large scores, where exp() turns a score's rounding into the output's
    and ds = p (dP - delta) cancels: prints each output's max |kernel -
    plain| and its ratio to LARGE_SCORE_TOL; fails above 1."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(5)
    for B, S, H, Kh, causal in LARGE_SCORE_CASES:
        q, k, v, do = (torch.randn(B, S, h, 64, generator=gen,
                                   device=device) for h in (H, Kh, Kh, H))
        q, k = 10 * q, 10 * k
        qo, kl = fa.scalar_i32(0, device), fa.scalar_i32(S, device)
        kw = dict(causal=causal, q_offset=qo, kv_len=kl)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, qo, kl, causal=causal)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, **kw)
        delta = fa.attention_delta(o_ref, do)
        args = (q, k, v, do, lse_ref, delta, qo, kl)
        got = (o, lse, fa.flash_attention_dq_cuda(*args, causal=causal),
               *fa.flash_attention_dkv_cuda(*args, causal=causal))
        want = (o_ref, lse_ref,
                *ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                             **kw))
        errs = {n: _max_err(g, w, *LARGE_SCORE_TOL) for n, g, w in zip(
            ("o", "lse", "dq", "dk", "dv"), got, want)}
        print(f"[train-kernel] flash at large scores ({B}, {S}, {H}/{Kh}, "
              f"64){' causal' if causal else ''}, max |q| "
              f"{float(q.abs().max()):.1f}, |k| {float(k.abs().max()):.1f}: "
              + ", ".join(f"{n} {e:.3e} ({r:.3f} of the limit)"
                          for n, (e, r) in errs.items()), flush=True)
        if any(r > 1.0 for _, r in errs.values()):
            fail(f"a flash kernel left the float32 tolerance at large "
                 f"scores: {errs}")


def check_train_kernels(cfg, device):
    """The six training kernels against their plain versions at the
    training shapes, float32, with times. Returns the JSON records of
    all but the grouped forward, and the grouped forward's numbers at
    these shapes (its record is the serve shape's)."""
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
    dx_lib = grouped_library(c, "dx", "[train-kernel] grouped_mlp_dx")
    dw_lib = grouped_library(dict(c, da=da, dg=dg, h=hh), "dw",
                             "[train-kernel] grouped_mlp_dw")

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
         grouped_bwd_work(c, "dx"), dx_lib,
         "src/repro_torch/kernels/csrc/grouped_mlp_bwd.cu",
         "src/repro/kernels/grouped_mlp.py:406"),
        ("grouped_mlp_dw",
         lambda: gm.grouped_mlp_dw_cuda(*dw_args),
         lambda: ref.grouped_mlp_dw_ref(*dw_args, block=gm.ROW_BLOCK),
         grouped_bwd_work(c, "dw"), dw_lib,
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
        lib_ms, chain = (time_library_ms(lib, flush=flush)
                         if lib is not None else (None, None))
        rec = _record(kname, src, replaces, max_err, ms, plain_ms, nbytes,
                      flops, lib_ms)
        if kname == "grouped_mlp_dx":
            grouped_extras("train-kernel", "grouped_mlp_dx float32", rec,
                           kern, gm.DX_ROW_TILES, chain, y_ref[0], flush)
        if kname == "grouped_mlp_dw":
            # One fixed order for every sum: a second call gives the same
            # bits.
            if not all(torch.equal(a, b) for a, b in zip(y, kern())):
                fail("grouped_mlp_dw: two calls gave different bits")
            rec["library_chain"], _, rec["library_calls"] = \
                chain or (None,) * 3
            if chain:
                print(f"[train-kernel] grouped_mlp_dw float32: library: the "
                      f"{chain[0]} chain of {chain[2]} torch calls, queued, "
                      f"max |library - plain| = "
                      f"{_max_err(chain[1](), y_ref, atol, rtol)[0]:.3e}; "
                      f"two calls bit-identical", flush=True)
        print(f"[train-kernel] {kname} float32: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
              f"{_bounds_text(rec)} ({nbytes} B, {flops} FLOP)", flush=True)
        records.append(rec)
    print_flash_pair("train-kernel", "causal (16, 512, 16/8, 64)",
                     {r["name"]: r for r in records})

    # The grouped forward at these shapes (the training step's calls).
    fargs = (c["xs"], c["wi"], c["wg"], c["wo"], c["counts"])
    y = gm.grouped_mlp_cuda(*fargs)
    torch.cuda.synchronize()
    y_ref = ref.grouped_mlp_ref(*fargs, block=gm.ROW_BLOCK)
    max_err, ratio = _max_err(y, y_ref, atol, rtol)
    print(f"[train-kernel] grouped_mlp float32: max |kernel - plain| = "
          f"{max_err:.3e}, max err / limit = {ratio:.3f} (atol {atol}, "
          f"rtol {rtol})", flush=True)
    if not ratio <= 1.0:
        fail(f"grouped_mlp at the training shapes: kernel and plain version "
             f"differ beyond atol {atol} + rtol {rtol} (ratio {ratio:.3g})")
    lib_ms, chain = time_library_ms(
        grouped_library(c, "fwd", "[train-kernel] grouped_mlp"), flush=flush)
    nbytes, flops = grouped_work(c, 4)
    rec = _record("grouped_mlp", "", "", max_err,
                  time_ms(lambda: gm.grouped_mlp_cuda(*fargs), flush=flush),
                  time_synced_ms(lambda: ref.grouped_mlp_ref(
                      *fargs, block=gm.ROW_BLOCK), flush=flush),
                  nbytes, flops, lib_ms)
    fwd = {k: v for k, v in rec.items() if k not in (
        "name", "route", "source", "replaces")}
    grouped_extras("train-kernel", "grouped_mlp float32", fwd,
                   lambda: gm.grouped_mlp_cuda(*fargs), gm.ROW_TILES, chain,
                   y_ref, flush)
    print(f"[train-kernel] grouped_mlp float32: ms={fwd['ms']:.4f} "
          f"plain_ms={fwd['plain_ms']:.4f} library_ms="
          f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
          f"{_bounds_text(rec)} ({nbytes} B, {flops} FLOP)", flush=True)
    return records, fwd


def print_flash_pair(tag, shape, by_name):
    """One line: the dq and dk/dv kernels' summed ms against SDPA's
    whole backward (dq, dk and dv in one call; each row timed it)."""
    dq, dkv = by_name["flash_attention_dq"], by_name["flash_attention_dkv"]
    pair = dq["ms"] + dkv["ms"]
    lib = (dq["library_ms"] + dkv["library_ms"]) / 2
    print(f"[{tag}] flash backward {shape}: dq + dk/dv = {pair:.4f} ms "
          f"against SDPA backward {lib:.4f} ms (the two rows' readings "
          f"{dq['library_ms']:.4f}, {dkv['library_ms']:.4f}): "
          f"{pair / lib:.3f}x", flush=True)


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
    # dW's order differs from the plain version's (tensor-core parts of
    # 32 rows against one f32 chain of 1,280): both held against a
    # float64 sum over two experts, the plain version's distance printed.
    sl = slice(0, 2)
    x64, dy64, da64, h64 = (t[:, sl].double() for t in (xe, dy, dxs[1],
                                                         dxs[3]))
    exact = (torch.einsum("gecd,gecf->edf", x64, da64),
             torch.einsum("gecf,gecd->efd", h64, dy64))
    del x64, dy64, da64, h64
    for tag, (dwi, _, dwo) in (
            ("kernel", em.expert_ffn_dw_cuda(xe, dy, *scratch)),
            ("plain", ref.expert_ffn_dw_ref(xe, dy, *scratch))):
        ratios = [_max_err(y[sl].double(), y64, atol, rtol)[1]
                  for y, y64 in zip((dwi, dwo), exact)]
        print(f"[vit-kernel] expert_mlp_dw {tag} against a float64 sum "
              f"(experts 0-1): max err / limit = {ratios[0]:.3f} (dwi), "
              f"{ratios[1]:.3f} (dwo)", flush=True)
        if tag == "kernel" and not max(ratios) <= 1.0:
            fail(f"expert_mlp_dw differs from a float64 sum beyond the "
                 f"float32 tolerance (ratio {max(ratios):.3g})")
    del exact, dwi, dwo
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
        at_vit[kname] = {k: v for k, v in rec.items() if k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "cuda_core_bound_ms", "library_ms")}
        print(f"[vit-kernel] {kname} non-causal {tuple(a['q'].shape)} float32: "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']:.4f} {_bounds_text(rec)} "
              f"({nbytes} B, {flops} FLOP)", flush=True)
    print_flash_pair("vit-kernel", f"non-causal {tuple(a['q'].shape)}",
                     at_vit)
    return records, at_vit


def _bounds_text(rec):
    cc = rec.get("cuda_core_bound_ms")
    return (f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})"
            + ("" if cc is None else f" cuda_core_bound_ms={cc:.4f}"))


def _shape_row(tag, kname, y, y_ref, kern, plain, lib, ncalls, work, flush,
               iters):
    """Hold one float32 kernel call against its plain version on the
    same inputs (TOL["float32"]), time the kernel, the plain version and
    the library yardstick, and print and return the numbers as one row
    of the kernel's JSON record (``at_shapes``)."""
    err, ratio = _max_err(y, y_ref, *TOL["float32"])
    print(f"[{tag}] {kname} float32: max |kernel - plain| = {err:.3e}, max "
          f"err / limit = {ratio:.3f}", flush=True)
    if not ratio <= 1.0:
        fail(f"{tag} {kname}: kernel and plain version differ beyond their "
             f"tolerance (ratio {ratio:.3g})")
    nbytes, flops = work
    ms, plain_ms, lib_ms = (time_ms(fn, flush=flush, iters=iters)
                            for fn in (kern, plain, lib))
    rec = _record(kname, "", "", err, ms, plain_ms, nbytes, flops, lib_ms)
    row = {k: v for k, v in rec.items() if k not in (
        "name", "route", "source", "replaces")}
    row["library_calls"] = ncalls
    print(f"[{tag}] {kname} float32: ms={row['ms']:.4f} plain_ms="
          f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"({ncalls} torch calls) {_bounds_text(rec)} ({nbytes} B, "
          f"{flops} FLOP)", flush=True)
    return kname, tag, row


def model_experts(params):
    """The first MoE layer's expert weights of a stack ({"wi", "wo"[,
    "wg"]} as (E, d, f) / (E, f, d) views, the repeat axis dropped)."""
    todo = [params]
    while todo:
        t = todo.pop(0)
        if isinstance(t, dict):
            if "experts" in t:
                return {k: w[0] for k, w in t["experts"].items()}
            todo.extend(t.values())
        elif isinstance(t, (list, tuple)):
            todo.extend(t)
    raise ValueError("no MoE layer in the parameters")


def expert_shape_row(tag, cfg, experts, tokens, device, *, seed, iters=20):
    """The expert-FFN kernel where a static engine's step runs it: the
    (G, E, cap, d) buffer of ``tokens`` tokens (dropless, every slot
    filled with a standard normal row) through the served model's own
    expert weights of one MoE layer, against the plain version and the
    float32 ``torch.matmul`` chain over each expert's rows."""
    import torch

    from repro_torch.core.routing import capacity
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import ref
    from repro_torch.models.layers import activation

    wi, wg, wo = experts["wi"], experts.get("wg"), experts["wo"]
    E, d, f = wi.shape
    g = min(cfg.moe.group_size, tokens)
    G, cap = -(-tokens // g), capacity(g, cfg.moe)
    gen = torch.Generator(device=device).manual_seed(seed)
    xe = torch.randn(G, E, cap, d, generator=gen, device=device)
    xt = xe.transpose(0, 1).reshape(E, G * cap, d).contiguous()
    act = activation(cfg.act)

    def lib():
        h = act(torch.matmul(xt, wi))
        if wg is not None:
            h = h * torch.matmul(xt, wg)
        torch.matmul(h, wo)

    kern = lambda: em.expert_ffn_cuda(xe, wi, wg, wo, act=cfg.act)  # noqa
    plain = lambda: ref.expert_ffn_ref(xe, wi, wg, wo, act=cfg.act)  # noqa
    y = kern()
    torch.cuda.synchronize()
    rows, nw = G * E * cap, 3 if wg is not None else 2
    work = ((2 * rows * d + nw * E * d * f) * 4,
            (2 * nw) * rows * d * f)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    out = _shape_row(tag, "expert_mlp", y, plain(), kern, plain, lib,
                     nw + 1 + (wg is not None), work, flush, iters)
    out[2]["shape"] = [G, E, cap, d, f]
    return out


def flash_shape_row(tag, cfg, B, S, device, *, seed):
    """The flash forward where the static prefill runs it: q (B, S, H,
    dh), k/v (B, S, Kh, dh) standard normal, causal from position 0,
    against the plain version and SDPA (GQA heads expanded, set-up)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    a = dict(q=rnd(B, S, H, dh), k=rnd(B, S, Kh, dh), v=rnd(B, S, Kh, dh))
    qo, kl = fa.scalar_i32(0, device), fa.scalar_i32(S, device)
    lq = a["q"].transpose(1, 2).contiguous()
    lk, lv = (a[n].transpose(1, 2).repeat_interleave(H // Kh, 1)
              .contiguous() for n in ("k", "v"))

    def sdpa():
        F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

    kern = lambda: fa.flash_attention_fwd_cuda(  # noqa: E731
        a["q"], a["k"], a["v"], qo, kl, causal=True)
    plain = lambda: ref.flash_attention_ref(  # noqa: E731
        a["q"], a["k"], a["v"], causal=True, q_offset=qo, kv_len=kl)
    y = kern()
    torch.cuda.synchronize()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    out = _shape_row(tag, "flash_attention", y, plain(), kern, plain, sdpa,
                     1, flash_work(a, "fwd"), flush, 20)
    out[2]["shape"] = [B, S, H, Kh, dh]
    return out


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


def condition_rwkv(params, cfg) -> None:
    """Condition a random rwkv6 model, in place, so that two float32
    implementations can be held token for token over 32 layers.

    ``init_params`` copies the reference's init, and two of its rules
    make a deep random model chaotic. (1) ``w0`` rises with the channel
    index, so each head holds a contiguous band of decays and the last
    heads decay within a step (w = exp(-exp(w0)) down to 1e-9 at w0 = 3):
    there o_t ~ (r_t . k_{t-1}) v_{t-1}, and the per-head group norm turns
    that into +-v_{t-1}/|v_{t-1}|, whose sign flips wherever a rounding
    moves r_t . k_{t-1} across 0. (2) The fan-in rule takes the head
    count as the fan-in of ``wr/wk/wv/wg (d, H, K)`` (ROADMAP queue 3).
    Interleaving ``w0`` (every head then spans the whole spread, the
    same set of decays per layer) and rescaling those four projections to
    fan-in d tames both; the rescaling alone does not
    (``tests/test_torch_rwkv.py::
    test_reference_init_is_chaotic_until_conditioned``)."""
    H, K, d = cfg.n_heads, cfg.ssm.head_size, cfg.d_model
    for seg in params["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            reps = m["w0"].shape[0]
            m["w0"].copy_(m["w0"].reshape(reps, H, K).transpose(1, 2)
                          .reshape(reps, d))
            for n in ("wr", "wk", "wv", "wg"):
                m[n] *= (H / d) ** 0.5


@contextlib.contextmanager
def wkv_sequential():
    """Inside the block the plain path's WKV (``ops.rwkv6`` "eager") is
    the sequential oracle instead of the chunked version: the recurrence
    itself in float32, without the chunked version's log-space error
    (WKV_RTOL). A second plain path to read the kernels' against."""
    from repro_torch.kernels import ref

    chunked = ref.rwkv6_chunked_ref
    ref.rwkv6_chunked_ref = lambda r, k, v, w, u, *, initial_state=None, \
        chunk=64: ref.rwkv6_ref(r, k, v, w, u, initial_state=initial_state)
    try:
        yield
    finally:
        ref.rwkv6_chunked_ref = chunked


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
    of :data:`TOL` (the WKV kernel: :data:`WKV_RTOL` against its chunked
    plain version)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6 as wkv

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
        (wkv, "rwkv6_cuda", "rwkv6",
         lambda r, k, v, w, u, s0=None: ref.rwkv6_chunked_ref(
             r, k, v, w, u, initial_state=s0)),
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
            if name == "rwkv6":  # against the chunked plain version
                err, ratio = wkv_err(y_cmp, ref_cmp, WKV_RTOL["chunked"])
            else:
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


def step_launches(cfg, kernels, moe: bool) -> dict:
    """The launches one training step must make: each attention kernel
    once a layer, and in a MoE step each of the path's expert kernels
    once a MoE layer."""
    from repro_torch.models import stack as stk

    n_moe = sum(d.ffn == "moe" for d in stk.layer_descs(cfg))
    want = {k: cfg.n_layers for k in FLASH_KERNELS}
    want.update({k: n_moe if moe else 0 for k in kernels
                 if k not in FLASH_KERNELS})
    return want


def check_step(name, tag, m, per, want) -> None:
    """A training step's checks: finite metrics, not skipped by the
    non-finite guard, and exactly the launches ``want`` names."""
    if not all(map(lambda x: x == x and abs(x) != float("inf"),
                   m.values())):
        fail(f"{name} {tag} step: non-finite metrics {m}")
    if m["skipped"]:
        fail(f"{name} {tag} step was skipped by the non-finite guard")
    if any(per.get(k, 0) != v for k, v in want.items()):
        fail(f"{name} {tag} step launched {per}, expected {want}")


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
        check_step(name, tag, m, per,
                   step_launches(cfg, kernels, tag == "moe"))
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


# ---------------------------------------------------------------------------
# rwkv6: the WKV kernel and the static engine
# ---------------------------------------------------------------------------


def wkv_case(cfg, T, device, gen, *, state: bool):
    """WKV inputs at the full width (B 8, H 64, K = V = 64): r, k, v
    standard normal, u ~ 0.3 N(0, 1), and the decay in its real range,
    w = exp(-exp(w0 + 0.5 N(0, 1))) over the config's w0 spread (-5 at
    the first channel to 3 at the last, ``time_mix_init``'s rule), which
    puts some w near 1 and some below 1e-9; s0 standard normal or
    None."""
    import torch

    B, H, K = RWKV_SERVE["max_batch"], cfg.n_heads, cfg.ssm.head_size
    d = H * K
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    w0 = -5.0 + 8.0 * (torch.arange(d, device=device) / (d - 1)) ** 0.7
    w = torch.exp(-torch.exp(w0 + 0.5 * rnd(B, T, d))).reshape(B, T, H, K)
    return dict(r=rnd(B, T, H, K), k=rnd(B, T, H, K), v=rnd(B, T, H, K),
                w=w, u=0.3 * rnd(H, K), s0=rnd(B, H, K, K) if state else None)


def wkv_work(c, itemsize):
    """Bytes (r, k, v in the inputs' dtype, w in f32, each read once; s0
    read if given; o written in v's dtype and the f32 state written once)
    and FLOPs (about 4 K V a (b, t, h): r^T S and the state update) of
    one WKV call on these inputs."""
    B, T, H, K = c["r"].shape
    V = c["v"].shape[-1]
    state = B * H * K * V * 4
    nbytes = (B * T * H * ((2 * K + 2 * V) * itemsize + 4 * K)
              + state * (2 if c["s0"] is not None else 1) + H * K * 4)
    return nbytes, 4 * B * T * H * K * V


def check_rwkv_kernel(cfg, device):
    """The WKV kernel against the chunked plain version and the sequential
    oracle at the serve shapes: the prefill (8, 512, 64, 64, 64) from a
    zero state and a decode step (8, 1, 64, 64, 64) from a random one, in
    float32, and the prefill with bfloat16 r, k, v (each call twice, same
    bits required); times the kernel and the chunked plain version on the
    device's clock. No single PyTorch call computes WKV-6, so it has no
    library time. Returns its JSON record (the prefill, the decode shape
    under ``at_decode_shape``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6 as wkv

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    rec = None
    for tag, T, state, dtype in (("prefill", RWKV_PLEN[1], False,
                                  torch.float32),
                                 ("decode", 1, True, torch.float32),
                                 ("prefill", RWKV_PLEN[1], False,
                                  torch.bfloat16)):
        c = wkv_case(cfg, T, device, gen, state=state)
        for n in ("r", "k", "v"):
            c[n] = c[n].to(dtype)
        args = (c["r"], c["k"], c["v"], c["w"], c["u"], c["s0"])
        y = wkv.rwkv6_cuda(*args)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[1]
        if not all(torch.equal(a, b) for a, b in zip(y, wkv.rwkv6_cuda(
                *args))):
            fail(f"rwkv6 {tag} {name}: two calls gave different bits")
        errs = {}
        for plain, fn in (("oracle", ref.rwkv6_ref),
                          ("chunked", ref.rwkv6_chunked_ref)):
            rtol = WKV_RTOL["bfloat16" if dtype == torch.bfloat16
                            else plain]
            err, ratio = wkv_err(y, fn(*args[:5], initial_state=args[5]),
                                 rtol)
            errs[plain] = err
            print(f"[rwkv-kernel] {tag} {tuple(c['v'].shape)} {name} vs "
                  f"{plain}: max |kernel - plain| = {err:.3e}, max err / "
                  f"limit = {ratio:.3f} (rtol {rtol} x max |plain|)",
                  flush=True)
            if not ratio <= 1.0:
                fail(f"rwkv6 {tag} {name}: kernel and {plain} version "
                     f"differ beyond their tolerance (ratio {ratio:.3g})")
        if dtype != torch.float32:
            continue
        nbytes, flops = wkv_work(c, 4)
        ms = time_ms(lambda: wkv.rwkv6_cuda(*args), flush=flush)
        # The chunked version launches ~25 kernels a chunk: 20 queued
        # calls would overrun the launch queue, so it is timed per call.
        plain_ms = time_synced_ms(lambda: ref.rwkv6_chunked_ref(
            *args[:5], initial_state=args[5]), flush=flush)
        r = _record("rwkv6", "src/repro_torch/kernels/csrc/rwkv6.cu",
                    "src/repro/kernels/rwkv6_kernel.py:31", errs["chunked"],
                    ms, plain_ms, nbytes, flops, None)
        r["max_abs_err_oracle"] = errs["oracle"]
        print(f"[rwkv-kernel] {tag} float32: ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}"
              f": {nbytes} B, {flops} FLOP) = {r['bound_ms'] / ms:.3f} of "
              f"the bound", flush=True)
        if rec is None:
            rec = r
        else:
            rec["at_decode_shape"] = {k: r[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    return rec


def static_prompts(cfg, n, plen, seed):
    """``n`` prompts from the seed: token ids in 1..vocab-1, lengths in
    ``plen`` (an inclusive (lo, hi) range) or exactly ``plen``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = ([int(x) for x in rng.integers(plen[0], plen[1] + 1, n)]
            if isinstance(plen, tuple) else [plen] * n)
    return [rng.integers(1, cfg.vocab_size, m).tolist() for m in lens]


def teacher_forced(paths, prompts, tokens):
    """Replay the static batch through each of ``paths`` ({name: (engine,
    context)}) in lockstep, every path fed the same ``tokens`` (a run's
    outputs): the prefill, then one decode step per generated token
    after the first. Returns (max |logits - the first path's logits| over
    every step, by path; the first path's top-2 logit gap of every row at
    every step, (steps, B))."""
    import torch

    from repro_torch.models import model_zoo as zoo

    B, plen = len(prompts), max(len(p) for p in prompts)
    steps = len(tokens[0]) - len(prompts[0])
    toks = torch.zeros(B, plen, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    caches = {}
    diffs = {name: 0.0 for name in paths}
    gaps = []
    with torch.no_grad():
        for s in range(steps):
            cur = torch.tensor([[o[len(p) + s - 1]] for o, p in
                                zip(tokens, prompts)]) if s else None
            first = None
            for name, (eng, ctx) in paths.items():
                with ctx():
                    if s == 0:
                        caches[name] = zoo.init_serve_cache(
                            eng.cfg, B, plen + steps, dtype=eng.cache_dtype,
                            device=eng.device)
                        caches[name], lg = zoo.prefill(
                            eng.params, {"tokens": toks.to(eng.device)},
                            caches[name], eng.cfg, ac=eng.ac)
                    else:
                        caches[name], lg = zoo.decode_step(
                            eng.params, cur.to(eng.device), caches[name],
                            plen + s - 1, eng.cfg, ac=eng.ac)
                lg = lg[:, -1]
                if first is None:
                    first = lg
                    top = torch.topk(lg, 2, dim=-1).values
                    gaps.append((top[:, 0] - top[:, 1]).cpu())
                else:
                    diffs[name] = max(diffs[name],
                                      float((lg - first).abs().max()))
    return diffs, torch.stack(gaps)


def first_static_divergence(prompts, a, b):
    """(row, token index) where the outputs ``a`` and ``b`` first part,
    or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        n = next((j for j in range(len(prompts[i]), len(x)) if x[j] != y[j]),
                 None)
        if n is not None:
            return i, n
    return None


def serve_static(tag, params, cfg, device, prompts, max_new, runs, expect):
    """Serve ``prompts`` through ``ServeEngine(paged=False)``, through the
    kernels and through the plain versions, ``runs`` times each,
    interleaved (kernels, plain, kernels, plain, ...), after one warm-up
    of each. Greedy outputs must be token-identical (a divergence only at
    a top-2 logit gap below TIE_GAP, RWKV_TIE_GAP for an rwkv stack, and
    then only if the paths' logits, fed the same tokens, part by no more
    than that), every kernel run must launch exactly ``expect``
    ({kernel: count}) and the plain runs none. For an rwkv stack the
    replay also reads the plain path with the WKV's sequential oracle.
    Prints prefill and decode tokens/s per run and the peak memory;
    returns (the kernel runs' launches, the kernels' engine)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import ServeConfig, ServeEngine

    sc = ServeConfig(**RWKV_SERVE)
    eng_k = ServeEngine(params, cfg, sc, device=device)
    eng_p = ServeEngine(params, cfg, sc, device=device, ac=zoo.ApplyCfg(
        moe_impl="eager", attn_impl="eager", mixer_impl="eager"))
    rwkv = cfg.attn_pattern == "none"
    for eng in (eng_k, eng_p):  # warm-up: cuBLAS, the allocator
        eng.generate([prompts[0][:16]], max_new=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    B, plen = len(prompts), max(len(p) for p in prompts)
    outs, launches = {}, None
    for key, eng in [("kernels", eng_k), ("plain", eng_p)] * runs:
        ops.reset_launch_counts()
        got = eng.generate(prompts, max_new=max_new)
        ran = {k: v for k, v in ops.launch_counts().items() if v}
        st = eng.last_stats
        pre = B * plen / st["prefill_s"]
        dec = B * st["decode_steps"] / st["decode_s"]
        print(f"[{tag}] {key}: prefill {B} x {plen} tokens in "
              f"{st['prefill_s']:.3f} s = {pre:.1f} tokens/s; "
              f"{st['decode_steps']} decode steps in {st['decode_s']:.3f} s "
              f"= {dec:.1f} tokens/s "
              f"({st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} ms "
              f"a step); launches={ran}", flush=True)
        if key == "kernels" and ran != expect:
            fail(f"{tag}: the kernels' run launched {ran}, expected {expect}")
        if key == "plain" and ran:
            fail(f"{tag}: a plain run launched kernels: {ran}")
        if key in outs and got != outs[key]:
            fail(f"{tag}: a repeated {key} run changed its outputs")
        outs[key] = got
        launches = ran if key == "kernels" else launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] peak memory over the runs {peak / 2 ** 30:.2f} GiB "
          f"({peak} B)", flush=True)
    # Both paths fed the kernels' tokens: how far their logits part, and
    # the kernels' top-2 gaps where the outputs part.
    paths = {"kernels": (eng_k, contextlib.nullcontext),
             "plain": (eng_p, contextlib.nullcontext)}
    if rwkv:
        paths["plain, sequential WKV"] = (eng_p, wkv_sequential)
    diffs, gaps = teacher_forced(paths, prompts, outs["kernels"])
    for key in list(paths)[1:]:
        print(f"[{tag}] fed the kernels' tokens, the {key} path's logits "
              f"part from the kernels' by at most {diffs[key]:.3e} over "
              f"{gaps.shape[0]} steps", flush=True)
    tie = RWKV_TIE_GAP if rwkv else TIE_GAP
    if diffs["plain"] > tie:
        fail(f"{tag}: fed the same tokens, the kernels' and the plain "
             f"path's logits part by {diffs['plain']:.3e} > {tie}")
    div = first_static_divergence(prompts, outs["kernels"], outs["plain"])
    if div is None:
        print(f"[{tag}] greedy outputs token-identical between the kernels "
              f"and the plain versions ({B} rows x {max_new} tokens)",
              flush=True)
    else:
        i, n = div
        gap = float(gaps[n - len(prompts[i]), i])
        print(f"[{tag}] kernels vs plain: row {i} diverges at token {n} "
              f"(generated token {n - len(prompts[i])}): the kernels' top-2 "
              f"logit gap there {gap:.3e}", flush=True)
        if gap >= tie:
            fail(f"{tag}: greedy divergence at row {i} token {n} with top-2 "
                 f"gap {gap:.3e} >= {tie}")
    return launches, eng_k


def witness_static_step(tag, eng, prompts, expect):
    """One prefill and one decode step of the static batch through the
    kernels with every kernel call witnessed; also prints how far the
    prefill's logits through the kernels are from the plain path's."""
    import dataclasses as dc

    import torch

    from repro_torch.models import model_zoo as zoo

    B, plen = len(prompts), max(len(p) for p in prompts)
    toks = torch.zeros(B, plen, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.to(eng.device)
    paths = [("kernels", "cuda", witnessed_kernels),
             ("plain", "eager", contextlib.nullcontext)]
    logits = {}
    with torch.no_grad():
        for key, impl, ctx in paths:
            ac = dc.replace(eng.ac, moe_impl=impl, attn_impl=impl,
                            mixer_impl=impl)
            cache = zoo.init_serve_cache(eng.cfg, B, plen + 1,
                                         dtype=eng.cache_dtype,
                                         device=eng.device)
            with ctx() as wit:
                cache, lg = zoo.prefill(eng.params, {"tokens": toks}, cache,
                                        eng.cfg, ac=ac)
                nxt = torch.argmax(lg[:, -1], -1)[:, None]
                zoo.decode_step(eng.params, nxt, cache, plen, eng.cfg, ac=ac)
                torch.cuda.synchronize()
            logits[key] = lg
            del cache
            if key == "kernels":
                report_witness(wit, expect)
    print(f"[{tag}] prefill logits, kernels vs plain: max |diff| = "
          f"{float((logits['kernels'] - logits['plain']).abs().max()):.3e} "
          f"(max |logit| {float(logits['plain'].abs().max()):.3f})",
          flush=True)


def rwkv_dense(device):
    """R2: rwkv6-7b at full width and depth through the static engine."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    torch.cuda.synchronize()
    print(f"[rwkv] {cfg.name} full width and depth: "
          f"{count_params(params) / 1e9:.3f} B params (float32), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = static_prompts(cfg, RWKV_PROMPTS, RWKV_PLEN, seed=5)
    print(f"[rwkv] prompt lengths {[len(p) for p in prompts]}, "
          f"{RWKV_NEW} new tokens each", flush=True)
    # At the package's own init every WKV call must match its plain
    # version on its own inputs; the logits are printed, not held: at
    # this init the paths part (see condition_rwkv).
    print("[rwkv] one prefill and decode step at the reference init:",
          flush=True)
    witness_static_step("rwkv", ServeEngine(params, cfg, ServeConfig(
        **RWKV_SERVE), device=device), prompts, ("rwkv6",))
    condition_rwkv(params, cfg)
    launches, eng = serve_static(
        "rwkv", params, cfg, device, prompts, RWKV_NEW, RWKV_RUNS,
        {"rwkv6": cfg.n_layers * RWKV_NEW})
    witness_static_step("rwkv", eng, prompts, ("rwkv6",))
    return launches



def rwkv_moe(device):
    """R3: the dense parent of rwkv6_7b.upcycled() at full width and
    RWKV_MOE_LAYERS layers, upcycled (experts copied) into the channel-mix
    MoE and served dropless through the static engine; then the
    expert-FFN kernel timed at the prefill's and a decode step's buffer
    with one MoE layer's weights. Returns (the kernels' launches, the
    timing rows)."""
    import torch

    from repro_torch.configs.rwkv6_7b import upcycled
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import stack as stk
    from repro_torch.models.param import count_params

    up = upcycled()
    cfg = dataclasses.replace(
        up, n_layers=RWKV_MOE_LAYERS, moe=dataclasses.replace(
            up.moe, capacity_factor=float(up.moe.num_experts)))
    dense_cfg = cfg.dense_parent()
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    parent = zoo.init_params(gen, dense_cfg, device=device)
    condition_rwkv(parent, dense_cfg)  # its layers are copied as they are
    n_dense = count_params(parent)
    params = upcycle_params(parent, dense_cfg, cfg, gen)
    del parent
    torch.cuda.empty_cache()
    n_moe = sum(d.ffn == "moe" for d in stk.layer_descs(cfg))
    print(f"[rwkv-moe] {dense_cfg.name} at {cfg.n_layers} layers: "
          f"{n_dense / 1e9:.3f} B params -> upcycled ({cfg.moe.expert_init}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} in {n_moe} "
          f"layers, capacity factor {cfg.moe.capacity_factor}): "
          f"{count_params(params) / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = static_prompts(cfg, RWKV_PROMPTS, RWKV_MOE_PLEN, seed=6)
    launches, eng = serve_static(
        "rwkv-moe", params, cfg, device, prompts, RWKV_MOE_NEW, 1,
        {"rwkv6": cfg.n_layers * RWKV_MOE_NEW,
         "expert_mlp": n_moe * RWKV_MOE_NEW})
    witness_static_step("rwkv-moe", eng, prompts, ("rwkv6", "expert_mlp"))
    del eng
    torch.cuda.empty_cache()
    experts = model_experts(params)
    rows = [expert_shape_row("rwkv-moe", cfg, experts, RWKV_PROMPTS * n,
                             device, seed=8, iters=iters)
            for n, iters in ((RWKV_MOE_PLEN, 5), (1, 20))]
    return launches, [(k, f"rwkv_moe_{ph}", r)
                      for (k, _, r), ph in zip(rows, ("prefill", "decode"))]


def granite_static(params, cfg, device):
    """R4: granite (conditioned, dropless) through the static engine: the
    flash forward at prefill, the plain decode attention, the expert FFN
    under the gather dispatch; then the flash forward at the prefill's
    shape and the expert FFN at the prefill's and a decode step's buffer
    timed. Returns (the kernels' launches, the timing rows)."""
    prompts = static_prompts(cfg, GRANITE_STATIC["prompts"],
                             GRANITE_STATIC["plen"], seed=7)
    new = GRANITE_STATIC["max_new"]
    launches, eng = serve_static(
        "granite-static", params, cfg, device, prompts, new, 1,
        {"flash_attention": cfg.n_layers, "expert_mlp": cfg.n_layers * new})
    witness_static_step("granite-static", eng, prompts,
                        ("flash_attention", "expert_mlp"))
    del eng
    B, plen = len(prompts), max(len(p) for p in prompts)
    experts = model_experts(params)
    rows = [flash_shape_row("granite-static", cfg, B, plen, device, seed=9),
            expert_shape_row("granite-static", cfg, experts, B * plen,
                             device, seed=10),
            expert_shape_row("granite-static", cfg, experts, B, device,
                             seed=11)]
    return launches, [(k, f"granite_static_{ph}", r) for (k, _, r), ph in
                      zip(rows, ("prefill", "prefill", "decode"))]


# ---------------------------------------------------------------------------
# checkpoints and the fault-tolerant Trainer
# ---------------------------------------------------------------------------

# The checkpoint chain at full width and depth: granite's dense parent
# (0.164 B params) trained by the Trainer from the reference init, batch
# 8 x 512, checkpoints every 2 steps; the same run killed after step 3
# and resumed; restored and upcycled (--upcycle-from) into granite-moe
# (1.335 B), which trains 2 steps through the sorted dispatch; then
# restored and served. f32 checkpoints: ~0.66 GB dense (params and
# Adafactor state), ~5.4 GB MoE.
CKPT = dict(arch="granite-moe-1b-a400m", batch=8, seq=512, dense_steps=4,
            moe_steps=2, every=2, crash_after=3, peak_lr=0.01, warmup=100)
# Free disk the phase needs where it writes: two dense runs of two
# checkpoints each and the MoE's.
CKPT_DISK_GB = 12.0
CKPT_KERNELS = TRAIN_KERNELS + ("decode_attention", "paged_prefill")


@contextlib.contextmanager
def timed_checkpoint_io():
    """Inside the block every store write and read, and every host
    snapshot of the manager, is timed: yields a list of (op, path,
    bytes, seconds), op in "write" (on the caller's thread: a blocking
    save), "write-async" (the manager's writer thread), "read" and
    "snapshot" (the host copy ``save`` takes before it returns)."""
    import threading
    import torch

    from repro_torch.checkpoint import manager as mgr_mod
    from repro_torch.checkpoint import store
    from repro_torch.models.param import tree_leaves

    log = []
    save_tree, load_tree = store.save_tree, store.load_tree
    snapshot = mgr_mod.host_snapshot

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    def timed_save(path, tree, **kw):
        t0 = time.perf_counter()
        save_tree(path, tree, **kw)
        dt = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        op = ("write" if threading.current_thread() is
              threading.main_thread() else "write-async")
        log.append((op, path, size, dt))

    def timed_load(path, like, **kw):
        t0 = time.perf_counter()
        out = load_tree(path, like, **kw)
        torch.cuda.synchronize()
        log.append(("read", path, nbytes(out), time.perf_counter() - t0))
        return out

    def timed_snapshot(tree):
        t0 = time.perf_counter()
        out = snapshot(tree)
        log.append(("snapshot", "", nbytes(out), time.perf_counter() - t0))
        return out

    store.save_tree, store.load_tree = timed_save, timed_load
    mgr_mod.host_snapshot = timed_snapshot
    try:
        yield log
    finally:
        store.save_tree, store.load_tree = save_tree, load_tree
        mgr_mod.host_snapshot = snapshot


def report_io(log, root) -> None:
    for op, path, size, dt in log:
        where = str(Path(path).relative_to(root)) if path else "host"
        print(f"[ckpt] {op} {where}: {size} B in {dt:.3f} s = "
              f"{size / dt / 1e9:.2f} GB/s", flush=True)


def leaf_diff(a, b):
    """(bit-identical?, max relative difference, its leaf path) of two
    trees of tensors, leaf by leaf in the store's path order."""
    import torch

    from repro_torch.checkpoint.store import _flatten

    worst, where = 0.0, None
    same = True
    for (p, x), (q, y) in zip(_flatten(a), _flatten(b)):
        if p != q:
            fail(f"trees differ in structure at {p} / {q}")
        y = y.to(x.device)
        if x.dtype != y.dtype or not torch.equal(x, y):
            same = False
            d = (x.double() - y.double()).abs().max() / \
                y.double().abs().max().clamp(min=1e-30)
            if float(d) > worst:
                worst, where = float(d), p
    return same, worst, where


def checkpoint_chain(device):
    """Phase 12: the paper's chain through the port's checkpoints, the
    Trainer and both launchers, at full width and depth, on the card.
    Returns the launches of the run."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.configs import get_config
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params
    from repro_torch.obs import Sink, Tracker, deterministic_rows
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.training import (
        TrainChaosConfig,
        TrainConfig,
        Trainer,
        run_chaotic,
    )

    class StepSink(Sink):
        """Keeps each "train" row with the kernel launches made since
        the row before it (a row follows its step's one host sync)."""

        def __init__(self):
            self.rows, self.per = [], []
            self._last = ops.launch_counts()

        def write(self, row):
            self.rows.append(row)
            if row["kind"] == "train":
                now = ops.launch_counts()
                self.per.append((row, {k: v - self._last[k]
                                       for k, v in now.items()}))
                self._last = now

    t_phase = time.perf_counter()
    full = get_config(CKPT["arch"])
    dense_cfg = full.dense_parent()
    serve_cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=float(full.moe.num_experts)))
    opt = adafactor(inverse_sqrt(peak=CKPT["peak_lr"],
                                 warmup_steps=CKPT["warmup"]))
    task = ClusteredBigramTask(vocab_size=min(full.vocab_size, TASK_VOCAB))
    tc = TrainConfig(checkpoint_every=CKPT["every"])

    def trainer(cfg, d, sink, dispatch="gather", **kw):
        it = make_iterator(cfg, global_batch=CKPT["batch"],
                           seq_len=CKPT["seq"], task=task)
        return Trainer(cfg, opt, it, d, ac=zoo.ApplyCfg(
            dispatch=dispatch, moe_impl="cuda", attn_impl="cuda"), tc=tc,
            tracker=Tracker((sink,)), device=device,
            log_fn=lambda s: print(f"[ckpt] {s}", flush=True), **kw)

    def check_rows(tag, sink, cfg, moe):
        want = step_launches(cfg, TRAIN_KERNELS, moe)
        for row, per in sink.per:
            m = {k: row[k] for k in ("loss", "ce", "grad_norm", "skipped")}
            print(f"[ckpt] {tag} step {row['t']}: loss={m['loss']!r} "
                  f"grad_norm={m['grad_norm']!r} ms={row['step_ms']:.1f} "
                  f"launches={ {k: v for k, v in per.items() if v} }",
                  flush=True)
            check_step(cfg.name, tag, m, per, want)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    root = Path(tmp.name)
    try:
        free = shutil.disk_usage(root).free / 1e9
        print(f"[ckpt] writing under {root}: {free:.1f} GB free "
              f"(needs {CKPT_DISK_GB})", flush=True)
        if free < CKPT_DISK_GB:
            fail(f"{free:.1f} GB free under {root}: the checkpoint phase "
                 f"needs {CKPT_DISK_GB} GB")
        dirs = {k: str(root / k) for k in ("dense", "resume", "moe",
                                           "launch")}
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with timed_checkpoint_io() as io:
            # 1. The dense parent through the Trainer, from the
            # reference init (no conditioning), as launch/train.py runs.
            straight = StepSink()
            out_a = trainer(dense_cfg, dirs["dense"], straight).run(
                CKPT["dense_steps"])
            n = count_params(out_a["state"]["params"])
            steps = CheckpointManager(dirs["dense"]).all_steps()
            print(f"[ckpt] {dense_cfg.name}: {n / 1e9:.3f} B params, "
                  f"checkpoints {steps}", flush=True)
            check_rows("dense", straight, dense_cfg, False)
            if len(straight.per) != CKPT["dense_steps"]:
                fail(f"the dense run took {len(straight.per)} steps")

            # 2. Killed after step 3 (before any save of it), resumed
            # from step 2: the restored state is the one saved.
            saved, resumed = {}, {}
            crashed = StepSink()

            def make(chaos, st):
                tr = trainer(dense_cfg, dirs["resume"], crashed,
                             chaos=chaos, chaos_state=st)
                mgr = tr.manager
                save, restore = mgr.save, mgr.restore_latest

                def keep_save(step, tree, **kw):
                    if step == CKPT["every"]:
                        saved["state"] = host_snapshot(tree)
                    return save(step, tree, **kw)

                def keep_restore(like, **kw):
                    out = restore(like, **kw)
                    if out[0] is not None:  # trained in place after
                        resumed["state"] = host_snapshot(out[0])
                        resumed["step"] = out[1]
                    return out

                mgr.save, mgr.restore_latest = keep_save, keep_restore
                return tr

            out_b, st = run_chaotic(
                make, CKPT["dense_steps"],
                TrainChaosConfig(crash_steps=(CKPT["crash_after"],)))
            if st.crashes != 1 or resumed.get("step") != CKPT["every"]:
                fail(f"the kill-and-resume run did not resume from step "
                     f"{CKPT['every']}: {st.summary()}, resumed {resumed}")
            check_rows("resume", crashed, dense_cfg, False)
            same, worst, where = leaf_diff(saved["state"], resumed["state"])
            print(f"[ckpt] resumed state vs the state saved at step "
                  f"{CKPT['every']}: bit-identical={same}", flush=True)
            if not same:
                fail(f"the state restored at resume differs from the state "
                     f"saved: {worst:.3e} at {where}")
            del saved, resumed
            last = {r["t"]: r for r in deterministic_rows(crashed.rows)
                    if r["kind"] == "train"}
            ref = {r["t"]: r for r in deterministic_rows(straight.rows)
                   if r["kind"] == "train"}
            for t in range(CKPT["every"] + 1, CKPT["dense_steps"] + 1):
                d = abs(last[t]["loss"] - ref[t]["loss"]) / abs(ref[t]["loss"])
                print(f"[ckpt] replayed step {t}: loss {last[t]['loss']!r} "
                      f"vs straight {ref[t]['loss']!r}, rel diff {d:.3e} "
                      f"(limit {LOSS_RTOL})", flush=True)
                if not d <= LOSS_RTOL:
                    fail(f"the replayed step {t} left LOSS_RTOL")
            same, worst, where = leaf_diff(out_b["state"], out_a["state"])
            print(f"[ckpt] final state after kill-and-resume vs the straight "
                  f"run: bit-identical={same}"
                  + ("" if same else f", max rel diff {worst:.3e} at {where}"),
                  flush=True)
            del out_b

            # 3. --upcycle-from: the full train-state checkpoint's params,
            # upcycled with a generator seeded 7, trained 2 steps.
            t0 = time.perf_counter()
            dense, sparse, step = ltrain.upcycle_from(dirs["dense"], full,
                                                      device=device)
            print(f"[ckpt] upcycle_from step {step}: "
                  f"{count_params(sparse) / 1e9:.3f} B params in "
                  f"{_sync_ms(t0) / 1e3:.2f} s", flush=True)
            same, worst, where = leaf_diff(dense, out_a["state"]["params"])
            print(f"[ckpt] restored dense params vs the Trainer's final "
                  f"params: bit-identical={same}", flush=True)
            if step != CKPT["dense_steps"] or not same:
                fail(f"--upcycle-from restored step {step}, params "
                     f"bit-identical={same} ({worst:.3e} at {where})")
            del dense, out_a
            moe_sink = StepSink()
            out_m = trainer(full, dirs["moe"], moe_sink,
                            dispatch="sorted").run(CKPT["moe_steps"],
                                                   init_params=sparse)
            del sparse
            check_rows("moe", moe_sink, full, True)

            # 4. Served from the checkpoint, and from the Trainer's
            # in-memory params: token-identical, no block leaked. Both
            # trees are conditioned alike first (condition_attention, as
            # phases 4-5 serve): the sorted dispatch's combine sums with
            # atomics (scatter_add, core/moe.py), so two runs of one
            # model differ in the last bits, and at the reference init's
            # attention scale such bits flip greedy tokens at top-2 gaps
            # far above TIE_GAP.
            params, step = lserve.load_params(
                serve_cfg, device=device,
                manager=CheckpointManager(dirs["moe"]))
            same, worst, where = leaf_diff(params, out_m["state"]["params"])
            print(f"[ckpt] serve restore of step {step} vs the Trainer's "
                  f"in-memory params: bit-identical={same}", flush=True)
            if step != CKPT["moe_steps"] or not same:
                fail(f"serve restored step {step}, bit-identical={same}")
            for p in (params, out_m["state"]["params"]):
                condition_attention(p, serve_cfg)
            sc = ServeConfig(paged=True, **SERVE)
            outs = {}
            for tag, p in (("checkpoint", params),
                           ("in-memory", out_m["state"]["params"])):
                eng = ServeEngine(p, serve_cfg, sc, device=device)
                outs[tag], finished, n_gen, wall = serve_once(eng, serve_cfg)
                es = eng.last_stats
                print(f"[ckpt] served from the {tag} params: {n_gen} tokens "
                      f"in {wall:.3f} s, free_blocks_at_close="
                      f"{es['free_blocks_at_close']}", flush=True)
                if any(r["status"] != "completed" for r in finished.values()):
                    fail(f"not every request completed: {finished}")
            div = first_divergence(outs["checkpoint"], outs["in-memory"],
                                   serve_cfg)
            if div is None:
                print("[ckpt] served tokens identical between the restored "
                      "and the in-memory params", flush=True)
            else:
                rid, k = div
                gap = top2_gap(eng, outs["checkpoint"][rid][:k])
                print(f"[ckpt] rid {rid} diverges at token {k}: top-2 gap "
                      f"{gap:.3e}", flush=True)
                if gap >= TIE_GAP:
                    fail(f"restored serving diverged at rid {rid} token {k}")
            del params, out_m, eng
            torch.cuda.empty_cache()

            # 5. The entry points themselves, on the card by default.
            ltrain.main(["--arch", CKPT["arch"], "--upcycle-from",
                         dirs["dense"], "--ckpt-dir", dirs["launch"],
                         "--steps", "1", "--batch", str(CKPT["batch"]),
                         "--seq", str(CKPT["seq"]), "--dispatch", "sorted"])
            lserve.main(["--arch", CKPT["arch"], "--ckpt-dir", dirs["moe"],
                         "--paged", "--max-new", "4"])
        launches = ops.launch_counts()
        report_io(io, root)
        snaps = [dt for op, _, _, dt in io if op == "snapshot"]
        print(f"[ckpt] save_async host copies: "
              f"{', '.join(f'{x:.3f}' for x in snaps)} s", flush=True)
    finally:
        tmp.cleanup()
    print(f"[ckpt] launches: {launches}", flush=True)
    missing = [k for k in CKPT_KERNELS if not launches[k]]
    if missing:
        fail(f"kernels of the checkpoint chain never launched: {missing}")
    print(f"[ckpt] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


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
        for fn, regs, stores, loads in ptxas_usage(lib[1].build_log):
            print(f"[build] {lib[0]}: {fn}: {regs} registers, spill "
                  f"stores {stores} B, loads {loads} B")
        hmma = sass_hmma(lib[1])
        print(f"[build] {lib[0]}: HMMA in SASS: {sum(hmma.values())} ("
              + ", ".join(f"{n} {c}" for n, c in hmma.items()) + ")",
              flush=True)

    full = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=float(full.moe.num_experts)))
    vit = get_config(VIT_TRAIN["arch"])
    records = check_kernels(cfg, device)
    train_records, grouped_at_train = check_train_kernels(full, device)
    check_flash_large_scores(device)
    records += train_records
    vit_records, flash_at_vit = check_vit_kernels(vit, device)
    records += vit_records
    for rec in records:
        if rec["name"] in flash_at_vit:
            rec["at_vit_shapes"] = flash_at_vit[rec["name"]]
        if rec["name"] == "grouped_mlp":
            rec["at_train_shapes"] = grouped_at_train

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
    sc = ServeConfig(paged=True, **SERVE)
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

    # The static engine's attention path on the same (conditioned) model.
    del eng, eager
    static_launches, shape_rows = granite_static(params, cfg, device)
    del params
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
    torch.cuda.empty_cache()

    # rwkv6: the WKV kernel, then the static engine on the dense model at
    # full width and depth and on its upcycled channel-mix MoE.
    records.append(check_rwkv_kernel(get_config("rwkv6-7b"), device))
    rwkv_launches = rwkv_dense(device)
    torch.cuda.empty_cache()
    rwkv_moe_launches, rows = rwkv_moe(device)
    shape_rows += rows
    torch.cuda.empty_cache()

    # Checkpoints and the Trainer: dense checkpoint -> --upcycle-from ->
    # MoE checkpoint -> served, at full width and depth.
    ckpt_launches = checkpoint_chain(device)

    for rec in records:
        name = rec["name"]
        by_path = {"serve": launches.get(name, 0),
                   "granite_static": static_launches.get(name, 0),
                   "granite_train": train_launches.get(name, 0),
                   "vit_train": vit_launches.get(name, 0),
                   "rwkv_static": rwkv_launches.get(name, 0),
                   "rwkv_moe_static": rwkv_moe_launches.get(name, 0),
                   "checkpoint_chain": ckpt_launches.get(name, 0)}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        at = {tag: row for k, tag, row in shape_rows if k == name}
        if at:
            rec["at_shapes"] = at
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
