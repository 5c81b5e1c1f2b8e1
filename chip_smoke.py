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
   token-identical greedy outputs, times both paths (``SERVE_RUNS``
   runs each, interleaved), and compares one mixed step through both
   paths;
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
10. builds rwkv6-7b at full width and RWKV_LAYERS of its 32 layers
    (float32) and serves 8 prompts of 256..512 tokens, 64 new tokens
    each, through the static engine, through the kernels and the plain
    versions, interleaved: token-identical, exactly RWKV_LAYERS x 64 WKV
    launches a run, prefill and decode tokens/s and peak memory, one
    prefill and decode step witnessed;
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
    (the Trainer's in-memory params) and the 12 requests of 4 are served
    from it (conditioned as in 4); then ``launch.train.main --upcycle-from``
    and ``launch.serve.main --ckpt-dir --paged`` run once each. Every
    step's launches are counted; every save and restore is timed (bytes,
    seconds, GB/s);
13. trains the paper's language model, t5-base-upcycled, at full width
    and depth (T5_TRAIN): T5 1.1 Base's dense parent (0.248 B params)
    takes 2 Adafactor steps on the span-corruption stream (16 x 512
    encoder and 16 x 128 decoder tokens), is upcycled with its optimizer
    state into the 2.003 B MoE (Expert Choice in the encoder, top-2 in the
    decoder, GEGLU experts), which takes 4 steps through the flash and
    expert-FFN kernels (each kernel's launches a step checked: every
    self- and cross-attention and every MoE layer of both stacks once);
    holds and witnesses the first MoE step as in 6; decodes 8 requests
    greedily (512 encoder tokens, 32 new) through ``zoo.prefill`` and
    ``zoo.decode_step``, through the kernels and the plain versions,
    token-identical, launches checked, one prefill and decode step
    witnessed; then holds and times the flash kernels at the cross,
    decoder-self and decode-cross shapes and the expert kernels at the
    encoder's and the decoder's buffers;
14. trains whisper-base (full config, frame frontend) 2 steps at 8 x
    1500 frames through the flash kernels, the first held and witnessed,
    and decodes 4 requests of 1500 frames, 16 new tokens, the same way;
15. serves granite (phase 4's weights and SERVE settings, the 12
    requests) through the rest of the serving engine: (1)
    ``admission="prefill_on_join"`` (bucketed B = 1 prefills through the
    flash forward, batched decode steps) through the kernels,
    token-identical to phase 4's chunked outputs (held against the plain
    versions), launches and one compile per bucket checked, one
    prefill and one decode step witnessed, the flash forward timed at
    the buckets; (2) speculative decoding at spec_k 4 on a fresh upcycle
    of the dense parent at SPEC_LAYERS layers (copy init, normalised
    combine weights): the
    ``dense`` and ``top1`` drafts token-identical to vanilla serving
    (vanilla and dense over interleaved rounds, top1 in the first;
    acceptance, drafted tokens, target steps and tokens/s printed), the
    dense draft accepting >= 0.99 at temperature 0.8, one spec tick
    witnessed; (3) the over-subscribed trace of
    ``examples/serve_moe.py --overload`` with the robustness knobs and
    seeded chaos (2 seeds), every request terminal once, completed ones
    token-identical to an unchaosed run; (4) a fleet of 3 replica
    sessions with replica 0 killed mid-decode, every request completed
    once, token-identical to phase 4; each with its launches held
    against the steps it made; then times the paged prefill
    kernel at a verify step's lanes (8 x 5 rows);
16. runs the rest of training on granite at full width (phase 6's
    upcycled MoE and first batch, 16 x 512, sorted dispatch): first the
    six training kernels in bfloat16 at the training shapes against
    their plain versions, timed beside SDPA and the per-expert chain in
    bfloat16; then one step under each remat policy (none, full, dots,
    moe) from the same state, the loss and gradient norm held against
    ``none``'s and the launches exact (each forward kernel twice a
    layer under remat); ``ce_chunk=128`` against the whole logits;
    ``grad_accum=4`` through the kernels against the plain versions;
    a step each with bf16 and int8 gradient compression, the residual
    equal to (g + e) - c on two leaves; 4 steps in bfloat16 compute,
    the first held against the plain versions' bfloat16 loss; 2 AdamW
    steps under the vision schedule; each step's ms and peak memory
    printed (``[knobs]`` lines); then ``launch.train.main`` at 8 x 512
    with ``--remat moe --grad-accum 2 --compression int8``, straight and
    killed after step 2 and resumed (the restored state bit-identical
    to the saved one, the losses held); and rwkv6-7b's dense stack at
    full width and 4 layers, 2 steps of 4 x 256 through the Trainer
    with the launcher's ApplyCfg (no WKV launch);
17. runs the other families at full width: (a) jamba-1.5-large-398b's
    dense parent at 5 of 72 layers (mamba at 0-3, attention at 4; 5.93 B
    params, float32) takes one Adafactor step at 1 x 256 through the
    kernels, held against the plain versions and every flash call
    witnessed; (b) cast to bfloat16 and upcycled into the dropless MoE
    (16 experts top-2 in layers 1 and 3, 24.05 B params), it serves 4
    prompts of 128..256 tokens, 16 new, through the static engine in
    bfloat16, kernels against plain versions (JAMBA_TIE_GAP), launches
    exact, one prefill and decode step witnessed, the mamba layers'
    share of a decode step printed; (c) pixtral-12b at 4 of 40 layers
    takes 2 steps at 4 x 1,152 positions of its patch stream (1,024
    patches), the first held and witnessed, and decodes 4 requests of
    1,024 patches and 128 tokens, 16 new, kernels against plain
    versions; (d) qwen1.5-0.5b at full depth, upcycled into its 32-expert
    MoE, serves phase 4's requests through the paged chunked engine as
    phase 4 serves granite, launches exact, one mixed step witnessed;
    (e) qwen2.5-14b and yi-9b at 2 layers, grok-1-314b at 1 and
    tinyllama-1.1b at all 22 serve 4 prompts through the static engine,
    kernels against plain versions; then holds and times the flash
    kernels at (a)'s and (c)'s training shapes (head dim 128), the flash
    forward at the GQA groups 5, 6 and 8 of (e), the expert FFN in
    bfloat16 at (b)'s buffers with jamba's expert weights and the
    grouped forward at (d)'s mixed step;
18. multi-GPU (``[determinism]``, ``[multi]``, ``[multi rank R]`` and
    ``[pad]`` lines): (a) one granite MoE layer at full width gives
    identical bits over two calls, forward and backward, through the
    gather and sorted dispatches at the training shape and the serve
    step's rows (the combine adds in a fixed order); the sorted
    dispatch's data movement is timed against the atomic scatter/gather
    it replaced; phase 4's MoE serve at the reference init repeats token
    for token; (b) in a world of one NCCL rank ``launch.train.main`` with
    ``--ep a2a`` trains granite 2 steps at 8 x 512 to the same bits as
    ``--ep none`` (no mesh can host expert parallelism: the fallback);
    (c) granite upcycled from a conditioned dense init (12 of its 24
    layers since phase 23 joined the smoke: its time limit) takes 1
    expert-parallel step at a global 8 x 512 on 2 spawned ranks sharing
    the card (gloo, which stages CUDA tensors through host memory; mesh
    (data=1, model=2), 16 of the 32 experts a rank, routing groups of
    2,048), each rank's grouped and flash launches exact (12 a kernel a
    step) and its first step witnessed, held against the single-process
    sorted steps (run first, on the same weights and batches, in 2
    microbatches of the ranks' rows: the same shapes route alike): the
    loss and every leaf after the step at the
    reference's distributed-step tolerances, ``ep_overflow_frac`` 0;
    then a starved budget (factor 0.25, capacity factor 4.0) reports
    overflow with a finite loss; step times, peak memory and the
    all-to-alls' bytes and host seconds printed, the forward's bytes a
    rank a step equal to the dry run's model of them
    (``launch/dryrun.collective_bytes``); (d) qwen2.5-14b at 2 layers
    with its 40/8 query heads padded to 48/8 gives the unpadded logits
    through the flash kernels, witnessed;
19. a step's counted cost against the dry run, from a clean card
    (``[dryrun]`` and ``[mfu]`` lines): (a) the dry run of the train
    cell (granite, 16 x 512 on a mesh of one, sorted dispatch, float32,
    no remat; ``launch/dryrun.run_cell`` on the meta device) predicts
    the argument bytes, equal to the train state's and batch's summed
    leaf bytes on the card after ``init_train_state``; (b) one granite
    MoE train step through the kernels under ``launch/flops.step_cost``:
    its aten FLOPs and the flash kernels' FLOPs equal the dry run's, the
    grouped kernels' at most its capacity-full figures (the ratio
    printed), its launches exactly one a kernel a layer; (c) the same
    step from the same state with and without the count gives the same
    bits and launches; then the ViT's MoE step (104 images, gather)
    against the dry run of its meta twin the same way; each with ``mfu``
    and ``hardware_flops_util`` from synchronised steps timed outside
    the count; (d) the serve mixed step at phase 4's shapes: counted
    FLOPs, the kernels' bytes and their share of the HBM rate; the dry
    run's peak of (a)'s step (``launch/memory.py`` over rank 0's step on
    the meta device) held against the uncounted step's
    ``max_memory_allocated`` (a ``[memory]`` line; within
    ``MEMORY_RTOL`` or ``MEMORY_ATOL``);
20. trains under the rules engine's placement (``[mesh]`` and ``[mesh
    rank R]`` lines): 4 spawned ranks share the card through gloo on the
    mesh (data=2, model=2) — FSDP of ``embed`` over data, heads, kv
    heads, ``mlp`` and ``vocab`` tensor parallel over model, the MoE's
    experts resident over model (``sharding.train_layout``,
    ``sharding/comm.py``) — (a) granite upcycled at full width and 12
    of its 24 layers, sorted dispatch, ep "none", 2 Adafactor steps at
    a global 8 x 512 in groups of 2,048 (8 of 16 heads, 16 of 32
    experts a rank)
    and (b) the ViT upcycled at full width and depth, gather dispatch,
    Expert Choice, its 1,000-class head vocab-parallel, 2 steps at a
    global 16 images in groups of 784 tokens; each against one process
    running the same steps first in 2 microbatches of the data ranks'
    rows: each step's loss within 1e-4 and gradient norm within 1e-3
    relative, every leaf of the gathered state after the first step
    (optimizer slots included) at the reference's distributed-step
    tolerances; every rank's launches exact (a flash kernel once an
    attention layer, an expert kernel once a MoE layer, a step), its
    first step witnessed against the plain versions and repeated bit
    for bit; the payload bytes each rank counted through each kind of
    collective a step equal to the dry run's
    (``launch/dryrun.rules_collective_payloads``); each rank's peak
    memory and step ms printed, and (a)'s second step's own peak held
    against the dry run of rank 0's step under a fake process group
    (``launch/dryrun.rank_memory``, gloo's reduce-scatter; ``[memory]``
    lines, run in processes of their own beside the phases, as are the
    predictions of phases 21, 23 (c) and 24 (a)); the flash, grouped
    and expert-FFN forwards timed at the ranks' local shapes;
21. serves under the rules' placement on phase 20's ranks after their
    steps (``[mesh-serve]`` and ``[mesh-serve rank R]`` lines):
    granite at full width and 12 of 24 layers (phase 4's conditioned
    weights, dropless) through ``ServeEngine(ctx=)``
    (``sharding.serve_layout``: 8 of 16 query heads, 4 of 8 KV heads
    and 16 of 32 experts a rank), (a) the static engine over 4 prompts
    padded to 128, 16 new (a cache of 144 positions, ``cache_seq`` over
    model: a decode step's partial softmaxes combined across the model
    ranks; the rows over data),
    then the same prompts padded to 127 (143 positions, ``kv_heads``
    over model), (b) the paged chunked engine over phase 4's settings
    and requests (the pools a rank's KV heads, the rows replicated over
    data); one process serves the same first, while the ranks train.
    Every rank's tokens identical to the one process's (a top-2 gap
    below 1e-4 excepted), ``compile_count`` 1, every request completed,
    no block leaked, its pools within 1e-3 of its KV-head block of the
    one process's (at most ``MESH_POOL_ROWS`` rows outside, each traced
    to its request, position and the router's top-8 gaps there, on the
    rank and in the one process, and held to sit above a gap below
    ``TIE_GAP``), exact launches (flash forward and expert forward
    static, decode, paged prefill and grouped paged) at the local
    shapes, one static prefill and decode step and one mixed step
    witnessed, and the payload bytes of each kind of collective in them
    equal to the dry run's; each rank's tokens/s, step ms and peak
    memory printed beside the one process's; the one process's static
    prefill of the 4 x 128 prompts (a cache of 128) held against the dry
    run's step peak (``[memory]``), rank 0's prediction printed beside
    its serving peak; the decode and paged prefill kernels timed at a
    rank's 8/4 heads;
22. on the same ranks after phase 21 (``[mesh-ep]``, ``[mesh-rwkv]``
    and ``[mesh-ep rank R]`` lines): (a) granite upcycled at full width
    and 12 of its 24 layers trained expert-parallel under the rules'
    placement
    (sorted dispatch, ``moe.ep="a2a"``, ``ShardCtx.for_mesh``'s ctx:
    FSDP over data, TP over model, 16 of 32 experts a rank, each model peer
    sending its block of its data rank's routing groups through the
    all-to-all), 2 Adafactor steps at a global 8 x 512 in groups of
    1,024, against one process in 2 microbatches of the data ranks'
    rows: losses, grad norms, every leaf of the first step's state,
    ``ep_overflow_frac`` 0, launches exact, the grouped kernels at 16
    experts a rank, the first step witnessed, payloads equal to the dry
    run's; (b) rwkv6-7b at full width and 4 layers served through the
    static engine under ``ServeEngine(ctx=)`` (the time mix tensor
    parallel over heads, WKV at 32 heads a rank), 8 prompts of 128, 16
    new, token-identical to one process (near-ties judged by
    ``RWKV_TIE_GAP``), payloads equal to the dry run's; the one process
    runs both while the ranks run phases 20 and 21;
23. on the same ranks after phase 22 (``[mesh-t5]``, ``[mesh-whisper]``,
    ``[mesh-jamba]`` and ``[mesh-family rank R]`` lines): (a)
    t5-base-upcycled (2.003 B) trained under the rules' placement at
    full width and depth, 2 steps at a global 8 x 512 encoder and 8 x
    128 decoder tokens in groups of 512 (whole groups a data rank), held
    as phase 20 holds its cells, its six kernels witnessed at a rank's
    6 of 12 heads and 16 of 32 experts; (b) T5 and whisper-base decoded
    greedily through ``zoo.prefill``/``decode_step`` under a serving
    ctx (8 requests of 512 tokens, 32 new; 4 of 1,500 frames, 16 new),
    token-identical to one process on every rank (near-ties judged by
    ``TIE_GAP``), launches exact, payloads equal to the dry run's; (c)
    jamba-1.5-large at full width and 2 of 72 layers (12.18 B params,
    bfloat16) served through ``ServeEngine(ctx=)``, each rank placing
    its blocks one leaf at a time from the one process's weights read
    memory-mapped (the mamba mixers tensor parallel over ``d_in``, 8 of
    16 experts a rank), 4 prompts of 64-128 tokens, 8 new, tokens as one
    process's (near-ties judged by ``JAMBA_TIE_GAP``), the expert FFN
    witnessed at 8 experts, payloads equal to the dry run's, the mamba
    caches' blocks against one process's and each rank's peak printed;
    the dry run's peaks of the one process's prefill and of its weights'
    build printed beside its measured peak (``[memory]``);
24. (``[mesh-serve-tp]``, ``[mesh-serve-tp rank R]`` and ``[examples]``
    lines) (a) on the same ranks after phase 23, the reference's
    weight-stationary ``serve_tp`` profile: phase 21's model served by
    ``ServeEngine(ctx=make_ctx(mesh, cfg, PROFILES["serve_tp"]))``,
    static (phase 21's prompt sets) and paged (phase 4's requests), each
    rank holding its 16 of 32 experts' half of d_ff ((16, 1024, 256)
    blocks), no weight joined at build, tokens held against phase 21's
    one process (near-ties judged by ``TIE_GAP``), exact launches, one
    static prefill and decode step and one mixed step witnessed, the
    payload bytes of each kind of collective equal to the dry run's
    under the profile's rules, each rank's decode and mixed-step ms and
    peak printed beside phase 21's, with the dry run's static prefill
    peak of a rank under each profile (``[memory]``); the expert FFN and
    the grouped
    forward timed at a rank's f-256 shapes; (b) in this process while
    the ranks run phases 22-24, the four examples
    (``examples/torch_*.py``) at the cuts of :data:`EXAMPLES`: the
    quickstart and the initial-drop ablation, the 100M run preempted and
    resumed in a temporary directory, the MoE served static and paged
    through the kernels token-identical to the same example through the
    plain versions; each example's launches counted, its losses finite;
25. prints one JSON line of per-kernel numbers (all twelve kernels,
    with their bfloat16 numbers at the training shapes), then the
    result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's peaks (H100 SXM data sheet) live in
# repro_torch/launch/mesh.py; the kernels' work models and the bound
# rule of the per-kernel line (bytes over the HBM rate against FLOPs
# over the dtype's peak, 3 x FLOPs over the TF32 rate for the 3xTF32
# kernels in float32) in repro_torch/kernels/tiling.py.

# Serve settings (the cell): max_batch 8, 16-token blocks, two 64-token
# chunk lanes per mixed step, 512-token sequences.
SERVE = dict(max_batch=8, max_len=512, block_size=16, chunk_size=64,
             chunks_per_step=2)
N_REQUESTS, MAX_NEW, PREFIX = 12, 32, 128
# Timed serve runs per path (kernels, plain), interleaved on one card:
# host-clock readings vary from run to run. (3 until phase 21 joined the
# smoke: its time limit.)
SERVE_RUNS = 1

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
# rwkv6-7b at full width and RWKV_LAYERS of its 32 layers (all 32, 30
# GB, until phase 22 joined the smoke: its time limit; the WKV kernel
# is held and timed at the same shapes in phase 9's first part): 8
# prompts of 256..512 tokens from
# the seed, 64 new tokens each, served through the kernels and through
# the plain versions RWKV_RUNS times each, interleaved. The upcycled
# channel-mix MoE (rwkv6_7b.upcycled(): 32 experts, top-2, every other
# layer) at full width and RWKV_MOE_LAYERS layers (the full depth would
# be 263 GB in float32), dropless: 8 prompts of 128 tokens, 16 new.
RWKV_SERVE = dict(max_batch=8, max_len=576)
# (RWKV_RUNS 2 until phase 21 joined the smoke: its time limit.)
RWKV_PROMPTS, RWKV_PLEN, RWKV_NEW, RWKV_RUNS = 8, (256, 512), 64, 1
RWKV_LAYERS = 16
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

# Phase 15, the rest of the serving engine on granite (the SERVE
# settings, the 12 requests of make_requests). Speculative decoding: 4
# drafts a verify pass on a fresh upcycle whose MoE computes what its
# dense parent computes (copy init, normalised combine weights); greedy
# runs in SPEC_RUNS interleaved rounds of vanilla and dense (top1, whose
# draft steps run the experts, in the first round only); the dense
# draft at SPEC_TEMPERATURE must accept at least SPEC_MIN_ACCEPT (draft
# and target agree up to float32 rounding). The upcycle takes
# SPEC_LAYERS of granite's 24 layers at full width.
# (SPEC_RUNS 2 until phase 21 joined the smoke, SPEC_LAYERS 24 until
# phase 22: its time limit.)
SPEC_K, SPEC_RUNS, SPEC_TEMPERATURE, SPEC_MIN_ACCEPT = 4, 1, 0.8, 0.99
SPEC_LAYERS = 12
# The over-subscribed trace of examples/serve_moe.py --overload (10
# requests of 12 tokens, 8 new, two arrivals a tick, the last two at
# priority 1, 2 slots, a pool of one request's blocks and a spare) with
# the robustness knobs on and tests/test_serve_chaos.py's chaos, seeds
# CHAOS_SEEDS.
OVERLOAD = dict(n=10, plen=12, max_new=8, max_batch=2)
CHAOS_SEEDS = (0, 1)  # (0, 1, 2) until phase 21 joined the smoke
CHAOS = dict(evict_prob=0.15, hold_prob=0.2, hold_max_blocks=3,
             hold_ticks=2, burst_prob=0.1, burst_size=2, burst_plen=9,
             burst_max_new=3, storm_prob=0.05, storm_ttft=10)
ROBUST = dict(queue_limit=3, queue_policy="shed-newest", preempt=True,
              shed_occupancy=0.95, shed_stall_ticks=6,
              default_ttft_deadline=60, default_deadline=120,
              watchdog_ticks=16)
# The fleet: 3 replica sessions of one engine, replica 0 killed at this
# tick (request 0, admitted there at tick 0, is decoding by then).
FLEET_KILL_TICK = 8
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
    ``spin`` cycles, whether the device reached the first event before
    the host had queued the last call (then host gaps may lie inside the
    reading), and the host ms the queueing took."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        body()
    queued = (time.perf_counter() - t0) * 1e3
    b.record()
    late = a.query()
    b.synchronize()
    return a.elapsed_time(b), late, queued


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

    waited = 0
    for _ in range(4):
        both, late_a, queued = _queued_ms(pair, iters, spin)
        # The host waited out the spin twice running (the second 4x the
        # first): a call reads device values on the host, and no longer
        # spin would queue it.
        waited = waited + 1 if late_a and \
            queued >= spin / _spin_cycles_per_ms() else 0
        if waited == 2:
            break
        only, late_b, _ = _queued_ms(flush.zero_, iters, spin)
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


def grouped_case(cfg, dtype, device, gen, n_assign=None, rows=None):
    """A ragged buffer as the mixed step lays it out: 136 rows x top-8 =
    1088 assignments over 32 experts, skewed, with empty experts; or
    ``n_assign`` valid rows in a buffer laid out for ``rows`` (an
    expert-parallel rank's: the all-to-all's static rows)."""
    import torch

    from repro_torch.kernels.grouped_mlp import (
        ROW_BLOCK,
        ragged_buffer_rows,
        ragged_row_offsets,
    )

    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    if n_assign is None:
        n_assign = (SERVE["max_batch"] + SERVE["chunks_per_step"]
                    * SERVE["chunk_size"]) * cfg.moe.top_k
    w = torch.rand(E, generator=gen, device=device) ** 3
    w[[e for e in (5, 17) if e < E]] = 0.0
    counts = torch.floor(w / w.sum() * n_assign).to(torch.int32)
    counts[0] += n_assign - int(counts.sum())
    M = ragged_buffer_rows(rows or n_assign, E, ROW_BLOCK)
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


def host_work(work):
    """A work model's (bytes, FLOPs) as Python ints (read from the card
    where the model took device tensors)."""
    return tuple(int(x) for x in work)


def decode_case_work(a, itemsize):
    """``tiling.decode_work`` of the decode call on attention_case's
    inputs."""
    from repro_torch.kernels import tiling

    B, H, dh = a["q_dec"].shape
    bs, Kh = a["kp"].shape[1], a["kp"].shape[2]
    return host_work(tiling.decode_work(B, H, Kh, dh, bs, a["lengths"],
                                        itemsize=itemsize))


def prefill_case_work(c, itemsize):
    """``tiling.prefill_work`` of the prefill call on these inputs
    (attention_case's chunk lanes, or verify_lane_row's lanes)."""
    from repro_torch.kernels import tiling

    NC, C, H, dh = c["q_ch"].shape
    P, bs, Kh = c["kp"].shape[:3]
    return host_work(tiling.prefill_work(
        NC, C, H, Kh, dh, bs, P, c["ctab"], c["starts"], c["lens"],
        itemsize=itemsize))


def grouped_case_work(c, kind):
    """``tiling.grouped_work`` of a gated grouped call (``kind`` fwd, dx
    or dw) on a grouped case's buffer and group sizes."""
    from repro_torch.kernels import tiling

    G, M, d = c["xs"].shape
    E, _, f = c["wi"].shape
    return host_work(tiling.grouped_work(
        kind, G, M, d, f, E, *tiling.grouped_rows(c["counts"]), gated=True,
        itemsize=c["xs"].element_size()))


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
    segment); it returns (dwi, dwg, dwo). In bfloat16 the chain runs on
    bfloat16 copies of the scratch, made at set-up."""
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
        kw = dict(dtype=xs.dtype, device=xs.device)
        dws = (torch.zeros(E, d, f, **kw), torch.zeros(E, d, f, **kw),
               torch.zeros(E, f, d, **kw))
        da, dg, hh = (c[k].to(xs.dtype) for k in ("da", "dg", "h"))
        seen, firsts = set(), set()  # each expert's first segment
        for g, e, _, _ in segs:
            if e not in seen:
                seen.add(e)
                firsts.add((g, e))

        def dw_seg():
            for g, e, s, n in segs:
                x, gy = xs[g, s:s + n], c["dy"][g, s:s + n]
                for dst, a, b in ((dws[0][e], x, da[g, s:s + n]),
                                  (dws[1][e], x, dg[g, s:s + n]),
                                  (dws[2][e], hh[g, s:s + n], gy)):
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
    """One kernel's JSON record; its bound is ``tiling.bound_ms``'s: the
    larger of the bytes over the memory rate and the FLOPs over the
    dtype's peak; for a float32 call of a kernel in
    ``tiling.TF32X3_KERNELS``, 3 x FLOPs over the TF32 tensor-core rate,
    with the CUDA-core bound as ``cuda_core_bound_ms``."""
    from repro_torch.kernels import tiling

    bound, by, cc = tiling.bound_ms(kname, nbytes, flops, dtype)
    rec = {
        "name": kname, "route": "cuda", "source": src,
        "replaces": replaces, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib_ms,
    }
    if cc is not None:
        rec["cuda_core_bound_ms"] = cc
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
             decode_case_work(a, item),
             lambda: F.scaled_dot_product_attention(
                 qd, kd, vd, attn_mask=dmask),
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:65"),
            ("paged_prefill", pp.paged_prefill_attention_cuda,
             ref.prefill_attention_ref,
             (a["q_ch"], a["kp"], a["vp"], a["ctab"], a["starts"],
              a["lens"]),
             prefill_case_work(a, item),
             lambda: F.scaled_dot_product_attention(
                 qc, kc, vc, attn_mask=cmask),
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:66"),
            ("grouped_mlp", gm.grouped_mlp_cuda,
             lambda *x: ref.grouped_mlp_ref(*x, block=gm.ROW_BLOCK),
             (g["xs"], g["wi"], g["wg"], g["wo"], g["counts"]),
             grouped_case_work(g, "fwd"), grouped_lib,
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


def flash_case_work(a, kind, causal=True):
    """``tiling.flash_work`` of one flash call on a case's q, k and v,
    from position 0 over every key."""
    from repro_torch.kernels import tiling

    B, S, H, dh = a["q"].shape
    Skv, Kh = a["k"].shape[1:3]
    return tiling.flash_work(kind, B, S, Skv, H, Kh, dh, causal=causal,
                             itemsize=a["q"].element_size())


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


def check_train_kernels(cfg, device, dtype="float32"):
    """The six training kernels against their plain versions at the
    training shapes, in ``dtype`` (float32, or bfloat16: the same inputs
    rounded; the bound at the bfloat16 peak), with times. Returns the
    JSON records of all but the grouped forward, and the grouped
    forward's numbers at these shapes (its record is the serve
    shape's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    a, c = train_cases(cfg, device, gen)
    tag = "train-kernel" if dtype == "float32" else "bf16-train-kernel"
    if dtype != "float32":
        dt = getattr(torch, dtype)
        a = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in a.items()}
        c = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in c.items()}
    kw = dict(causal=True, q_offset=a["qo"], kv_len=a["kl"])
    o, lse = fa.flash_attention_fwd_cuda(a["q"], a["k"], a["v"], a["qo"],
                                         a["kl"], causal=True)
    delta = fa.attention_delta(o, a["do"])
    bwd_args = (a["q"], a["k"], a["v"], a["do"], lse, delta)
    gargs = (c["xs"], c["wi"], c["wg"], c["wo"], c["dy"], c["counts"])
    _, da, dg, hh = ref.grouped_mlp_dx_ref(*gargs, block=gm.ROW_BLOCK)
    dw_args = (c["xs"], c["dy"], da, dg, hh, c["counts"])
    dx_lib = grouped_library(c, "dx", f"[{tag}] grouped_mlp_dx")
    dw_lib = grouped_library(dict(c, da=da, dg=dg, h=hh), "dw",
                             f"[{tag}] grouped_mlp_dw")

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
         flash_case_work(a, "fwd"), sdpa_fwd,
         "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:94"),
        ("flash_attention_dq",
         lambda: fa.flash_attention_dq_cuda(*bwd_args, a["qo"], a["kl"],
                                            causal=True),
         lambda: ref.flash_attention_dq_ref(*bwd_args, **kw),
         flash_case_work(a, "dq"), sdpa_bwd,
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention.py:256"),
        ("flash_attention_dkv",
         lambda: fa.flash_attention_dkv_cuda(*bwd_args, a["qo"], a["kl"],
                                             causal=True),
         lambda: ref.flash_attention_dkv_ref(*bwd_args, **kw),
         flash_case_work(a, "dkv"), sdpa_bwd,
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention.py:285"),
        ("grouped_mlp_dx",
         lambda: gm.grouped_mlp_dx_cuda(*gargs),
         lambda: ref.grouped_mlp_dx_ref(*gargs, block=gm.ROW_BLOCK),
         grouped_case_work(c, "dx"), dx_lib,
         "src/repro_torch/kernels/csrc/grouped_mlp_bwd.cu",
         "src/repro/kernels/grouped_mlp.py:406"),
        ("grouped_mlp_dw",
         lambda: gm.grouped_mlp_dw_cuda(*dw_args),
         lambda: ref.grouped_mlp_dw_ref(*dw_args, block=gm.ROW_BLOCK),
         grouped_case_work(c, "dw"), dw_lib,
         "src/repro_torch/kernels/csrc/grouped_mlp_bwd.cu",
         "src/repro/kernels/grouped_mlp.py:476"),
    ]
    atol, rtol = TOL[dtype]
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
        print(f"[{tag}] {kname} {dtype}: max |kernel - plain| = "
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
                      flops, lib_ms, dtype)
        if kname == "grouped_mlp_dx":
            grouped_extras(tag, f"grouped_mlp_dx {dtype}", rec,
                           kern, gm.DX_ROW_TILES, chain, y_ref[0], flush)
        if kname == "grouped_mlp_dw":
            # One fixed order for every sum: a second call gives the same
            # bits.
            if not all(torch.equal(a, b) for a, b in zip(y, kern())):
                fail("grouped_mlp_dw: two calls gave different bits")
            rec["library_chain"], _, rec["library_calls"] = \
                chain or (None,) * 3
            if chain:
                print(f"[{tag}] grouped_mlp_dw {dtype}: library: the "
                      f"{chain[0]} chain of {chain[2]} torch calls, queued, "
                      f"max |library - plain| = "
                      f"{_max_err(chain[1](), y_ref, atol, rtol)[0]:.3e}; "
                      f"two calls bit-identical", flush=True)
        print(f"[{tag}] {kname} {dtype}: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms="
              f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
              f"{_bounds_text(rec)} ({nbytes} B, {flops} FLOP)", flush=True)
        records.append(rec)
    print_flash_pair(tag, "causal (16, 512, 16/8, 64)",
                     {r["name"]: r for r in records})

    # The grouped forward at these shapes (the training step's calls).
    fargs = (c["xs"], c["wi"], c["wg"], c["wo"], c["counts"])
    y = gm.grouped_mlp_cuda(*fargs)
    torch.cuda.synchronize()
    y_ref = ref.grouped_mlp_ref(*fargs, block=gm.ROW_BLOCK)
    max_err, ratio = _max_err(y, y_ref, atol, rtol)
    print(f"[{tag}] grouped_mlp {dtype}: max |kernel - plain| = "
          f"{max_err:.3e}, max err / limit = {ratio:.3f} (atol {atol}, "
          f"rtol {rtol})", flush=True)
    if not ratio <= 1.0:
        fail(f"grouped_mlp at the training shapes: kernel and plain version "
             f"differ beyond atol {atol} + rtol {rtol} (ratio {ratio:.3g})")
    lib_ms, chain = time_library_ms(
        grouped_library(c, "fwd", f"[{tag}] grouped_mlp"), flush=flush)
    nbytes, flops = grouped_case_work(c, "fwd")
    rec = _record("grouped_mlp", "", "", max_err,
                  time_ms(lambda: gm.grouped_mlp_cuda(*fargs), flush=flush),
                  time_synced_ms(lambda: ref.grouped_mlp_ref(
                      *fargs, block=gm.ROW_BLOCK), flush=flush),
                  nbytes, flops, lib_ms, dtype)
    fwd = {k: v for k, v in rec.items() if k not in (
        "name", "route", "source", "replaces")}
    grouped_extras(tag, f"grouped_mlp {dtype}", fwd,
                   lambda: gm.grouped_mlp_cuda(*fargs), gm.ROW_TILES, chain,
                   y_ref, flush)
    print(f"[{tag}] grouped_mlp {dtype}: ms={fwd['ms']:.4f} "
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


def expert_case_work(c, kind, gated=False):
    """``tiling.expert_work`` of one expert-FFN call over every row of a
    case's buffer ``c["xe"]``."""
    from repro_torch.kernels import tiling

    G, E, cap, d = c["xe"].shape
    return tiling.expert_work(kind, G, E, cap, d, c["wi"].shape[-1],
                              gated=gated, itemsize=c["xe"].element_size())


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
         expert_case_work(c, "fwd"), lib_fwd, 3,
         "src/repro_torch/kernels/csrc/expert_mlp.cu",
         "src/repro/kernels/expert_mlp.py:79"),
        ("expert_mlp_dx", lambda: em.expert_ffn_dx_cuda(xe, wi, None, wo, dy,
                                                        act="gelu"),
         lambda: ref.expert_ffn_dx_ref(xe, wi, None, wo, dy, act="gelu"),
         expert_case_work(c, "dx"), lib_dx, 4,
         "src/repro_torch/kernels/csrc/expert_mlp_bwd.cu",
         "src/repro/kernels/expert_mlp.py:227"),
        ("expert_mlp_dw", lambda: em.expert_ffn_dw_cuda(xe, dy, *scratch),
         lambda: ref.expert_ffn_dw_ref(xe, dy, *scratch),
         expert_case_work(c, "dw"), lib_dw, 2,
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
        nbytes, flops = flash_case_work(a, kind, causal=False)
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
               iters, dtype="float32"):
    """Hold one kernel call in ``dtype`` against its plain version on
    the same inputs (TOL[dtype]), time the kernel, the plain version and
    the library yardstick, and print and return the numbers as one row
    of the kernel's JSON record (``at_shapes``)."""
    err, ratio = _max_err(y, y_ref, *TOL[dtype])
    print(f"[{tag}] {kname} {dtype}: max |kernel - plain| = {err:.3e}, max "
          f"err / limit = {ratio:.3f}", flush=True)
    if not ratio <= 1.0:
        fail(f"{tag} {kname}: kernel and plain version differ beyond their "
             f"tolerance (ratio {ratio:.3g})")
    nbytes, flops = work
    ms, plain_ms, lib_ms = (time_ms(fn, flush=flush, iters=iters)
                            for fn in (kern, plain, lib))
    rec = _record(kname, "", "", err, ms, plain_ms, nbytes, flops, lib_ms,
                  dtype=dtype)
    row = {k: v for k, v in rec.items() if k not in (
        "name", "route", "source", "replaces")}
    row["library_calls"] = ncalls
    row["dtype"] = dtype
    print(f"[{tag}] {kname} {dtype}: ms={row['ms']:.4f} plain_ms="
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


def expert_shape_row(tag, cfg, experts, tokens, device, *, seed, iters=20,
                     dtype="float32"):
    """The expert-FFN kernel where a static engine's step runs it: the
    (G, E, cap, d) buffer of ``tokens`` tokens (dropless, every slot
    filled with a standard normal row, in ``dtype``: the served model's
    compute dtype, that of its weights) through the served model's own
    expert weights of one MoE layer, against the plain version and the
    ``torch.matmul`` chain over each expert's rows in that dtype."""
    import torch

    from repro_torch.core.routing import capacity
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import ref, tiling
    from repro_torch.models.layers import activation

    wi, wg, wo = experts["wi"], experts.get("wg"), experts["wo"]
    E, d, f = wi.shape
    g = min(cfg.moe.group_size, tokens)
    G, cap = -(-tokens // g), capacity(g, cfg.moe)
    gen = torch.Generator(device=device).manual_seed(seed)
    xe = torch.randn(G, E, cap, d, generator=gen, device=device).to(
        getattr(torch, dtype))
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
    nw = 3 if wg is not None else 2
    work = tiling.expert_work("fwd", G, E, cap, d, f, gated=wg is not None,
                              itemsize=xe.element_size())
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    out = _shape_row(tag, "expert_mlp", y, plain(), kern, plain, lib,
                     nw + 1 + (wg is not None), work, flush, iters,
                     dtype=dtype)
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
                     1, flash_case_work(a, "fwd"), flush, 20)
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
    the kernels-vs-plain comparisons below can be held tight. An
    encoder-decoder model's encoder layers are rescaled the same way,
    and so is each decoder layer's cross-attention (its wk and wv read
    the encoder states, also at fan-in d); a hybrid stack's mamba
    mixers are left as they are."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for key in ("encoder", "stack"):
        for seg in params.get(key, {"segments": []})["segments"]:
            for pos in seg.values():
                for m in (pos[n] for n in ("mixer", "cross")
                          if n in pos and "wq" in pos[n]):  # not mamba
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


def check_tokens(tag, got, want, rids, gap_eng) -> None:
    """Hold two runs' outputs token for token, request by request: a
    divergence is accepted only at a top-2 logit gap below TIE_GAP
    (measured by replaying the shared prefix through ``gap_eng``, a
    chunked engine over the same weights)."""
    diverged = 0
    for rid in rids:
        x, y = got[rid], want[rid]
        if x == y:
            continue
        n = next(i for i in range(max(len(x), len(y)))
                 if i >= len(x) or i >= len(y) or x[i] != y[i])
        gap = top2_gap(gap_eng, x[:n])
        diverged += 1
        print(f"[check] {tag}: rid {rid} diverges at token {n}: top-2 "
              f"logit gap {gap:.3e}", flush=True)
        if gap >= TIE_GAP:
            fail(f"{tag}: rid {rid} diverges at token {n} with top-2 gap "
                 f"{gap:.3e} >= {TIE_GAP}")
    if not diverged:
        print(f"[check] {tag}: token-identical", flush=True)


@contextlib.contextmanager
def witnessed_kernels():
    """Hold every kernel call made inside the block against its plain
    version on that call's own inputs (for the serve step: the pools as
    the step has just written them). Yields ``{kernel: [calls, max |err|,
    max err/limit]}`` with the limit ``atol + rtol * |plain|`` of
    :data:`TOL` for the output's dtype (float32 or bfloat16; the WKV
    kernel: :data:`WKV_RTOL` against its chunked plain version)."""
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
                err, ratio = _max_err(y_cmp, ref_cmp, *TOL[
                    "bfloat16" if first.dtype == torch.bfloat16
                    else "float32"])
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


def all_descs(cfg) -> list:
    """The layer descs of every stack of ``cfg``: the decoder's (or the
    encoder-only model's) and an encoder-decoder model's encoder's."""
    from repro_torch.models import stack as stk

    descs = stk.layer_descs(cfg)
    if cfg.structure == "encoder_decoder":
        descs += stk.layer_descs(cfg, stack="encoder")
    return descs


def step_launches(cfg, kernels, moe: bool) -> dict:
    """The launches one training step must make: each attention kernel
    once an attention (self- and cross-attention of every stack; a
    hybrid stack's mamba layers launch none), and in a MoE step each of
    the path's expert kernels once a MoE layer."""
    descs = all_descs(cfg)
    n_moe = sum(d.ffn == "moe" for d in descs)
    n_attn = sum(d.mixer == "attn" for d in descs) + sum(d.cross
                                                         for d in descs)
    want = {k: n_attn for k in FLASH_KERNELS}
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
    encdec = cfg.structure == "encoder_decoder"
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
    dec = ""
    if encdec:  # make_iterator's decoder length
        dec_len = max(spec["seq"] // 4, 8)
        tokens += spec["batch"] * dec_len
        what = "encoder sequences"
        dec = f" + {spec['batch']} x {dec_len} decoder"
    print(f"[{name}] {dense_cfg.name}: {count_params(params) / 1e9:.3f} B "
          f"params; batch {spec['batch']} {what} x {spec['seq']}{dec} = "
          f"{tokens} tokens a step" + ("" if encoder else
                                       f" (task vocab {task.vocab_size})")
          + f"; {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated "
          "before the run (the peak below includes it)", flush=True)
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
                           kernels, label="first MoE step"):
    """The first MoE step's (``label``'s) loss and gradient norm through
    the plain versions, against the kernels' (from the main path); then
    the same step through the kernels with every kernel call
    witnessed."""
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
    print(f"[check] {name} {label}, plain versions (no kernel "
          f"launched): loss={loss!r} grad_norm={gn!r}; kernels: "
          f"loss={kernel_mets['loss']!r} grad_norm="
          f"{kernel_mets['grad_norm']!r} ({plain_ms:.0f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)",
          flush=True)
    d_loss = abs(kernel_mets["loss"] - loss) / abs(loss)
    d_gn = abs(kernel_mets["grad_norm"] - gn) / abs(gn)
    print(f"[check] {name} {label}, kernels vs plain: loss rel diff "
          f"{d_loss:.3e} (limit {LOSS_RTOL}), grad_norm rel diff {d_gn:.3e} "
          f"(limit {GRAD_NORM_RTOL})", flush=True)
    if not (d_loss <= LOSS_RTOL and d_gn <= GRAD_NORM_RTOL):
        fail(f"the {name} {label} through the kernels and through the "
             "plain versions disagree")
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


def wkv_case_work(c, itemsize):
    """``tiling.wkv_work`` of one WKV call on wkv_case's inputs."""
    from repro_torch.kernels import tiling

    B, T, H, K = c["r"].shape
    return tiling.wkv_work(B, T, H, K, c["v"].shape[-1], itemsize=itemsize,
                           state_in=c["s0"] is not None)


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
        nbytes, flops = wkv_case_work(c, 4)
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


def serve_static(tag, params, cfg, device, prompts, max_new, runs, expect,
                 *, ac=None, serve=RWKV_SERVE, tie=None):
    """Serve ``prompts`` through ``ServeEngine(paged=False)`` (``serve``'s
    settings, ``ac``'s compute dtype), through the kernels and through
    the plain versions, ``runs`` times each,
    interleaved (kernels, plain, kernels, plain, ...), after one warm-up
    of each. Greedy outputs must be token-identical (a divergence only at
    a top-2 logit gap below ``tie``: by default TIE_GAP, RWKV_TIE_GAP for
    an rwkv stack, and
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

    sc = ServeConfig(**serve)
    ac = zoo.ApplyCfg() if ac is None else ac
    eng_k = ServeEngine(params, cfg, sc, device=device, ac=ac)
    eng_p = ServeEngine(params, cfg, sc, device=device, ac=dataclasses.replace(
        ac, moe_impl="eager", attn_impl="eager", mixer_impl="eager"))
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
    if tie is None:
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
    """R2: rwkv6-7b at full width, RWKV_LAYERS layers, through the
    static engine."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=RWKV_LAYERS)
    t0 = time.perf_counter()
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    torch.cuda.synchronize()
    print(f"[rwkv] {cfg.name} full width, {cfg.n_layers} of 32 layers: "
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

            # 4. Served from the checkpoint, whose params are the
            # Trainer's in-memory ones bit for bit (a second serve from
            # those was cut for the smoke's time: the combine adds in a
            # fixed order, so it repeated the first's tokens); every
            # request completed, no block leaked. Conditioned first
            # (condition_attention, as phases 4-5 serve).
            params, step = lserve.load_params(
                serve_cfg, device=device,
                manager=CheckpointManager(dirs["moe"]))
            same, worst, where = leaf_diff(params, out_m["state"]["params"])
            print(f"[ckpt] serve restore of step {step} vs the Trainer's "
                  f"in-memory params: bit-identical={same}", flush=True)
            if step != CKPT["moe_steps"] or not same:
                fail(f"serve restored step {step}, bit-identical={same}")
            condition_attention(params, serve_cfg)
            eng = ServeEngine(params, serve_cfg, ServeConfig(paged=True,
                                                             **SERVE),
                              device=device)
            _, finished, n_gen, wall = serve_once(eng, serve_cfg)
            es = eng.last_stats
            print(f"[ckpt] served from the checkpoint params: {n_gen} tokens "
                  f"in {wall:.3f} s, free_blocks_at_close="
                  f"{es['free_blocks_at_close']}", flush=True)
            if any(r["status"] != "completed" for r in finished.values()):
                fail(f"not every request completed: {finished}")
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


# ---------------------------------------------------------------------------
# the encoder-decoder family: T5 and whisper
# ---------------------------------------------------------------------------

# The paper's language model, t5-base-upcycled at full width and depth:
# the dense parent (T5 1.1 Base, 0.248 B params) takes 2 Adafactor steps
# on the span-corruption stream, 16 x 512 encoder and 16 x 128 decoder
# tokens a step (the paper's 512-token inputs; batch cut for time), is
# upcycled (experts copied) with its Adafactor state carried over into
# the 2.003 B MoE (32 experts in every other layer of both stacks: Expert
# Choice in the encoder, two groups of 4096 tokens, buffer (2, 32, 256,
# 768); top-2 in the decoder, one group of 2048 tokens, capacity 128),
# which takes 4 steps through the gather dispatch.
T5_TRAIN = dict(arch="t5-base-upcycled", batch=16, seq=512, dense_steps=2,
                moe_steps=4, peak_lr=0.01, warmup=100, dispatch="gather",
                resume_opt=True)
# Greedy decoding of the upcycled model as the reference drives an
# encoder-decoder model (zoo.prefill, then zoo.decode_step): 8 requests of
# 512 encoder tokens from the stream at a step the training never reads,
# the first 8 decoder tokens as the prompt, 32 new tokens. A decode step's
# top-2 buffer holds 1 row an expert (routing.capacity ignores top_k).
T5_DECODE = dict(requests=8, plen=8, new=32, data_step=1000)
# whisper-base (the full config: dense, frame frontend, LayerNorm): 2
# Adafactor steps at 8 x 1500 frames (decoder length 375), the first held
# against the plain versions; then 4 requests of 1500 frames decoded
# greedily, 16 new tokens.
WHISPER = dict(arch="whisper-base", batch=8, seq=1500, steps=2, peak_lr=0.01,
               warmup=100, dispatch="gather", requests=4, plen=8, new=16,
               data_step=1000)


def encdec_batch(cfg, n, seq, step):
    """``n`` sequences of the arch's stream at ``step`` (the task over the
    first TASK_VOCAB ids, as training reads it), all of them in every
    process (a rank of a process group too)."""
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.launch.train import TASK_VOCAB

    it = make_iterator(cfg, global_batch=n, seq_len=seq,
                       task=ClusteredBigramTask(
                           vocab_size=min(cfg.vocab_size, TASK_VOCAB)),
                       host_index=0, host_count=1)
    it.step = step
    return next(it)


def greedy(params, cfg, batch, plen, new, impl, device):
    """Greedy decoding: ``zoo.prefill`` over ``batch``'s first ``plen``
    prompt tokens (an encoder-decoder model's ``dec_tokens``, encoding
    its encoder input into the cache; a decoder's ``tokens`` with its
    ``patch_embeds`` over the first positions), then ``new - 1``
    ``zoo.decode_step`` calls (float32 caches). Returns (tokens (B,
    new), logits (B, new, V), prefill ms, decode ms), host clock,
    synchronised."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.training.train_loop import batch_to

    b = batch_to({k: v for k, v in batch.items() if k != "targets"}, device)
    key = "dec_tokens" if "dec_tokens" in b else "tokens"
    b[key] = b[key][:, :plen]
    enc = b.get("frames", b.get("enc_tokens"))
    ac = zoo.ApplyCfg(moe_impl=impl, attn_impl=impl)
    toks, logits = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = zoo.init_serve_cache(cfg, b[key].shape[0], plen + new,
                                     dtype=torch.float32, device=device,
                                     enc_len=0 if enc is None else
                                     enc.shape[1])
        cache, lg = zoo.prefill(params, b, cache, cfg, ac=ac)
        for t in range(new):
            logits.append(lg[:, -1])
            toks.append(lg[:, -1].argmax(-1))
            if t == 0:
                pre_ms, t1 = _sync_ms(t0), time.perf_counter()
            if t == new - 1:
                break
            cache, lg = zoo.decode_step(params, toks[-1][:, None], cache,
                                        plen + t, cfg, ac=ac)
        dec_ms = _sync_ms(t1)
    return torch.stack(toks, 1), torch.stack(logits, 1), pre_ms, dec_ms


def encdec_decode(name, params, cfg, device, batch, plen, new):
    """Greedy decoding of an encoder-decoder model through the kernels
    and through the plain versions (hold_greedy). The kernels' run must
    launch exactly what the stacks imply: the prefill, every self- and
    cross-attention and MoE layer once; each decode step, each
    cross-attention (its single query through the flash forward) and
    each decoder MoE layer once; the decoder's self-attention decodes
    outside any kernel, as the reference's does. Returns the kernels'
    run's launches."""
    from repro_torch.core.routing import capacity
    from repro_torch.models import stack as stk

    enc_d = stk.layer_descs(cfg, stack="encoder")
    dec_d = stk.layer_descs(cfg)
    n_dec_moe = sum(d.ffn == "moe" for d in dec_d)
    expect = {"flash_attention": len(enc_d) + 2 * len(dec_d)
              + len(dec_d) * (new - 1),
              "expert_mlp": sum(d.ffn == "moe" for d in enc_d) + n_dec_moe
              + n_dec_moe * (new - 1)}
    expect = {k: v for k, v in expect.items() if v}
    B = batch["dec_tokens"].shape[0]
    if cfg.moe is not None:
        print(f"[{name}-decode] the decoder's top-{cfg.moe.top_k} buffer: "
              f"prefill (1, {cfg.moe.num_experts}, "
              f"{capacity(B * plen, cfg.moe)}, {cfg.d_model}), decode step "
              f"(1, {cfg.moe.num_experts}, {capacity(B, cfg.moe)}, "
              f"{cfg.d_model})", flush=True)
    enc = batch["frames" if "frames" in batch else "enc_tokens"]
    return hold_greedy(name, params, cfg, device, batch, plen, new, expect,
                       f"{tuple(enc.shape)} encoder + {B} x {plen} decoder")


def hold_greedy(name, params, cfg, device, batch, plen, new, expect, what):
    """Greedy decoding (:func:`greedy`) through the kernels and through
    the plain versions: token-identical, or a divergence only where the
    kernels' top-2 logit gap is below TIE_GAP (at the first step where
    any row parts: MoE rows share their experts' capacity, so the rows
    are not independent). The kernels' run must launch exactly
    ``expect``, the plain run nothing. Then one prefill and one decode
    step through the kernels, every call witnessed. ``what`` describes
    the prefill. Returns ``expect``."""
    import torch

    from repro_torch.kernels import ops

    B = next(iter(batch.values())).shape[0]
    greedy(params, cfg, batch, plen, 2, "cuda", device)  # warm-up
    out = {}
    for impl in ("cuda", "eager"):
        ops.reset_launch_counts()
        toks, logits, pre_ms, dec_ms = greedy(params, cfg, batch, plen, new,
                                              impl, device)
        ran = {k: v for k, v in ops.launch_counts().items() if v}
        key = "kernels" if impl == "cuda" else "plain"
        print(f"[{name}-decode] {key}: {B} requests, prefill {what} in "
              f"{pre_ms:.1f} ms; {new - 1} decode steps in {dec_ms:.1f} ms "
              f"({dec_ms / max(new - 1, 1):.2f} ms a step, "
              f"{B * (new - 1) / dec_ms * 1e3:.1f} tokens/s); launches={ran}",
              flush=True)
        if impl == "cuda" and ran != expect:
            fail(f"{name} decode: the kernels' run launched {ran}, expected "
                 f"{expect}")
        if impl == "eager" and ran:
            fail(f"{name} decode: the plain run launched kernels: {ran}")
        out[impl] = (toks, logits)
    (tk, lk), (tp, lp) = out["cuda"], out["eager"]
    if not torch.isfinite(lk).all():
        fail(f"{name} decode: non-finite logits through the kernels")
    parts = (tk != tp).any(0).nonzero()
    n = int(parts[0]) if len(parts) else new
    diff = float((lk[:, :n] - lp[:, :n]).abs().max()) if n else 0.0
    print(f"[{name}-decode] kernels vs plain: logits part by at most "
          f"{diff:.3e} over the {n} steps before any token parts (max "
          f"|logit| {float(lp.abs().max()):.3f})", flush=True)
    if n == new:
        print(f"[{name}-decode] greedy outputs token-identical between the "
              f"kernels and the plain versions ({B} rows x {new} tokens)",
              flush=True)
    else:
        rows = (tk[:, n] != tp[:, n]).nonzero()[:, 0].tolist()
        top = torch.topk(lk[rows, n], 2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).tolist()
        print(f"[{name}-decode] kernels vs plain: rows {rows} part at "
              f"generated token {n}: the kernels' top-2 logit gaps there "
              f"{[f'{g:.3e}' for g in gaps]}", flush=True)
        if max(gaps) >= TIE_GAP:
            fail(f"{name} decode: greedy divergence at generated token {n} "
                 f"with top-2 gap {max(gaps):.3e} >= {TIE_GAP}")
    with witnessed_kernels() as wit:
        greedy(params, cfg, batch, plen, 2, "cuda", device)
        torch.cuda.synchronize()
    report_witness(wit, tuple(expect))
    return expect


def flash_case_rows(tag, cfg, B, Sq, Skv, causal, device, *, seed,
                    backward=True):
    """The flash kernels where this path runs them: q (B, Sq, H, dh), k/v
    (B, Skv, Kh, dh), dO standard normal; the forward (and dq, dk/dv)
    held against the plain versions and timed beside SDPA's forward (its
    backward, dq, dk and dv in one call, via autograd)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    a = dict(q=rnd(B, Sq, H, dh), k=rnd(B, Skv, Kh, dh), v=rnd(B, Skv, Kh, dh),
             do=rnd(B, Sq, H, dh), qo=fa.scalar_i32(0, device),
             kl=fa.scalar_i32(Skv, device))
    kw = dict(causal=causal, q_offset=a["qo"], kv_len=a["kl"])
    lq = a["q"].transpose(1, 2).contiguous().requires_grad_()
    lk, lv = (a[n].transpose(1, 2).repeat_interleave(H // Kh, 1)
              .contiguous().requires_grad_() for n in ("k", "v"))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    fwd = lambda: fa.flash_attention_fwd_cuda(  # noqa: E731
        a["q"], a["k"], a["v"], a["qo"], a["kl"], causal=causal)
    o, lse = fwd()
    torch.cuda.synchronize()
    cases = [("flash_attention", (o, lse), fwd,
              lambda: ref.flash_attention_ref(a["q"], a["k"], a["v"], **kw),
              sdpa_fwd, "fwd")]
    if backward:
        bwd_args = (a["q"], a["k"], a["v"], a["do"], lse,
                    fa.attention_delta(o, a["do"]))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        ldo = a["do"].transpose(1, 2).contiguous()

        def sdpa_bwd():
            torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

        for kname, kern, plain, kind in (
                ("flash_attention_dq", fa.flash_attention_dq_cuda,
                 ref.flash_attention_dq_ref, "dq"),
                ("flash_attention_dkv", fa.flash_attention_dkv_cuda,
                 ref.flash_attention_dkv_ref, "dkv")):
            call = functools.partial(kern, *bwd_args, a["qo"], a["kl"],
                                     causal=causal)
            cases.append((kname, call(), call,
                          functools.partial(plain, *bwd_args, **kw), sdpa_bwd,
                          kind))
    rows = []
    for kname, y, kern, plain, lib, kind in cases:
        k, _, row = _shape_row(tag, kname, y, plain(), kern, plain, lib, 1,
                               flash_case_work(a, kind, causal=causal),
                               flush, 20)
        row["shape"] = [B, Sq, Skv, H, Kh, dh, causal]
        rows.append((k, tag, row))
    return rows


def expert_case_rows(tag, cfg, G, cap, device, *, seed):
    """The expert-FFN forward, dx and dW where this path runs them: the
    (G, E, cap, d) buffer with every slot a standard normal row, the
    config's activation (T5: GEGLU) and weights at fan-in scale, held
    against the plain versions and timed beside the float32
    ``torch.matmul`` chain over each expert's rows (gated: forward 5
    calls, dx 10, dW 3)."""
    import torch

    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import ref
    from repro_torch.models.layers import activation

    E, d, f, act = cfg.moe.num_experts, cfg.d_model, cfg.d_ff, cfg.act
    gated = cfg.gated_mlp
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    c = dict(xe=rnd(G, E, cap, d), dy=rnd(G, E, cap, d),
             wi=rnd(E, d, f) / d ** 0.5, wo=rnd(E, f, d) / f ** 0.5,
             wg=rnd(E, d, f) / d ** 0.5 if gated else None)
    xe, dy, wi, wg, wo = (c[k] for k in ("xe", "dy", "wi", "wg", "wo"))
    scratch = [None if t is None else t.contiguous()
               for t in ref.expert_ffn_dx_ref(xe, wi, wg, wo, dy, act=act)[1:]]
    # The yardstick's inputs: each expert's G * cap rows together (set-up).
    per_e = lambda t: None if t is None else t.transpose(0, 1).reshape(  # noqa
        E, G * cap, -1).contiguous()
    xt, dyt, da_t, dg_t, h_t = (per_e(t) for t in (xe, dy, *scratch))
    fn = activation(act)
    grad = {"gelu": lambda g, a: torch.ops.aten.gelu_backward(
        g, a, approximate="tanh"),
            "silu": torch.ops.aten.silu_backward}[act]

    def lib_fwd():
        h = fn(torch.matmul(xt, wi))
        if gated:
            h = h * torch.matmul(xt, wg)
        torch.matmul(h, wo)

    def lib_dx():
        at = torch.matmul(xt, wi)
        dh = torch.matmul(dyt, wo.transpose(1, 2))
        if gated:
            gt = torch.matmul(xt, wg)
            dg = dh * fn(at)
            dh = dh * gt
        dx = torch.matmul(grad(dh, at), wi.transpose(1, 2))
        if gated:
            dx = dx + torch.matmul(dg, wg.transpose(1, 2))

    def lib_dw():
        torch.matmul(xt.transpose(1, 2), da_t)
        if gated:
            torch.matmul(xt.transpose(1, 2), dg_t)
        torch.matmul(h_t.transpose(1, 2), dyt)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    cases = [
        ("expert_mlp", lambda: em.expert_ffn_cuda(xe, wi, wg, wo, act=act),
         lambda: ref.expert_ffn_ref(xe, wi, wg, wo, act=act), lib_fwd,
         5 if gated else 3, "fwd"),
        ("expert_mlp_dx",
         lambda: em.expert_ffn_dx_cuda(xe, wi, wg, wo, dy, act=act),
         lambda: ref.expert_ffn_dx_ref(xe, wi, wg, wo, dy, act=act), lib_dx,
         10 if gated else 4, "dx"),
        ("expert_mlp_dw", lambda: em.expert_ffn_dw_cuda(xe, dy, *scratch),
         lambda: ref.expert_ffn_dw_ref(xe, dy, *scratch), lib_dw,
         3 if gated else 2, "dw"),
    ]
    rows = []
    for kname, kern, plain, lib, ncalls, kind in cases:
        y = kern()
        torch.cuda.synchronize()
        k, _, row = _shape_row(tag, kname, y, plain(), kern, plain, lib,
                               ncalls, expert_case_work(c, kind, gated),
                               flush, 20)
        del y
        row["shape"] = [G, E, cap, d, f]
        row["act"] = f"{act}{' gated' if gated else ''}"
        rows.append((k, tag, row))
    return rows


def t5_path(device):
    """Phase 13: t5-base-upcycled trained (T5_TRAIN) and decoded
    (T5_DECODE) through the kernels at full width and depth, held
    against the plain versions; then the flash and expert kernels timed
    at the path's shapes. Returns (launches by path, timing rows)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.routing import capacity

    cfg = get_config(T5_TRAIN["arch"])
    t0 = time.perf_counter()
    train_launches, first_params, first_batch, first_mets = train_path(
        cfg, device, T5_TRAIN, VIT_KERNELS)
    compare_first_moe_step(cfg, device, first_params, first_batch, first_mets,
                           T5_TRAIN, VIT_KERNELS)
    del first_batch
    torch.cuda.empty_cache()
    batch = encdec_batch(cfg, T5_DECODE["requests"], T5_TRAIN["seq"],
                         T5_DECODE["data_step"])
    decode_launches = encdec_decode("t5", first_params, cfg, device, batch,
                                    T5_DECODE["plen"], T5_DECODE["new"])
    del first_params
    torch.cuda.empty_cache()
    B, S = T5_TRAIN["batch"], T5_TRAIN["seq"]
    Sd = max(S // 4, 8)
    moe = cfg.moe
    rows = (flash_case_rows("t5_cross", cfg, B, Sd, S, False, device, seed=21)
            + flash_case_rows("t5_decoder_self", cfg, B, Sd, Sd, True, device,
                              seed=22)
            + flash_case_rows("t5_decode_cross", cfg, T5_DECODE["requests"], 1,
                              S, False, device, seed=23, backward=False)
            + expert_case_rows("t5_encoder", cfg, B * S // moe.group_size,
                               capacity(moe.group_size, moe), device, seed=24)
            + expert_case_rows("t5_decoder", cfg, 1, capacity(B * Sd, moe),
                               device, seed=25))
    print(f"[t5] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"t5_train": train_launches, "t5_decode": decode_launches}, rows


def whisper_path(device):
    """Phase 14: whisper-base (full config, dense, frame frontend) takes
    WHISPER's 2 steps through the flash kernels, each step's launches
    checked (every self- and cross-attention once), the first held and
    witnessed against the plain versions; then a greedy decode through
    the kernels and the plain versions (encdec_decode). Returns the
    launches by path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params, tree_map
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    name, spec = "whisper", WHISPER
    cfg = get_config(spec["arch"])
    t0 = time.perf_counter()
    opt = adafactor(inverse_sqrt(peak=spec["peak_lr"],
                                 warmup_steps=spec["warmup"]))
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(cfg, global_batch=spec["batch"], seq_len=spec["seq"],
                       task=task)
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    condition_attention(params, cfg)
    first_params = tree_map(torch.clone, params)
    state = init_train_state(None, cfg, opt, params=params)
    dec_len = max(spec["seq"] // 4, 8)
    print(f"[{name}] {cfg.name}: {count_params(params) / 1e9:.3f} B params; "
          f"batch {spec['batch']} x {spec['seq']} frames + {spec['batch']} x "
          f"{dec_len} decoder tokens a step (task vocab {task.vocab_size}); "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated "
          "before the run", flush=True)
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(
        dispatch=spec["dispatch"], moe_impl="cuda", attn_impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    want = step_launches(cfg, FLASH_KERNELS, False)
    first_batch, first = None, None
    for i in range(spec["steps"]):
        batch = next(it)
        before = ops.launch_counts()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        ms = _sync_ms(t1)
        m = {k: float(v) for k, v in m.items()}
        per = {k: v - before[k] for k, v in ops.launch_counts().items()}
        print(f"[{name}] step {int(state['step'])}: loss={m['loss']:.5f} "
              f"grad_norm={m['grad_norm']:.5f} skipped={m['skipped']:.0f} "
              f"ms={ms:.1f} ({spec['batch'] * (spec['seq'] + dec_len) / ms * 1e3:.0f}"
              f" tokens/s) launches={ {k: v for k, v in per.items() if v} }",
              flush=True)
        check_step(name, "dense", m, per, want)
        if i == 0:
            first_batch, first = batch, m
    train_launches = ops.launch_counts()
    print(f"[{name}] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
          f" GiB", flush=True)
    del state
    compare_first_moe_step(cfg, device, first_params, first_batch, first, spec,
                           FLASH_KERNELS, label="first step")
    batch = encdec_batch(cfg, spec["requests"], spec["seq"], spec["data_step"])
    decode_launches = encdec_decode(name, first_params, cfg, device, batch,
                                    spec["plen"], spec["new"])
    print(f"[{name}] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"whisper_train": train_launches, "whisper_decode": decode_launches}


# ---------------------------------------------------------------------------
# phase 15: prefill-on-join, speculative decoding, chaos and the fleet
# ---------------------------------------------------------------------------


def verify_lane_row(cfg, device, *, seed):
    """The paged prefill kernel at a verify step's verify lanes (the
    SERVE settings at spec_k SPEC_K: 8 lanes of 5 rows, starts inside
    blocks, lens 5 but for one 1-row lane and one idle lane, which
    starts at 0 as the engine zeroes an idle lane; the chunk lanes
    beside them are the call of check_kernels), against the plain
    version and SDPA over each lane's blocks gathered dense."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref

    bs, nb = SERVE["block_size"], SERVE["max_len"] // SERVE["block_size"]
    B, K1 = SERVE["max_batch"], SPEC_K + 1
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa
    P = 1 + B * nb
    kp, vp = rnd(P, bs, Kh, dh), rnd(P, bs, Kh, dh)
    vtab = (1 + torch.randperm(P - 1, generator=gen, device=device)
            ).reshape(B, nb).to(torch.int32)
    i32 = dict(dtype=torch.int32, device=device)
    starts = torch.tensor([1, 17, 70, 131, 250, 333, 400, 0], **i32)
    lens = torch.tensor([K1] * (B - 2) + [1, 0], **i32)
    q = rnd(B, K1, H, dh)
    c = dict(q_ch=q, kp=kp, ctab=vtab, starts=starts, lens=lens)
    k = kp[vtab.long()].reshape(B, nb * bs, Kh, dh)
    v = vp[vtab.long()].reshape(B, nb * bs, Kh, dh)
    kd, vd = (t.transpose(1, 2).repeat_interleave(H // Kh, 1).contiguous()
              for t in (k, v))
    qpos = starts[:, None] + torch.arange(K1, device=device)[None]
    mask = (torch.arange(nb * bs, device=device)[None, None]
            <= qpos[..., None])[:, None]
    qt = q.transpose(1, 2)

    def sdpa():
        F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask)

    args = (q, kp, vp, vtab, starts, lens)
    kern = lambda: pp.paged_prefill_attention_cuda(*args)  # noqa: E731
    plain = lambda: ref.prefill_attention_ref(*args)  # noqa: E731
    y = kern()
    torch.cuda.synchronize()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    out = _shape_row("verify_lanes", "paged_prefill", y, plain(), kern,
                     plain, sdpa, 1, prefill_case_work(c, 4), flush, 20)
    out[2]["shape"] = [B, K1, H, Kh, dh]
    return out


def prefill_on_join_path(params, cfg, device, chunked, gap_eng):
    """Phase 15.1: the 12 requests through ``admission="prefill_on_join"``
    (one bucketed B = 1 prefill an admission, the flash forward; one
    batched decode step a tick, the decode kernel), through the kernels;
    held token for token against phase 4's chunked outputs (themselves
    held against the plain versions); launches and ``compile_count``
    (one shape a bucket plus the decode step's) checked; one prefill and
    one decode step witnessed. Returns the kernels' run's launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import ServeConfig, ServeEngine, bucket_len

    L, bs = cfg.n_layers, SERVE["block_size"]
    reqs = make_requests(cfg)
    buckets = [bucket_len(len(r.prompt), bs) for r in reqs]
    sc = ServeConfig(paged=True, admission="prefill_on_join", **SERVE)
    eng = ServeEngine(params, cfg, sc, device=device)
    ops.reset_launch_counts()
    outs, fin, n_gen, wall = serve_once(eng, cfg)
    launches = ops.launch_counts()
    st = eng.last_stats
    print(f"[pp] kernels: {n_gen} tokens in {wall:.3f} s = "
          f"{n_gen / wall:.1f} tokens/s, decode steps={st['mixed_steps']}, "
          f"decode_stall_ticks={st['decode_stall_ticks']}, "
          f"compile_count={st['compile_count']} ({len(set(buckets))} "
          f"buckets {sorted(set(buckets))} + the decode step), "
          f"launches={launches}, "
          f"free_blocks_at_close={st['free_blocks_at_close']}", flush=True)
    if any(rec["status"] != "completed" for rec in fin.values()):
        fail(f"prefill-on-join: not every request completed: {fin}")
    if st["compile_count"] != len(set(buckets)) + 1:
        fail(f"prefill-on-join compile_count {st['compile_count']} != "
             f"{len(set(buckets))} buckets + 1")
    want = {"flash_attention": L * len(reqs),
            "decode_attention": L * st["mixed_steps"],
            "grouped_mlp": L * (len(reqs) + st["mixed_steps"]),
            "paged_prefill": 0}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"prefill-on-join launches {launches}, want {want}")
    # Phase 4 held the chunked outputs against the plain versions; a
    # plain run of this path too was cut for the smoke's time.
    rids = [r.rid for r in reqs]
    check_tokens("pp vs chunked (phase 4)", outs, chunked, rids, gap_eng)

    # One B = 1 prefill and one decode step, every kernel call witnessed.
    ac = zoo.ApplyCfg(dispatch="sorted")
    nb = SERVE["max_len"] // bs
    cache = zoo.init_paged_serve_cache(cfg, 1 + nb, bs, dtype=torch.float32,
                                       device=device)
    r = reqs[-1]
    plen, sp = len(r.prompt), bucket_len(len(r.prompt), bs)
    i32 = dict(dtype=torch.int32, device=device)
    toks = torch.zeros((1, sp), **i32)
    toks[0, :plen] = torch.tensor(r.prompt, **i32)
    table = torch.arange(1, nb + 1, **i32)[None]
    with witnessed_kernels() as wit:
        cache, lg = zoo.paged_prefill(params, toks, cache, table, plen, cfg,
                                      ac=ac)
        torch.cuda.synchronize()
    print(f"[witness] prefill-on-join prefill (1, {sp}) of a {plen}-token "
          "prompt:", flush=True)
    report_witness(wit, ("flash_attention", "grouped_mlp"))
    B = SERVE["max_batch"]
    tables = torch.zeros((B, nb), **i32)
    tables[0] = table[0]
    lengths = torch.zeros((B,), **i32)
    lengths[0] = plen
    cur = torch.zeros((B, 1), **i32)
    cur[0, 0] = int(lg[0, 0].argmax())
    with witnessed_kernels() as wit:
        zoo.paged_decode_step(params, cur, cache, tables, lengths, cfg,
                              ac=ac)
        torch.cuda.synchronize()
    print("[witness] prefill-on-join decode step:", flush=True)
    report_witness(wit, ("decode_attention", "grouped_mlp"))
    return launches


def bucket_rows(cfg, device):
    """The flash forward at prefill-on-join's smallest, middle and
    largest bucket of the 12 requests (B = 1), with its launches in the
    run of :func:`prefill_on_join_path`."""
    from repro_torch.serve import bucket_len

    buckets = [bucket_len(len(r.prompt), SERVE["block_size"])
               for r in make_requests(cfg)]
    used = sorted(set(buckets))
    rows = []
    for S in (used[0], used[len(used) // 2], used[-1]):
        row = flash_shape_row(f"pp_bucket_{S}", cfg, 1, S, device, seed=S)
        row[2]["launches"] = cfg.n_layers * buckets.count(S)
        rows.append(row)
    return rows


def upcycled_granite(cfg, device):
    """A fresh upcycle of granite's dense parent (seed 1, attention
    conditioned as in phase 4): copy init and normalised combine weights,
    so the MoE computes what its parent computes (the reference's
    ``upcycled`` fixture, tests/test_speculative.py). Returns (params,
    cfg)."""
    import torch

    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.models import model_zoo as zoo

    scfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_init="copy", normalize_combine_weights=True))
    dcfg = scfg.dense_parent()
    dense = zoo.init_params(torch.Generator(device=device).manual_seed(1),
                            dcfg, device=device)
    condition_attention(dense, dcfg)
    return upcycle_params(dense, dcfg, scfg, 2), scfg


def spec_path(cfg, device):
    """Phase 15.2: speculative decoding (spec_k SPEC_K) on a fresh
    upcycle: greedy vanilla and dense in interleaved rounds, top1 in the
    first (the
    drafts token-identical to vanilla by check_tokens' rule; acceptance,
    drafted tokens, target steps and tokens/s printed), launches checked
    against the steps each run made, the dense draft at temperature
    accepting at least SPEC_MIN_ACCEPT, and one spec tick witnessed.
    Returns the launches of the first round's runs."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine

    params, scfg = upcycled_granite(
        dataclasses.replace(cfg, n_layers=SPEC_LAYERS), device)
    L = scfg.n_layers
    base = dict(paged=True, **SERVE)
    engines = {
        "vanilla": ServeEngine(params, scfg, ServeConfig(**base),
                               device=device),
        "dense": ServeEngine(params, scfg, ServeConfig(
            **base, draft="dense", spec_k=SPEC_K), device=device),
        "top1": ServeEngine(params, scfg, ServeConfig(
            **base, draft="top1", spec_k=SPEC_K), device=device),
    }
    gap_eng = engines["vanilla"]
    rids = [r.rid for r in make_requests(scfg)]
    total, tps, ref_outs = {}, {k: [] for k in engines}, None
    for rnd in range(SPEC_RUNS):
        for key, eng in engines.items():
            if key == "top1" and rnd:
                continue
            ops.reset_launch_counts()
            outs, fin, n, wall = serve_once(eng, scfg)
            launches = ops.launch_counts()
            st = eng.last_stats
            tps[key].append(n / wall)
            line = (f"[spec] {key} round {rnd}: {n} tokens in {wall:.3f} s "
                    f"= {n / wall:.1f} tokens/s, target steps="
                    f"{st['mixed_steps']}")
            if key == "vanilla":
                if ref_outs is None:
                    ref_outs = outs
                want = {"decode_attention": L * st["mixed_steps"],
                        "paged_prefill": L * st["mixed_steps"],
                        "grouped_mlp": L * st["mixed_steps"]}
            else:
                sp = st["spec"]
                line += (f", acceptance_rate={st['acceptance_rate']:.4f}, "
                         f"spec_drafted={st['spec_drafted']}, spec_accepted="
                         f"{st['spec_accepted']}, draft_steps="
                         f"{sp['draft_steps']}, catch_up_steps="
                         f"{sp['catch_up_steps']}, compile_count="
                         f"{st['compile_count']}, draft_compile_count="
                         f"{st['draft_compile_count']}")
                draft_moe = L * (sp["draft_steps"] + sp["catch_up_steps"])
                want = {"decode_attention": L * sp["draft_steps"],
                        "paged_prefill": L * (2 * st["mixed_steps"]
                                              + sp["catch_up_steps"]),
                        "grouped_mlp": L * st["mixed_steps"]
                        + (draft_moe if key == "top1" else 0)}
                if st["compile_count"] != 1 or \
                        st["draft_compile_count"] != 2:
                    fail(f"spec {key}: compile_count "
                         f"{st['compile_count']}, draft "
                         f"{st['draft_compile_count']} (want 1, 2)")
            print(line + f", launches={launches}", flush=True)
            if any(launches[k] != v for k, v in want.items()):
                fail(f"spec {key}: launches {launches}, want {want}")
            if any(rec["status"] != "completed" for rec in fin.values()):
                fail(f"spec {key}: not every request completed")
            if rnd == 0:
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            check_tokens(f"spec {key} round {rnd} vs vanilla", outs,
                         ref_outs, rids, gap_eng)
    for key, v in tps.items():
        print(f"[spec] {key}: tokens/s over {len(v)} rounds = "
              f"{', '.join(f'{x:.1f}' for x in v)}", flush=True)

    # Temperature: the dense draft is the MoE's parent, q == p up to
    # float32 rounding.
    hot = {k: ServeEngine(params, scfg, ServeConfig(
        **base, temperature=SPEC_TEMPERATURE,
        **({} if k == "vanilla" else dict(draft=k, spec_k=SPEC_K))),
        device=device) for k in ("vanilla", "dense")}
    outs_t = {}
    for k, eng in hot.items():
        outs_t[k] = eng.serve(make_requests(scfg), seed=7)[0]
    st = hot["dense"].last_stats
    differ = sum(outs_t["dense"][r] != outs_t["vanilla"][r] for r in rids)
    print(f"[spec] dense at temperature {SPEC_TEMPERATURE}: "
          f"acceptance_rate={st['acceptance_rate']:.4f} "
          f"({st['spec_accepted']} of {st['spec_drafted']}), "
          f"{differ} of {len(rids)} requests differ from vanilla",
          flush=True)
    if st["acceptance_rate"] < SPEC_MIN_ACCEPT:
        fail(f"the dense draft of a fresh upcycle accepted "
             f"{st['acceptance_rate']:.4f} < {SPEC_MIN_ACCEPT}")

    # One spec tick with drafts in flight, every kernel call witnessed.
    sess = engines["dense"].open_session()
    for r in make_requests(scfg):
        sess.submit(r)
    while sess.stats["spec_drafted"] == 0:
        sess.tick()
    with witnessed_kernels() as wit:
        sess.tick()
        torch.cuda.synchronize()
    print(f"[witness] one spec tick (verify lanes {SERVE['max_batch']} x "
          f"{SPEC_K + 1}, chunk lanes {SERVE['chunks_per_step']} x "
          f"{SERVE['chunk_size']}):", flush=True)
    report_witness(wit, [k for k in SERVE_KERNELS if k in wit])
    if not {"paged_prefill", "grouped_mlp"} <= set(wit):
        fail(f"the witnessed spec tick called {sorted(wit)}")
    while sess.tick():
        pass
    sess.close()
    return total


def overload_requests(cfg):
    """examples/serve_moe.py's over-subscribed trace."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, arrival=i // 2,
                    prompt=[int(t) for t in rng.integers(
                        1, 250, size=OVERLOAD["plen"])],
                    max_new=OVERLOAD["max_new"],
                    priority=1 if i >= 8 else 0)
            for i in range(OVERLOAD["n"])]


def chaos_path(params, cfg, device, gap_eng):
    """Phase 15.3: the over-subscribed trace with the robustness knobs
    and seeded chaos. Every request (bursts included) reaches exactly
    one terminal status (the session checks it at close, with the block
    leak), the pool is audited every tick, and every completed request
    is token-identical (check_tokens' rule) to its run in an unchaosed,
    ample engine; for each of CHAOS_SEEDS. Returns the chaos runs'
    launches."""
    from repro_torch.serve import ServeConfig, ServeEngine, blocks_needed

    bs = SERVE["block_size"]
    base = dict(SERVE, max_batch=OVERLOAD["max_batch"], paged=True)
    clean = ServeEngine(params, cfg, ServeConfig(**base), device=device)
    clean_outs, _ = clean.serve(overload_requests(cfg))
    need = blocks_needed(OVERLOAD["plen"], OVERLOAD["max_new"], bs)
    total = {}
    for seed in CHAOS_SEEDS:
        launches = chaos_run(params, cfg, device, gap_eng, seed, clean_outs,
                             dict(base, num_blocks=1 + need + 1))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def chaos_run(params, cfg, device, gap_eng, seed, clean_outs, base):
    """One chaos seed of :func:`chaos_path`; returns its launches."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ChaosConfig, ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, ServeConfig(
        **base, chaos=ChaosConfig(seed=seed, **CHAOS), **ROBUST),
        device=device)
    ops.reset_launch_counts()
    outs, fin = eng.serve(overload_requests(cfg))
    launches = ops.launch_counts()
    st = eng.last_stats
    print(f"[chaos] seed {seed}: {len(fin)} requests "
          f"({st['chaos']['burst_reqs']} from "
          f"bursts): status_counts={st['status_counts']}, chaos="
          f"{st['chaos']}, preemptions={st['preemptions']}, "
          f"watchdog_failures={st['watchdog_failures']}, mixed_steps="
          f"{st['mixed_steps']}, audits={st['audits']}, compile_count="
          f"{st['compile_count']}, launches={launches}", flush=True)
    if set(outs) != set(fin) or sum(st["status_counts"].values()) != len(fin):
        fail("chaos: a request without exactly one terminal status")
    if any(rec["status"] not in ("completed", "shed", "timeout", "failed")
           for rec in fin.values()):
        fail(f"chaos: unknown terminal status in {fin}")
    if st["audits"] <= st["mixed_steps"] or st["compile_count"] != 1:
        fail(f"chaos: audits {st['audits']}, mixed steps "
             f"{st['mixed_steps']}, compile_count {st['compile_count']}")
    want = cfg.n_layers * st["mixed_steps"]
    if any(launches[k] != want for k in SERVE_KERNELS):
        fail(f"chaos seed {seed}: launches {launches}, want {want} of "
             f"each of {SERVE_KERNELS}")
    done = [rid for rid, rec in fin.items()
            if rid < OVERLOAD["n"] and rec["status"] == "completed"]
    print(f"[chaos] seed {seed}: {len(done)} of {OVERLOAD['n']} trace "
          f"requests completed: {done}", flush=True)
    check_tokens(f"chaos seed {seed} completed vs unchaosed", outs,
                 clean_outs, done, gap_eng)
    return launches


def fleet_path(params, cfg, device, chunked, gap_eng):
    """Phase 15.4: the 12 requests through a Fleet of 3 replica sessions
    of one engine (pools audited every tick), replica 0 killed at
    FLEET_KILL_TICK: every request completes exactly once, and the
    outputs are token-identical (check_tokens' rule) to phase 4's solo run.
    Returns the fleet run's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (Fleet, FleetChaosConfig, FleetConfig,
                                   ServeConfig, ServeEngine)

    eng = ServeEngine(params, cfg, ServeConfig(
        paged=True, audit_invariants=True, **SERVE), device=device)
    fleet = Fleet(eng, FleetConfig(num_engines=3, chaos=FleetChaosConfig(
        seed=1, kills=((FLEET_KILL_TICK, 0),))))
    reqs = make_requests(cfg)
    ops.reset_launch_counts()
    outs, fin = fleet.run(reqs)
    launches = ops.launch_counts()
    fs = fleet.last_stats
    moved = sorted(rid for rid, rec in fin.items() if rec["migrations"])
    print(f"[fleet] {fs['num_engines']} replicas, {fs['ticks']} ticks, "
          f"kills={fs['kills']}, migrations={fs['migrations']} (rids "
          f"{moved}), status_counts={fs['status_counts']}, engines="
          + str({e: (s["state"], s["mixed_steps"], s["audits"])
                 for e, s in fs["engines"].items()})
          + f", launches={launches}", flush=True)
    if sorted(fin) != [r.rid for r in reqs] or \
            fs["status_counts"] != {"completed": len(reqs)}:
        fail(f"fleet: not every request completed exactly once: {fin}")
    if fs["kills"] != 1 or not moved:
        fail("fleet: the kill migrated no request mid-flight")
    want = cfg.n_layers * sum(s["mixed_steps"] for s in fs["engines"].values())
    if any(launches[k] != want for k in SERVE_KERNELS):
        fail(f"fleet: launches {launches}, want {want} of each of "
             f"{SERVE_KERNELS}")
    check_tokens("fleet vs solo (phase 4)", outs, chunked,
                 [r.rid for r in reqs], gap_eng)
    return launches


def serve_engine_modes(cfg, device, chunked):
    """Phase 15: prefill-on-join, speculative decoding, robustness and
    chaos, and the fleet, each sub-phase's seconds, launches and peak
    memory printed. ``chunked``: phase 4's outputs (the same weights).
    Returns (launches by path, shape rows)."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    condition_attention(params, cfg)  # phase 4's weights
    gap_eng = ServeEngine(params, cfg, ServeConfig(paged=True, **SERVE),
                          device=device)
    by_path = {}
    for name, run in (
            ("serve_prefill_on_join",
             lambda: prefill_on_join_path(params, cfg, device, chunked,
                                          gap_eng)),
            ("serve_spec", lambda: spec_path(cfg, device)),
            ("serve_chaos", lambda: chaos_path(params, cfg, device,
                                               gap_eng)),
            ("serve_fleet", lambda: fleet_path(params, cfg, device,
                                               chunked, gap_eng))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        launches = by_path[name] = run()
        torch.cuda.synchronize()
        print(f"[{name}] {time.perf_counter() - t0:.1f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} "
              "GiB", flush=True)
    rows = bucket_rows(cfg, device) + [verify_lane_row(cfg, device, seed=3)]
    print(f"[serve_modes] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path, rows


# ---------------------------------------------------------------------------
# phase 16: the rest of training (remat, the chunked CE, gradient
# accumulation and compression, bfloat16 compute, AdamW, the launcher)
# ---------------------------------------------------------------------------

# Granite at full width from phase 6's upcycled MoE weights (attention
# conditioned) and its first MoE batch, 16 x 512 tokens, sorted
# dispatch; each knob's step starts from a fresh copy of that state.
# ce_chunk 128: 4 chunks of 16 x 128 x 49,155 float32 logits, 0.40 GB
# each, against 1.61 GB for the whole logits.
KNOBS = dict(arch="granite-moe-1b-a400m", peak_lr=0.01, warmup=100,
             ce_chunk=128, grad_accum=4, bf16_steps=4, adamw_steps=2,
             data_step=100)
REMAT_POLICIES = ("none", "full", "dots", "moe")
# A remat step against the step without remat, through the kernels:
# remat repeats the forward (the MoE combine adds in a fixed order), so
# the loss (from the first forward) within 1e-6 and the gradient norm
# (through recomputed residuals) within 1e-4.
REMAT_LOSS_RTOL, REMAT_GRAD_NORM_RTOL = 1e-6, 1e-4
# ce_chunk against the whole logits: the CE's sum in another order.
CE_CHUNK_LOSS_RTOL = 1e-5
# The first bfloat16 step through the kernels against the plain
# versions' bfloat16 loss: both round each product's output once to
# bfloat16 from float32 sums of different orders, so single outputs may
# sit one bfloat16 rounding (2^-8) apart; through 24 layers, and with a
# routing choice flipped where two experts tie, the CPU's two bfloat16
# implementations of the 4-layer model part by up to 7e-5 in loss
# (tests/test_torch_train_knobs.py). 1e-3; a wrong kernel moves the
# loss by O(1e-1).
BF16_STEP_LOSS_RTOL = 1e-3
# The vision schedule for the AdamW steps (paper §A.1.2), cut to steps.
ADAMW_SCHEDULE = dict(peak=4e-4, warmup_steps=10, timescale=100,
                      cooldown_start=50, cooldown_steps=20)
# launch/train.py main() on granite at 8 x 512: remat "moe", 2
# microbatches, int8 compression; 4 steps straight, and 4 steps killed
# (SIGTERM: a blocking save and a clean exit) after step 2 and resumed.
# Each run upcycles (--upcycle-from) a dense parent at the package's
# init with its attention conditioned, saved once: at the MoE's own
# reference init the first step's gradient norm is ~5e11, and Adafactor
# turns the zero rows of an int8-compressed embedding gradient beside
# rows of that size into NaN updates (ROADMAP.md queue 3).
LAUNCH = dict(batch=8, seq=512, steps=4, kill_after=2,
              flags=("--remat", "moe", "--grad-accum", "2",
                     "--compression", "int8", "--dispatch", "sorted"))
# Free disk the killed run's save needs: params and residual, 10.7 GB,
# and the dense parent's params, 0.66 GB.
LAUNCH_DISK_GB = 12.0
# rwkv6-7b at full width and 4 of its 32 layers through the Trainer with
# the launcher's ApplyCfg (the eager WKV: the kernel has no backward):
# 4 x (5 * 4096^2 + 2 * 4096 * 14336) + 2 x 65536 x 4096 ~ 1.3 B params.
RWKV_TRAIN = dict(arch="rwkv6-7b", layers=4, batch=4, seq=256, steps=2)


def remat_launches(cfg, policy: str) -> dict:
    """A MoE step's launches under ``policy``: every policy but "none"
    runs each layer body's forward again in the backward, and no policy
    can save a kernel's output (the kernels are
    ``torch.autograd.Function``s over pybind calls, which a selective
    policy does not see), so the forward kernels launch twice a layer
    and the backward kernels once."""
    want = step_launches(cfg, TRAIN_KERNELS, True)
    if policy != "none":
        for k in ("flash_attention", "grouped_mlp"):
            want[k] *= 2
    return want


@contextlib.contextmanager
def launcher_probe(kill_after=None):
    """Inside the block every ``Trainer.run`` result and every checkpoint
    the managers save (host copies) and restore is kept: yields {"runs":
    [...], "saved": {step: state}, "restored": [(step, state)]} (train
    states: not the params ``--upcycle-from`` reads). With
    ``kill_after`` the process sends itself SIGTERM once that many steps
    of a run are done (the launcher's PreemptionSignal: a blocking save
    of that step and a clean exit)."""
    import os
    import signal

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.training.train_loop import Trainer

    got = {"runs": [], "saved": {}, "restored": []}
    run, watchdog = Trainer.run, Trainer._watchdog
    save, restore = CheckpointManager.save, CheckpointManager.restore_latest

    def keep_run(self, *a, **kw):
        out = run(self, *a, **kw)
        got["runs"].append(out)
        return out

    def kill(self, step, dt):
        watchdog(self, step, dt)
        if kill_after is not None and step + 1 == kill_after:
            os.kill(os.getpid(), signal.SIGTERM)

    def keep_save(self, step, tree, **kw):
        got["saved"][step] = host_snapshot(tree)
        return save(self, step, tree, **kw)

    def keep_restore(self, like, **kw):
        out = restore(self, like, **kw)
        if out[0] is not None and kw.get("key") is None:  # a train state
            got["restored"].append((out[1], host_snapshot(out[0])))
        return out

    Trainer.run, Trainer._watchdog = keep_run, kill
    CheckpointManager.save = keep_save
    CheckpointManager.restore_latest = keep_restore
    try:
        yield got
    finally:
        Trainer.run, Trainer._watchdog = run, watchdog
        CheckpointManager.save, CheckpointManager.restore_latest = \
            save, restore


def residual_exact(kind, g, e, c, e_new):
    """(the new residual equals (g + e) - c exactly, max |c + e_new - (g
    + e)|, the leaf's shape) for one leaf of one compression: bf16's
    difference is exact in float32; int8's residual is x - q * scale
    rounded once (training/compression.py), recomputed here in
    float64."""
    import torch

    x = g.float() + e
    if kind == "bf16":
        want = x - c
    else:
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127)
        want = (x.double() - q.double() * scale.double()).float()
    back = float((c.double() + e_new.double() - x.double()).abs().max())
    return torch.equal(e_new, want), back, tuple(x.shape)


def train_rows(path) -> dict:
    """step -> loss of the "train" rows a ``--obs-jsonl`` file holds."""
    with open(path) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    return {r["t"]: r["loss"] for r in rows if r.get("kind") == "train"}


def knobs_path(device, params, batch):
    """Phase 16: the training knobs on granite at full width through the
    kernels (``params``: phase 6's upcycled MoE on the host; ``batch``:
    its first MoE batch), the launcher with them, and rwkv6-7b's dense
    stack through the launcher's ApplyCfg. Returns (the launches of the
    phase's steps, the bfloat16 kernel records at the training shapes,
    the grouped forward's bfloat16 numbers there)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params, tree_leaves, tree_map
    from repro_torch.optim import (
        adafactor,
        adamw,
        inverse_sqrt,
        rsqrt_with_cooldown,
    )
    from repro_torch.optim.base import global_norm
    from repro_torch.training import (
        TrainConfig,
        Trainer,
        compression,
        init_train_state,
        make_train_step,
    )
    from repro_torch.training.train_loop import batch_to, loss_and_grads

    t_phase = time.perf_counter()
    cfg = get_config(KNOBS["arch"])
    name = "knobs"
    # The six training kernels in bfloat16 at the training shapes; their
    # launches are comparisons, not the path's.
    bf16_records, bf16_fwd = check_train_kernels(cfg, device, "bfloat16")
    params = tree_map(lambda t: t.to(device), params)
    batch = batch_to(batch, device)
    tokens = batch["tokens"].numel()
    opt = adafactor(inverse_sqrt(peak=KNOBS["peak_lr"],
                                 warmup_steps=KNOBS["warmup"]))
    print(f"[{name}] {cfg.name}: {count_params(params) / 1e9:.3f} B params "
          f"(phase 6's upcycle), batch {tuple(batch['tokens'].shape)}, "
          f"sorted dispatch", flush=True)

    def kac(**kw):
        return zoo.ApplyCfg(dispatch="sorted", moe_impl="cuda",
                            attn_impl="cuda", **kw)

    def pac(**kw):
        return zoo.ApplyCfg(dispatch="sorted", moe_impl="eager",
                            attn_impl="eager", **kw)

    def step(tag, ac, *, tc=TrainConfig(), optimizer=opt, state=None,
             data=None, want=None, keep=False):
        """One step (from a fresh copy of the phase's state unless
        ``state``): returns (the new state if ``keep``, metrics, ms, peak
        bytes)."""
        if state is None:
            state = init_train_state(None, cfg, optimizer, tc=tc,
                                     params=tree_map(torch.clone, params))
        fn = make_train_step(cfg, optimizer, ac=ac, tc=tc)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        state, m = fn(state, batch if data is None else data)
        ms = _sync_ms(t0)
        peak = torch.cuda.max_memory_allocated()
        m = {k: float(v) for k, v in m.items()}
        per = {k: v - before[k] for k, v in ops.launch_counts().items()}
        print(f"[{name}] {tag}: loss={m['loss']!r} grad_norm="
              f"{m['grad_norm']!r} skipped={m['skipped']:.0f} ms={ms:.1f} "
              f"({tokens / ms * 1e3:.0f} tokens/s) peak {peak / 2 ** 30:.2f} "
              f"GiB ({peak} B; {resident / 2 ** 30:.2f} GiB resident before "
              f"the step) launches={ {k: v for k, v in per.items() if v} }",
              flush=True)
        check_step(cfg.name, tag, m, per,
                   step_launches(cfg, TRAIN_KERNELS, True) if want is None
                   else want)
        return (state if keep else None), m, ms, peak

    def rel(a, b):
        return abs(a - b) / abs(b)

    ops.reset_launch_counts()
    # 1. Remat: one step under each policy from the same state and batch,
    # after one untimed step of it (the policy's first pass pays one-off
    # costs).
    remat = {}
    for policy in REMAT_POLICIES:
        for tag in (f"remat={policy} (warm-up)", f"remat={policy}"):
            _, m, ms, peak = step(tag, kac(remat=policy),
                                  want=remat_launches(cfg, policy))
        remat[policy] = (m, ms, peak)
    m0, ms0, peak0 = remat["none"]
    for policy in REMAT_POLICIES[1:]:
        m, ms, peak = remat[policy]
        dl, dg = rel(m["loss"], m0["loss"]), rel(m["grad_norm"],
                                                 m0["grad_norm"])
        print(f"[{name}] remat={policy} vs none: loss rel diff {dl:.3e} "
              f"(limit {REMAT_LOSS_RTOL}), grad_norm rel diff {dg:.3e} "
              f"(limit {REMAT_GRAD_NORM_RTOL}); step {ms / ms0:.3f}x none's, "
              f"peak {peak / 2 ** 30:.2f} against {peak0 / 2 ** 30:.2f} GiB",
              flush=True)
        if not (dl <= REMAT_LOSS_RTOL and dg <= REMAT_GRAD_NORM_RTOL):
            fail(f"remat={policy}'s step parts from the step without remat")

    # 2. The chunked CE against the whole logits.
    _, m, ms, peak = step(f"ce_chunk={KNOBS['ce_chunk']}",
                          kac(ce_chunk=KNOBS["ce_chunk"]))
    dl = rel(m["loss"], m0["loss"])
    print(f"[{name}] ce_chunk={KNOBS['ce_chunk']} vs 0: loss rel diff "
          f"{dl:.3e} (limit {CE_CHUNK_LOSS_RTOL}); peak {peak / 2 ** 30:.2f} "
          f"against {peak0 / 2 ** 30:.2f} GiB", flush=True)
    if not dl <= CE_CHUNK_LOSS_RTOL:
        fail("the chunked CE's loss parts from the whole logits'")

    # 3. Gradient accumulation through the kernels and the plain versions.
    A = KNOBS["grad_accum"]
    tca = TrainConfig(grad_accum=A)
    _, mk, _, _ = step(f"grad_accum={A}", kac(), tc=tca, want={
        k: A * v for k, v in step_launches(cfg, TRAIN_KERNELS, True).items()})
    _, mp, _, _ = step(f"grad_accum={A}, plain versions", pac(), tc=tca,
                       want={k: 0 for k in ops.launch_counts()})
    dl, dg = rel(mk["loss"], mp["loss"]), rel(mk["grad_norm"],
                                              mp["grad_norm"])
    print(f"[{name}] grad_accum={A}, kernels vs plain: loss rel diff "
          f"{dl:.3e} (limit {LOSS_RTOL}), grad_norm rel diff {dg:.3e} "
          f"(limit {GRAD_NORM_RTOL})", flush=True)
    if not (dl <= LOSS_RTOL and dg <= GRAD_NORM_RTOL):
        fail(f"grad_accum={A} through the kernels and the plain versions "
             "disagree")

    # 4. Compression: a step each; then the error feedback's invariant on
    # two leaves for fresh gradients at the step's params.
    leaves = (("router", lambda p: p["stack"]["segments"][0]["pos0"]["ffn"]
               ["router"]["w"]),
              ("experts.wi", lambda p: p["stack"]["segments"][0]["pos0"]
               ["ffn"]["experts"]["wi"]))
    for kind in ("bf16", "int8"):
        tc = TrainConfig(compression=kind)
        st, _, _, _ = step(f"compression={kind}", kac(), tc=tc, keep=True)
        g, _ = loss_and_grads(st["params"], batch, cfg, ac=kac())
        c, e = compression.compress(g, st["residual"], kind)
        for label, leaf in leaves:
            same, back, shape = residual_exact(
                kind, leaf(g), leaf(st["residual"]), leaf(c), leaf(e))
            print(f"[{name}] compression={kind} {label} {shape}: residual "
                  f"== (g + e) - c exactly: {same}; max |c + e' - (g + e)| "
                  f"= {back:.3e}", flush=True)
            if not same:
                fail(f"compression={kind}: the residual of {label} is not "
                     "(g + e) - c")
        del st, g, c, e

    # 5. bfloat16 compute: 4 steps through the kernels, the first held
    # against the plain versions' bfloat16 loss.
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(cfg, global_batch=batch["tokens"].shape[0],
                       seq_len=batch["tokens"].shape[1], task=task)
    it.restore({"step": KNOBS["data_step"]})
    grads, plain = loss_and_grads(params, batch, cfg,
                                  ac=pac(compute_dtype="bfloat16"))
    plain = float(plain["loss"])
    del grads
    st, bf_ms = None, []
    for i in range(KNOBS["bf16_steps"]):
        st, m, ms, peak = step(f"bfloat16 step {i + 1}",
                               kac(compute_dtype="bfloat16"), state=st,
                               data=None if i == 0 else batch_to(next(it),
                                                                 device),
                               keep=True)
        bf_ms.append(ms)
        if i == 0:
            dl = rel(m["loss"], plain)
            print(f"[{name}] bfloat16 first step, kernels vs plain: loss "
                  f"{m['loss']!r} vs {plain!r}, rel diff {dl:.3e} (limit "
                  f"{BF16_STEP_LOSS_RTOL}); float32 loss {m0['loss']!r}",
                  flush=True)
            if not dl <= BF16_STEP_LOSS_RTOL:
                fail("the bfloat16 step through the kernels parts from the "
                     "plain versions'")
    later = sum(bf_ms[1:]) / len(bf_ms[1:])
    print(f"[{name}] bfloat16 steps {', '.join(f'{x:.1f}' for x in bf_ms)} "
          f"ms (after the first {later:.1f}, {tokens / later * 1e3:.0f} "
          f"tokens/s) against float32's {ms0:.1f} ms; peak "
          f"{peak / 2 ** 30:.2f} GiB against {peak0 / 2 ** 30:.2f}", flush=True)
    del st

    # 6. AdamW under the vision schedule.
    aopt = adamw(rsqrt_with_cooldown(**ADAMW_SCHEDULE))
    st = init_train_state(None, cfg, aopt,
                          params=tree_map(torch.clone, params))
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(st["opt_state"]))
    print(f"[{name}] AdamW state {nbytes} B ({nbytes / 2 ** 30:.2f} GiB; "
          f"Adafactor's: {sum(t.numel() * t.element_size() for t in tree_leaves(opt.init(params))) / 2 ** 30:.3f} GiB)", flush=True)
    for i in range(KNOBS["adamw_steps"]):
        st, _, _, _ = step(f"adamw step {i + 1}", kac(), optimizer=aopt,
                           state=st, keep=True)
    del st, params
    gc.collect()
    torch.cuda.empty_cache()

    # 7. The launcher: straight, and killed after step 2 and resumed.
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_knobs_")
    root = Path(tmp.name)
    try:
        free = shutil.disk_usage(root).free / 1e9
        if free < LAUNCH_DISK_GB:
            fail(f"{free:.1f} GB free under {root}: the launcher runs need "
                 f"{LAUNCH_DISK_GB} GB")

        t0 = time.perf_counter()
        dense_cfg = cfg.dense_parent()
        dense = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                                dense_cfg, device=device)
        condition_attention(dense, dense_cfg)
        CheckpointManager(str(root / "dense")).save(0, {"params": dense})
        del dense

        def main_args(d, obs):
            return ["--arch", KNOBS["arch"], "--steps", str(LAUNCH["steps"]),
                    "--batch", str(LAUNCH["batch"]), "--seq",
                    str(LAUNCH["seq"]), "--ckpt-dir", str(root / d),
                    "--obs-jsonl", str(root / obs), "--upcycle-from",
                    str(root / "dense"), *LAUNCH["flags"]]

        with launcher_probe() as straight:
            ltrain.main(main_args("straight", "straight.jsonl"))
        with launcher_probe(kill_after=LAUNCH["kill_after"]) as killed:
            ltrain.main(main_args("resumed", "killed.jsonl"))
        killed["runs"].clear()  # the killed run's state, on the card
        with launcher_probe() as resumed:
            ltrain.main(main_args("resumed", "resumed.jsonl"))
        k = LAUNCH["kill_after"]
        if list(killed["saved"]) != [k] or [s for s, _ in
                                            resumed["restored"]] != [k]:
            fail(f"the killed run saved {list(killed['saved'])} and the "
                 f"resumed run restored "
                 f"{[s for s, _ in resumed['restored']]}, not step {k}")
        same, worst, where = leaf_diff(killed["saved"][k],
                                       resumed["restored"][0][1])
        print(f"[{name}] launcher: the state restored at resume (params, "
              f"optimizer, residual: "
              f"{sorted(killed['saved'][k])}) vs the state saved at step "
              f"{k}: bit-identical={same}", flush=True)
        if not same:
            fail(f"the launcher's resumed state differs from the state "
                 f"saved: {worst:.3e} at {where}")
        a = train_rows(root / "straight.jsonl")
        b = {**train_rows(root / "killed.jsonl"),
             **train_rows(root / "resumed.jsonl")}
        for t in range(1, LAUNCH["steps"] + 1):
            d = rel(b[t], a[t])
            print(f"[{name}] launcher step {t}: loss {b[t]!r} vs straight "
                  f"{a[t]!r}, rel diff {d:.3e} (limit {LOSS_RTOL})",
                  flush=True)
            if not (math.isfinite(b[t]) and d <= LOSS_RTOL):
                fail(f"the launcher's resumed step {t} parts from the "
                     "straight run")
        fin_a = straight["runs"][-1]["state"]
        fin_b = resumed["runs"][-1]["state"]
        for part in ("params", "residual"):
            same, worst, where = leaf_diff(fin_b[part], fin_a[part])
            print(f"[{name}] launcher final {part} after kill-and-resume vs "
                  f"the straight run: bit-identical={same}"
                  + ("" if same else f", max rel diff {worst:.3e} at "
                     f"{where}"), flush=True)
        del straight, killed, resumed, fin_a, fin_b
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{name}] launcher runs {time.perf_counter() - t0:.1f} s",
              flush=True)

        # 8. rwkv6-7b's dense stack, 4 layers, conditioned, through the
        # launcher's ApplyCfg.
        rcfg = dataclasses.replace(get_config(RWKV_TRAIN["arch"]),
                                   n_layers=RWKV_TRAIN["layers"])
        rac = ltrain.apply_cfg(ltrain.parse_args(
            ["--arch", RWKV_TRAIN["arch"]]), device)
        rtask = ClusteredBigramTask(vocab_size=min(rcfg.vocab_size,
                                                   TASK_VOCAB))
        rit = make_iterator(rcfg, global_batch=RWKV_TRAIN["batch"],
                            seq_len=RWKV_TRAIN["seq"], task=rtask)
        before = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rparams = zoo.init_params(
            torch.Generator(device=device).manual_seed(0), rcfg,
            device=device)
        condition_rwkv(rparams, rcfg)  # as phases 10-11 serve it
        out = Trainer(rcfg, opt, rit, str(root / "rwkv"), ac=rac,
                      device=device, log_fn=lambda s: None).run(
            RWKV_TRAIN["steps"], init_params=rparams)
        del rparams
        ms = _sync_ms(t0)
        rl = {k: v - before[k] for k, v in ops.launch_counts().items()}
        loss = out["metrics"]["loss"]
        n = count_params(out["state"]["params"])
        print(f"[{name}] {rcfg.name} at {rcfg.n_layers} of 32 layers: "
              f"{n / 1e9:.3f} B params, ApplyCfg moe={rac.moe_impl} "
              f"attn={rac.attn_impl} mixer={rac.mixer_impl}; "
              f"{RWKV_TRAIN['steps']} steps of {RWKV_TRAIN['batch']} x "
              f"{RWKV_TRAIN['seq']} in {ms:.0f} ms (init included), loss "
              f"{loss!r}, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
              f" GiB, launches={ {k: v for k, v in rl.items() if v} }",
              flush=True)
        if rac.mixer_impl != "eager" or rl["rwkv6"] or not math.isfinite(loss) \
                or int(out["state"]["step"]) != RWKV_TRAIN["steps"]:
            fail(f"rwkv through the launcher's ApplyCfg: mixer "
                 f"{rac.mixer_impl}, {rl['rwkv6']} WKV launches, loss {loss}")
        del out
    finally:
        tmp.cleanup()
    launches = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{name}] launches: {launches}", flush=True)
    print(f"[{name}] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, bf16_records, bf16_fwd


# ---------------------------------------------------------------------------
# phase 17: the other families — jamba's mamba + attention + MoE hybrid,
# pixtral's patch frontend, the config-only decoders
# ---------------------------------------------------------------------------

# jamba-1.5-large-398b at full width and 5 of its 72 layers: mamba at
# 0-3, attention at 4 (the fewest layers that hold its attention layer),
# MoE at 1 and 3. The dense parent (5.93 B params, 23.7 GB in float32)
# takes one Adafactor step at 1 x 256 tokens; cast to bfloat16 and
# upcycled (copy) into the dropless MoE (24.05 B params, 48.1 GB), it is
# served in bfloat16 (weights, activations, caches; the SSM state stays
# float32) through the static engine: 4 prompts of 128..256 tokens, 16
# new each.
JAMBA = dict(arch="jamba-1.5-large-398b", layers=5, batch=1, seq=256,
             peak_lr=0.01, warmup=100, dispatch="gather", prompts=4,
             plen=(128, 256), new=16)
# The near-tie bound of jamba's bfloat16 serve (serve_static's rule: a
# divergence only at a top-2 gap below it, and only if the two paths'
# logits, fed the same tokens, part by no more). The logits come out of
# a bfloat16 head: one bf16 ulp is 2^-5 = 0.031 for a logit in [4, 8),
# and two such logits tie exactly (gap 0) often. Fed the same tokens the
# kernels' and the plain path part by one ulp (3.125e-2 over 16 steps;
# the prefill logits too), and a greedy row parts at a gap of 0
# (measured on an NVIDIA H100 80GB HBM3 at 700 W). The bound allows four
# ulps, for the run-to-run order of the combine's float atomics; a
# wrong kernel moves the logits by O(1).
JAMBA_TIE_GAP = 0.125
# pixtral-12b at full width and 4 of 40 layers (2.46 B params, 9.8 GB in
# float32): 2 Adafactor steps at 4 x 1,152 positions of the port's patch
# stream (1,024 patches, 128 tokens), the first held and witnessed; then
# 4 requests decoded greedily, each a prefill of 1,024 patches and 128
# tokens, then 16 new tokens.
PIXTRAL = dict(arch="pixtral-12b", layers=4, batch=4, seq=1152, steps=2,
               peak_lr=0.01, warmup=100, dispatch="gather", new=16,
               data_step=1000)
# The config-only decoders through the static engine, float32 (arch,
# layers kept: None = all), 4 prompts of 64..128 tokens, 8 new each.
DECODERS = (("qwen2.5-14b", 2), ("yi-9b", 2), ("grok-1-314b", 1),
            ("tinyllama-1.1b", None))
DECODER_STATIC = dict(prompts=4, plen=(64, 128), new=8)


def _dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def mamba_decode_share(eng, prompts, steps: int = 3) -> float:
    """The mamba layers' share of a static decode step through ``eng``:
    each ``ssm.mamba_apply`` call timed on the host between two
    synchronisations, over ``steps`` decode steps after a prefill, and
    divided by those steps' time (synchronised the same way)."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import ssm

    B, plen = len(prompts), max(len(p) for p in prompts)
    toks = torch.zeros(B, plen, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    spent = [0.0]
    real = ssm.mamba_apply

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    with torch.no_grad():
        cache = zoo.init_serve_cache(eng.cfg, B, plen + steps,
                                     dtype=eng.cache_dtype, device=eng.device)
        cache, lg = zoo.prefill(eng.params, {"tokens": toks.to(eng.device)},
                                cache, eng.cfg, ac=eng.ac)
        cur = lg[:, -1].argmax(-1)[:, None]
        ssm.mamba_apply = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in range(steps):
                cache, lg = zoo.decode_step(eng.params, cur, cache, plen + s,
                                            eng.cfg, ac=eng.ac)
                cur = lg[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            ssm.mamba_apply = real
    print(f"[jamba] mamba layers in a decode step: {spent[0] / steps * 1e3:.2f}"
          f" of {total / steps * 1e3:.2f} ms (share {spent[0] / total:.3f}; "
          f"each mamba call and the step synchronised)", flush=True)
    return spent[0] / total


def jamba_path(device):
    """Phase 17 (a) and (b). (a) jamba's dense parent (float32, attention
    conditioned) takes one Adafactor step through the kernels, held
    against the same step through the plain versions (LOSS_RTOL,
    GRAD_NORM_RTOL), every flash call of it witnessed; (b) cast to
    bfloat16, upcycled and served (serve_static with JAMBA_TIE_GAP),
    launches exact, one prefill and decode step witnessed, the mamba
    layers' share of a decode step printed. Returns (launches by path,
    the expert FFN's timing rows at the serve buffers, the MoE
    config)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import stack as stk
    from repro_torch.models.param import count_params, tree_map
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.optim.base import global_norm
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.train_loop import batch_to, loss_and_grads

    spec, name = JAMBA, "jamba"
    t0 = time.perf_counter()
    cfg = _dropless(dataclasses.replace(get_config(spec["arch"]),
                                        n_layers=spec["layers"]))
    dense_cfg = cfg.dense_parent()
    gen = torch.Generator(device=device).manual_seed(0)
    params = zoo.init_params(gen, dense_cfg, device=device)
    condition_attention(params, dense_cfg)
    opt = adafactor(inverse_sqrt(peak=spec["peak_lr"],
                                 warmup_steps=spec["warmup"]))
    state = init_train_state(None, dense_cfg, opt, params=params)
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    batch = batch_to(next(make_iterator(
        dense_cfg, global_batch=spec["batch"], seq_len=spec["seq"],
        task=task)), device)
    torch.cuda.synchronize()
    print(f"[{name}] {dense_cfg.name} at {cfg.n_layers} of 72 layers "
          f"{[(d.mixer, d.ffn) for d in stk.layer_descs(cfg)]}: "
          f"{count_params(params) / 1e9:.3f} B params (float32), init "
          f"{time.perf_counter() - t0:.1f} s; batch {spec['batch']} x "
          f"{spec['seq']}", flush=True)
    kern_ac = zoo.ApplyCfg(moe_impl="cuda", attn_impl="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    grads, m = loss_and_grads(params, batch, dense_cfg, ac=zoo.ApplyCfg(
        moe_impl="eager", attn_impl="eager"))
    gn, loss = float(global_norm(grads)), float(m["loss"])
    del grads
    plain_ms = _sync_ms(t1)
    if any(ops.launch_counts().values()):
        fail(f"jamba's plain step launched kernels: {ops.launch_counts()}")
    with witnessed_kernels() as wit:
        grads, _ = loss_and_grads(params, batch, dense_cfg, ac=kern_ac)
        torch.cuda.synchronize()
    del grads
    report_witness(wit, FLASH_KERNELS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    state, km = make_train_step(dense_cfg, opt, ac=kern_ac)(state, batch)
    ms = _sync_ms(t1)
    per = ops.launch_counts()
    km = {k: float(v) for k, v in km.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[{name}] dense step through the kernels: loss={km['loss']!r} "
          f"grad_norm={km['grad_norm']!r} ms={ms:.1f} peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak} B); plain versions: "
          f"loss={loss!r} grad_norm={gn!r} ({plain_ms:.0f} ms); launches="
          f"{ {k: v for k, v in per.items() if v} }", flush=True)
    check_step(name, "dense", km, per,
               step_launches(dense_cfg, FLASH_KERNELS, False))
    d_loss, d_gn = abs(km["loss"] - loss) / abs(loss), abs(
        km["grad_norm"] - gn) / abs(gn)
    print(f"[check] {name} dense step, kernels vs plain: loss rel diff "
          f"{d_loss:.3e} (limit {LOSS_RTOL}), grad_norm rel diff {d_gn:.3e} "
          f"(limit {GRAD_NORM_RTOL})", flush=True)
    if not (d_loss <= LOSS_RTOL and d_gn <= GRAD_NORM_RTOL):
        fail("jamba's dense step through the kernels and through the plain "
             "versions disagree")
    train_launches = {k: v for k, v in per.items() if v}

    # (b) bfloat16: the trained parent cast, the float32 copy freed, then
    # upcycled.
    parent = tree_map(lambda t: t.to(torch.bfloat16), state["params"])
    del state, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    sparse = upcycle_params(parent, dense_cfg, cfg, gen)
    del parent
    torch.cuda.empty_cache()
    n_moe = sum(d.ffn == "moe" for d in stk.layer_descs(cfg))
    print(f"[{name}] upcycled ({cfg.moe.expert_init}, {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.top_k} in {n_moe} layers, capacity factor "
          f"{cfg.moe.capacity_factor}) in bfloat16: "
          f"{count_params(sparse) / 1e9:.3f} B params in "
          f"{_sync_ms(t1):.0f} ms; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated",
          flush=True)
    prompts = static_prompts(cfg, spec["prompts"], spec["plen"], seed=17)
    new = spec["new"]
    ac = zoo.ApplyCfg(compute_dtype="bfloat16")
    expect = {"flash_attention": 1, "expert_mlp": n_moe * new}
    torch.cuda.reset_peak_memory_stats()
    launches, eng = serve_static(
        name, sparse, cfg, device, prompts, new, 1, expect, ac=ac,
        serve=dict(RWKV_SERVE, cache_dtype="bfloat16"), tie=JAMBA_TIE_GAP)
    witness_static_step(name, eng, prompts, tuple(expect))
    mamba_decode_share(eng, prompts)
    del eng
    torch.cuda.empty_cache()
    experts = model_experts(sparse)
    B, plen = len(prompts), max(len(p) for p in prompts)
    rows = [expert_shape_row(name, cfg, experts, n, device, seed=s,
                             iters=it, dtype="bfloat16")
            for n, s, it in ((B * plen, 31, 5), (B, 32, 20))]
    del sparse, experts
    print(f"[{name}] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return ({"jamba_train": train_launches, "jamba_static": launches},
            [(k, f"jamba_static_{ph}", r)
             for (k, _, r), ph in zip(rows, ("prefill", "decode"))], cfg)


def pixtral_path(device):
    """Phase 17 (c): pixtral-12b at full width and 4 layers (float32,
    attention conditioned) takes PIXTRAL's 2 steps on its patch stream
    through the flash kernels, each step's launches checked, the first
    held and witnessed against the plain versions; then greedy decoding
    of 4 requests (1,024 patches and 128 tokens a prompt) through the
    kernels and the plain versions: token-identical (a divergence only
    at a top-2 gap below TIE_GAP), the kernels' launches exact (the
    prefill's flash forward once a layer; the decode steps attend over
    the dense cache outside any kernel), one prefill and decode step
    witnessed. Returns (launches by path, the config)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params, tree_map
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    spec, name = PIXTRAL, "pixtral"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    opt = adafactor(inverse_sqrt(peak=spec["peak_lr"],
                                 warmup_steps=spec["warmup"]))
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(cfg, global_batch=spec["batch"], seq_len=spec["seq"],
                       task=task)
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    condition_attention(params, cfg)
    first_params = tree_map(torch.clone, params)
    state = init_train_state(None, cfg, opt, params=params)
    n_patch = min(cfg.n_frontend_positions, spec["seq"])
    print(f"[{name}] {cfg.name} at {cfg.n_layers} of 40 layers: "
          f"{count_params(params) / 1e9:.3f} B params; batch {spec['batch']} "
          f"x {spec['seq']} positions ({n_patch} patches, "
          f"{spec['seq'] - n_patch} tokens; task vocab {task.vocab_size})",
          flush=True)
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(
        dispatch=spec["dispatch"], moe_impl="cuda", attn_impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    want = step_launches(cfg, FLASH_KERNELS, False)
    first_batch, first = None, None
    for i in range(spec["steps"]):
        batch = next(it)
        if batch["patch_embeds"].shape != (spec["batch"], n_patch,
                                           cfg.d_model):
            fail(f"pixtral's stream gave patches "
                 f"{batch['patch_embeds'].shape}")
        before = ops.launch_counts()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        ms = _sync_ms(t1)
        m = {k: float(v) for k, v in m.items()}
        per = {k: v - before[k] for k, v in ops.launch_counts().items()}
        print(f"[{name}] step {int(state['step'])}: loss={m['loss']:.5f} "
              f"grad_norm={m['grad_norm']:.5f} skipped={m['skipped']:.0f} "
              f"ms={ms:.1f} ({spec['batch'] * spec['seq'] / ms * 1e3:.0f} "
              f"positions/s) launches={ {k: v for k, v in per.items() if v} }",
              flush=True)
        check_step(name, "dense", m, per, want)
        if i == 0:
            first_batch, first = batch, m
    train_launches = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"[{name}] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
          f" GiB", flush=True)
    del state
    compare_first_moe_step(cfg, device, first_params, first_batch, first, spec,
                           FLASH_KERNELS, label="first step")
    it.step = spec["data_step"]
    batch = next(it)
    # The prefill's flash forward once a layer; the decode steps attend
    # over the dense cache outside any kernel.
    expect = hold_greedy(name, first_params, cfg, device, batch,
                         spec["seq"], spec["new"],
                         {"flash_attention": cfg.n_layers},
                         f"{spec['batch']} x {spec['seq']} ({n_patch} "
                         "patches)")
    del first_params
    print(f"[{name}] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"pixtral_train": train_launches, "pixtral_decode": expect}, cfg


def grouped_shape_row(tag, cfg, experts, device, *, seed, **case):
    """The grouped forward where the paged mixed step runs it: the
    ragged buffer of grouped_case at ``cfg``'s top-k and expert count
    (136 rows, skewed, two experts empty; or ``case``'s), through the
    served model's own expert weights of one MoE layer (random ones for
    ``experts`` None), float32, held against the plain version
    (TOL["float32"]), timed beside it (synchronised per call: it reads
    the sizes on the host) and the library chain."""
    import torch

    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    g = grouped_case(cfg, torch.float32, device,
                     torch.Generator(device=device).manual_seed(seed),
                     **case)
    if experts is not None:
        g.update(wi=experts["wi"], wg=experts["wg"], wo=experts["wo"])
    args = (g["xs"], g["wi"], g["wg"], g["wo"], g["counts"])
    kern = lambda: gm.grouped_mlp_cuda(*args)  # noqa: E731
    plain = lambda: ref.grouped_mlp_ref(*args, block=gm.ROW_BLOCK)  # noqa
    y, y_ref = kern(), plain()
    torch.cuda.synchronize()
    err, ratio = _max_err(y, y_ref, *TOL["float32"])
    print(f"[{tag}] grouped_mlp float32: max |kernel - plain| = {err:.3e}, "
          f"max err / limit = {ratio:.3f}", flush=True)
    if not ratio <= 1.0:
        fail(f"{tag} grouped_mlp: kernel and plain version differ beyond "
             f"their tolerance (ratio {ratio:.3g})")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    nbytes, flops = grouped_case_work(g, "fwd")
    lib_ms, chain = time_library_ms(grouped_library(g, "fwd", f"[{tag}]"),
                                    flush=flush)
    rec = _record("grouped_mlp", "", "", err, time_ms(kern, flush=flush),
                  time_synced_ms(plain, flush=flush), nbytes, flops, lib_ms)
    row = {k: v for k, v in rec.items() if k not in (
        "name", "route", "source", "replaces")}
    row.update(library_chain=chain[0] if chain else None, dtype="float32",
               shape=[int(g["counts"].sum()), *g["wi"].shape])
    print(f"[{tag}] grouped_mlp float32: ms={row['ms']:.4f} plain_ms="
          f"{row['plain_ms']:.4f} library_ms={lib_ms} "
          f"{_bounds_text(rec)} ({nbytes} B, {flops} FLOP)", flush=True)
    return "grouped_mlp", tag, row


def qwen_paged_path(device):
    """Phase 17 (d): qwen1.5-0.5b (tied embeddings, QKV bias) at full
    width and depth, its dense parent (attention conditioned) upcycled
    into qwen1_5_0_5b.upcycled() (32 experts top-2, every other layer),
    dropless, serving phase 4's 12 requests with phase 4's settings
    through the paged chunked engine, through the kernels and the plain
    versions: token-identical (check_tokens), one step signature, no
    block leaked, the decode and paged prefill kernels launched once an
    attention layer and the grouped forward once a MoE layer every mixed
    step; one mixed step witnessed (compare_mixed_step). Returns
    (launches by path, the timing row of the grouped forward)."""
    import torch

    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import stack as stk
    from repro_torch.models.param import count_params
    from repro_torch.serve import ServeConfig, ServeEngine

    name = "qwen1.5"
    t0 = time.perf_counter()
    cfg = _dropless(qwen1_5_0_5b.upcycled())
    dense_cfg = cfg.dense_parent()
    gen = torch.Generator(device=device).manual_seed(0)
    parent = zoo.init_params(gen, dense_cfg, device=device)
    condition_attention(parent, dense_cfg)
    n_dense = count_params(parent)
    params = upcycle_params(parent, dense_cfg, cfg, gen)
    del parent
    descs = stk.layer_descs(cfg)
    L, n_moe = len(descs), sum(d.ffn == "moe" for d in descs)
    print(f"[{name}] {dense_cfg.name}: {n_dense / 1e9:.3f} B params -> "
          f"upcycled ({cfg.moe.num_experts} experts top-{cfg.moe.top_k} in "
          f"{n_moe} of {L} layers, dropless): {count_params(params) / 1e9:.3f}"
          f" B params; tied head {'head' not in params or not params['head']}",
          flush=True)
    sc = ServeConfig(paged=True, **SERVE)
    eng = ServeEngine(params, cfg, sc, device=device)
    eng.serve(make_requests(cfg)[:1])  # warm-up
    outs, launches = {}, None
    rids = [r.rid for r in make_requests(cfg)]
    for key, e in (("kernels", eng), ("plain", ServeEngine(
            params, cfg, sc, device=device,
            ac=zoo.ApplyCfg(moe_impl="eager", attn_impl="eager")))):
        ops.reset_launch_counts()
        outs[key], finished, n_gen, wall = serve_once(e, cfg)
        ran = {k: v for k, v in ops.launch_counts().items() if v}
        st = e.last_stats
        print(f"[{name}] {key}: {n_gen} tokens in {wall:.3f} s = "
              f"{n_gen / wall:.1f} tokens/s, mixed_steps={st['mixed_steps']}, "
              f"prefix_hit_frac={st['prefix_hit_frac']:.3f}, compile_count="
              f"{st['compile_count']}, free_blocks_at_close="
              f"{st['free_blocks_at_close']}, launches={ran}", flush=True)
        want_free = sc.max_batch * -(-sc.max_len // sc.block_size)
        if st["compile_count"] != 1 or st["free_blocks_at_close"] != want_free:
            fail(f"{name} {key}: compile_count {st['compile_count']}, "
                 f"{st['free_blocks_at_close']} blocks free at close, not "
                 f"{want_free}")
        if any(rec["status"] != "completed" for rec in finished.values()):
            fail(f"{name} {key}: not every request completed")
        want = ({"decode_attention": L * st["mixed_steps"],
                 "paged_prefill": L * st["mixed_steps"],
                 "grouped_mlp": n_moe * st["mixed_steps"]}
                if key == "kernels" else {})
        if ran != want:
            fail(f"{name} {key}: launched {ran}, expected {want}")
        if key == "kernels":
            launches = ran
    check_tokens(f"{name} greedy outputs vs the plain run", outs["kernels"],
                 outs["plain"], rids, eng)
    del eng, e
    step_err = compare_mixed_step(params, cfg, device)
    print(f"[check] {name} one mixed step, kernels vs plain: max |logit "
          f"diff| = {step_err:.3e} (atol {STEP_ATOL})", flush=True)
    if not step_err <= STEP_ATOL:
        fail(f"{name} mixed step logits differ by {step_err:.3e}")
    row = grouped_shape_row(f"{name}_mixed", cfg, model_experts(params),
                            device, seed=41)
    del params
    print(f"[{name}] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"qwen15_paged": launches}, row


def decoders_path(device):
    """Phase 17 (e): each of DECODERS at full width and its cut depth
    (float32, attention conditioned, dropless), served through the
    static engine (serve_static) through the kernels and the plain
    versions, launches exact (the flash forward once an attention layer
    at the prefill; the expert FFN once a MoE layer a step), one prefill
    and decode step witnessed, each model freed before the next; the
    flash forward timed at the prefills of the GQA groups 5, 6 and 8.
    Returns (launches by path, timing rows)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import stack as stk
    from repro_torch.models.param import count_params

    launches, rows, groups = {}, [], set()
    spec = DECODER_STATIC
    for i, (arch, layers) in enumerate(DECODERS):
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = _dropless(dataclasses.replace(
            full, n_layers=layers or full.n_layers))
        params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                                 cfg, device=device)
        condition_attention(params, cfg)
        descs = stk.layer_descs(cfg)
        n_moe = sum(d.ffn == "moe" for d in descs)
        group = cfg.n_heads // cfg.n_kv_heads
        print(f"[{arch}] {cfg.n_layers} of {full.n_layers} layers: "
              f"{count_params(params) / 1e9:.3f} B params (float32), heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim} (group "
              f"{group}), qkv_bias {cfg.qkv_bias}, tied {cfg.tie_embeddings}"
              + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} in "
                 f"{n_moe} layers (dropless)" if n_moe else ""), flush=True)
        prompts = static_prompts(cfg, spec["prompts"], spec["plen"],
                                 seed=40 + i)
        expect = {"flash_attention": len(descs)}
        if n_moe:
            expect["expert_mlp"] = n_moe * spec["new"]
        ran, eng = serve_static(arch, params, cfg, device, prompts,
                                spec["new"], 1, expect)
        witness_static_step(arch, eng, prompts, tuple(expect))
        launches[f"{arch}_static"] = ran
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        if group in (5, 6, 8) and group not in groups:
            groups.add(group)
            B, plen = len(prompts), max(len(p) for p in prompts)
            k, _, row = flash_shape_row(arch, cfg, B, plen, device,
                                        seed=50 + i)
            rows.append((k, f"{arch}_prefill_group{group}", row))
        print(f"[{arch}] {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, rows


def other_families(device):
    """Phase 17: jamba (a, b), pixtral (c), qwen1.5's upcycled MoE paged
    (d), the config-only decoders (e); then the flash kernels held and
    timed at jamba's and pixtral's training shapes (dh 128, groups 8
    and 4). Returns (launches by path, timing rows)."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[other-families] {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          "GiB allocated at the start (jamba's dense step needs ~71 GiB at "
          "its peak)", flush=True)
    launches, rows, jcfg = jamba_path(device)
    gc.collect()
    torch.cuda.empty_cache()
    got, pcfg = pixtral_path(device)
    launches.update(got)
    gc.collect()
    torch.cuda.empty_cache()
    got, row = qwen_paged_path(device)
    launches.update(got)
    rows.append(row)
    gc.collect()
    torch.cuda.empty_cache()
    got, more = decoders_path(device)
    launches.update(got)
    rows += more
    rows += [(k, "jamba_train", r) for k, _, r in flash_case_rows(
        "jamba_train", jcfg, JAMBA["batch"], JAMBA["seq"], JAMBA["seq"],
        True, device, seed=61)]
    rows += [(k, "pixtral_train", r) for k, _, r in flash_case_rows(
        "pixtral_train", pcfg, PIXTRAL["batch"], PIXTRAL["seq"],
        PIXTRAL["seq"], True, device, seed=62)]
    print(f"[other-families] phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# phase 18: multi-GPU — the deterministic MoE combine, the launcher's
# --ep a2a in one process, expert parallelism over two ranks sharing the
# card, query-head padding through the flash kernels
# ---------------------------------------------------------------------------

# Granite at full width, 1 MoE step at a global 8 x 512 (phase 12's
# batch) over 2 ranks of mesh (data=1, model=2): 16 of the 32 experts a
# rank, budget factor 2.0 (= ep: no EP drops), then one forward at a
# starved factor. The ranks share the one card: NCCL refuses two ranks
# on one device, so they talk through gloo, which stages CUDA tensors
# through host memory — the all-to-all numbers below measure that host
# transport on one card, not NCCL.
# Routing groups of 2,048 tokens, one a rank: at the config's 4,096 the
# 8 x 512 batch is one group, which no mesh of 2 ranks can split (the
# reference raises the same divisibility error). The starved forward
# also raises the capacity factor to 4.0, as the reference's overflow
# test does: at 2.0 a group keeps at most 32 x 128 assignments, 2,048 a
# peer, which a budget of 0.25 x 16,384 / 2 = 2,048 rows still holds.
# One step (two until phase 20 joined the smoke: its time limit).
MULTI = dict(arch="granite-moe-1b-a400m", batch=8, seq=512, steps=1,
             ranks=2, factor=2.0, starved=0.25, starved_capacity=4.0,
             group=2048, peak_lr=0.01, warmup=100, layers=12)
# The 2-rank steps against the single-process steps: the tolerances of
# the reference's distributed step (tests/test_system.py), on every leaf.
MULTI_LOSS_RTOL, MULTI_PARAM_ATOL, MULTI_PARAM_RTOL = 2e-4, 2e-4, 2e-3
# Query-head padding through the flash kernels: qwen2.5-14b at 2 layers,
# 40/8 heads padded to 48/8 at multiple 16, logits held at STEP_ATOL.
PAD = dict(arch="qwen2.5-14b", layers=2, multiple=16, batch=2, seq=256)
# The scatter/gather device time of granite's train step before the
# fixed-order combine (PERF.md §5: f32, bf16).
ATOMIC_MS = {"float32": 28.1, "bfloat16": 53.2}


def combine_determinism(device):
    """Phase 18 (a): two calls of one MoE layer at granite's full width
    give identical bits — forward, and forward + backward — for the
    gather and sorted dispatches at the training shape (16 x 512) and
    the serve step's rows; the combine's device time; and phase 4's MoE
    serve at the reference init, run twice, token for token."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import routing as R
    from repro_torch.core.moe import moe_apply, moe_init
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import tree_leaves
    from repro_torch.serve import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    full = get_config(MULTI["arch"])
    dropless = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=float(full.moe.num_experts)))
    d = full.d_model
    gen = torch.Generator(device=device).manual_seed(3)
    p = moe_init(gen, full, full.moe, device=device)
    serve_rows = SERVE["max_batch"] + SERVE["chunks_per_step"] * \
        SERVE["chunk_size"]
    for tag, cfg, shape in (
            ("train", full, (TRAIN["batch"], TRAIN["seq"], d)),
            ("serve", dropless, (serve_rows, d))):
        x = torch.randn(shape, generator=gen, device=device)
        for dispatch in ("gather", "sorted"):
            outs = []
            for _ in range(2):
                leaves = [x, *tree_leaves(p)]
                for t in leaves:
                    t.requires_grad_(True)
                y, _ = moe_apply(p, x, cfg, cfg.moe, dispatch=dispatch,
                                 implementation="cuda")
                g = torch.autograd.grad((y.float() ** 2).sum(), leaves)
                for t in leaves:
                    t.requires_grad_(False)
                outs.append((y.detach(), g))
            same_y = torch.equal(outs[0][0], outs[1][0])
            same_g = all(torch.equal(a, b) for a, b in zip(outs[0][1],
                                                           outs[1][1]))
            print(f"[determinism] {tag} {tuple(shape)} {dispatch}: two "
                  f"calls bit-identical: forward={same_y} "
                  f"gradients={same_g}", flush=True)
            if not (same_y and same_g):
                fail(f"the {dispatch} MoE layer at the {tag} shape does "
                     "not repeat bit for bit")
        del x, outs, y, g

    # The sorted dispatch's data movement at the training shape, forward
    # and backward (take each ragged row from its token, weight the
    # rows, combine them into their tokens), per layer and for granite's
    # 24 MoE layers, on one routing: the fixed-order row maps
    # (``R.take_rows`` / ``R.sum_rows``) against the atomic forms they
    # replaced (an expanded-index gather, ``scatter_add``), each timed
    # the same way in this run.
    from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_destinations

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    E = full.moe.num_experts
    xt = torch.randn((TRAIN["batch"] * TRAIN["seq"], d), generator=gen,
                     device=device)
    g = full.moe.group_size
    G = xt.shape[0] // g
    r = R.route((xt @ p["router"]["w"]).reshape(G, g, E), full.moe,
                "top_k", slot_tables=False)
    tok, eid, w = R.assignment_stream(r, E, g)
    key = torch.where(eid < E, eid, torch.full_like(eid, E)).to(torch.int32)
    perm, key_s, _, dest, M = ragged_destinations(key, E, ROW_BLOCK)
    row_of = torch.empty_like(dest, dtype=torch.int64).scatter_(
        1, perm.long(), dest.long())
    gi = torch.arange(G, device=device)[:, None]
    row_of = torch.where(row_of < M, gi * M + row_of, G * M)
    m = R.row_map(row_of.reshape(G * g, -1), G * M)
    wv = torch.where(eid < E, w, torch.zeros_like(w))
    wr = wv.new_zeros(G * M + 1).index_copy(0, row_of.reshape(-1),
                                            wv.reshape(-1))[:G * M]
    src = m.src.reshape(G, M) - gi * g  # group-local; g or more: none
    src = torch.clamp(src, max=g)
    del xt, r, key, perm, key_s, dest
    for dtype in (torch.float32, torch.bfloat16):
        xg = torch.randn((G, g, d), generator=gen, device=device,
                         dtype=dtype, requires_grad=True)
        ys = torch.randn((G, M, d), generator=gen, device=device,
                         dtype=dtype, requires_grad=True)

        def fixed():
            xs = R.take_rows(xg.reshape(G * g, d), m)
            yw = (ys.reshape(G * M, d) * wr[:, None]).to(dtype)
            y = R.sum_rows(yw, m)
            torch.autograd.backward([xs, y], [torch.ones_like(xs),
                                              torch.ones_like(y)])

        def atomic():
            idx = torch.clamp(src, max=g - 1)[..., None].expand(G, M, d)
            xs = torch.gather(xg, 1, idx) * (src < g)[..., None].to(dtype)
            yw = (ys * wr.reshape(G, M)[..., None]).to(dtype)
            y = torch.zeros((G, g + 1, d), dtype=dtype, device=device)
            y = y.scatter_add(1, src[..., None].expand(G, M, d), yw)[:, :g]
            torch.autograd.backward([xs, y], [torch.ones_like(xs),
                                              torch.ones_like(y)])

        ms = time_ms(fixed, flush=flush, iters=5)
        ms_atomic = time_ms(atomic, flush=flush, iters=5)
        name = "float32" if dtype == torch.float32 else "bfloat16"
        print(f"[determinism] sorted dispatch's data movement (take, "
              f"weight, combine), forward and backward, {name}, G={G} "
              f"g={g} k={full.moe.top_k} d={d}: fixed order {ms:.3f} ms a "
              f"layer ({24 * ms:.1f} ms for 24 layers), atomic "
              f"{ms_atomic:.3f} ms ({24 * ms_atomic:.1f}); granite's step "
              f"traced {ATOMIC_MS[name]} ms of atomic scatter/gather "
              f"(PERF.md §5); {card_line()}", flush=True)
        del xg, ys
    del p, flush, m, wr, src, row_of
    torch.cuda.empty_cache()

    # Phase 4's serve at the package's own init (not conditioned), twice.
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             dropless, device=device)
    eng = ServeEngine(params, dropless, ServeConfig(paged=True, **SERVE),
                      device=device)
    before = ops.launch_counts()
    runs = [serve_once(eng, dropless)[0] for _ in range(2)]
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    same = runs[0] == runs[1]
    print(f"[determinism] phase 4's MoE serve at the reference init, run "
          f"twice: token-identical={same} ({len(runs[0])} requests)",
          flush=True)
    if not same:
        fail("the MoE serve at the reference init does not repeat token "
             "for token")
    del eng, params, runs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[determinism] phase 18 (a) {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher_ep_world1(device, root):
    """Phase 18 (b): ``launch.train.main`` in a world of one NCCL rank,
    ``--ep a2a`` against ``--ep none`` at granite's full width (2 steps
    at 8 x 512, sorted dispatch): no mesh can host expert parallelism,
    so --ep a2a runs the single-device path — the same bits."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ltrain

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    before = ops.launch_counts()
    try:
        outs = {}
        for ep in ("a2a", "none"):
            outs[ep] = ltrain.main([
                "--arch", MULTI["arch"], "--steps", str(MULTI["steps"]),
                "--batch", str(MULTI["batch"]), "--seq", str(MULTI["seq"]),
                "--dispatch", "sorted", "--ep", ep, "--ckpt-dir",
                str(root / f"launch_{ep}")])
            outs[ep] = {"state": host_snapshot(outs[ep]["state"]),
                        "metrics": outs[ep]["metrics"]}
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    same, worst, where = leaf_diff(outs["a2a"]["state"],
                                   outs["none"]["state"])
    print(f"[multi] launcher, 1 NCCL rank: --ep a2a vs --ep none after "
          f"{MULTI['steps']} steps: state bit-identical={same}, losses "
          f"{outs['a2a']['metrics']['loss']!r} / "
          f"{outs['none']['metrics']['loss']!r}; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not same:
        fail(f"--ep a2a in one process parts from --ep none: {worst:.3e} "
             f"at {where}")
    return launches


def multi_setup(device):
    """(cfg, upcycled params on ``device``, the data iterator): granite
    at full width and MULTI's layers with ep="a2a", upcycled (copy init,
    routers from seed 7) from the package's dense init with its
    attention conditioned — the same bits in every process."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo

    full = dataclasses.replace(get_config(MULTI["arch"]),
                               n_layers=MULTI["layers"])
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, ep="a2a", ep_budget_factor=MULTI["factor"],
        group_size=MULTI["group"]))
    dense_cfg = cfg.dense_parent()
    dense = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                            dense_cfg, device=device)
    condition_attention(dense, dense_cfg)
    params = upcycle_params(dense, dense_cfg, cfg,
                            torch.Generator(device=device).manual_seed(7))
    del dense
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(cfg, global_batch=MULTI["batch"],
                       seq_len=MULTI["seq"], task=task)
    return cfg, params, it


def multi_step_fns(cfg, **kw):
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import make_train_step

    opt = adafactor(inverse_sqrt(peak=MULTI["peak_lr"],
                                 warmup_steps=MULTI["warmup"]))
    ac = zoo.ApplyCfg(dispatch="sorted", moe_impl="cuda", attn_impl="cuda")
    return opt, ac, make_train_step(cfg, opt, ac=ac, **kw)


def ep_rank(rank, world, root):
    """One rank of phase 18 (c), in a process of its own on cuda:0."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.core import ep as ep_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import build_all
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params
    from repro_torch.sharding import ShardCtx, train_layout
    from repro_torch.training import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            rank=rank, world_size=world)
    build_all(ops.KERNELS)  # built by the parent: binds only
    # The mesh names the ranks (its device type only matters to DTensor,
    # which the port does not use); the tensors live on cuda:0. The
    # expert-only layout, asked for explicitly (tensor_parallel False):
    # for_mesh's ctx composes expert parallelism with the rules'
    # placement (phase 22).
    ctx = dataclasses.replace(
        ShardCtx.for_mesh(make_mesh((1, world), ("data", "model"),
                                    device_type="cpu")),
        tensor_parallel=False)
    tag = f"[multi rank {rank}]"
    cfg, params, it = multi_setup(device)
    opt, ac, _ = multi_step_fns(cfg)
    state = init_train_state(None, cfg, opt, params=params)
    del params
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    gc.collect()
    torch.cuda.empty_cache()
    _, _, step = multi_step_fns(cfg, layout=layout)
    print(f"{tag} {count_params(state['params']) / 1e9:.3f} B params held "
          f"({cfg.moe.num_experts // world} of {cfg.moe.num_experts} "
          f"experts), {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB "
          "allocated", flush=True)

    # The all-to-alls of the dispatch (forward): bytes and host seconds
    # of the gloo exchange, synchronised around each call.
    a2a = {"calls": 0, "bytes": 0, "s": 0.0}
    real = ep_mod._all_to_all

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(x, group)
        out = out + 0 if out.is_floating_point() else out  # wait for it
        torch.cuda.synchronize()
        a2a["calls"] += 1
        a2a["bytes"] += x.numel() * x.element_size()
        a2a["s"] += time.perf_counter() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    want = step_launches(cfg, TRAIN_KERNELS, True)
    losses, times, mets = [], [], []
    for i in range(MULTI["steps"]):
        batch = next(it)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        if i == 0:
            ep_mod._all_to_all = timed
            with witnessed_kernels() as wit:
                state, m = step(state, batch)
                torch.cuda.synchronize()
            ep_mod._all_to_all = real
        else:
            state, m = step(state, batch)
        ms = _sync_ms(t0)
        m = {k: float(v) for k, v in m.items()}
        per = {k: v - before[k] for k, v in ops.launch_counts().items()}
        ran = {k: v for k, v in per.items() if v}
        print(f"{tag} step {i + 1}: loss={m['loss']!r} "
              f"grad_norm={m['grad_norm']!r} ep_overflow_frac_sum="
              f"{m['ep_overflow_frac_sum']!r} ms={ms:.1f}"
              + (" (witnessed, all-to-alls synchronised)" if i == 0
                 else "") + f" launches={ran}", flush=True)
        check_step("multi", f"rank {rank}", m, per, want)
        if i == 0:
            report_witness(wit, TRAIN_KERNELS)
            first = layout.gather(state)["params"]
            if rank == 0:
                torch.save(host_snapshot(first), f"{root}/ep_params.pt")
            del first
        losses.append(m["loss"])
        times.append(ms)
        mets.append(m)
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()

    # The starved budget: one forward at factor 0.25, capacity 4.0.
    starved = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_budget_factor=MULTI["starved"],
        capacity_factor=MULTI["starved_capacity"]))
    from repro_torch.training.train_loop import batch_to

    with torch.no_grad():
        local = batch_to(next(it), device)
        loss, sm = zoo.loss_fn(state["params"], local, starved,
                               ac=ac.resolve(device), ctx=ctx)
    over = float(sm["ep_overflow_frac_sum"]) / float(sm["moe_layer_count"])
    print(f"{tag} starved budget (factor {MULTI['starved']}, capacity "
          f"{MULTI['starved_capacity']}): mean "
          f"ep_overflow_frac {over!r} over the MoE layers, loss "
          f"{float(loss)!r}", flush=True)
    if not (over > 0 and math.isfinite(float(loss))):
        fail(f"{tag} the starved budget dropped nothing or gave a "
             "non-finite loss")
    with open(f"{root}/ep_rank{rank}.json", "w") as fh:
        json.dump({"losses": losses, "ms": times, "peak": peak,
                   "launches": launches, "a2a": a2a,
                   "overflow": [m["ep_overflow_frac_sum"] for m in mets],
                   "starved": over}, fh)
    dist.destroy_process_group()


def ep_two_ranks(device, root):
    """Phase 18 (c): granite at full width over 2 ranks sharing the
    card, expert-parallel, held against the single-process sorted
    steps on the same weights and batches. Returns the ranks' launches
    ({"multi_rank0": ..., "multi_rank1": ...})."""
    import torch

    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.kernels import ops
    from repro_torch.training import TrainConfig, init_train_state

    t_phase = time.perf_counter()
    # The single-process reference first; what the comparison needs goes
    # to the host and the card is freed before the ranks start.
    cfg, params, it = multi_setup(device)
    # Each step in MULTI["ranks"] microbatches of the ranks' rows: every
    # microbatch's forward has a rank's shapes, so the two runs route
    # alike (on different shapes cuBLAS may round the replicated
    # projections otherwise, and a routing choice at a near-tie flips).
    opt, ac, step = multi_step_fns(
        cfg, tc=TrainConfig(grad_accum=MULTI["ranks"]))
    state = init_train_state(None, cfg, opt, params=params)
    del params
    ref_losses, ref_ms = [], []
    before = ops.launch_counts()
    for i in range(MULTI["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, next(it))
        ref_ms.append(_sync_ms(t0))
        ref_losses.append(float(m["loss"]))
        if i == 0:
            ref_params = host_snapshot(state["params"])
    ref_launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    del state, m, step, it
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[multi] single process, {MULTI['batch']} x {MULTI['seq']} in "
          f"{MULTI['ranks']} microbatches: "
          f"losses {ref_losses!r}, step ms "
          f"{', '.join(f'{x:.1f}' for x in ref_ms)}; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB left "
          "allocated before the ranks start", flush=True)

    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        ep_rank, args=(MULTI["ranks"], str(root)), nprocs=MULTI["ranks"],
        start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(MULTI["ranks"]):
        with open(root / f"ep_rank{r}.json") as fh:
            ranks.append(json.load(fh))
    for r, info in enumerate(ranks):
        a = info["a2a"]
        print(f"[multi rank {r}] steps ms {info['ms']}; peak memory "
              f"{info['peak'] / 2 ** 30:.2f} GiB ({info['peak']} B); "
              f"forward all-to-alls of the witnessed step: {a['calls']} "
              f"calls, {a['bytes'] / 1e9:.3f} GB sent, {a['s']:.3f} s on "
              "the host (gloo over host memory on one card, not NCCL; "
              "the backward's exchanges move the rows' bytes again); "
              f"{card_line()}", flush=True)
    got = torch.load(root / "ep_params.pt")
    n_leaves, worst, bad = 0, 0.0, []
    for (p, x), (q, y) in zip(_flatten(ref_params), _flatten(got)):
        if p != q:
            fail(f"the ranks' params differ in structure at {p} / {q}")
        x, y = x.to(device).double(), y.to(device).double()  # on the card
        gap = (y - x).abs()
        off = gap > MULTI_PARAM_ATOL + MULTI_PARAM_RTOL * x.abs()
        n_leaves += 1
        worst = max(worst, float(gap.max()))
        if off.any():
            bad.append(p)
            print(f"[multi] params {p}: {int(off.sum())} of {x.numel()} "
                  f"elements outside atol {MULTI_PARAM_ATOL} + rtol "
                  f"{MULTI_PARAM_RTOL}, max |diff| {float(gap.max()):.3e}",
                  flush=True)
    # The dry run's model of the same exchange (launch/dryrun.py): the
    # static budgets make the forward's bytes a rank a step exact.
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.models import model_zoo as zoo

    pred = collective_bytes(
        cfg, kind="train", params=zoo.init_params(None, cfg, device="meta"),
        dispatch="sorted", remat="none",
        mesh={"data": 1, "model": MULTI["ranks"]},
        tokens=MULTI["batch"] * MULTI["seq"], itemsize=4)
    counted = [info["a2a"]["bytes"] for info in ranks]
    print(f"[multi] the dry run's all-to-all bytes a rank a step: forward "
          f"{pred['a2a_forward']} (counted by each rank: {counted}), "
          f"backward {pred['a2a_backward']}; the gradient all-reduce "
          f"{pred['grad_all_reduce']} B a rank", flush=True)
    if any(b != pred["a2a_forward"] for b in counted):
        fail(f"the dry run predicts {pred['a2a_forward']} B of forward "
             f"all-to-alls a rank a step; the ranks sent {counted}")
    loss_d = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                     ref_losses))
    over = max(max(info["overflow"]) for info in ranks)
    print(f"[multi] 2 ranks vs single process ({MULTI['ranks']} "
          f"microbatches) over {MULTI['steps']} steps: losses "
          f"{ranks[0]['losses']!r} vs {ref_losses!r}, max rel diff "
          f"{loss_d:.3e} (limit {MULTI_LOSS_RTOL}); the first step's "
          f"params: {n_leaves - len(bad)} of {n_leaves} leaves within atol "
          f"{MULTI_PARAM_ATOL} + rtol {MULTI_PARAM_RTOL}, max |diff| "
          f"{worst:.3e}; ep_overflow_frac {over!r}; spawn + ranks "
          f"{spawn_s:.1f} s, phase (c) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not (loss_d <= MULTI_LOSS_RTOL and not bad and over == 0.0):
        fail("the 2-rank expert-parallel steps part from the "
             "single-process steps")
    out = {f"multi_rank{r}": info["launches"] for r, info in
           enumerate(ranks)}
    out["multi_reference"] = ref_launches
    return out


def head_padding(device):
    """Phase 18 (d): qwen2.5-14b at 2 layers, its 40/8 query heads
    padded to 48/8 (multiple 16), the same logits as unpadded through
    the flash kernels; the padded forward witnessed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo

    cfg = dataclasses.replace(get_config(PAD["arch"]),
                              n_layers=PAD["layers"])
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    condition_attention(params, cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (PAD["batch"], PAD["seq"]),
                         generator=gen, device=device)
    batch = {"tokens": toks, "targets": toks}
    before = ops.launch_counts()
    with torch.no_grad():
        y0, _ = zoo.forward_train(params, batch, cfg,
                                  ac=zoo.ApplyCfg(attn_impl="cuda"))
        with witnessed_kernels() as wit:
            y1, _ = zoo.forward_train(
                params, batch, cfg, ac=zoo.ApplyCfg(
                    attn_impl="cuda",
                    pad_heads_multiple=PAD["multiple"]))
            torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    report_witness(wit, ("flash_attention",))
    err = float((y1 - y0).abs().max())
    print(f"[pad] {cfg.name} at {cfg.n_layers} layers: {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads padded to multiple {PAD['multiple']}, "
          f"batch {PAD['batch']} x {PAD['seq']}: max |logit diff| padded vs "
          f"unpadded through the kernels = {err:.3e} (atol {STEP_ATOL}); "
          f"launches {launches}", flush=True)
    if not err <= STEP_ATOL:
        fail(f"head padding changed the logits by {err:.3e}")
    del params, y0, y1
    torch.cuda.empty_cache()
    return launches


def multi_gpu(device):
    """Phase 18. Returns {path: launches}."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    print(f"[multi] phase 18 starts with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
          f"{card_line()}", flush=True)
    out = {"multi_determinism": combine_determinism(device)}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_multi_"))
    try:
        out["multi_launcher"] = launcher_ep_world1(device, root)
        out.update(ep_two_ranks(device, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["multi_head_padding"] = head_padding(device)
    print(f"[multi] phase 18 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: a step's counted cost against the dry run, and its mfu
# ---------------------------------------------------------------------------

# Synchronised steps timed for the mfu (after the counted ones, outside
# step_cost, whose dispatch modes add host work to the step they count).
COST_STEPS = 3
# The dry run's step peak (launch/memory.py on the meta device) against
# the card's: within MEMORY_RTOL of the card's figure or MEMORY_ATOL
# bytes, whichever is larger. The card's figure is the step's own:
# max_memory_allocated after reset_peak_memory_stats just before it, less
# what the process held then beyond the step's arguments.
MEMORY_RTOL, MEMORY_ATOL = 0.05, 128 * 2 ** 20


def alloc_bytes(tree) -> int:
    """The caching allocator's bytes of a tree's storages, each rounded
    up to 512 B (a block of over 1 MB may hold up to 1 MB more)."""
    import torch

    from repro_torch.launch.memory import rounded
    from repro_torch.models.param import tree_leaves

    seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(rounded(n) for n in seen.values())


def memory_line(tag, mem, card, *, held=True) -> None:
    """A ``[memory]`` line: the dry run's step peak (``mem``: a record's
    ``memory``, or ``rank_memory``'s) beside the card's, their
    difference and the dry run's largest live groups at its peak; with
    ``held``, fails outside MEMORY_RTOL / MEMORY_ATOL."""
    pred = mem["peak_bytes"]
    diff = pred - card
    limit = max(MEMORY_RTOL * card, MEMORY_ATOL)
    top = "; ".join(f"{g['bytes']} B x{g['count']} {g['op']} ({g['where']})"
                    for g in mem["at_peak"])
    print(f"[memory] {tag}: predicted step peak {pred} B "
          f"({pred / 2 ** 30:.3f} GiB; arguments {mem['argument_bytes']}, "
          f"temporaries {mem['temp_bytes']}, outputs {mem['output_bytes']}),"
          f" the card's {card} B ({card / 2 ** 30:.3f} GiB): difference "
          f"{diff:+d} B ({diff / max(card, 1):+.4f})"
          + (f", limit {limit:.0f} B" if held else ", no limit")
          + f"; at the predicted peak: {top}; {card_line()}", flush=True)
    if held and abs(diff) > limit:
        fail(f"{tag}: the dry run predicts a step peak of {pred} B, the "
             f"card's is {card} B ({diff:+d} B, limit {limit:.0f})")


def meta_twin(tree):
    """The tree's tensors as empty tensors of their shapes and dtypes on
    the meta device (a dry run of the same step)."""
    import torch

    from repro_torch.models.param import tree_map

    return tree_map(lambda t: torch.empty_like(t, device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def _timed_ms(fn, steps: int) -> list:
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        out.append(_sync_ms(t0))
    return out


def _held_cost(tag, cost, dry, launches, want, capacity_full) -> None:
    """Phase 19's checks of a counted step against its dry run: the aten
    FLOPs and the flash kernels' FLOPs equal, the kernels in
    ``capacity_full`` at most the dry run's (the ratio printed), the
    launches and the counted calls exactly ``want``."""
    ratios = {k: cost["kernel_flops"].get(k, 0) / dry["kernel_flops"][k]
              for k in capacity_full}
    print(f"[mfu] {tag}: counted aten FLOPs {cost['aten_flops']} (dry run "
          f"{dry['aten_flops']}); flash FLOPs "
          + ", ".join(f"{k} {cost['kernel_flops'].get(k)} (dry run "
                      f"{dry['kernel_flops'].get(k)})"
                      for k in FLASH_KERNELS)
          + "; counted / capacity-full FLOPs "
          + ", ".join(f"{k} {r:.4f}" for k, r in ratios.items()),
          flush=True)
    if cost["aten_flops"] != dry["aten_flops"]:
        fail(f"{tag}: the counted aten FLOPs differ from the dry run's")
    if any(cost["kernel_flops"].get(k) != dry["kernel_flops"].get(k)
           for k in FLASH_KERNELS):
        fail(f"{tag}: the flash kernels' counted FLOPs differ from the "
             "dry run's")
    if not all(0 < r <= 1 for r in ratios.values()):
        fail(f"{tag}: counted FLOPs above the dry run's capacity-full "
             f"bound: {ratios}")
    ran = {k: v for k, v in launches.items() if v}
    if ran != want or cost["kernel_calls"] != want:
        fail(f"{tag}: launched {ran}, counted {cost['kernel_calls']}, "
             f"expected {want}")


def _mfu_line(tag, cfg, tokens, cost, ms) -> None:
    from repro_torch.launch.flops import model_flops, utilization

    model = model_flops(cfg, "train", tokens)
    ms_med = sorted(ms)[len(ms) // 2]
    u = utilization(model, cost["total_flops"], ms_med / 1e3)
    print(f"[mfu] {tag}: {tokens} tokens a step, model FLOPs {model} (6 N "
          f"D), counted {cost['total_flops']} (aten {cost['aten_flops']}, "
          f"kernels {sum(cost['kernel_flops'].values())}), "
          f"useful_flops_ratio={u['useful_flops_ratio']:.4f}; step ms "
          f"{', '.join(f'{x:.1f}' for x in ms)} (median {ms_med:.1f}, "
          f"synchronised, uncounted): mfu={u['mfu']:.4f} "
          f"hardware_flops_util={u['hardware_flops_util']:.4f} against "
          f"989 TFLOP/s; {card_line()}", flush=True)
    if not 0 < u["mfu"] <= 1:
        fail(f"{tag}: mfu {u['mfu']} outside (0, 1]")


def step_costs(device):
    """Phase 19 (``[dryrun]`` and ``[mfu]`` lines). Returns its
    launches."""
    import tempfile

    import torch

    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.flops import step_cost
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.launch.profile_step import mixed_step_fn
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.train_loop import batch_to

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mfu] phase 19 starts with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
          f"{card_line()}", flush=True)
    ops.reset_launch_counts()
    cfg = get_config(TRAIN["arch"])
    B, S = TRAIN["batch"], TRAIN["seq"]
    # (a) the dry run of the train cell: granite at 16 x 512 on a mesh of
    # one, with phase 6's ApplyCfg.
    ac = dict(dispatch=TRAIN["dispatch"], compute_dtype="float32",
              remat="none", ce_chunk=0, pad_heads_multiple=0)
    with tempfile.TemporaryDirectory() as out_dir:
        dry = dryrun.run_cell(cfg.name, ShapeCfg("smoke_train", S, B,
                                                 "train"),
                              "one", "baseline", out_dir, extra_ac=ac,
                              mesh={"data": 1, "model": 1})
    opt = adafactor(inverse_sqrt(peak=TRAIN["peak_lr"],
                                 warmup_steps=TRAIN["warmup"]))
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device=device)
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    batch = batch_to(next(make_iterator(cfg, global_batch=B, seq_len=S,
                                        task=task)), device)
    torch.cuda.synchronize()
    held = {"state": sum(t.nbytes for t in tree_leaves(state)),
            "batch": sum(t.nbytes for t in batch.values())}
    held["total"] = held["state"] + held["batch"]
    mem = dry["memory"]["argument_bytes_by_input"]
    print(f"[dryrun] {cfg.name} {B} x {S} on one card: argument_bytes "
          f"{dry['memory']['argument_bytes']} predicted ({mem}); the card's "
          f"train state and batch after init_train_state: {held} B "
          f"(torch.cuda.memory_allocated {torch.cuda.memory_allocated()} "
          f"B: the caching allocator rounds each leaf up to 512 B)",
          flush=True)
    if held != mem:
        fail(f"the dry run predicts {mem} argument bytes, the card holds "
             f"{held}")

    # (b), (c): one step counted and one not, from the same state.
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(
        dispatch=TRAIN["dispatch"]))
    want = step_launches(cfg, TRAIN_KERNELS, True)
    clone = lambda tree: tree_map(  # noqa: E731
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
    runs = {}
    for counted in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        st = clone(state)
        before = ops.launch_counts()
        if counted:
            (st, m), cost = step_cost(step, st, batch)
        else:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st, m = step(st, batch)
            torch.cuda.synchronize()
            # Held beyond the arguments (the clone and the batch): base
            # less the batch.
            card_peak = (torch.cuda.max_memory_allocated() - base
                         + alloc_bytes(batch))
        torch.cuda.synchronize()
        runs[counted] = (st, m, {k: v - before[k] for k, v in
                                 ops.launch_counts().items()})
    memory_line(f"phase 19 {cfg.name} train {B} x {S} on a mesh of one",
                dry["memory"], card_peak)
    del state
    (s0, m0, l0), (s1, m1, l1) = runs[False], runs[True]
    same = (torch.equal(m0["loss"], m1["loss"]) and l0 == l1 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(s0),
                                          tree_leaves(s1))))
    print(f"[mfu] {cfg.name}: the step with and without count_work(): "
          f"loss {float(m0['loss'])!r} / {float(m1['loss'])!r}, "
          f"{len(tree_leaves(s0))} state leaves "
          f"{'bit-identical' if same else 'DIFFERENT'}, launches equal: "
          f"{l0 == l1}", flush=True)
    if not same:
        fail("counting the step's work changed its result or launches")
    _held_cost(f"{cfg.name} train", cost, dry, l1, want,
               ("grouped_mlp", "grouped_mlp_dx", "grouped_mlp_dw"))
    del s1, runs
    ms = _timed_ms(lambda: step(s0, batch), COST_STEPS)
    _mfu_line(f"{cfg.name} train", cfg, B * S, cost, ms)
    del s0, batch
    gc.collect()
    torch.cuda.empty_cache()

    # The ViT's MoE step (Expert Choice, gather, 104 images), its dry
    # run on the meta twin of its state and batch.
    vit = get_config(VIT_TRAIN["arch"])
    vstate = init_train_state(torch.Generator(device=device).manual_seed(0),
                              vit, opt, device=device)
    vbatch = batch_to(next(make_iterator(
        vit, global_batch=VIT_TRAIN["batch"], seq_len=VIT_TRAIN["seq"],
        task=task)), device)
    vstep = make_train_step(vit, opt, ac=zoo.ApplyCfg(
        dispatch=VIT_TRAIN["dispatch"]))
    _, vdry = step_cost(vstep, meta_twin(vstate), meta_twin(vbatch))
    print(f"[dryrun] {vit.name} {VIT_TRAIN['batch']} images on the meta "
          f"device: aten FLOPs {vdry['aten_flops']}, kernel FLOPs "
          f"{vdry['kernel_flops']}", flush=True)
    before = ops.launch_counts()
    (vstate, _), vcost = step_cost(vstep, vstate, vbatch)
    torch.cuda.synchronize()
    _held_cost(f"{vit.name} train", vcost, vdry,
               {k: v - before[k] for k, v in ops.launch_counts().items()},
               step_launches(vit, VIT_KERNELS, True), EXPERT_KERNELS)
    ms = _timed_ms(lambda: vstep(vstate, vbatch), COST_STEPS)
    _mfu_line(f"{vit.name} train", vit, VIT_TRAIN["batch"]
              * vit.n_frontend_positions, vcost, ms)
    del vstate, vbatch
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the serve mixed step at phase 4's shapes.
    scfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    fn = mixed_step_fn(scfg, device)
    fn()
    ms = _timed_ms(fn, 2 * COST_STEPS)
    _, scost = step_cost(fn)
    kbytes = sum(scost["kernel_bytes"].values())
    ms_med = sorted(ms)[len(ms) // 2]
    swant = {k: scfg.n_layers for k in SERVE_KERNELS}
    print(f"[mfu] {scfg.name} mixed step (phase 4's shapes): counted FLOPs "
          f"{scost['total_flops']} (aten {scost['aten_flops']}, kernels "
          f"{scost['kernel_flops']}), kernel bytes {scost['kernel_bytes']} "
          f"(sum {kbytes}); step ms {', '.join(f'{x:.2f}' for x in ms)} "
          f"(median {ms_med:.2f}, synchronised, uncounted): HBM share of "
          f"the kernels' bytes {kbytes / (ms_med / 1e3 * HBM_BW):.6f}, "
          f"hardware_flops_util "
          f"{scost['total_flops'] / (ms_med / 1e3 * PEAK_FLOPS_BF16):.6f}; "
          f"{card_line()}", flush=True)
    if scost["kernel_calls"] != swant:
        fail(f"the counted mixed step called {scost['kernel_calls']}, not "
             f"{swant}")
    del fn
    gc.collect()
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    print(f"[mfu] phase 19 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 20: the rules' placement — FSDP over data, tensor parallelism over
# model, expert-resident MoE — on a (data=2, model=2) mesh of 4 ranks
# sharing the card
# ---------------------------------------------------------------------------

# Two cells at full width and depth, 2 Adafactor steps each (phase 18's
# schedule), on 4 spawned ranks sharing the card through gloo (host
# staging, as phase 18): (a) granite, sorted dispatch, ep "none", a
# global 8 x 512 in routing groups of 2,048 (one a data rank); (b) the
# ViT, gather dispatch, Expert Choice, a global 16 images in groups of
# 784 tokens (4 images: the config's 4,096 is not a multiple of the 196
# patches an image, so a data rank's 8 images form 2 whole groups, the
# single process's own). Each is held against one process running the
# same steps on the same global batches in 2 microbatches of the data
# ranks' rows (phase 18's rule: the same shapes route alike).
# Adafactor takes eps1 = 1e-6 (the CPU parity tests' choice,
# tests/test_torch_mesh_train.py): at step 1 its update of an unfactored
# leaf (the attention weights, whose last two dims are heads and
# head_dim; the routers) is g / sqrt(g^2 + eps1), sign(g) at the default
# 1e-30, and splitting the heads and experts over ranks reassociates
# float32 sums, so an element whose gradient lies at the rounding floor
# (the upcycled ViT's routers: zero up to rounding) takes either sign in
# two correct runs — 2 lr p_rms apart (at the default eps1 on an H100:
# 159-340 elements of each granite attention leaf, about half of each
# ViT router, 4.0e-4-6.4e-4 off, the losses within 3.4e-7 and 4.9e-5).
MESH = dict(shape=(2, 2), steps=2, ranks=4, eps1=1e-6,
            cells={"granite": dict(arch="granite-moe-1b-a400m", batch=8,
                                   seq=512, group=2048, dispatch="sorted",
                                   layers=12),
                   "vit": dict(arch="vit-b16-upcycled", batch=16, seq=196,
                               group=784, dispatch="gather"),
                   "t5": dict(arch="t5-base-upcycled", batch=8, seq=512,
                              group=512, dispatch="gather")})
# Phase 20's cells (granite at 12 of its 24 layers since phase 23 joined
# the smoke: its time limit; the placement does not depend on the
# depth); phase 23 (a) trains "t5" at full depth: 8 x 512 encoder and
# 8 x 128 decoder tokens cut from phase 13's 16 rows, in routing groups
# of 512, so that a data rank's 4 x 512 encoder and 4 x 128 decoder
# tokens form whole groups.
MESH_TRAIN = ("granite", "vit")
# Each step's loss within 1e-4 relative, the gradient norm within 1e-3
# relative, every leaf of the gathered state after the first step
# (optimizer slots included) at the reference's distributed-step
# tolerances (MULTI_PARAM_ATOL, MULTI_PARAM_RTOL).
MESH_LOSS_RTOL, MESH_GN_RTOL = 1e-4, 1e-3


def mesh_cfg(name):
    """The config of a phase 20, 22 or 23 training cell: the arch at the
    cell's routing groups (and depth, and expert parallelism)."""
    from repro_torch.configs import get_config

    c = {**MESH["cells"], "granite_ep": MESH_EP}[name]
    full = get_config(c["arch"])
    if "layers" in c:
        full = dataclasses.replace(full, n_layers=c["layers"])
    ep = dict(ep="a2a", ep_budget_factor=c["factor"]) if "factor" in c \
        else {}
    return dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, group_size=c["group"], **ep))


def mesh_setup(name, device):
    """(cfg, upcycled params on ``device``, the global data iterator,
    ApplyCfg, the path's kernels, the optimizer) of a phase 20 or 23
    cell (or phase 22's ``granite_ep``): the package's dense init (seed
    0) with its attention conditioned, upcycled (routers from seed 7) —
    the same bits in every process."""
    import torch

    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adafactor, inverse_sqrt

    c = {**MESH["cells"], "granite_ep": MESH_EP}[name]
    cfg = mesh_cfg(name)
    dense_cfg = cfg.dense_parent()
    dense = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                            dense_cfg, device=device)
    condition_attention(dense, dense_cfg)
    params = upcycle_params(dense, dense_cfg, cfg,
                            torch.Generator(device=device).manual_seed(7))
    del dense
    task = (None if cfg.structure == "encoder_only" else
            ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB)))
    it = make_iterator(cfg, global_batch=c["batch"], seq_len=c["seq"],
                       task=task, host_index=0, host_count=1)
    ac = zoo.ApplyCfg(dispatch=c["dispatch"], moe_impl="cuda",
                      attn_impl="cuda")
    kernels = TRAIN_KERNELS if c["dispatch"] == "sorted" else VIT_KERNELS
    opt = adafactor(inverse_sqrt(peak=MULTI["peak_lr"],
                                 warmup_steps=MULTI["warmup"]),
                    eps1=MESH["eps1"])
    return cfg, params, it, ac, kernels, opt


def _mesh_compare(state, ref_path, layout, device):
    """This rank's blocks of a state against the same blocks of the
    single-process state saved at ``ref_path`` (read memory-mapped, each
    block cut as the layout places it, compared on the card): (leaves,
    {leaf: elements outside MULTI_PARAM_ATOL + MULTI_PARAM_RTOL |ref|},
    max |diff|)."""
    import torch

    from repro_torch.checkpoint.store import _flatten

    ref = layout.shard(torch.load(ref_path, mmap=True))
    n, off, worst = 0, {}, 0.0
    for (p, y), (q, x) in zip(_flatten(state), _flatten(ref)):
        if p != q:
            fail(f"the mesh state differs in structure at {p} / {q}")
        x = x.to(device).double()
        gap = (y.double() - x).abs()
        bad = int((gap > MULTI_PARAM_ATOL + MULTI_PARAM_RTOL * x.abs()
                   ).sum())
        n += 1
        worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        if bad:
            off[p] = bad
    return n, off, worst


def wait_for(root, name) -> None:
    """Block a rank until the parent writes ``root / name`` (exit if the
    parent removed the directory: it failed)."""
    while not (root / name).exists():
        if not root.exists():
            sys.exit(1)
        time.sleep(0.1)


def mesh_cell_rank(name, ctx, root, device, tag, go, *, repeat=True):
    """A rank's steps of a training cell under the rules' placement: it
    sets up (its blocks of the state) and waits for the parent's ``go``;
    the first step is witnessed, its kernels' shapes recorded and, with
    ``repeat``, repeated bit for bit from the same state and rows; its
    state after the first step is held against the single-process state
    the parent saved. Returns what the parent checks."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models.param import count_params, tree_leaves, tree_map
    from repro_torch.sharding import comm, train_layout
    from repro_torch.training import init_train_state, make_train_step

    cfg, params, it, ac, kernels, opt = mesh_setup(name, device)
    state = init_train_state(None, cfg, opt, params=params)
    del params
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt, ac=ac, layout=layout)
    row, rows = layout.batch_rows()
    print(f"{tag} {name}: {count_params(state['params']) / 1e9:.3f} B "
          f"params held (data rows block {row} of {rows}), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    want = step_launches(cfg, kernels, True)
    start = tree_map(torch.clone, state) if repeat else None
    wait_for(root, go)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    first = ops.launch_counts()
    rec = {"loss": [], "grad_norm": [], "ms": [], "counts": []}
    peak = 0
    for i in range(MESH["steps"]):
        batch = next(it)
        per = len(next(iter(batch.values()))) // rows
        local = {k: v[row * per:(row + 1) * per] for k, v in batch.items()}
        before = ops.launch_counts()
        comm.reset_counts()
        t0 = time.perf_counter()
        if i == 0:
            with witnessed_kernels() as wit, kernel_shapes() as shapes:
                state, m = step(state, local)
                torch.cuda.synchronize()
        else:
            # The step's own peak (its rows reach the card inside it):
            # held beyond the arguments, the process's bytes less the
            # state's.
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() - alloc_bytes(state)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, local)
            torch.cuda.synchronize()
            rec["step_peak"] = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            peak = max(peak, rec["step_peak"] + base)
        ms = _sync_ms(t0)
        rec["counts"].append(comm.counts())
        m = {k: float(v) for k, v in m.items()}
        launched = {k: v - before[k] for k, v in
                    ops.launch_counts().items()}
        print(f"{tag} {name} step {i + 1}: loss={m['loss']!r} "
              f"grad_norm={m['grad_norm']!r} ms={ms:.1f}"
              + (" (witnessed)" if i == 0 else "")
              + f" launches={ {k: v for k, v in launched.items() if v} }"
              f" collective payload B={rec['counts'][-1]}", flush=True)
        check_step(f"mesh {name}", tag, m, launched, want)
        rec["loss"].append(m["loss"])
        rec["grad_norm"].append(m["grad_norm"])
        rec["ms"].append(ms)
        if i == 0:
            report_witness(wit, kernels)
            rec["shapes"] = shapes
            if repeat:
                # The same step again from the same state and rows.
                again, m2 = step(start, local)
                rec["repeat"] = all(
                    torch.equal(a, b) for a, b in
                    zip(tree_leaves(again), tree_leaves(state))) and \
                    {k: float(v) for k, v in m2.items()} == m
                del again, start
            rec["leaves"], rec["off"], rec["worst"] = _mesh_compare(
                state, root / f"mesh_{name}_ref.pt", layout, device)
    rec["peak"] = max(peak, torch.cuda.max_memory_allocated())
    rec["launches"] = {k: v - first[k] for k, v in
                       ops.launch_counts().items()}
    del state, step, layout
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_rank(rank, world, root):
    """One rank of phases 20 to 24, in a process of its own on cuda:0. It
    sets up while the parent runs the single-process steps, and starts
    its timed steps when the parent writes ``go``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.kernels.build import build_all
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ShardCtx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            rank=rank, world_size=world)
    root = Path(root)
    build_all(ops.KERNELS)  # built by the parent: binds only
    ctx = ShardCtx.for_mesh(make_mesh(MESH["shape"], ("data", "model"),
                                      device_type="cpu"))
    tag = f"[mesh rank {rank}]"
    info = {name: mesh_cell_rank(name, ctx, root, device, tag, "go")
            for name in MESH_TRAIN}
    # Phase 21 on the same ranks and mesh, then phases 22 and 23.
    info["serve"] = mesh_serve_rank(rank, ctx, root, device)
    info["ep"] = mesh_ep_rank(rank, ctx, root, device)
    info["family"] = mesh_family_rank(rank, ctx, root, device)
    info["serve_tp"] = mesh_serve_tp_rank(rank, device)
    with open(root / f"mesh_rank{rank}.json", "w") as fh:
        json.dump(info, fh)
    dist.destroy_process_group()


def mesh_local_rows(device):
    """The kernels at the local shapes of phase 20's ranks, timed: the
    flash forward on granite's 8 of 16 query heads (4 of 8 KV heads) at
    a data rank's 4 x 512, the expert FFN forward on the ViT's (2, 16,
    49, 768) buffer (a data rank's 2 groups, 16 of the 32 experts)."""
    import torch

    from repro_torch.configs import get_config

    rows = []
    g = get_config("granite-moe-1b-a400m")
    half = dataclasses.replace(g, n_heads=g.n_heads // 2,
                               n_kv_heads=g.n_kv_heads // 2,
                               d_head=g.head_dim)
    rows.append(flash_shape_row("mesh_granite_local", half, 4, 512, device,
                                seed=20))
    gen = torch.Generator(device=device).manual_seed(21)
    v = get_config("vit-b16-upcycled")
    vl = dataclasses.replace(v, moe=dataclasses.replace(
        v.moe, num_experts=v.moe.num_experts // 2,
        group_size=MESH["cells"]["vit"]["group"]))
    E, d, f = vl.moe.num_experts, vl.d_model, vl.d_ff
    ex = {"wi": torch.randn(E, d, f, generator=gen, device=device) * d ** -.5,
          "wo": torch.randn(E, f, d, generator=gen, device=device) * f ** -.5}
    # The expert FFN's capacity is the whole config's (32 experts): a
    # local expert keeps the slots it has in one process.
    cap_cfg = dataclasses.replace(vl, moe=dataclasses.replace(
        vl.moe, num_experts=v.moe.num_experts))
    rows.append(expert_shape_row("mesh_vit_local", cap_cfg, ex,
                                 MESH["cells"]["vit"]["batch"] // 2
                                 * vl.n_frontend_positions, device, seed=23))
    del ex
    torch.cuda.empty_cache()
    return rows


def mesh_cell_reference(name, device, root):
    """The single-process steps of a training cell, in as many
    microbatches as the mesh has data ranks (the ranks' rows), its state
    after the first step saved for the ranks to hold their blocks
    against: ({losses, grad norms, step ms, peak}, launches)."""
    import torch

    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.kernels import ops
    from repro_torch.training import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    c, dp = MESH["cells"][name], MESH["shape"][0]
    torch.cuda.reset_peak_memory_stats()
    cfg, params, it, ac, kernels, opt = mesh_setup(name, device)
    step = make_train_step(cfg, opt, ac=ac, tc=TrainConfig(grad_accum=dp))
    state = init_train_state(None, cfg, opt, params=params)
    del params
    before = ops.launch_counts()
    r = {"loss": [], "grad_norm": [], "ms": []}
    for i in range(MESH["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, next(it))
        r["ms"].append(_sync_ms(t0))
        r["loss"].append(float(m["loss"]))
        r["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            torch.save(host_snapshot(state), root / f"mesh_{name}_ref.pt")
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    r["peak"] = torch.cuda.max_memory_allocated()
    print(f"[mesh] {name} single process, {c['batch']} x {c['seq']} in "
          f"{dp} microbatches: losses {r['loss']!r}, grad norms "
          f"{r['grad_norm']!r}, step ms "
          f"{', '.join(f'{x:.1f}' for x in r['ms'])}, peak "
          f"{r['peak'] / 2 ** 30:.2f} GiB", flush=True)
    del state, m, step, it
    gc.collect()
    torch.cuda.empty_cache()
    return r, launches


def mesh_cell_check(name, ref, ranks, bad) -> dict:
    """A training cell's checks over the ranks' results (``ranks``: each
    rank's record of the cell) against the one process's ``ref``; appends
    to ``bad``; returns {path: launches} of each rank."""
    from repro_torch.launch.dryrun import rules_collective_payloads
    from repro_torch.models import model_zoo as zoo

    c = MESH["cells"][name]
    for rk, i in enumerate(ranks):
        print(f"[mesh rank {rk}] {name}: steps ms {i['ms']}; peak "
              f"memory {i['peak'] / 2 ** 30:.2f} GiB ({i['peak']} B); "
              f"collective payload B a step {i['counts'][0]} (sum "
              f"{sum(i['counts'][0].values())}; gloo over host memory "
              "on one card, not NCCL); second run of the first step "
              f"bit-identical: {i.get('repeat', 'not run')}; its blocks of "
              f"the first step's state: {i['leaves'] - len(i['off'])} of "
              f"{i['leaves']} leaves within atol {MULTI_PARAM_ATOL} + "
              f"rtol {MULTI_PARAM_RTOL}, max |diff| {i['worst']:.3e}; "
              f"{card_line()}", flush=True)
        for p, n_off in i["off"].items():
            print(f"[mesh rank {rk}] {name} {p}: {n_off} elements "
                  "outside the tolerance", flush=True)
        if i.get("repeat") is False:
            bad.append(f"rank {rk} {name}: a second run of the step "
                       "differs")
        if i["loss"] != ranks[0]["loss"]:
            bad.append(f"rank {rk} {name}: losses differ between ranks")
    got = ranks[0]
    loss_d = max(abs(a - b) / abs(b) for a, b in
                 zip(got["loss"], ref["loss"]))
    gn_d = max(abs(a - b) / abs(b) for a, b in
               zip(got["grad_norm"], ref["grad_norm"]))
    off = sorted({p for i in ranks for p in i["off"]})
    worst = max(i["worst"] for i in ranks)
    cfg = mesh_cfg(name)
    pred = rules_collective_payloads(
        cfg, params=zoo.init_params(None, cfg, device="meta"),
        mesh=dict(zip(("data", "model"), MESH["shape"])),
        dispatch=c["dispatch"], remat="none",
        tokens=c["batch"] * c["seq"], itemsize=4)
    counted = [i["counts"] for i in ranks]
    held = all(cs == pred for k in counted for cs in k)
    print(f"[mesh] {name}: the dry run's collective payloads a rank a "
          f"step {pred} (counted by every rank, each step: {held})",
          flush=True)
    if not held:
        bad.append(f"{name}: the dry run predicts {pred}, the ranks "
                   f"counted {counted}")
    n = ranks[0]["leaves"]
    print(f"[mesh] {name}: (2, 2) vs single process over "
          f"{MESH['steps']} steps: losses {got['loss']!r} vs "
          f"{ref['loss']!r}, max rel diff {loss_d:.3e} (limit "
          f"{MESH_LOSS_RTOL}); grad norms {got['grad_norm']!r} vs "
          f"{ref['grad_norm']!r}, max rel diff {gn_d:.3e} (limit "
          f"{MESH_GN_RTOL}); the first step's state: {n - len(off)} of "
          f"{n} leaves within atol {MULTI_PARAM_ATOL} + rtol "
          f"{MULTI_PARAM_RTOL} on every rank, max |diff| {worst:.3e}",
          flush=True)
    if not (loss_d <= MESH_LOSS_RTOL and gn_d <= MESH_GN_RTOL
            and not off):
        bad.append(f"{name}: the (2, 2) steps part from the "
                   "single-process steps")
    return {f"mesh_{name}_rank{rk}": i["launches"]
            for rk, i in enumerate(ranks)}


def mesh_memory_predictions(out: dict) -> None:
    """The dry run's step peaks (``launch/dryrun.rank_memory``: rank 0's
    step on the meta device under a "fake" process group, reduce-scatters
    built as gloo's) of phase 20 (a)'s granite step on (2, 2), phase 21's
    one-process static prefill and its rank's, phase 23 (c)'s jamba
    prefill and phase 24 (a)'s serve_tp rank's, into ``out`` (its
    ``"error"`` where one raised). Each runs in a process of its own, on
    the host's cores while the card runs the phases."""
    import torch

    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import rank_memory
    from repro_torch.launch.memory import measure
    from repro_torch.models import model_zoo as zoo

    t0 = time.perf_counter()
    try:
        arch, f32 = "granite-moe-1b-a400m", torch.float32
        mesh = dict(zip(("data", "model"), MESH["shape"]))
        one = {"data": 1, "model": 1}
        c = MESH["cells"]["granite"]
        out["granite"] = rank_memory(
            arch, ShapeCfg("mesh_granite", c["seq"], c["batch"], "train"),
            mesh, profile="optimized", cfg=mesh_cfg("granite"),
            param_dtype=f32, transport="gloo",
            extra_ac=dict(dispatch=c["dispatch"], compute_dtype="float32",
                          remat="none", ce_chunk=0, pad_heads_multiple=0))
        serve = dict(cfg=mesh_serve_cfg(), param_dtype=f32, cache_dtype=f32)
        shape = ShapeCfg("mesh_serve", MESH_SERVE["plen"][1],
                         MESH_SERVE["prompts"], "prefill")
        ac = dict(dispatch="gather", compute_dtype="float32",
                  pad_heads_multiple=0)
        out["serve_one"] = rank_memory(arch, shape, one, extra_ac=ac,
                                       **serve)
        out["serve_rank"] = rank_memory(arch, shape, mesh,
                                        profile="optimized", extra_ac=ac,
                                        transport="gloo", **serve)
        out["serve_tp"] = rank_memory(
            arch, shape, mesh, profile="serve_tp", transport="gloo",
            extra_ac={**ac, "pad_heads_multiple": 16}, **serve)
        jcfg = mesh_jamba_cfg()
        prompts = static_prompts(jcfg, MESH_JAMBA["prompts"],
                                 MESH_JAMBA["plen"], MESH_JAMBA["seed"])
        bf16 = torch.bfloat16
        out["jamba"] = rank_memory(
            jcfg.name, ShapeCfg("mesh_jamba", max(map(len, prompts)),
                                len(prompts), "prefill"), one, cfg=jcfg,
            param_dtype=bf16, cache_dtype=bf16,
            extra_ac=dict(dispatch="gather", compute_dtype="bfloat16",
                          pad_heads_multiple=0))
        # The same process's weights built (a dispatch mode holds to its
        # thread: the card's phases run on beside it).
        _, out["jamba_init"] = measure(lambda: zoo.init_params(
            None, jcfg, dtype=bf16, device="meta"))
    except Exception as e:  # re-raised by the parent as a failure
        out["error"] = repr(e)
    out["s"] = time.perf_counter() - t0


def mesh_train(device):
    """Phases 20 to 24. The ranks start first and set up while this
    process runs the single-process steps (their first-step states saved
    for the ranks to hold their blocks against), the local-shape rows,
    phase 21's one-process serving and phase 23 (c)'s one-process jamba
    (its weights saved for the ranks); then it writes ``go`` and the
    ranks run their timed steps and serve, while this process runs phase
    22's one process and phase 23 (a)'s, and writes ``ep_go`` (so that
    none of its large models shares the card with phase 22's ranks),
    then phase 23 (b)'s one-process decoding, writes ``family_go`` and
    runs phase 24 (b), the examples; the ranks run phases 22 to 24.
    Returns ({path: launches}, shape rows, {phase 21 to 24 path:
    launches})."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] phase 20 starts with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
          f"{card_line()}", flush=True)
    refs, out = {}, {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    procs = torch.multiprocessing.start_processes(
        mesh_rank, args=(MESH["ranks"], str(root)),
        nprocs=MESH["ranks"], join=False, start_method="spawn")
    preds = {}
    dry = threading.Thread(target=mesh_memory_predictions, args=(preds,),
                           daemon=True)
    dry.start()
    try:
        for name in MESH_TRAIN:
            refs[name], out[f"mesh_{name}_reference"] = mesh_cell_reference(
                name, device, root)
        rows = mesh_local_rows(device)
        gc.collect()
        torch.cuda.empty_cache()
        # Phase 21's one process, then phase 23 (c)'s (a 49 GiB peak),
        # while the ranks hold their blocks and wait.
        t_serve = time.perf_counter()
        serve_eng, serve_ref = mesh_serve_reference(device, root)
        print(f"[mesh-serve] one process {time.perf_counter() - t_serve:.1f}"
              " s", flush=True)
        family_ref = {"jamba": mesh_jamba_reference(device, root)}
        print(f"[mesh] {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
              f"left allocated when the ranks start their steps, "
              f"{time.perf_counter() - t_phase:.1f} s into the phase",
              flush=True)
        (root / "go").touch()
        t0 = time.perf_counter()
        # Phase 22's and phase 23 (a)'s one process while the ranks run
        # phases 20 and 21.
        ep_ref = mesh_ep_reference(device, root)
        family_ref["t5"] = mesh_cell_reference("t5", device, root)
        (root / "ep_go").touch()
        family_ref["decode"] = mesh_decode_reference(device)
        (root / "family_go").touch()
        print(f"[mesh] this process's phases 22 and 23 "
              f"{time.perf_counter() - t0:.1f} s after go", flush=True)
        # Phase 24 (b) while the ranks run phases 22 to 24.
        example_launches = run_examples(device)
        while not procs.join():
            pass
        ranks_s = time.perf_counter() - t0
        ranks = []
        for rk in range(MESH["ranks"]):
            with open(root / f"mesh_rank{rk}.json") as fh:
                ranks.append(json.load(fh))
    finally:
        # A failure here must not leave ranks waiting for ``go``.
        for proc in procs.processes:
            if proc.is_alive():
                proc.terminate()
        shutil.rmtree(root, ignore_errors=True)
    dry.join()
    if "error" in preds:
        fail(f"the dry run's memory predictions: {preds['error']}")
    print(f"[memory] the dry run's step peaks of phases 20, 21, 23 (c) and "
          f"24 (a), each in a process of its own: {preds['s']:.1f} s",
          flush=True)
    for rk, info in enumerate(ranks):
        memory_line(f"phase 20 (a) granite rank {rk} (its second step)",
                    preds["granite"], info["granite"]["step_peak"])
    memory_line("phase 21 one process: static prefill of "
                f"{MESH_SERVE['prompts']} x 128", preds["serve_one"],
                serve_ref["prefill_peak"])
    memory_line(f"phase 23 (c) jamba at {MESH_JAMBA['layers']} layers, one "
                "process: its static prefill (beside the run's whole peak: "
                "weights built, prefill and decode)", preds["jamba"],
                family_ref["jamba"]["peak"], held=False)
    memory_line(f"phase 23 (c) jamba at {MESH_JAMBA['layers']} layers, one "
                "process: its weights' build (init_params in bfloat16, "
                "beside the run's whole peak)", preds["jamba_init"],
                family_ref["jamba"]["peak"], held=False)
    for key, phase in (("serve_rank", "21"), ("serve_tp", "24 (a)")):
        got = [info["serve" if key == "serve_rank" else "serve_tp"]["peak"]
               for info in ranks]
        memory_line(f"phase {phase} rank 0 ({key}): its static prefill of "
                    f"{MESH_SERVE['prompts']} x 128 (beside rank 0's whole "
                    f"serving peak; the ranks' {got})", preds[key], got[0],
                    held=False)
    bad = []
    for name in MESH_TRAIN:
        out.update(mesh_cell_check(name, refs[name],
                                   [info[name] for info in ranks], bad))
    print(f"[mesh] the ranks' steps, serving and checks {ranks_s:.1f} s "
          f"after go; phases 20 to 24 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if bad:
        fail("phase 20: " + "; ".join(bad))
    serve_launches = mesh_serve_check(serve_eng, serve_ref,
                                      [info["serve"] for info in ranks])
    serve_launches.update(mesh_ep_check(ep_ref,
                                        [info["ep"] for info in ranks]))
    serve_launches.update(mesh_family_check(family_ref,
                                            [info["family"]
                                             for info in ranks]))
    serve_launches.update(mesh_serve_tp_check(
        serve_eng, serve_ref, ranks))
    serve_launches.update(example_launches)
    rows.append(mesh_ep_row(device, ranks[0]["ep"]["shapes"]))
    del serve_eng
    gc.collect()
    torch.cuda.empty_cache()
    rows += mesh_serve_rows(device)
    rows += mesh_serve_tp_rows(device, ranks[0]["serve_tp"]["shapes"])
    return out, rows, serve_launches

# ---------------------------------------------------------------------------
# phase 21: serving under the rules' placement on the (data=2, model=2)
# mesh of phase 20's ranks
# ---------------------------------------------------------------------------

# Granite at full width, f32 weights from seed 0 with attention
# conditioned and dropless routing (phase 4's model), served by phase
# 20's 4 ranks after their training steps (sharding.serve_layout: 8 of
# 16 query heads, 4 of 8 KV heads and 16 of 32 experts a rank): (a) the
# static engine, 4 prompts of 64-128 tokens padded to 128 and 16 new
# (a cache of 144: cache_seq over model, a decode step's partial
# softmaxes combined across the model ranks), then the same prompts cut
# to 127 (a cache of 143: kv_heads over model), the rows over data;
# (b) the paged chunked engine over phase 4's SERVE settings and
# requests, the pools holding a rank's 4 KV heads, the rows replicated
# over data. One process serves the same first, while the ranks train.
# 12 of its 24 layers (24 until phase 22 joined the smoke: its time
# limit; the placements do not depend on the depth).
MESH_SERVE = dict(prompts=4, plen=(64, 128), new=16, seed=31, layers=12,
                  static=dict(max_batch=8, max_len=576))
# A rank's pools against its KV-head block of the one process's, row by
# row (a layer's k or v at one pool position): within atol + rtol |x|
# (tensor parallelism reassociates float32 sums: ~3e-6 in every layer).
# A MoE router whose top-8 of 32 experts ties within float32 noise at a
# token may pick another expert in one run, which moves that token's
# hidden state, so its k and v rows in the layers above (on an H100:
# one row, 2e-2 off in the last layer; one process through the kernels
# against the plain versions shows the same, ~3 rows a layer above
# layer 6, 4.7e-2 off; PERF.md). At most MESH_POOL_ROWS rows may lie
# outside, each traced to its token (mesh_pool_trace: the first
# MESH_POOL_TRACE tokens of the ranks' rows) and held to sit above a
# router gap below TIE_GAP, on the rank or in the one process, in a MoE
# layer at or below its own; a wrong placement or kernel moves them
# all, with no near-tie beneath.
MESH_POOL_TOL, MESH_POOL_ROWS, MESH_POOL_TRACE = (1e-3, 1e-3), 4, 8


def mesh_serve_prompts(cfg):
    """{"seq": 4 prompts padded to 128 (the first 128 tokens long),
    "heads": the same with the first cut to 127}."""
    c = MESH_SERVE
    prompts = static_prompts(cfg, c["prompts"], c["plen"], c["seed"])
    prompts[0] = (prompts[0] * 2)[:c["plen"][1]]
    return {"seq": prompts, "heads": [prompts[0][:-1]] + prompts[1:]}


def mesh_serve_cfg():
    """Phase 4's config (dropless) at MESH_SERVE's layers."""
    from repro_torch.configs import get_config

    full = get_config("granite-moe-1b-a400m")
    return dataclasses.replace(
        full, n_layers=MESH_SERVE["layers"], moe=dataclasses.replace(
            full.moe, capacity_factor=float(full.moe.num_experts)))


def mesh_serve_model(device):
    """(phase 4's config at MESH_SERVE's layers, its conditioned weights
    on ``device``)."""
    import torch

    from repro_torch.models import model_zoo as zoo

    cfg = mesh_serve_cfg()
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    condition_attention(params, cfg)
    return cfg, params


def serve_session(eng, cfg, *, witness=False):
    """Phase 4's requests through a chunked session, a tick at a time:
    (outputs, finished, generated tokens, wall s, each step's ms, the
    first step's collective payloads, its witness, the cache, each pool
    block's last owner {block: (rid, its index in the request's
    table)})."""
    import torch

    from repro_torch.sharding import comm

    reqs = make_requests(cfg)
    sess = eng.open_session()
    for r in reqs:
        sess.submit(r)
    step_ms, steps, first, wit, owners = [], 0, None, None, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        for slot in sess.sched.slots:
            if slot.request is not None:
                for j, b in enumerate(slot.blocks):
                    owners[int(b)] = (slot.request.rid, j)
        comm.reset_counts()
        t1 = time.perf_counter()
        if witness and first is None:
            with witnessed_kernels() as wit:
                alive = sess.tick()
                torch.cuda.synchronize()
        else:
            alive = sess.tick()
        if sess.stats["mixed_steps"] != steps:
            steps = sess.stats["mixed_steps"]
            step_ms.append(_sync_ms(t1))
            first = comm.counts() if first is None else first
        if not alive:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs, fin = sess.close()
    gen = sum(len(outs[r.rid]) - len(r.prompt) for r in reqs)
    return outs, fin, gen, wall, step_ms, first, wit, sess.cache, owners


def mesh_static_steps(eng, prompts, tokens, new):
    """A static batch's prefill and first decode step teacher-forced on
    ``tokens`` (a run's outputs) under the engine's layout, every kernel
    call witnessed: (the payloads each counted, the witness)."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.sharding import comm

    B, plen = len(prompts), max(len(p) for p in prompts)
    toks = torch.zeros(B, plen, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    nxt = torch.tensor([[t[len(p)]] for t, p in zip(tokens, prompts)])
    cache, ctx, (lo, hi) = eng.static_cache(B, plen + new)
    counts = []
    with torch.no_grad(), witnessed_kernels() as wit:
        comm.reset_counts()
        cache, _ = zoo.prefill(eng.params, {"tokens": toks[lo:hi].to(
            eng.device)}, cache, eng.cfg, ac=eng.ac, ctx=ctx)
        counts.append(comm.counts())
        comm.reset_counts()
        zoo.decode_step(eng.params, nxt[lo:hi].to(eng.device), cache, plen,
                        eng.cfg, ac=eng.ac, ctx=ctx)
        counts.append(comm.counts())
        torch.cuda.synchronize()
    return counts, wit


def static_prefill_peak(eng, prompts) -> int:
    """The card's peak of one static prefill step of ``eng`` (one
    process) over ``prompts`` right-padded to the longest (int32 tokens),
    its cache of as many positions, as the dry run's prefill cell runs
    it: max_memory_allocated over the cache's allocation and the
    prefill, less what the process held beyond the weights and tokens."""
    import torch

    from repro_torch.models import model_zoo as zoo

    B, plen = len(prompts), max(len(p) for p in prompts)
    toks = torch.zeros(B, plen, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.to(eng.device)
    torch.cuda.synchronize()
    base = (torch.cuda.memory_allocated() - alloc_bytes(eng.params)
            - alloc_bytes(toks))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        cache, ctx, _ = eng.static_cache(B, plen)
        out = zoo.prefill(eng.params, {"tokens": toks}, cache, eng.cfg,
                          ac=eng.ac, ctx=ctx)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, cache
    return peak


def mesh_serve_reference(device, root):
    """Phase 21's one process, before the ranks start: the static
    engine over both prompt sets and the paged engine over phase 4's
    requests through the kernels; the tokens, times and launches to
    ``mesh_serve_ref.json``, the pools at close to
    ``mesh_serve_pools.pt``. Returns (the paged engine, for near-tie
    gaps; {tokens}; launches)."""
    import torch

    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, params = mesh_serve_model(device)
    ref = {"static": {}, "launches": {}}
    eng = ServeEngine(params, cfg, ServeConfig(**MESH_SERVE["static"]),
                      device=device)
    before = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for case, prompts in mesh_serve_prompts(cfg).items():
        out = eng.generate(prompts, MESH_SERVE["new"])
        st = eng.last_stats
        ref["static"][case] = {"tokens": out, "prefill_s": st["prefill_s"],
                               "decode_s": st["decode_s"]}
    ref["prefill_peak"] = static_prefill_peak(
        eng, mesh_serve_prompts(cfg)["seq"])
    peng = ServeEngine(params, cfg, ServeConfig(paged=True, **SERVE),
                       device=device)
    outs, _, n_gen, wall, step_ms, _, _, cache, _ = serve_session(peng,
                                                                 cfg)
    ref["launches"] = {k: v - before[k] for k, v in
                       ops.launch_counts().items()}
    ref["paged"] = {"tokens": {str(k): v for k, v in outs.items()},
                    "tokens_s": n_gen / wall, "step_ms": step_ms,
                    "compile_count": peng.last_stats["compile_count"]}
    ref["peak"] = torch.cuda.max_memory_allocated()
    torch.save(host_snapshot(cache), root / "mesh_serve_pools.pt")
    del cache
    with open(root / "mesh_serve_ref.json", "w") as fh:
        json.dump(ref, fh)
    s = ref["static"]
    print(f"[mesh-serve] one process: static prefill "
          f"{s['seq']['prefill_s']:.3f} s and {MESH_SERVE['new'] - 1} "
          "decode steps "
          f"{s['seq']['decode_s']:.3f} s (cache_seq over model), "
          f"{s['heads']['prefill_s']:.3f} / {s['heads']['decode_s']:.3f} s "
          f"(kv_heads); paged {n_gen} tokens in {wall:.3f} s = "
          f"{n_gen / wall:.1f} tokens/s, {len(step_ms)} mixed steps, median "
          f"{sorted(step_ms)[len(step_ms) // 2]:.1f} ms; peak "
          f"{ref['peak'] / 2 ** 30:.2f} GiB; {card_line()}", flush=True)
    return peng, ref


@contextlib.contextmanager
def router_logits():
    """Record every MoE layer's router logits inside the block, in call
    order: a list of (tokens, E) float32 tensors."""
    from repro_torch.core import routing

    seen, real = [], routing.route

    def route(logits, *args, **kw):
        seen.append(logits.detach().reshape(-1, logits.shape[-1]).float())
        return real(logits, *args, **kw)

    routing.route = route
    try:
        yield seen
    finally:
        routing.route = real


def router_gaps(eng, seq, ctx=None) -> list:
    """The router's top-k gap (the k-th largest logit less the next) at
    the last token of ``seq`` in every MoE layer, layer by layer: ``seq``
    prefilled alone through ``eng``'s weights (under ``ctx``, a serving
    ctx of one replicated row, on a rank)."""
    import torch

    from repro_torch.models import model_zoo as zoo

    cfg, k = eng.cfg, eng.cfg.moe.top_k
    with torch.no_grad(), router_logits() as seen:
        if ctx is None:
            cache = zoo.init_serve_cache(cfg, 1, len(seq), device=eng.device,
                                         dtype=eng.cache_dtype)
        else:
            cache, ctx, _ = eng.static_cache(1, len(seq))
        zoo.prefill(eng.params, {"tokens": torch.tensor([seq],
                                                        device=eng.device)},
                    cache, cfg, ac=eng.ac, ctx=ctx)
    out = []
    for lg in seen:
        top = torch.topk(lg[len(seq) - 1], k + 1).values
        out.append(float(top[k - 1] - top[k]))
    return out


def mesh_pool_trace(eng, moved, owners, outs, ctx, tag) -> list:
    """Phase 21's pool rows outside MESH_POOL_TOL traced to their tokens:
    every rank's moved rows (layer, pool block, offset) gathered, each
    block's last owner giving the request and position, and the router's
    top-k gaps at that token in every MoE layer through the rank's
    static engine (``eng``, every rank replaying the same tokens in one
    order). Returns [{layer, block, offset, rid, pos, gaps (the rank's,
    one a MoE layer)}] of the rank's own rows; prints each."""
    import torch.distributed as dist

    bs = SERVE["block_size"]
    mine = []
    for li, b, o in moved:
        rid, j = owners.get(b, (None, None))
        mine.append({"layer": li, "block": b, "offset": o, "rid": rid,
                     "pos": None if rid is None else j * bs + o})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    tokens = sorted({(r["rid"], r["pos"]) for rows in every for r in rows
                     if r["rid"] is not None})[:MESH_POOL_TRACE]
    gaps = {t: router_gaps(eng, outs[t[0]][:t[1] + 1], ctx) for t in tokens}
    for r in mine:
        r["gaps"] = gaps.get((r["rid"], r["pos"]))
        low = None if r["gaps"] is None else min(r["gaps"][:r["layer"] + 1])
        print(f"{tag} pool row off the one process's: layer {r['layer']}, "
              f"block {r['block']} offset {r['offset']}: request {r['rid']} "
              f"position {r['pos']}; the router's top-8 gap there in layers "
              f"0..{r['layer']} on this rank "
              f"{None if r['gaps'] is None else [f'{g:.3e}' for g in r['gaps'][:r['layer'] + 1]]}"
              f" (smallest {low})", flush=True)
    return mine


def mesh_serve_rank(rank, ctx, root, device):
    """A rank's phase 21: the same engines under ``ctx``; returns what
    the parent checks (tokens, launches, payloads, pools' distance, times,
    peak memory)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine

    tag = f"[mesh-serve rank {rank}]"
    cfg, params = mesh_serve_model(device)
    eng = ServeEngine(params, cfg, ServeConfig(**MESH_SERVE["static"]),
                      device=device, ctx=ctx)
    peng = ServeEngine(params, cfg, ServeConfig(paged=True, **SERVE),
                       device=device, ctx=ctx)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    info = {"static": {}}
    new, L = MESH_SERVE["new"], cfg.n_layers
    for case, prompts in mesh_serve_prompts(cfg).items():
        before = ops.launch_counts()
        out = eng.generate(prompts, new)
        ran = {k: v - before[k] for k, v in ops.launch_counts().items()
               if v != before[k]}
        want = {"flash_attention": L, "expert_mlp": L * new}
        if ran != want:
            fail(f"{tag} static {case}: launched {ran}, expected {want}")
        st = eng.last_stats
        rec = {"tokens": out, "prefill_s": st["prefill_s"],
               "decode_s": st["decode_s"], "launches": ran}
        if case == "seq":
            rec["counts"], wit = mesh_static_steps(eng, prompts, out, new)
            report_witness(wit, ("flash_attention", "expert_mlp"))
        info["static"][case] = rec
        print(f"{tag} static {case}: prefill {st['prefill_s']:.3f} s, "
              f"{new - 1} decode steps {st['decode_s']:.3f} s "
              f"({st['decode_s'] * 1e3 / (new - 1):.1f} ms a step), "
              f"launches {ran}", flush=True)
    before = ops.launch_counts()
    outs, fin, n_gen, wall, step_ms, first, wit, cache, owners = \
        serve_session(peng, cfg, witness=True)
    report_witness(wit, SERVE_KERNELS)
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    st = peng.last_stats
    want = {k: L * st["mixed_steps"] for k in SERVE_KERNELS}
    if ran != want:
        fail(f"{tag} paged: launched {ran}, expected {want}")
    if st["compile_count"] != 1 or any(
            r["status"] != "completed" for r in fin.values()):
        fail(f"{tag} paged: compile_count {st['compile_count']}, statuses "
             f"{st['status_counts']}")
    # The rank's pools against its KV-head block of the one process's.
    lay = peng._paged_layout(peng.layout)[0]
    want_pools = lay.shard_cache(torch.load(root / "mesh_serve_pools.pt",
                                            mmap=True))
    atol, rtol = MESH_POOL_TOL
    worst, off, layers, moved = 0.0, 0, [], []
    for seg, ref_seg in zip(cache["stack"]["segments"],
                            want_pools["stack"]["segments"]):
        for pos, ref_pos in zip(seg.values(), ref_seg.values()):
            rows = 0
            for k in ("k", "v"):
                y = pos["mixer"][k][:, 1:]  # block 0: the trash block
                x = ref_pos["mixer"][k][:, 1:].to(device)
                gap = (y - x).abs()
                worst = max(worst, float(gap.max()))
                rows = rows | (gap > atol + rtol * x.abs()).flatten(3).any(3)
                # Per layer: (max |diff|, max |ref|).
                layers.append([k, gap.flatten(1).max(1).values.tolist(),
                               x.abs().flatten(1).max(1).values.tolist()])
            off += int(rows.sum())
            # (layer, block, offset) of each row off: granite's stack is
            # one segment of one position, its layers the repeats.
            moved += [(int(li), int(b) + 1, int(o)) for li, b, o in
                      rows.nonzero().tolist()]
    trace = mesh_pool_trace(eng, moved, owners, outs, ctx, tag)
    info["paged"] = {
        "tokens": {str(k): v for k, v in outs.items()},
        "tokens_s": n_gen / wall, "step_ms": step_ms, "counts": first,
        "launches": ran, "compile_count": st["compile_count"],
        "free_blocks_at_close": st["free_blocks_at_close"],
        "pool_max_diff": worst, "pool_off": off, "pool_layers": layers,
        "pool_trace": trace,
        "pool_shape": list(cache["stack"]["segments"][0]["pos0"]["mixer"]
                           ["k"].shape)}
    info["peak"] = torch.cuda.max_memory_allocated()
    info["launches"] = {k: sum(r["launches"].get(k, 0) for r in
                               info["static"].values()) + ran.get(k, 0)
                        for k in ops.launch_counts()}
    print(f"{tag} paged: {n_gen} tokens in {wall:.3f} s = "
          f"{n_gen / wall:.1f} tokens/s, {len(step_ms)} mixed steps, median "
          f"{sorted(step_ms)[len(step_ms) // 2]:.1f} ms (the first "
          f"witnessed); pools {info['paged']['pool_shape']}: max |diff| from "
          f"the one process's block {worst:.3e} (largest in "
          f"{[(k, g.index(max(g))) for k, g, _ in layers]}, (k or v, "
          f"layer)), {off} rows outside atol "
          f"{atol} + rtol {rtol} (at most {MESH_POOL_ROWS}); peak "
          f"{info['peak'] / 2 ** 30:.2f} GiB", flush=True)
    del eng, peng, cache, want_pools
    gc.collect()
    torch.cuda.empty_cache()
    return info


def check_static_tokens(tag, got, want, prompts, gap_eng) -> None:
    """Hold a static run's rows token for token: a divergence is accepted
    only at a top-2 gap below TIE_GAP, measured by replaying the row as
    the static engine saw it (its prompt right-padded with 0) through
    ``gap_eng``."""
    plen = max(len(p) for p in prompts)
    for i, (x, y, p) in enumerate(zip(got, want, prompts)):
        if x == y:
            continue
        n = next(j for j in range(len(x)) if x[j] != y[j])
        seq = p + [0] * (plen - len(p)) + x[len(p):n]
        gap = top2_gap(gap_eng, seq)
        print(f"[check] {tag}: row {i} diverges at token {n}: top-2 logit "
              f"gap {gap:.3e}", flush=True)
        if gap >= TIE_GAP:
            fail(f"{tag}: row {i} diverges at token {n} with top-2 gap "
                 f"{gap:.3e} >= {TIE_GAP}")
    if got == want:
        print(f"[check] {tag}: token-identical", flush=True)


def mesh_serve_check(peng, ref, ranks):
    """Phase 21's checks over the ranks' results against the one
    process's; returns {path: launches}."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    cfg = peng.cfg
    prompts = mesh_serve_prompts(cfg)
    mesh = dict(zip(("data", "model"), MESH["shape"]))
    B, new = MESH_SERVE["prompts"], MESH_SERVE["new"]
    S = MESH_SERVE["plen"][1]
    kw = dict(params=None, mesh=mesh, remat="none", itemsize=4)
    pred = {
        "prefill": rules_collective_payloads(
            cfg, dispatch="gather", kind="prefill", tokens=B * S, batch=B,
            cache_len=S + new, **kw),
        "decode": rules_collective_payloads(
            cfg, dispatch="gather", kind="decode", tokens=B, batch=B,
            cache_len=S + new, **kw),
        "mixed": rules_collective_payloads(
            cfg, dispatch="sorted", kind="mixed",
            tokens=SERVE["max_batch"] + SERVE["chunks_per_step"]
            * SERVE["chunk_size"],
            logits_rows=SERVE["max_batch"] + SERVE["chunks_per_step"], **kw)}
    print(f"[mesh-serve] the dry run's collective payloads a rank: {pred}",
          flush=True)
    rids = [r.rid for r in make_requests(cfg)]
    ref_outs = {int(k): v for k, v in ref["paged"]["tokens"].items()}
    # The one process's router gaps replay each traced token through a
    # static engine on the paged engine's weights.
    from repro_torch.serve import ServeConfig, ServeEngine

    peng_static = ServeEngine(peng.params, cfg,
                              ServeConfig(**MESH_SERVE["static"]),
                              device=peng.device)
    bad, one_gaps = [], {}
    for rk, info in enumerate(ranks):
        s = info["static"]
        for case in ("seq", "heads"):
            check_static_tokens(f"mesh serve rank {rk} static {case} vs one "
                                "process", s[case]["tokens"],
                                ref["static"][case]["tokens"], prompts[case],
                                peng)
        check_tokens(f"mesh serve rank {rk} paged vs one process",
                     {int(k): v for k, v in info["paged"]["tokens"].items()},
                     {int(k): v for k, v in ref["paged"]["tokens"].items()},
                     rids, peng)
        got = {"prefill": s["seq"]["counts"][0],
               "decode": s["seq"]["counts"][1],
               "mixed": info["paged"]["counts"]}
        if got != pred:
            bad.append(f"rank {rk}: counted {got}")
        if info["paged"]["pool_off"] > MESH_POOL_ROWS:
            bad.append(f"rank {rk}: {info['paged']['pool_off']} pool rows "
                       "off the one process's block")
        for r in info["paged"]["pool_trace"]:
            if r["gaps"] is None:
                bad.append(f"rank {rk}: pool row {r} not traced to a token")
                continue
            key = (r["rid"], r["pos"])
            if key not in one_gaps:
                one_gaps[key] = router_gaps(
                    peng_static, ref_outs[r["rid"]][:r["pos"] + 1])
            one = one_gaps[key]
            low = min(r["gaps"][:r["layer"] + 1] + one[:r["layer"] + 1])
            print(f"[mesh-serve rank {rk}] pool row off at layer "
                  f"{r['layer']}, request {r['rid']} position {r['pos']}: "
                  f"the router's top-8 gaps in layers 0..{r['layer']} in the "
                  f"one process {[f'{g:.3e}' for g in one[:r['layer'] + 1]]},"
                  f" on the rank "
                  f"{[f'{g:.3e}' for g in r['gaps'][:r['layer'] + 1]]}; "
                  f"smallest {low:.3e} (TIE_GAP {TIE_GAP})", flush=True)
            if low >= TIE_GAP:
                bad.append(f"rank {rk}: pool row {r['layer']}/{r['rid']}/"
                           f"{r['pos']} moved with no router near-tie at or "
                           f"below it (smallest gap {low:.3e}): a placement "
                           "fault")
        p = info["paged"]
        med = sorted(ref["paged"]["step_ms"])[len(ref["paged"]["step_ms"])
                                              // 2]
        print(f"[mesh-serve rank {rk}] static prefill "
              f"{s['seq']['prefill_s']:.3f} / {s['heads']['prefill_s']:.3f} s"
              f", decode {s['seq']['decode_s']:.3f} / "
              f"{s['heads']['decode_s']:.3f} s (one process "
              f"{ref['static']['seq']['prefill_s']:.3f} / "
              f"{ref['static']['heads']['prefill_s']:.3f}, "
              f"{ref['static']['seq']['decode_s']:.3f} / "
              f"{ref['static']['heads']['decode_s']:.3f}); paged "
              f"{p['tokens_s']:.1f} tokens/s, median step "
              f"{sorted(p['step_ms'])[len(p['step_ms']) // 2]:.1f} ms (one "
              f"process {ref['paged']['tokens_s']:.1f}, "
              f"{med:.1f}); peak {info['peak'] / 2 ** 30:.2f} GiB ({info['peak']} B; "
              f"one process {ref['peak'] / 2 ** 30:.2f}); payload B "
              f"counted = the dry run's: {got == pred}; compile_count "
              f"{p['compile_count']}; {card_line()}", flush=True)
    if bad:
        fail("phase 21: " + "; ".join(bad))
    total = {}
    for info in ranks:
        for k, v in info["launches"].items():
            total[k] = total.get(k, 0) + v
    return {"mesh_serve": total, "mesh_serve_reference": ref["launches"]}


def mesh_serve_rows(device):
    """The paged decode and prefill kernels at a rank's local heads (8
    of 16 query heads, 4 of 8 KV heads) at the serve shapes
    (attention_case), against the plain versions and SDPA over each
    row's blocks gathered dense."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref

    g = get_config("granite-moe-1b-a400m")
    half = dataclasses.replace(g, n_heads=g.n_heads // 2,
                               n_kv_heads=g.n_kv_heads // 2,
                               d_head=g.head_dim)
    a = attention_case(half, torch.float32,
                       device, torch.Generator(device=device).manual_seed(32))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    nb, bs = a["tables"].shape[1], a["kp"].shape[1]
    H, Kh, dh = half.n_heads, half.n_kv_heads, half.head_dim

    def dense(tab):
        n = tab.shape[0]
        k = a["kp"][tab.long()].reshape(n, nb * bs, Kh, dh)
        v = a["vp"][tab.long()].reshape(n, nb * bs, Kh, dh)
        return tuple(t.transpose(1, 2).repeat_interleave(H // Kh, 1)
                     .contiguous() for t in (k, v))

    kd, vd = dense(a["tables"])
    dmask = (torch.arange(nb * bs, device=device)[None]
             < a["lengths"][:, None])[:, None, None]
    kc, vc = dense(a["ctab"])
    qpos = a["starts"][:, None] + torch.arange(SERVE["chunk_size"],
                                               device=device)[None]
    cmask = (torch.arange(nb * bs, device=device)[None, None]
             <= qpos[..., None])[:, None]
    qd, qc = a["q_dec"][:, :, None], a["q_ch"].transpose(1, 2)
    rows = []
    for kname, kern, plain, args, work, lib in (
            ("decode_attention", da.paged_decode_attention_cuda,
             ref.decode_attention_ref,
             (a["q_dec"], a["kp"], a["vp"], a["tables"], a["lengths"]),
             decode_case_work(a, 4),
             lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                    attn_mask=dmask)),
            ("paged_prefill", pp.paged_prefill_attention_cuda,
             ref.prefill_attention_ref,
             (a["q_ch"], a["kp"], a["vp"], a["ctab"], a["starts"],
              a["lens"]),
             prefill_case_work(a, 4),
             lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                    attn_mask=cmask))):
        y = kern(*args)
        torch.cuda.synchronize()
        rows.append(_shape_row("mesh_serve_local", kname, y, plain(*args),
                               lambda: kern(*args), lambda: plain(*args),
                               lib, 1, work, flush, 20))
    return rows


# ---------------------------------------------------------------------------
# phase 22: expert parallelism under the rules' placement, and rwkv6 under
# a serving mesh, on phase 20's ranks after phase 21
# ---------------------------------------------------------------------------

# (a) Granite at full width and 12 of its 24 layers (24 until phase 23
# joined the smoke: its time limit), sorted dispatch, moe.ep "a2a" at
# budget factor 2.0 (= the model axis: no assignment dropped), the
# default rules with tensor parallelism (ShardCtx.for_mesh's ctx): FSDP
# of embed over data, heads, kv heads and vocab over model, 16 of the 32
# experts a rank, each model peer routing its data rank's 2 groups and
# sending its one group's rows through the all-to-all. 2 Adafactor steps
# at a global 8 x 512 in groups of 1,024 (cut from phase 20's 2,048: the
# global group count must divide the 4 ranks, as the reference requires),
# against one process running the same steps in 2 microbatches of the
# data ranks' rows. (b) rwkv6-7b at full width and 4 of its 32 layers
# (f32, condition_rwkv), the static engine over 8 prompts of 128 tokens,
# 16 new: each rank its 32 of the 64 heads of the time mix and of the
# WKV state, the rows over data, the FFN's f over model; against one
# process, a divergence accepted only at a top-2 gap below RWKV_TIE_GAP.
# The one process runs both while the ranks run phases 20 and 21; the
# ranks start phase 22 when it has written "ep_go".
MESH_EP = dict(arch="granite-moe-1b-a400m", batch=8, seq=512, group=1024,
               dispatch="sorted", factor=2.0, steps=2, layers=12)
MESH_RWKV = dict(layers=4, prompts=8, plen=128, new=16, seed=34,
                 static=dict(max_batch=8, max_len=160))


@contextlib.contextmanager
def kernel_shapes():
    """Record the shapes the grouped, WKV, flash and expert-FFN kernels
    are called at inside the block: {kernel: {"(first input's shape) x
    n": calls}}, n the experts a grouped call runs, a WKV or flash call's
    (query) heads or an expert-FFN call's experts; and a grouped kernel's
    first call's valid rows (``<kernel>_valid_rows``)."""
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import rwkv6 as wkv

    seen = {}
    heads = lambda args: args[0].shape[2]  # noqa: E731
    experts = lambda args: args[0].shape[1]  # noqa: E731
    keys = [(gm, "grouped_mlp_cuda", "grouped_mlp", 4),
            (gm, "grouped_mlp_dx_cuda", "grouped_mlp_dx", 5),
            (gm, "grouped_mlp_dw_cuda", "grouped_mlp_dw", 5),
            (wkv, "rwkv6_cuda", "rwkv6", heads),
            (fa, "flash_attention_fwd_cuda", "flash_attention", heads),
            (fa, "flash_attention_dq_cuda", "flash_attention_dq", heads),
            (fa, "flash_attention_dkv_cuda", "flash_attention_dkv", heads),
            (em, "expert_ffn_cuda", "expert_mlp", experts),
            (em, "expert_ffn_dx_cuda", "expert_mlp_dx", experts),
            (em, "expert_ffn_dw_cuda", "expert_mlp_dw", experts)]

    def record(fn, name, sizes):
        def call(*args, **kw):
            # (the rows' shape, the experts a call runs or the heads)
            grouped = isinstance(sizes, int)
            n = args[sizes].shape[-1] if grouped else sizes(args)
            key = f"{tuple(args[0].shape)} x {n}"
            if name not in seen and grouped:
                seen[f"{name}_valid_rows"] = int(args[sizes].sum())
            seen.setdefault(name, {})
            seen[name][key] = seen[name].get(key, 0) + 1
            return fn(*args, **kw)
        return call

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in keys]
    for mod, attr, name, sizes in keys:
        setattr(mod, attr, record(getattr(mod, attr), name, sizes))
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def shape_counts(shapes, name) -> set:
    """The n of every call of ``name`` that :func:`kernel_shapes`
    recorded."""
    return {int(key.split(" x ")[1]) for key in shapes.get(name, {})}


def mesh_rwkv_model(device):
    """(rwkv6-7b at MESH_RWKV's layers, its conditioned weights on
    ``device``, the prompts)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    cfg = dataclasses.replace(get_config("rwkv6-7b"),
                              n_layers=MESH_RWKV["layers"])
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    condition_rwkv(params, cfg)
    prompts = static_prompts(cfg, MESH_RWKV["prompts"], MESH_RWKV["plen"],
                             MESH_RWKV["seed"])
    return cfg, params, prompts


def mesh_ep_reference(device, root):
    """Phase 22's one process, while the ranks run phases 20 and 21: (a)
    the granite EP cell's 2 steps in 2 microbatches of the data ranks'
    rows, its first-step state to ``mesh_ep_ref.pt``; (b) the rwkv cell
    through the static engine, and its top-2 gaps fed its own tokens.
    Returns what the checks read."""
    import torch

    from repro_torch.checkpoint.manager import host_snapshot
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.training import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, it, ac, _, opt = mesh_setup("granite_ep", device)
    step = make_train_step(cfg, opt, ac=ac,
                           tc=TrainConfig(grad_accum=MESH["shape"][0]))
    state = init_train_state(None, cfg, opt, params=params)
    del params
    before = ops.launch_counts()
    ref = {"loss": [], "grad_norm": [], "ms": [], "launches": {}}
    for i in range(MESH_EP["steps"]):
        t1 = time.perf_counter()
        state, m = step(state, next(it))
        ref["ms"].append(_sync_ms(t1))
        ref["loss"].append(float(m["loss"]))
        ref["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            torch.save(host_snapshot(state), root / "mesh_ep_ref.pt")
    ref["launches"]["mesh_ep_reference"] = {
        k: v - before[k] for k, v in ops.launch_counts().items()}
    ref["peak"] = torch.cuda.max_memory_allocated()
    print(f"[mesh-ep] granite EP cell, one process, {MESH_EP['batch']} x "
          f"{MESH_EP['seq']} in groups of {MESH_EP['group']}, 2 "
          f"microbatches: losses {ref['loss']!r}, grad norms "
          f"{ref['grad_norm']!r}, step ms "
          f"{', '.join(f'{x:.1f}' for x in ref['ms'])}, peak "
          f"{ref['peak'] / 2 ** 30:.2f} GiB", flush=True)
    del state, m, step, it
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rcfg, rparams, prompts = mesh_rwkv_model(device)
    eng = ServeEngine(rparams, rcfg, ServeConfig(**MESH_RWKV["static"]),
                      device=device)
    del rparams
    eng.generate([prompts[0][:16]], max_new=2)  # warm-up
    before = ops.launch_counts()
    out = eng.generate(prompts, MESH_RWKV["new"])
    ref["launches"]["mesh_rwkv_reference"] = {
        k: v - before[k] for k, v in ops.launch_counts().items()}
    st = eng.last_stats
    _, gaps = teacher_forced({"one": (eng, contextlib.nullcontext)},
                             prompts, out)
    ref["rwkv"] = {"tokens": out, "gaps": gaps.tolist(),
                   "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                   "peak": torch.cuda.max_memory_allocated()}
    print(f"[mesh-rwkv] one process, {rcfg.n_layers} layers, "
          f"{len(prompts)} x {MESH_RWKV['plen']} + {MESH_RWKV['new']} new: "
          f"prefill {st['prefill_s']:.3f} s, decode {st['decode_s']:.3f} s "
          f"({st['decode_s'] * 1e3 / (MESH_RWKV['new'] - 1):.1f} ms a step);"
          f" peak {ref['rwkv']['peak'] / 2 ** 30:.2f} GiB; phase 22's one "
          f"process {time.perf_counter() - t0:.1f} s", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def mesh_ep_rank(rank, ctx, root, device):
    """A rank's phase 22: the granite EP steps under the tensor-parallel
    ctx, then the rwkv cell's static engine under ``ctx``; returns what
    the parent checks."""
    import torch

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models.param import count_params
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.sharding import comm, train_layout
    from repro_torch.training import init_train_state, make_train_step

    wait_for(root, "ep_go")
    tag = f"[mesh-ep rank {rank}]"
    cfg, params, it, ac, kernels, opt = mesh_setup("granite_ep", device)
    state = init_train_state(None, cfg, opt, params=params)
    del params
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt, ac=ac, layout=layout)
    row, rows = layout.batch_rows()
    print(f"{tag} {count_params(state['params']) / 1e9:.3f} B params held "
          f"(data rows block {row} of {rows}), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    want = step_launches(cfg, kernels, True)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    rec = {"loss": [], "grad_norm": [], "over": [], "ms": [], "counts": [],
           "launches": {}}
    for i in range(MESH_EP["steps"]):
        batch = next(it)
        per = len(next(iter(batch.values()))) // rows
        local = {k: v[row * per:(row + 1) * per] for k, v in batch.items()}
        before = ops.launch_counts()
        comm.reset_counts()
        t0 = time.perf_counter()
        if i == 0:
            with witnessed_kernels() as wit, kernel_shapes() as shapes:
                state, m = step(state, local)
                torch.cuda.synchronize()
        else:
            # The step's own peak (its rows reach the card inside it):
            # held beyond the arguments, the process's bytes less the
            # state's.
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() - alloc_bytes(state)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, local)
            torch.cuda.synchronize()
            rec["step_peak"] = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            peak = max(peak, rec["step_peak"] + base)
        ms = _sync_ms(t0)
        rec["counts"].append(comm.counts())
        m = {k: float(v) for k, v in m.items()}
        ran = {k: v - before[k] for k, v in ops.launch_counts().items()}
        for k, v in ran.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + v
        print(f"{tag} granite EP step {i + 1}: loss={m['loss']!r} "
              f"grad_norm={m['grad_norm']!r} ep_overflow_frac_sum="
              f"{m['ep_overflow_frac_sum']!r} ms={ms:.1f}"
              + (" (witnessed)" if i == 0 else "")
              + f" launches={ {k: v for k, v in ran.items() if v} }"
              f" collective payload B={rec['counts'][-1]}", flush=True)
        check_step("mesh EP", f"rank {rank}", m, ran, want)
        for key, v in (("loss", m["loss"]), ("grad_norm", m["grad_norm"]),
                       ("over", m["ep_overflow_frac_sum"]), ("ms", ms)):
            rec[key].append(v)
        if i == 0:
            report_witness(wit, kernels)
            rec["shapes"] = shapes
            print(f"{tag} the grouped kernels' shapes in step 1 (rows' "
                  f"shape x experts): {shapes}", flush=True)
            rec["leaves"], rec["off"], rec["worst"] = _mesh_compare(
                state, root / "mesh_ep_ref.pt", layout, device)
    rec["peak"] = torch.cuda.max_memory_allocated()
    del state, step, layout
    gc.collect()
    torch.cuda.empty_cache()

    rcfg, rparams, prompts = mesh_rwkv_model(device)
    eng = ServeEngine(rparams, rcfg, ServeConfig(**MESH_RWKV["static"]),
                      device=device, ctx=ctx)
    del rparams
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    new = MESH_RWKV["new"]
    before = ops.launch_counts()
    with kernel_shapes() as shapes:
        out = eng.generate(prompts, new)
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    wantr = {"rwkv6": rcfg.n_layers * new}
    if ran != wantr:
        fail(f"{tag} rwkv: launched {ran}, expected {wantr}")
    st = eng.last_stats
    counts, wit = mesh_static_steps(eng, prompts, out, new)
    report_witness(wit, ("rwkv6",))
    rec["rwkv"] = {"tokens": out, "prefill_s": st["prefill_s"],
                   "decode_s": st["decode_s"], "launches": ran,
                   "counts": counts, "shapes": shapes,
                   "peak": torch.cuda.max_memory_allocated()}
    print(f"{tag} rwkv: prefill {st['prefill_s']:.3f} s, {new - 1} decode "
          f"steps {st['decode_s']:.3f} s "
          f"({st['decode_s'] * 1e3 / (new - 1):.1f} ms a step), launches "
          f"{ran}, WKV shapes {shapes.get('rwkv6')}, peak "
          f"{rec['rwkv']['peak'] / 2 ** 30:.2f} GiB", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_ep_row(device, shapes):
    """The grouped forward at rank 0's expert-parallel buffer of step 1
    (its rows' shape, its experts, its first call's valid rows, skewed
    over the 16 experts), random weights, timed against the plain version
    and the library chain."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_mlp import ROW_BLOCK

    (key,) = shapes["grouped_mlp"]
    M, E = int(key.split(", ")[1]), int(key.split(" x ")[1])
    full = get_config(MESH_EP["arch"])
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, num_experts=E))
    return grouped_shape_row(
        "mesh_ep_local", cfg, None, device, seed=36,
        n_assign=shapes["grouped_mlp_valid_rows"],
        rows=M - E * ROW_BLOCK)


def mesh_ep_check(ref, ranks):
    """Phase 22's checks over the ranks' results against the one
    process's; returns {path: launches}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import rules_collective_payloads
    from repro_torch.models import model_zoo as zoo

    cfg = mesh_cfg("granite_ep")
    rcfg = dataclasses.replace(get_config("rwkv6-7b"),
                               n_layers=MESH_RWKV["layers"])
    mesh = dict(zip(("data", "model"), MESH["shape"]))
    m = MESH["shape"][1]
    kw = dict(mesh=mesh, remat="none", itemsize=4)
    pred = rules_collective_payloads(
        cfg, params=zoo.init_params(None, cfg, device="meta"),
        dispatch="sorted", tokens=MESH_EP["batch"] * MESH_EP["seq"], **kw)
    B, S, new = MESH_RWKV["prompts"], MESH_RWKV["plen"], MESH_RWKV["new"]
    rpred = [rules_collective_payloads(
        rcfg, params=None, dispatch="gather", kind=kind,
        tokens=B * (S if kind == "prefill" else 1), batch=B,
        cache_len=S + new, **kw) for kind in ("prefill", "decode")]
    print(f"[mesh-ep] the dry run's collective payloads a rank: granite EP "
          f"step {pred}; rwkv prefill {rpred[0]}, decode {rpred[1]}",
          flush=True)
    bad = []
    E_l = cfg.moe.num_experts // m
    H_l = rcfg.d_model // rcfg.ssm.head_size // m
    prompts = static_prompts(rcfg, B, S, MESH_RWKV["seed"])
    want_tokens = ref["rwkv"]["tokens"]
    for rk, info in enumerate(ranks):
        if any(c != pred for c in info["counts"]):
            bad.append(f"rank {rk}: counted {info['counts']}, the dry run "
                       f"{pred}")
        if info["off"]:
            bad.append(f"rank {rk}: leaves off the one process's "
                       f"{info['off']}")
        if any(info["over"]):
            bad.append(f"rank {rk}: ep_overflow_frac {info['over']}")
        for k in ("grouped_mlp", "grouped_mlp_dx", "grouped_mlp_dw"):
            ran = info["shapes"].get(k, {})
            if shape_counts(info["shapes"], k) != {E_l} or len(ran) != 1:
                bad.append(f"rank {rk}: {k} ran at {ran}, not {E_l} "
                           "experts")
        ran = info["rwkv"]["shapes"].get("rwkv6", {})
        if shape_counts(info["rwkv"]["shapes"], "rwkv6") != {H_l}:
            bad.append(f"rank {rk}: the WKV kernel ran at {ran}, not {H_l} "
                       "heads")
        if info["rwkv"]["counts"] != rpred:
            bad.append(f"rank {rk}: rwkv counted {info['rwkv']['counts']}, "
                       f"the dry run {rpred}")
        got = info["rwkv"]["tokens"]
        div = first_static_divergence(prompts, got, want_tokens)
        if div is not None:
            i, n = div
            gap = ref["rwkv"]["gaps"][n - len(prompts[i])][i]
            print(f"[mesh-rwkv rank {rk}] row {i} diverges from the one "
                  f"process at token {n}: its top-2 gap {gap:.3e}",
                  flush=True)
            if gap >= RWKV_TIE_GAP:
                bad.append(f"rank {rk}: rwkv row {i} diverges at token {n}"
                           f" with top-2 gap {gap:.3e} >= {RWKV_TIE_GAP}")
        r = info["rwkv"]
        print(f"[mesh-ep rank {rk}] granite EP: steps ms {info['ms']}; peak "
              f"{info['peak'] / 2 ** 30:.2f} GiB ({info['peak']} B); payload "
              f"B a step {info['counts'][0]} (sum "
              f"{sum(info['counts'][0].values())}); its blocks of the first "
              f"step's state: {info['leaves'] - len(info['off'])} of "
              f"{info['leaves']} leaves within atol {MULTI_PARAM_ATOL} + "
              f"rtol {MULTI_PARAM_RTOL}, max |diff| {info['worst']:.3e}; "
              f"rwkv: prefill {r['prefill_s']:.3f} s (one process "
              f"{ref['rwkv']['prefill_s']:.3f}), decode {r['decode_s']:.3f} "
              f"s (one process {ref['rwkv']['decode_s']:.3f}), peak "
              f"{r['peak'] / 2 ** 30:.2f} GiB, token-identical to the one "
              f"process: {got == want_tokens}; {card_line()}", flush=True)
    got = ranks[0]
    loss_d = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                     ref["loss"]))
    gn_d = max(abs(a - b) / abs(b) for a, b in zip(got["grad_norm"],
                                                   ref["grad_norm"]))
    print(f"[mesh-ep] granite EP (2, 2) vs one process over "
          f"{MESH_EP['steps']} steps: losses {got['loss']!r} vs "
          f"{ref['loss']!r}, max rel diff {loss_d:.3e} (limit "
          f"{MESH_LOSS_RTOL}); grad norms {got['grad_norm']!r} vs "
          f"{ref['grad_norm']!r}, max rel diff {gn_d:.3e} (limit "
          f"{MESH_GN_RTOL}); payloads equal to the dry run's on every rank: "
          f"{all(c == pred for info in ranks for c in info['counts'])}",
          flush=True)
    if not (loss_d <= MESH_LOSS_RTOL and gn_d <= MESH_GN_RTOL):
        bad.append("granite EP: the (2, 2) steps part from the one "
                   "process's")
    if any(info["loss"] != got["loss"] for info in ranks):
        bad.append("granite EP: the ranks' losses differ")
    if bad:
        fail("phase 22: " + "; ".join(bad))
    total = {"mesh_ep": {}, "mesh_rwkv": {}}
    for info in ranks:
        for path, ran in (("mesh_ep", info["launches"]),
                          ("mesh_rwkv", info["rwkv"]["launches"])):
            for k, v in ran.items():
                total[path][k] = total[path].get(k, 0) + v
    return {**total, **ref["launches"]}


# ---------------------------------------------------------------------------
# phase 23: every family under the rules' placement on phase 20's ranks
# ---------------------------------------------------------------------------

# (a) is MESH's "t5" cell. (b) T5 (the cell's initial weights: upcycled,
# attention conditioned) and whisper-base (seed 0, attention
# conditioned) decoded greedily under a serving ctx through
# zoo.prefill / zoo.decode_step at full width: phase 13's 8 requests of
# 512 encoder tokens (32 new) and phase 14's 4 of 1,500 frames (16 new),
# 8-token decoder prompts of the stream at data step 1000; a rank holds
# its rows (over data) and its 6 of 12 heads, T5's 16 of 32 experts.
MESH_DECODE = {"t5": dict(requests=8, enc=512, plen=8, new=32),
               "whisper": dict(requests=4, enc=1500, plen=8, new=16),
               "data_step": 1000}
# (c) jamba-1.5-large at full width (d 8192, d_in 16,384), its first 2 of
# 72 layers: a mamba layer with a dense FFN and a mamba layer with a MoE
# of 16 experts (dropless), 12.18 B params in bfloat16 from seed 0,
# served through ServeEngine(ctx=) as phase 17 serves it (bfloat16
# compute and cache): 4 prompts of 64-128 tokens, 8 new. The one process
# saves its weights; each rank reads them memory-mapped and places its
# blocks one leaf at a time (its d_in block of both mamba layers, half of
# the dense FFN, 8 of 16 experts, its vocabulary blocks), never holding
# the whole model on the card.
MESH_JAMBA = dict(layers=2, prompts=4, plen=(64, 128), new=8, seed=37,
                  static=dict(max_batch=4, max_len=136,
                              cache_dtype="bfloat16"))


def mesh_decode_model(name, device):
    """(cfg, params on ``device``, the requests' batch) of a phase 23 (b)
    model."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    if name == "t5":
        cfg, params, *_ = mesh_setup("t5", device)
    else:
        cfg = get_config(WHISPER["arch"])
        params = zoo.init_params(
            torch.Generator(device=device).manual_seed(0), cfg,
            device=device)
        condition_attention(params, cfg)
    d = MESH_DECODE[name]
    return cfg, params, encdec_batch(cfg, d["requests"], d["enc"],
                                     MESH_DECODE["data_step"])


def mesh_greedy(name, device, ctx=None):
    """Greedy decoding of a phase 23 (b) model through the kernels: in one
    process (``ctx`` None) or under ``sharding.serve_layout`` on a rank
    (its rows, its heads and experts, the decoder's cache by the act
    rules). Returns {tokens (rows of the global batch), each step's top-2
    gaps (steps, rows), launches, prefill s, decode s, the payloads of
    the prefill and the first decode step, the launches it must make}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import stack as stk
    from repro_torch.sharding import comm, serve_layout
    from repro_torch.training.train_loop import batch_to

    cfg, params, batch = mesh_decode_model(name, device)
    d = MESH_DECODE[name]
    plen, new = d["plen"], d["new"]
    b = batch_to({k: v for k, v in batch.items() if k != "targets"}, device)
    b["dec_tokens"] = b["dec_tokens"][:, :plen]
    B, enc = b["dec_tokens"].shape[0], d["enc"]
    ac = zoo.ApplyCfg(moe_impl="cuda", attn_impl="cuda")
    meta = zoo.init_serve_cache(cfg, B, plen + new, dtype=torch.float32,
                                device="meta", enc_len=enc)
    if ctx is None:
        cache = zoo.init_serve_cache(cfg, B, plen + new, dtype=torch.float32,
                                     device=device, enc_len=enc)
        sctx, lo, hi = None, 0, B
    else:
        lay = serve_layout(ctx, cfg, params, cache=meta)
        params = lay.place(params)
        cache, sctx = lay.alloc(meta, device=device), lay.ctx
        i, n = lay.rows()
        lo, hi = i * B // n, (i + 1) * B // n
    gc.collect()
    torch.cuda.empty_cache()
    b = {k: v[lo:hi] for k, v in b.items()}
    enc_d, dec_d = (stk.layer_descs(cfg, stack="encoder"),
                    stk.layer_descs(cfg))
    n_moe = sum(x.ffn == "moe" for x in dec_d)
    expect = {"flash_attention": len(enc_d) + len(dec_d) * (new + 1),
              "expert_mlp": sum(x.ffn == "moe" for x in enc_d)
              + n_moe * new}
    expect = {k: v for k, v in expect.items() if v}
    toks, gaps, counts = [], [], []
    before = ops.launch_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comm.reset_counts()
        cache, lg = zoo.prefill(params, b, cache, cfg, ac=ac, ctx=sctx)
        counts.append(comm.counts())
        for t in range(new):
            lg = lg[:, -1]
            top = torch.topk(lg, 2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).tolist())
            cur = lg.argmax(-1)
            toks.append(cur.tolist())
            if t == 0:
                pre_s, t1 = _sync_ms(t0) / 1e3, time.perf_counter()
            if t == new - 1:
                break
            comm.reset_counts()
            cache, lg = zoo.decode_step(params, cur[lo:hi, None], cache,
                                        plen + t, cfg, ac=ac, ctx=sctx)
            if t == 0:
                counts.append(comm.counts())
        dec_s = _sync_ms(t1) / 1e3
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": [list(r) for r in zip(*toks)], "gaps": gaps,
            "launches": ran, "expect": expect, "prefill_s": pre_s,
            "decode_s": dec_s, "counts": counts}


def mesh_decode_reference(device):
    """Phase 23 (b)'s one process: {model: mesh_greedy's record}."""
    out = {}
    for name in ("t5", "whisper"):
        out[name] = r = mesh_greedy(name, device)
        d = MESH_DECODE[name]
        print(f"[mesh-{name}] one process: {d['requests']} requests, "
              f"prefill {r['prefill_s']:.3f} s, {d['new'] - 1} decode steps "
              f"{r['decode_s']:.3f} s; launches {r['launches']}", flush=True)
        if r["launches"] != r["expect"]:
            fail(f"phase 23 {name} one process: launched {r['launches']}, "
                 f"expected {r['expect']}")
    return out


def mesh_jamba_cfg():
    from repro_torch.configs import get_config

    return _dropless(dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                         n_layers=MESH_JAMBA["layers"]))


def mesh_jamba_steps(eng, prompts, tokens):
    """The static batch teacher-forced on ``tokens`` (a run's outputs)
    through ``eng`` (one process or a rank's): (each step's top-2 logit
    gaps (steps, rows), the mamba layers' caches at the end on the host:
    {layer: {"conv", "ssm"}}, this rank's rows, the collective payloads
    of the prefill and the first decode step)."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.sharding import comm

    B, plen = len(prompts), max(len(p) for p in prompts)
    new = len(tokens[0]) - len(prompts[0])
    toks = torch.zeros(B, plen, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    cache, ctx, (lo, hi) = eng.static_cache(B, plen + new)
    gaps, counts = [], []
    with torch.no_grad():
        comm.reset_counts()
        cache, lg = zoo.prefill(eng.params, {"tokens": toks[lo:hi].to(
            eng.device)}, cache, eng.cfg, ac=eng.ac, ctx=ctx)
        counts.append(comm.counts())
        for s in range(new):
            top = torch.topk(lg[:, -1].float(), 2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).tolist())
            if s == new - 1:
                break
            cur = torch.tensor([[o[len(p) + s]] for o, p in
                                zip(tokens, prompts)])
            comm.reset_counts()
            cache, lg = zoo.decode_step(eng.params, cur[lo:hi].to(
                eng.device), cache, plen + s, eng.cfg, ac=eng.ac, ctx=ctx)
            counts.append(comm.counts())
    caches = {f"{si}/{pos}": {k: layer["mixer"][k].cpu() for k in
                              ("conv", "ssm")}
              for si, seg in enumerate(cache["stack"]["segments"])
              for pos, layer in seg.items() if "ssm" in layer["mixer"]}
    return gaps, caches, (lo, hi), counts[:2]


def mesh_jamba_reference(device, root):
    """Phase 23 (c)'s one process, before the ranks start their steps:
    the model from seed 0 in bfloat16, served; its mamba caches after the
    teacher-forced steps saved to ``mesh_jamba_caches.pt``, and its
    weights copied to the host, freed on the card and saved to
    ``mesh_jamba.pt`` for the ranks by a thread, which writes
    ``jamba_saved`` when done. Returns what the checks read."""
    import shutil

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import count_params, tree_map
    from repro_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = mesh_jamba_cfg()
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, dtype=torch.bfloat16, device=device)
    n = count_params(params)
    free = shutil.disk_usage(root).free
    if free < 1.2 * 2 * n:
        fail(f"phase 23: jamba's {2 * n / 1e9:.1f} GB of weights do not fit "
             f"the {free / 1e9:.1f} GB free under {root}")
    eng = ServeEngine(params, cfg, ServeConfig(**MESH_JAMBA["static"]),
                      ac=zoo.ApplyCfg(compute_dtype="bfloat16"),
                      device=device)
    prompts = static_prompts(cfg, MESH_JAMBA["prompts"], MESH_JAMBA["plen"],
                             MESH_JAMBA["seed"])
    before = ops.launch_counts()
    out = eng.generate(prompts, MESH_JAMBA["new"])
    st = eng.last_stats
    gaps, caches, _, _ = mesh_jamba_steps(eng, prompts, out)
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    torch.save(caches, root / "mesh_jamba_caches.pt")
    t1 = time.perf_counter()
    host = tree_map(lambda t: t.detach().cpu(), params)
    copy_s = time.perf_counter() - t1
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    def save():
        # The marker comes last whatever happens: a failed save leaves
        # the ranks a missing or partial file, on which they raise.
        t2 = time.perf_counter()
        try:
            torch.save(host, root / "mesh_jamba.pt")
            print(f"[mesh-jamba] the weights saved for the ranks in "
                  f"{time.perf_counter() - t2:.1f} s", flush=True)
        finally:
            (root / "jamba_saved").touch()

    threading.Thread(target=save, daemon=True).start()
    print(f"[mesh-jamba] one process: {cfg.name} at {cfg.n_layers} of 72 "
          f"layers, {n / 1e9:.3f} B params (bfloat16); {len(prompts)} "
          f"prompts of {[len(p) for p in prompts]} tokens, "
          f"{MESH_JAMBA['new']} new: prefill {st['prefill_s']:.3f} s, "
          f"decode {st['decode_s']:.3f} s; peak {peak / 2 ** 30:.2f} GiB; "
          f"weights copied to the host in {copy_s:.1f} s, saved for the "
          f"ranks in the background ({free / 1e9:.0f} GB free); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"tokens": out, "gaps": gaps, "launches": launches, "peak": peak,
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "params": n, "prompts": prompts}


def mesh_jamba_rank(rank, ctx, root, device, tag):
    """A rank's phase 23 (c): ServeEngine(ctx=) over the one process's
    weights, read memory-mapped and placed one leaf at a time; the
    teacher-forced steps witnessed, their mamba caches against the one
    process's blocks."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = mesh_jamba_cfg()
    wait_for(root, "jamba_saved")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = torch.load(root / "mesh_jamba.pt", mmap=True,
                        map_location="cpu", weights_only=True)
    eng = ServeEngine(params, cfg, ServeConfig(**MESH_JAMBA["static"]),
                      ac=zoo.ApplyCfg(compute_dtype="bfloat16"),
                      device=device, ctx=ctx)
    del params
    place_s = time.perf_counter() - t0
    placed = torch.cuda.max_memory_allocated()
    prompts = static_prompts(cfg, MESH_JAMBA["prompts"], MESH_JAMBA["plen"],
                             MESH_JAMBA["seed"])
    new = MESH_JAMBA["new"]
    before = ops.launch_counts()
    out = eng.generate(prompts, new)
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    st = eng.last_stats
    # Rank 0 holds every expert FFN call of the steps against the plain
    # version (a float32 copy of its 8 experts' weights, 19 GB: one rank
    # at a time fits beside the others).
    witness = witnessed_kernels() if rank == 0 else contextlib.nullcontext()
    with witness as wit, kernel_shapes() as shapes:
        _, caches, (lo, hi), counts = mesh_jamba_steps(eng, prompts, out)
    if rank == 0:
        report_witness(wit, ("expert_mlp",))
    want = torch.load(root / "mesh_jamba_caches.pt")
    m, k = ctx.shape["model"], ctx.coord("model")
    diffs = {}
    for layer, c in caches.items():
        n = want[layer]["ssm"].shape[2] // m
        diffs[layer] = {
            "ssm": float((c["ssm"] - want[layer]["ssm"][
                :, lo:hi, k * n:(k + 1) * n]).abs().max()),
            "conv": float((c["conv"].float() - want[layer]["conv"][
                :, lo:hi, :, k * n:(k + 1) * n].float()).abs().max()),
            "shape": list(c["ssm"].shape)}
    rec = {"tokens": out, "launches": ran, "shapes": shapes,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "place_s": place_s, "placed": placed, "caches": diffs,
           "counts": counts,
           "peak": torch.cuda.max_memory_allocated()}
    print(f"{tag} jamba: placed from the memory-mapped weights in "
          f"{place_s:.1f} s ({placed / 2 ** 30:.2f} GiB on the card); "
          f"prefill {st['prefill_s']:.3f} s, {new - 1} decode steps "
          f"{st['decode_s']:.3f} s; launches {ran}; expert FFN shapes "
          f"{shapes.get('expert_mlp')}; mamba caches, this rank's rows "
          f"{lo}..{hi} and d_in block {k} of {m}, max |diff| from the one "
          f"process's block {diffs}; peak {rec['peak'] / 2 ** 30:.2f} GiB",
          flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_family_rank(rank, ctx, root, device):
    """A rank's phase 23, after phase 22: (a) T5's training steps, (b)
    T5's and whisper's decoding, (c) jamba served."""
    import torch

    wait_for(root, "family_go")
    t0 = time.perf_counter()
    tag = f"[mesh-family rank {rank}]"
    info = {"t5": mesh_cell_rank("t5", ctx, root, device, tag, "family_go",
                                 repeat=False)}
    info["decode"] = {}
    for name in ("t5", "whisper"):
        torch.cuda.reset_peak_memory_stats()
        r = info["decode"][name] = mesh_greedy(name, device, ctx)
        r["peak"] = torch.cuda.max_memory_allocated()
        print(f"{tag} {name} decoding: prefill {r['prefill_s']:.3f} s, "
              f"{MESH_DECODE[name]['new'] - 1} decode steps "
              f"{r['decode_s']:.3f} s; launches {r['launches']}; payload B "
              f"{r['counts']}; peak {r['peak'] / 2 ** 30:.2f} GiB",
              flush=True)
    info["jamba"] = mesh_jamba_rank(rank, ctx, root, device, tag)
    info["s"] = time.perf_counter() - t0
    print(f"{tag} phase 23 {info['s']:.1f} s", flush=True)
    return info


def mesh_family_check(ref, ranks):
    """Phase 23's checks over the ranks' results against the one
    process's; returns {path: launches}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import rules_collective_payloads

    bad = []
    m = MESH["shape"][1]
    mesh = dict(zip(("data", "model"), MESH["shape"]))
    # (a) T5 trained: the cell's checks, its kernels at a rank's shapes.
    t5, t5_launches = ref["t5"]
    out = mesh_cell_check("t5", t5, [info["t5"] for info in ranks], bad)
    cfg = mesh_cfg("t5")
    for rk, info in enumerate(ranks):
        sh = info["t5"]["shapes"]
        for k in FLASH_KERNELS:
            if shape_counts(sh, k) != {cfg.n_heads // m}:
                bad.append(f"rank {rk}: t5 {k} ran at {sh.get(k)}, not "
                           f"{cfg.n_heads // m} heads")
        for k in EXPERT_KERNELS:
            if shape_counts(sh, k) != {cfg.moe.num_experts // m}:
                bad.append(f"rank {rk}: t5 {k} ran at {sh.get(k)}, not "
                           f"{cfg.moe.num_experts // m} experts")
        print(f"[mesh-t5 rank {rk}] kernels' shapes in step 1 (first "
              f"input x heads or experts): "
              f"{ {k: sh.get(k) for k in VIT_KERNELS} }", flush=True)
    # (b) T5 and whisper decoded.
    decode_launches = {}
    for name in ("t5", "whisper"):
        want, d = ref["decode"][name], MESH_DECODE[name]
        B = d["requests"]
        dcfg = cfg if name == "t5" else get_config(WHISPER["arch"])
        pred = [rules_collective_payloads(
            dcfg, params=None, mesh=mesh, dispatch="gather", remat="none",
            itemsize=4, kind=kind,
            tokens=B * (d["plen"] if kind == "prefill" else 1), batch=B,
            cache_len=d["plen"] + d["new"], enc_len=d["enc"])
            for kind in ("prefill", "decode")]
        for rk, info in enumerate(ranks):
            got = info["decode"][name]
            for path, n in got["launches"].items():
                decode_launches[path] = decode_launches.get(path, 0) + n
            if got["launches"] != got["expect"]:
                bad.append(f"rank {rk}: {name} decoding launched "
                           f"{got['launches']}, expected {got['expect']}")
            if got["counts"] != pred:
                bad.append(f"rank {rk}: {name} decoding counted "
                           f"{got['counts']}, the dry run {pred}")
            same = got["tokens"] == want["tokens"]
            for i, (x, y) in enumerate(zip(got["tokens"], want["tokens"])):
                n = next((j for j in range(len(x)) if x[j] != y[j]), None)
                if n is None:
                    continue
                gap = want["gaps"][n][i]
                print(f"[mesh-{name} rank {rk}] row {i} diverges from the "
                      f"one process at generated token {n}: top-2 gap "
                      f"{gap:.3e}", flush=True)
                if gap >= TIE_GAP:
                    bad.append(f"rank {rk}: {name} row {i} diverges at "
                               f"token {n} with top-2 gap {gap:.3e} >= "
                               f"{TIE_GAP}")
                break  # MoE rows share routing: later rows follow
            print(f"[mesh-{name} rank {rk}] decoded under the serving ctx: "
                  f"token-identical to the one process: {same}; prefill "
                  f"{got['prefill_s']:.3f} s (one process "
                  f"{want['prefill_s']:.3f}), decode {got['decode_s']:.3f} s "
                  f"(one process {want['decode_s']:.3f}); payloads equal "
                  f"to the dry run's: {got['counts'] == pred}; peak "
                  f"{got['peak'] / 2 ** 30:.2f} GiB; {card_line()}",
                  flush=True)
        print(f"[mesh-{name}] the dry run's payloads a rank: prefill "
              f"{pred[0]}, decode step {pred[1]}", flush=True)
    # (c) jamba served.
    jref, jcfg = ref["jamba"], mesh_jamba_cfg()
    prompts = jref["prompts"]
    jamba_launches = {}
    n_moe = sum(d.ffn == "moe" for d in all_descs(jcfg))
    B, plen = len(prompts), max(len(p) for p in prompts)
    jpred = [rules_collective_payloads(
        jcfg, params=None, mesh=mesh, dispatch="gather", remat="none",
        itemsize=2, kind=kind, tokens=B * (plen if kind == "prefill" else 1),
        batch=B, cache_len=plen + MESH_JAMBA["new"])
        for kind in ("prefill", "decode")]
    print(f"[mesh-jamba] the dry run's payloads a rank: prefill {jpred[0]}, "
          f"decode step {jpred[1]}", flush=True)
    for rk, info in enumerate(ranks):
        got = info["jamba"]
        for k, n in got["launches"].items():
            jamba_launches[k] = jamba_launches.get(k, 0) + n
        if got["launches"] != {"expert_mlp": n_moe * MESH_JAMBA["new"]}:
            bad.append(f"rank {rk}: jamba launched {got['launches']}")
        if got["counts"] != jpred:
            bad.append(f"rank {rk}: jamba counted {got['counts']}, the dry "
                       f"run {jpred}")
        if shape_counts(got["shapes"], "expert_mlp") != {
                jcfg.moe.num_experts // m}:
            bad.append(f"rank {rk}: jamba's expert FFN ran at "
                       f"{got['shapes'].get('expert_mlp')}")
        div = first_static_divergence(prompts, got["tokens"], jref["tokens"])
        if div is not None:
            i, n = div
            gap = jref["gaps"][n - len(prompts[i])][i]
            print(f"[mesh-jamba rank {rk}] row {i} diverges from the one "
                  f"process at token {n}: its top-2 gap {gap:.3e}",
                  flush=True)
            if gap >= JAMBA_TIE_GAP:
                bad.append(f"rank {rk}: jamba row {i} diverges at token {n}"
                           f" with top-2 gap {gap:.3e} >= {JAMBA_TIE_GAP}")
        print(f"[mesh-jamba rank {rk}] token-identical to the one process: "
              f"{got['tokens'] == jref['tokens']}; payloads equal to the dry "
              f"run's: {got['counts'] == jpred}; placed in "
              f"{got['place_s']:.1f} s; prefill {got['prefill_s']:.3f} s "
              f"(one process {jref['prefill_s']:.3f}), decode "
              f"{got['decode_s']:.3f} s (one process {jref['decode_s']:.3f});"
              f" peak {got['peak'] / 2 ** 30:.2f} GiB ({got['peak']} B; one "
              f"process {jref['peak'] / 2 ** 30:.2f}); {card_line()}",
              flush=True)
    print(f"[mesh-family] the ranks' phase 23 {[info['s'] for info in ranks]}"
          " s", flush=True)
    if bad:
        fail("phase 23: " + "; ".join(bad))
    t5_ranks = {}
    for path, launches in out.items():
        for k, v in launches.items():
            t5_ranks[k] = t5_ranks.get(k, 0) + v
    return {"mesh_t5": t5_ranks, "mesh_t5_reference": t5_launches,
            "mesh_encdec_decode": decode_launches,
            "mesh_encdec_decode_reference": {
                k: sum(r["launches"].get(k, 0)
                       for r in ref["decode"].values())
                for k in set().union(*(r["launches"]
                                       for r in ref["decode"].values()))},
            "mesh_jamba": jamba_launches,
            "mesh_jamba_reference": ref["jamba"]["launches"]}


# ---------------------------------------------------------------------------
# phase 24: the reference's weight-stationary serve_tp profile on phase 20's
# ranks after phase 23, and the four examples in this process
# ---------------------------------------------------------------------------

# (a) Phase 21's model (granite at full width, 12 of 24 layers, conditioned,
# dropless) served under launch/specs.PROFILES["serve_tp"] (no FSDP, embed
# (), mlp over model then data): each rank holds its 16 of the 32 experts'
# half of d_ff, the static engine gathers a step's rows over data and every
# MoE layer sums the ranks' partial outputs over data and model; phase 21's
# prompt sets and phase 4's requests, its one-process tokens the reference.
# (b) The examples at these cuts (the reference's values beside them): the
# quickstart's PRETRAIN and EXTRA 200 -> 20, the ablation's PRETRAIN 200 ->
# 20, the 100M run's 300 MoE and 50 dense steps -> 30 and 10, preempted at
# step 20 and rerun (its SLIM, batch 16 x 256 and grad_accum 2 as they are),
# its data task over the first 2,048 token ids as the training launcher's
# (launch/train.TASK_VOCAB): the whole 32,000-id vocabulary's bigram tables
# (8, V, V) are 65.5 GB of float64 on the host, more than a 96-GiB host
# holds beside phase 23's ranks.
SERVE_TP_EXPERTS = {"wi": (16, 1024, 256), "wg": (16, 1024, 256),
                    "wo": (16, 256, 1024)}
EXAMPLES = {"quickstart": dict(PRETRAIN=20, EXTRA=20),
            "ablation_initial_drop": dict(PRETRAIN=20),
            "train_upcycled_100m": ["--steps", "30", "--dense-steps", "10"],
            "preempt_at": 20}
EXAMPLE_TRAIN_KERNELS = FLASH_KERNELS + EXPERT_KERNELS


def serve_tp_ctx(cfg):
    """The ``serve_tp`` profile's ctx on phase 20's (data=2, model=2) mesh
    of the ranks' process group (its process groups built by every rank
    alike)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import PROFILES, make_ctx

    return make_ctx(make_mesh(MESH["shape"], ("data", "model"),
                              device_type="cpu"), cfg, PROFILES["serve_tp"])


def mesh_serve_tp_rank(rank, device):
    """A rank's phase 24 (a): phase 21's engines under the ``serve_tp``
    profile's ctx; returns what the parent checks (tokens, launches,
    payloads, the experts' blocks, build payloads, times, peak)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.specs import PROFILES
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.sharding import comm

    t0 = time.perf_counter()
    tag = f"[mesh-serve-tp rank {rank}]"
    cfg, params = mesh_serve_model(device)
    ctx = serve_tp_ctx(cfg)
    ac = zoo.ApplyCfg(
        pad_heads_multiple=PROFILES["serve_tp"].pad_heads_multiple)
    comm.reset_counts()
    eng = ServeEngine(params, cfg, ServeConfig(**MESH_SERVE["static"]),
                      device=device, ctx=ctx, ac=ac)
    peng = ServeEngine(params, cfg, ServeConfig(paged=True, **SERVE),
                       device=device, ctx=ctx, ac=ac)
    info = {"build": comm.counts(), "static": {},
            "experts": {k: list(w.shape) for k, w in
                        model_experts(eng.params).items()}}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    new, L = MESH_SERVE["new"], cfg.n_layers
    for case, prompts in mesh_serve_prompts(cfg).items():
        before = ops.launch_counts()
        out = eng.generate(prompts, new)
        ran = {k: v - before[k] for k, v in ops.launch_counts().items()
               if v != before[k]}
        want = {"flash_attention": L, "expert_mlp": L * new}
        if ran != want:
            fail(f"{tag} static {case}: launched {ran}, expected {want}")
        st = eng.last_stats
        rec = {"tokens": out, "prefill_s": st["prefill_s"],
               "decode_s": st["decode_s"], "launches": ran}
        if case == "seq":
            with kernel_shapes() as shapes:
                rec["counts"], wit = mesh_static_steps(eng, prompts, out, new)
            report_witness(wit, ("flash_attention", "expert_mlp"))
            info["shapes"] = {"expert_mlp": shapes.get("expert_mlp", {})}
        info["static"][case] = rec
        print(f"{tag} static {case}: prefill {st['prefill_s']:.3f} s, "
              f"{new - 1} decode steps {st['decode_s']:.3f} s "
              f"({st['decode_s'] * 1e3 / (new - 1):.1f} ms a step), "
              f"launches {ran}", flush=True)
    before = ops.launch_counts()
    with kernel_shapes() as shapes:
        outs, fin, n_gen, wall, step_ms, first, wit, cache, _ = \
            serve_session(peng, cfg, witness=True)
    report_witness(wit, SERVE_KERNELS)
    info["shapes"]["grouped_mlp_valid_rows"] = shapes.get(
        "grouped_mlp_valid_rows")
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    st = peng.last_stats
    want = {k: L * st["mixed_steps"] for k in SERVE_KERNELS}
    if ran != want:
        fail(f"{tag} paged: launched {ran}, expected {want}")
    if st["compile_count"] != 1 or any(
            r["status"] != "completed" for r in fin.values()):
        fail(f"{tag} paged: compile_count {st['compile_count']}, statuses "
             f"{st['status_counts']}")
    info["paged"] = {"tokens": {str(k): v for k, v in outs.items()},
                     "tokens_s": n_gen / wall, "step_ms": step_ms,
                     "counts": first, "launches": ran,
                     "free_blocks_at_close": st["free_blocks_at_close"]}
    info["peak"] = torch.cuda.max_memory_allocated()
    info["launches"] = {k: sum(r["launches"].get(k, 0) for r in
                               info["static"].values()) + ran.get(k, 0)
                        for k in ops.launch_counts()}
    info["s"] = time.perf_counter() - t0
    print(f"{tag} paged: {n_gen} tokens in {wall:.3f} s = "
          f"{n_gen / wall:.1f} tokens/s, {len(step_ms)} mixed steps, median "
          f"{sorted(step_ms)[len(step_ms) // 2]:.1f} ms (the first "
          f"witnessed); experts {info['experts']}; build payload B "
          f"{ {k: v for k, v in info['build'].items() if v} }; peak "
          f"{info['peak'] / 2 ** 30:.2f} GiB; phase 24 {info['s']:.1f} s",
          flush=True)
    del eng, peng, cache
    gc.collect()
    torch.cuda.empty_cache()
    return info


def mesh_serve_tp_check(peng, ref, ranks):
    """Phase 24 (a)'s checks over the ranks' results against phase 21's
    one process; returns {path: launches}."""
    from repro_torch.launch.dryrun import serve_collective_payloads
    from repro_torch.launch.specs import PROFILES, make_ctx
    from repro_torch.sharding.comm import KINDS

    cfg = peng.cfg
    prompts = mesh_serve_prompts(cfg)
    mesh = dict(zip(("data", "model"), MESH["shape"]))
    rules = make_ctx(mesh, cfg, PROFILES["serve_tp"]).param_rules
    B, new = MESH_SERVE["prompts"], MESH_SERVE["new"]
    S = MESH_SERVE["plen"][1]
    kw = dict(mesh=mesh, itemsize=4, param_rules=rules)
    pred = {
        "prefill": serve_collective_payloads(
            cfg, kind="prefill", tokens=B * S, batch=B, cache_len=S + new,
            **kw),
        "decode": serve_collective_payloads(
            cfg, kind="decode", tokens=B, batch=B, cache_len=S + new, **kw),
        "mixed": serve_collective_payloads(
            cfg, kind="mixed", tokens=SERVE["max_batch"]
            + SERVE["chunks_per_step"] * SERVE["chunk_size"],
            logits_rows=SERVE["max_batch"] + SERVE["chunks_per_step"], **kw)}
    print(f"[mesh-serve-tp] the dry run's collective payloads a rank under "
          f"serve_tp: {pred}", flush=True)
    rids = [r.rid for r in make_requests(cfg)]
    bad = []
    for rk, info in enumerate(ranks):
        tp, p21 = info["serve_tp"], info["serve"]
        s = tp["static"]
        for case in ("seq", "heads"):
            check_static_tokens(f"mesh serve_tp rank {rk} static {case} vs "
                                "phase 21's one process", s[case]["tokens"],
                                ref["static"][case]["tokens"], prompts[case],
                                peng)
        check_tokens(f"mesh serve_tp rank {rk} paged vs phase 21's one "
                     "process",
                     {int(k): v for k, v in tp["paged"]["tokens"].items()},
                     {int(k): v for k, v in ref["paged"]["tokens"].items()},
                     rids, peng)
        got = {"prefill": s["seq"]["counts"][0],
               "decode": s["seq"]["counts"][1],
               "mixed": tp["paged"]["counts"]}
        if got != pred:
            bad.append(f"rank {rk}: counted {got}")
        if tp["build"] != dict.fromkeys(KINDS, 0):
            bad.append(f"rank {rk}: the build moved {tp['build']}")
        want = {k: list(v) for k, v in SERVE_TP_EXPERTS.items()}
        if tp["experts"] != want:
            bad.append(f"rank {rk}: expert blocks {tp['experts']}, not "
                       f"{want}")
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        print(f"[mesh-serve-tp rank {rk}] static decode "
              f"{s['seq']['decode_s'] * 1e3 / (new - 1):.1f} / "
              f"{s['heads']['decode_s'] * 1e3 / (new - 1):.1f} ms a step "
              f"(phase 21's rank "
              f"{p21['static']['seq']['decode_s'] * 1e3 / (new - 1):.1f} / "
              f"{p21['static']['heads']['decode_s'] * 1e3 / (new - 1):.1f}, "
              f"one process "
              f"{ref['static']['seq']['decode_s'] * 1e3 / (new - 1):.1f}), "
              f"prefill {s['seq']['prefill_s']:.3f} s (phase 21's "
              f"{p21['static']['seq']['prefill_s']:.3f}); mixed step median "
              f"{med(tp['paged']['step_ms']):.1f} ms (phase 21's "
              f"{med(p21['paged']['step_ms']):.1f}, one process "
              f"{med(ref['paged']['step_ms']):.1f}), "
              f"{tp['paged']['tokens_s']:.1f} tokens/s; peak "
              f"{tp['peak'] / 2 ** 30:.2f} GiB ({tp['peak']} B; phase 21's "
              f"{p21['peak'] / 2 ** 30:.2f}); payload B counted = the dry "
              f"run's: {got == pred}; the build's payload B {tp['build']}; "
              f"{card_line()}", flush=True)
    print(f"[mesh-serve-tp] the ranks' phase 24 "
          f"{[info['serve_tp']['s'] for info in ranks]} s", flush=True)
    if bad:
        fail("phase 24: " + "; ".join(bad))
    total = {}
    for info in ranks:
        for k, v in info["serve_tp"]["launches"].items():
            total[k] = total.get(k, 0) + v
    return {"mesh_serve_tp": total}


def mesh_serve_tp_rows(device, shapes):
    """The expert FFN at a rank's static prefill buffer and the grouped
    forward over a rank's first mixed step's valid rows under
    ``serve_tp`` (16 experts, f 256; random weights, in one ragged
    group), against the plain versions and the per-expert chain."""
    import torch

    from repro_torch.configs import get_config

    full = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=float(full.moe.num_experts)))
    gen = torch.Generator(device=device).manual_seed(41)
    E, d, f = SERVE_TP_EXPERTS["wi"]
    ex = {"wi": torch.randn(E, d, f, generator=gen, device=device) * d ** -.5,
          "wg": torch.randn(E, d, f, generator=gen, device=device) * d ** -.5,
          "wo": torch.randn(E, f, d, generator=gen, device=device) * f ** -.5}
    B, S = MESH_SERVE["prompts"], MESH_SERVE["plen"][1]
    rows = [expert_shape_row("mesh_serve_tp_local", cfg, ex, B * S, device,
                             seed=42)]
    got = rows[0][2]["shape"]
    ran = sorted(shapes["expert_mlp"])
    if f"{tuple(got[:4])} x {E}" not in ran:
        fail(f"phase 24: the timed expert buffer {got} is none of the "
             f"rank's {ran}")
    half = dataclasses.replace(cfg, d_ff=f, moe=dataclasses.replace(
        cfg.moe, num_experts=E))
    rows.append(grouped_shape_row(
        "mesh_serve_tp_local", half, None, device, seed=43,
        n_assign=shapes["grouped_mlp_valid_rows"]))
    return rows


def _load_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(device):
    """Phase 24 (b): the four examples in this process on the card at
    :data:`EXAMPLES`'s cuts, each example's kernel launches counted and
    its losses held finite; the served MoE through the kernels against
    the same example through the plain versions. Returns {path:
    launches}."""
    import io
    import shutil
    import signal
    import tempfile

    import torch

    from repro_torch.data import ClusteredBigramTask
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo

    t_phase = time.perf_counter()
    print(f"[examples] start with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    launches = {}

    def run(path, fn, expect, counted=True):
        before = ops.launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fn()
        torch.cuda.synchronize()
        text = buf.getvalue()
        ran = {k: v - before[k] for k, v in ops.launch_counts().items()
               if v != before[k]}
        for line in text.splitlines()[-6:]:
            print(f"[examples] {path} | {line}", flush=True)
        print(f"[examples] {path}: {time.perf_counter() - t0:.1f} s, "
              f"launches {ran}", flush=True)
        if counted:
            missing = [k for k in expect if not ran.get(k)]
            if missing:
                fail(f"phase 24 {path}: never launched {missing}")
            total = launches.setdefault(f"example_{path}", {})
            for k, v in ran.items():
                total[k] = total.get(k, 0) + v
        elif ran:
            fail(f"phase 24 {path}: the plain run launched {ran}")
        return res, text

    def finite(path, *vals):
        if not all(math.isfinite(v) for v in vals):
            fail(f"phase 24 {path}: non-finite losses {vals}")

    dev = ["--device", "cuda"]
    mod = _load_example("quickstart")
    for k, v in EXAMPLES["quickstart"].items():
        setattr(mod, k, v)
    res, _ = run("quickstart", lambda: mod.main(dev), EXAMPLE_TRAIN_KERNELS)
    finite("quickstart", *res.values())
    mod = _load_example("ablation_initial_drop")
    for k, v in EXAMPLES["ablation_initial_drop"].items():
        setattr(mod, k, v)
    # Dense steps, then the upcycled models' forward losses only.
    res, _ = run("ablation_initial_drop", lambda: mod.main(dev),
                 FLASH_KERNELS + ("expert_mlp",))
    finite("ablation_initial_drop", res["dense_ce"], res["eval_dense_ce"],
           *res["grid"].values())
    mod = _load_example("train_upcycled_100m")
    mod.make_iterator = functools.partial(
        mod.make_iterator, task=ClusteredBigramTask(
            vocab_size=min(mod.SLIM.vocab_size, TASK_VOCAB)))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
    flags = EXAMPLES["train_upcycled_100m"] + ["--ckpt-dir", tmp] + dev
    term = signal.getsignal(signal.SIGTERM)
    try:
        at = EXAMPLES["preempt_at"]
        res, text = run("train_upcycled_100m",
                        lambda: mod.main(flags + ["--preempt-at", str(at)]),
                        EXAMPLE_TRAIN_KERNELS)
        if f"preempted at step {at}" not in text:
            fail(f"phase 24: the 100M run was not preempted at step {at}")
        res, text = run("train_upcycled_100m", lambda: mod.main(flags),
                        EXAMPLE_TRAIN_KERNELS)
        steps = int(EXAMPLES["train_upcycled_100m"][1])
        if f"resumed from step {at}" not in text or \
                int(res["state"]["step"]) != steps:
            fail(f"phase 24: the 100M rerun did not resume from step {at} "
                 f"to {steps}")
        finite("train_upcycled_100m", res["metrics"]["loss"])
    finally:
        # The example installs its SIGTERM handler (PreemptionSignal).
        signal.signal(signal.SIGTERM, term)
        shutil.rmtree(tmp, ignore_errors=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    for paged in (False, True):
        flags = (["--paged"] if paged else []) + dev
        path = "serve_moe" + ("_paged" if paged else "")
        kernels = SERVE_KERNELS if paged else ("flash_attention",
                                               "expert_mlp")
        mod = _load_example("serve_moe")
        got, _ = run(path, lambda: mod.main(flags), kernels)
        mod.ServeEngine = functools.partial(
            mod.ServeEngine,
            ac=zoo.ApplyCfg(moe_impl="eager", attn_impl="eager"))
        want, _ = run(path + "_plain", lambda: mod.main(flags), (),
                      counted=False)
        if got != want:
            fail(f"phase 24 {path}: the greedy outputs through the kernels "
                 f"{got} differ from the plain versions' {want}")
        print(f"[examples] {path}: greedy outputs through the kernels "
              "token-identical to the plain versions'", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[examples] phase 24 (b) {time.perf_counter() - t_phase:.1f} s; "
          f"{card_line()}", flush=True)
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
    from repro_torch.models.param import count_params, tree_map
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
    check_tokens("greedy outputs vs the plain run", outs, outs_e,
                 [r.rid for r in make_requests(cfg)], eng)
    tps = {"kernels": [n_gen / wall], "plain": [n_gen_e / wall_e]}
    for _ in range(SERVE_RUNS - 1):
        for key, want in (("kernels", outs), ("plain", outs_e)):
            got, _, n, w = serve_once(eng if key == "kernels" else eager,
                                      cfg)
            if got != want:
                fail(f"a repeated {key} serve run changed its outputs")
            tps[key].append(n / w)
    for key, v in tps.items():
        print(f"[serve] {key}: tokens/s over {len(v)} runs = "
              f"{', '.join(f'{x:.1f}' for x in v)} (median "
              f"{sorted(v)[len(v) // 2]:.1f})", flush=True)
    chunked_outs = outs
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
    # Phase 16 starts from this upcycled MoE and batch (on the host
    # until then).
    knob_params = tree_map(lambda t: t.cpu(), first_params)
    knob_batch = first_batch
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
    # full width (RWKV_LAYERS layers) and on its upcycled channel-mix MoE.
    records.append(check_rwkv_kernel(get_config("rwkv6-7b"), device))
    rwkv_launches = rwkv_dense(device)
    torch.cuda.empty_cache()
    rwkv_moe_launches, rows = rwkv_moe(device)
    shape_rows += rows
    torch.cuda.empty_cache()

    # Checkpoints and the Trainer: dense checkpoint -> --upcycle-from ->
    # MoE checkpoint -> served, at full width and depth.
    ckpt_launches = checkpoint_chain(device)
    gc.collect()  # the chain's Trainers hold tensors in reference cycles
    torch.cuda.empty_cache()

    # The paper's language model, then whisper-base: the encoder-decoder
    # family trained and decoded.
    encdec_launches, rows = t5_path(device)
    shape_rows += rows
    torch.cuda.empty_cache()
    encdec_launches.update(whisper_path(device))
    gc.collect()
    torch.cuda.empty_cache()

    # The rest of the serving engine on granite: prefill-on-join,
    # speculative decoding, robustness and chaos, the fleet.
    modes_launches, rows = serve_engine_modes(cfg, device, chunked_outs)
    shape_rows += rows
    gc.collect()
    torch.cuda.empty_cache()

    # The rest of training: remat, the chunked CE, gradient accumulation
    # and compression, bfloat16 compute, AdamW, the launcher with them.
    knob_launches, bf16_records, bf16_fwd = knobs_path(device, knob_params,
                                                       knob_batch)
    del knob_params
    bf16_at = {r["name"]: {k: v for k, v in r.items() if k not in (
        "name", "route", "source", "replaces")} for r in bf16_records}
    bf16_at["grouped_mlp"] = bf16_fwd
    gc.collect()
    torch.cuda.empty_cache()

    # The other families: jamba's hybrid trained, upcycled and served,
    # pixtral trained and decoded with patches, the config-only decoders
    # served through the kernels.
    family_launches, rows = other_families(device)
    shape_rows += rows
    gc.collect()
    torch.cuda.empty_cache()

    # Multi-GPU: the fixed-order MoE combine, --ep a2a in the launcher,
    # granite expert-parallel over 2 ranks sharing the card, query-head
    # padding through the flash kernels.
    multi_launches = multi_gpu(device)

    # A step's counted FLOPs and bytes against the dry run on the meta
    # device, and the steps' mfu.
    cost_launches = step_costs(device)
    gc.collect()
    torch.cuda.empty_cache()

    # The rules' placement: granite and the ViT trained on a (data=2,
    # model=2) mesh of 4 ranks sharing the card, against one process.
    # Serving under the same placement: granite's static and paged
    # engines on the same ranks, against one process.
    mesh_launches, rows, serve_launches = mesh_train(device)
    mesh_launches.update(serve_launches)
    shape_rows += rows

    for rec in records:
        name = rec["name"]
        by_path = {"serve": launches.get(name, 0),
                   "granite_static": static_launches.get(name, 0),
                   "granite_train": train_launches.get(name, 0),
                   "vit_train": vit_launches.get(name, 0),
                   "rwkv_static": rwkv_launches.get(name, 0),
                   "rwkv_moe_static": rwkv_moe_launches.get(name, 0),
                   "checkpoint_chain": ckpt_launches.get(name, 0)}
        by_path.update({path: n.get(name, 0)
                        for path, n in encdec_launches.items()})
        by_path.update({path: n.get(name, 0)
                        for path, n in modes_launches.items()})
        by_path["training_knobs"] = knob_launches.get(name, 0)
        by_path.update({path: n.get(name, 0)
                        for path, n in family_launches.items()})
        by_path.update({path: n.get(name, 0)
                        for path, n in multi_launches.items()})
        by_path["step_cost"] = cost_launches.get(name, 0)
        by_path.update({path: n.get(name, 0)
                        for path, n in mesh_launches.items()})
        rec["launches"] = sum(by_path.values())
        if name in bf16_at:
            rec["bf16_at_train_shapes"] = bf16_at[name]
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
