"""Training launcher of the port (port of ``repro/launch/train.py``):
the fault-tolerant ``Trainer`` with checkpoints in
``--ckpt-dir`` (auto-resume from the newest valid one), Adafactor on an
inverse-sqrt schedule, the arch's synthetic stream (clustered bigrams
for a decoder-only LM, span corruption for T5, stub frames for whisper,
the patch task for the encoder-only ViT).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch ARCH [--reduced] \\
        [--steps 100] [--batch 8] [--seq 64] [--ckpt-dir DIR] \\
        [--upcycle-from DENSE_DIR] [--impl auto|cuda|eager] \\
        [--dispatch gather|einsum|sorted] [--grad-accum 1] \\
        [--compression none|bf16|int8] [--remat none|full|dots|moe] \\
        [--ep none|a2a] [--ep-budget-factor 2.0] [--peak-lr 0.01] \\
        [--warmup 100] [--obs-jsonl PATH] \\
        [--spike-threshold X ...] [--train-chaos SEED] [--device cuda|cpu]

``--upcycle-from`` restores the dense parent's params from the newest
valid checkpoint there — a params-only checkpoint or a Trainer's full
train state — and upcycles them into ``--arch`` (routers from a
generator seeded 7, as the reference's ``PRNGKey(7)``); the MoE then
trains from step 0 with fresh optimizer state, as in the reference.

``--arch`` is any registered arch (``repro_torch.configs.list_configs``):
the ten assigned ones (pixtral-12b, qwen2.5-14b, tinyllama-1.1b,
qwen1.5-0.5b, yi-9b, grok-1-314b, granite-moe-1b-a400m, whisper-base,
rwkv6-7b, jamba-1.5-large-398b) and the paper's t5-base-upcycled and
vit-b16-upcycled. pixtral-12b's stream adds stub patch embeddings over
its first positions.

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch path. The data task covers at most the first
``TASK_VOCAB`` token ids (its bigram tables are (K, V, V)). An
encoder-only model's sequence is its patches: ``--seq`` is not read. An
encoder-decoder model's ``--seq`` is its encoder length, its decoder
length ``max(seq // 4, 8)``; ``--upcycle-from`` upcycles its encoder
and decoder stacks (t5-base-upcycled: Expert Choice in the encoder,
top-2 in the decoder).

``--grad-accum A`` sums the gradients of A microbatches of ``--batch /
A`` rows a step; ``--compression`` compresses them with error feedback
(the residual rides in every checkpoint); ``--remat`` recomputes each
layer body's activations in the backward, saving what the policy names
(``moe``: the MoE layers' outputs only). The stack's mixer runs the
reference launcher's path: an rwkv6 stack trains through autograd of
the plain chunked WKV (``mixer_impl="eager"``, printed on the kernels
line), since the WKV kernel is forward-only; jamba's mamba layers run
the reference's recurrence as plain PyTorch ops, no kernel
(``mamba=scan`` on the kernels line).

One process, or one per rank under ``torchrun`` (``WORLD_SIZE`` > 1):
the launcher then initialises the process group from the environment
(``nccl`` on CUDA, each rank on ``cuda:LOCAL_RANK``; ``gloo`` with
``--device cpu``), builds the mesh — ``(data=1, model=world)`` under
``--ep a2a``, ``(data=world,)`` otherwise — and trains with that
``ShardCtx``: the state takes the rules' placement
(``sharding.train_layout``). On ``(data=world,)`` that is FSDP: each
rank takes its rows of every batch and holds its block of every
``embed`` dim, gathered at use and its gradient reduce-scattered. Under
``--ep a2a`` (``--dispatch sorted``) it is tensor parallelism of heads,
KV heads, ``mlp`` and ``vocab`` over the ``world`` ranks, which take
the same rows, with the MoE layers expert-parallel on top: each rank
holds ``E / world`` experts and sends its block of the routing groups
through the all-to-all (budget ``--ep-budget-factor``; the groups must
divide the ranks), as the reference's default rules compose them.
Gradients are reduced over the ranks, and checkpoints hold the global
state (written by rank 0). The
``model`` axis's tensor parallelism is reached through the API
(``ShardCtx.for_mesh`` on a mesh with one, as the reference's
launcher builds none). In one process ``--ep a2a`` falls back to the
single-device sorted path, as the reference's launcher does without a
mesh:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --reduced --steps 3 --batch 4 \\
        --seq 16 --dispatch sorted --ep a2a --device cpu --ckpt-dir DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import signal

TASK_VOCAB = 2048


def upcycle_from(directory: str, cfg, *, device):
    """The ``--upcycle-from`` restore: the dense parent's params
    (``cfg.dense_parent()``) from the newest valid checkpoint in
    ``directory`` (its ``params`` subtree, whichever form the checkpoint
    has), upcycled into ``cfg`` with a generator seeded 7. Returns
    (dense params, upcycled params, the checkpoint's step); raises
    ``FileNotFoundError`` when ``directory`` holds no checkpoint."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.models import model_zoo as zoo

    if cfg.moe is None:
        raise ValueError(f"--upcycle-from needs an arch with MoE, not "
                         f"{cfg.name}")
    dense_cfg = cfg.dense_parent()
    like = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                           dense_cfg, device=device)
    dense, step, _ = CheckpointManager(directory).restore_latest(
        like, key="params")
    if dense is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    del like
    sparse = upcycle_params(dense, dense_cfg, cfg,
                            torch.Generator(device=device).manual_seed(7))
    return dense, sparse, step


def apply_cfg(args, device):
    """The ``ApplyCfg`` the launcher trains with: ``--impl`` for
    attention and the experts, ``--dispatch``, ``--remat``, and the
    mixer on the reference launcher's path, "eager" (the chunked WKV
    under autograd; the WKV kernel has no backward), resolved for
    ``device``."""
    from repro_torch.models import model_zoo as zoo

    return zoo.ApplyCfg(dispatch=args.dispatch, moe_impl=args.impl,
                        attn_impl=args.impl, mixer_impl="eager",
                        remat=args.remat).resolve(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="artifacts/train_run")
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "cuda", "eager"],
                    help="kernels for attention and the expert FFN: "
                         "'auto' = the CUDA kernels (forward and backward) "
                         "on the card, the plain versions on the CPU")
    ap.add_argument("--dispatch", default="gather",
                    choices=["gather", "einsum", "sorted"],
                    help="MoE dispatch: 'gather'/'einsum' build the padded "
                         "capacity buffer (the expert-FFN kernels), "
                         "'sorted' the ragged buffer (the grouped-GEMM "
                         "kernels)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches a step (--batch must be a multiple)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"],
                    help="gradient compression with error feedback")
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots", "moe"],
                    help="recompute each layer body in the backward: "
                         "'full' saves nothing inside it, 'dots' the dense "
                         "matmuls' outputs, 'moe' the MoE layers' outputs "
                         "only")
    ap.add_argument("--ep", default="none", choices=["none", "a2a"],
                    help="expert parallelism for --dispatch sorted over "
                         "the ranks of a torchrun job (one process: the "
                         "single-device path)")
    ap.add_argument("--ep-budget-factor", type=float, default=2.0,
                    help="EP a2a send-buffer row budget as a multiple of "
                         "the balanced per-peer share")
    ap.add_argument("--upcycle-from", default="",
                    help="dense checkpoint dir to sparse-upcycle from")
    ap.add_argument("--peak-lr", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--obs-jsonl", default="", metavar="PATH",
                    help="stream per-step train rows + checkpoint "
                         "counters as JSONL (src/repro_torch/obs/README.md)")
    ap.add_argument("--spike-threshold", type=float, default=0.0,
                    help="divergence detector: roll back when a finite "
                         "loss exceeds this multiple of the trailing "
                         "baseline (0 = detector off)")
    ap.add_argument("--spike-window", type=int, default=32,
                    help="trailing-loss window the spike baseline is "
                         "computed over")
    ap.add_argument("--spike-mode", default="median",
                    choices=["median", "ewma"],
                    help="spike baseline: median of the window (robust) "
                         "or EWMA (tracks a falling curve tighter)")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="abort with the rollback history after this "
                         "many divergence rollbacks")
    ap.add_argument("--rollback-skip", type=int, default=8,
                    help="batches to fast-forward past the offending "
                         "batch after a rollback (PaLM-style skip)")
    ap.add_argument("--rollback-lr-decay", type=float, default=1.0,
                    help="LR multiplier applied for --rollback-cooldown "
                         "steps after a rollback (1.0 = no decay)")
    ap.add_argument("--rollback-cooldown", type=int, default=0,
                    help="steps the post-rollback LR decay stays active")
    ap.add_argument("--train-chaos", type=int, default=None,
                    metavar="SEED",
                    help="seeded train-side fault injection: loss "
                         "spikes, transient store IO faults "
                         "(repro_torch.training.chaos; exercises the "
                         "rollback + resume machinery end to end)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def init_distributed(device):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): initialise the process
    group from the environment and return (this rank's device, world
    size); else (``device``, 1)."""
    import os

    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device, 1
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo")
    return device, world


def main(argv=None) -> dict:
    """Run the launcher; returns the Trainer's result (``state``,
    ``metrics``, ``stats``)."""
    args = parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.models.stack import layer_descs
    from repro_torch.obs import JsonlSink, Tracker
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import (
        PreemptionSignal,
        TrainChaosConfig,
        TrainConfig,
        Trainer,
    )

    device, world = init_distributed(resolve_device(args.device))
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.moe is not None and args.ep != "none":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep=args.ep, ep_budget_factor=args.ep_budget_factor))
    ctx = None
    if world > 1:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.sharding import ShardCtx

        shape, axes = (((1, world), ("data", "model")) if args.ep == "a2a"
                       else ((world,), ("data",)))
        ctx = ShardCtx.for_mesh(
            make_mesh(shape, axes, device_type=device.type), cfg=cfg)
    say = print if ctx is None or torch.distributed.get_rank() == 0 \
        else (lambda *a, **k: None)
    opt = adafactor(inverse_sqrt(peak=args.peak_lr,
                                 warmup_steps=args.warmup))
    tc = TrainConfig(grad_accum=args.grad_accum,
                     compression=args.compression,
                     spike_threshold=args.spike_threshold,
                     spike_window=args.spike_window,
                     spike_mode=args.spike_mode,
                     max_rollbacks=args.max_rollbacks,
                     rollback_skip=args.rollback_skip,
                     rollback_lr_decay=args.rollback_lr_decay,
                     rollback_cooldown=args.rollback_cooldown)
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(cfg, global_batch=args.batch, seq_len=args.seq,
                       task=task)

    init_params = None
    if args.upcycle_from:
        try:
            _, init_params, step = upcycle_from(args.upcycle_from, cfg,
                                                device=device)
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(str(e))
        say(f"[train] upcycled from {args.upcycle_from} @ step {step}")

    # SIGTERM saves and exits cleanly while the run lasts; the handler
    # the process had comes back after it.
    term = signal.getsignal(signal.SIGTERM)
    sig = PreemptionSignal().install()
    ac = apply_cfg(args, device)
    mamba = any(d.mixer == "mamba" for d in layer_descs(cfg))
    say(f"[train] kernels: moe={ac.moe_impl} attn={ac.attn_impl} "
        f"dispatch={ac.dispatch} mixer={ac.mixer_impl} remat={ac.remat} "
        f"device={device}" + (" mamba=scan (plain ops, no kernel)"
                              if mamba else "")
        + (f" ranks={world} mesh={ctx.shape}" if ctx is not None else ""),
        flush=True)
    tracker = Tracker((JsonlSink(args.obs_jsonl),)) \
        if args.obs_jsonl else None
    chaos = None
    if args.train_chaos is not None:
        chaos = TrainChaosConfig(
            seed=args.train_chaos, spike_prob=0.05,
            io_fault_prob=0.2, preempt_prob=0.0,
        )
    tr = Trainer(cfg, opt, it, args.ckpt_dir, ac=ac, tc=tc, preemption=sig,
                 tracker=tracker, chaos=chaos, device=device, ctx=ctx,
                 log_fn=say)
    try:
        out = tr.run(args.steps, init_params=init_params)
    finally:
        signal.signal(signal.SIGTERM, term)
        if tracker is not None:
            tracker.close()
    if tr.stats.get("rollbacks"):
        say(f"[train] survived {len(tr.stats['rollbacks'])} "
            "divergence rollback(s)")
    loss = out["metrics"].get("loss", float("nan"))
    say(f"[train] finished at step {int(out['state']['step'])}, "
        f"loss {loss:.4f}")
    return out


if __name__ == "__main__":
    main()
