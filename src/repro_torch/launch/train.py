"""Training launcher of the port (port of ``repro/launch/train.py``,
single process): the fault-tolerant ``Trainer`` with checkpoints in
``--ckpt-dir`` (auto-resume from the newest valid one), Adafactor on an
inverse-sqrt schedule, the arch's synthetic stream (clustered bigrams
for a decoder-only LM, the patch task for the encoder-only ViT).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m|vit-b16-upcycled [--reduced] \\
        [--steps 100] [--batch 8] [--seq 64] [--ckpt-dir DIR] \\
        [--upcycle-from DENSE_DIR] [--impl auto|cuda|eager] \\
        [--dispatch gather|einsum|sorted] [--peak-lr 0.01] \\
        [--warmup 100] [--obs-jsonl PATH] [--spike-threshold X ...] \\
        [--train-chaos SEED] [--device cuda|cpu]

``--upcycle-from`` restores the dense parent's params from the newest
valid checkpoint there — a params-only checkpoint or a Trainer's full
train state — and upcycles them into ``--arch`` (routers from a
generator seeded 7, as the reference's ``PRNGKey(7)``); the MoE then
trains from step 0 with fresh optimizer state, as in the reference.

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch path. The data task covers at most the first
``TASK_VOCAB`` token ids (its bigram tables are (K, V, V)). An
encoder-only model's sequence is its patches: ``--seq`` is not read.
``--grad-accum``, ``--compression``, ``--remat`` and ``--ep`` are queued
in ROADMAP.md.
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> None:
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
    ap.add_argument("--upcycle-from", default="",
                    help="dense checkpoint dir to sparse-upcycle from")
    ap.add_argument("--peak-lr", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--obs-jsonl", default="", metavar="PATH",
                    help="stream per-step train rows + checkpoint "
                         "counters as JSONL (src/repro/obs/README.md)")
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
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.models import model_zoo as zoo
    from repro_torch.obs import JsonlSink, Tracker
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import (
        PreemptionSignal,
        TrainChaosConfig,
        TrainConfig,
        Trainer,
    )

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = adafactor(inverse_sqrt(peak=args.peak_lr,
                                 warmup_steps=args.warmup))
    tc = TrainConfig(spike_threshold=args.spike_threshold,
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
        print(f"[train] upcycled from {args.upcycle_from} @ step {step}")

    # SIGTERM saves and exits cleanly while the run lasts; the handler
    # the process had comes back after it.
    term = signal.getsignal(signal.SIGTERM)
    sig = PreemptionSignal().install()
    ac = zoo.ApplyCfg(dispatch=args.dispatch, moe_impl=args.impl,
                      attn_impl=args.impl).resolve(device)
    print(f"[train] kernels: moe={ac.moe_impl} attn={ac.attn_impl} "
          f"dispatch={ac.dispatch} device={device}", flush=True)
    tracker = Tracker((JsonlSink(args.obs_jsonl),)) \
        if args.obs_jsonl else None
    chaos = None
    if args.train_chaos is not None:
        chaos = TrainChaosConfig(
            seed=args.train_chaos, spike_prob=0.05,
            io_fault_prob=0.2, preempt_prob=0.0,
        )
    tr = Trainer(cfg, opt, it, args.ckpt_dir, ac=ac, tc=tc, preemption=sig,
                 tracker=tracker, chaos=chaos, device=device)
    try:
        out = tr.run(args.steps, init_params=init_params)
    finally:
        signal.signal(signal.SIGTERM, term)
        if tracker is not None:
            tracker.close()
    if tr.stats.get("rollbacks"):
        print(f"[train] survived {len(tr.stats['rollbacks'])} "
              "divergence rollback(s)")
    loss = out["metrics"].get("loss", float("nan"))
    print(f"[train] finished at step {int(out['state']['step'])}, "
          f"loss {loss:.4f}")


if __name__ == "__main__":
    main()
