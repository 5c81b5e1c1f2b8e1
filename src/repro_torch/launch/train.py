"""Training launcher of the port (the single-process step subset of
``repro/launch/train.py``): random weights from a seed, Adafactor on an
inverse-sqrt schedule, the arch's synthetic stream (clustered bigrams
for a decoder-only LM, the patch task for the encoder-only ViT).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m|vit-b16-upcycled [--reduced] \\
        [--steps 6] [--batch 8] [--seq 64] [--impl auto|cuda|eager] \\
        [--dispatch gather|einsum|sorted] [--peak-lr 0.01] \\
        [--warmup 100] [--device cuda|cpu]

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch path. The data task covers at most the first
``TASK_VOCAB`` token ids (its bigram tables are (K, V, V)). An
encoder-only model's sequence is its patches: ``--seq`` is not read.
Checkpoints (``--ckpt-dir``), ``--upcycle-from``, remat, accumulation,
compression and the Trainer runtime are queued in ROADMAP.md.
"""
from __future__ import annotations

import argparse

TASK_VOCAB = 2048


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
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
    ap.add_argument("--peak-lr", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = adafactor(inverse_sqrt(peak=args.peak_lr,
                                 warmup_steps=args.warmup))
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    it = make_iterator(cfg, global_batch=args.batch, seq_len=args.seq,
                       task=task)
    ac = zoo.ApplyCfg(dispatch=args.dispatch, moe_impl=args.impl,
                      attn_impl=args.impl).resolve(device)
    print(f"[train] kernels: moe={ac.moe_impl} attn={ac.attn_impl} "
          f"dispatch={ac.dispatch} device={device}", flush=True)
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device=device)
    step = make_train_step(cfg, opt, ac=ac)
    mets = None
    for _ in range(args.steps):
        state, mets = step(state, next(it))
    loss = float(mets["loss"]) if mets is not None else float("nan")
    print(f"[train] finished at step {int(state['step'])}, loss {loss:.4f}")


if __name__ == "__main__":
    main()
