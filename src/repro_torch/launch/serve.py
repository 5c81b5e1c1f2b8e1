"""Serving launcher of the port: weights from the newest valid
checkpoint in ``--ckpt-dir`` (or random ones from a seed), served
through the static-batch engine, or with ``--paged`` through the paged
chunked engine (the static and paged chunked subsets of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch rwkv6-7b|granite-moe-1b-a400m [--reduced] [--max-new 16] \\
        [--ckpt-dir DIR] [--max-batch 4] [--temperature 0.8] \\
        [--device cuda|cpu] \\
        [--paged [--block-size 16] [--chunk-size 32] \\
         [--chunks-per-step 1] [--no-prefix-cache] [--stream]]

``--ckpt-dir`` reads the ``params`` of a params-only checkpoint or of a
Trainer's full train state alike (the reference's loader takes the
first form only: ROADMAP.md queue 3). Without ``--paged`` the prompts
are served as one static batch (any stack the port runs: attention or
rwkv6); ``--paged`` serves attention-only stacks with continuous
batching. Runs on the card by default and raises without one;
``--device cpu`` runs the plain PyTorch path. Prefill-on-join admission,
speculative decoding, robustness knobs and the fleet are queued in
ROADMAP.md.
"""
from __future__ import annotations

import argparse


def load_params(cfg, *, device, manager=None):
    """The served weights: ``zoo.init_params`` from seed 0, replaced by
    the ``params`` subtree of ``manager``'s newest valid checkpoint
    where there is one (one manager a process, as in the reference).
    Returns (params, the checkpoint's step or None)."""
    import torch

    from repro_torch.models import model_zoo as zoo

    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    if manager is None:
        return params, None
    restored, step, _ = manager.restore_latest(params, key="params")
    if restored is None:
        return params, None
    return restored, step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default="",
                    help="serve the params of the newest valid checkpoint "
                         "there")
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over a paged KV cache")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV tokens per pool block")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="prompt tokens per prefill chunk lane")
    ap.add_argument("--chunks-per-step", type=int, default=1,
                    help="prefill chunk lanes per mixed step")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable block-level prompt-prefix reuse")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated (--paged)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    params, step = load_params(cfg, device=device, manager=manager)
    if step is not None:
        print(f"[serve] loaded checkpoint step {step}")
    sc = ServeConfig(max_batch=args.max_batch, max_len=256,
                     temperature=args.temperature, paged=args.paged,
                     block_size=args.block_size, chunk_size=args.chunk_size,
                     chunks_per_step=args.chunks_per_step,
                     prefix_cache=not args.no_prefix_cache)
    eng = ServeEngine(params, cfg, sc, device=device)
    demo = [[1, 2, 3], [10, 20], [7, 7, 7, 7]][: args.max_batch]
    if not args.paged:
        for i, seq in enumerate(eng.generate(demo, max_new=args.max_new)):
            print(f"[serve] req{i}: {demo[i]} -> {seq[len(demo[i]):]}")
        es = eng.last_stats
        print(f"[serve] engine: device={device} mode={es['mode']} "
              f"batch={es['batch']} prompt_len={es['prompt_len']} "
              f"decode_steps={es['decode_steps']}")
        return
    # Staggered arrivals show mid-flight admission.
    reqs = [Request(rid=i, prompt=p, max_new=args.max_new, arrival=2 * i)
            for i, p in enumerate(demo)]
    on_token = ((lambda rid, t: print(f"[serve] req{rid} += {t}",
                                      flush=True))
                if args.stream else None)

    def on_event(rid, ev, detail):
        print(f"[serve] req{rid} event: {ev}"
              + (f" ({detail})" if detail else ""), flush=True)

    outs, stats = eng.serve(reqs, on_token=on_token, on_event=on_event)
    for i, p in enumerate(demo):
        s = stats[i]
        print(f"[serve] req{i}: {p} -> {outs[i][len(p):]} "
              f"({s['status']}/{s['reason']} admitted@{s['admitted_at']} "
              f"done@{s['finished_at']} prefix_hit={s['prefix_tokens']})")
    es = eng.last_stats
    print(f"[serve] engine: device={device} mode={es['mode']} "
          f"steps={es['mixed_steps']} compile_count={es['compile_count']} "
          f"prefix_hit_frac={es['prefix_hit_frac']:.2f} "
          f"status_counts={es['status_counts']}")


if __name__ == "__main__":
    main()
