"""Serving launcher of the port (port of ``repro/launch/serve.py``):
weights from the newest valid checkpoint in ``--ckpt-dir`` (or random
ones from a seed), served through the static-batch engine, or with
``--paged`` through the paged engine, solo or as a replica fleet.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch ARCH [--reduced] [--max-new 16] \\
        [--ckpt-dir DIR] [--max-batch 4] [--temperature 0.8] \\
        [--device cuda|cpu] [--obs-jsonl PATH] \\
        [--paged [--block-size 16] [--admission chunked|prefill_on_join] \\
         [--chunk-size 32] [--chunks-per-step 1] [--no-prefix-cache] \\
         [--draft none|dense|top1 [--spec-k 4]] [--stream] \\
         [robustness flags] [--chaos SEED] [fleet flags]]

``--arch`` is any registered decoder-only arch (pixtral-12b,
qwen2.5-14b, tinyllama-1.1b, qwen1.5-0.5b, yi-9b, grok-1-314b,
granite-moe-1b-a400m, rwkv6-7b, jamba-1.5-large-398b; pixtral is served
on text prompts, without patches). ``--ckpt-dir`` reads the ``params``
of a params-only checkpoint or of a Trainer's full train state alike
(the reference's loader takes the first form only: ROADMAP.md queue 3).
Without ``--paged`` the prompts are served as one static batch (any
stack the port runs: attention, jamba's mamba and attention hybrid,
rwkv6); ``--paged`` serves attention-only stacks with continuous
batching. ``--admission prefill_on_join`` selects the pre-chunking
per-admission prefill. ``--draft dense`` (or ``top1``) turns on
speculative decoding: the dense parent sliced out of the MoE drafts
``--spec-k`` tokens a slot and the MoE verifies them in one pass.

Robustness (chunked admission): ``--queue-limit`` / ``--queue-policy``
bound the wait queue, ``--shed-occupancy`` / ``--shed-stall-ticks``
drive load shedding, ``--preempt`` enables preempt-and-requeue,
``--ttft-deadline`` / ``--deadline`` set default deadlines in ticks,
``--watchdog-ticks`` bounds zero-progress spins and ``--chaos SEED``
arms the seeded fault injector. Every request ends in exactly one
terminal status.

Fleet (``--fleet N``, paged + chunked): N replica sessions behind the
health-checked router; ``--fleet-kill TICK:EID`` (repeatable),
``--fleet-hedge-after``, ``--fleet-restart-after`` (with ``--ckpt-dir``
the replacement reloads the newest checkpoint), ``--fleet-timeline``
(per-tick JSONL) and ``--fleet-autoscale MAX``. ``--obs-jsonl PATH``
streams the tracker's rows. Runs on the card by default and raises
without one; ``--device cpu`` runs the plain PyTorch path.
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
    ap.add_argument("--admission", default="chunked",
                    choices=["chunked", "prefill_on_join"],
                    help="paged admission path (chunked = mixed step)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable block-level prompt-prefix reuse")
    ap.add_argument("--draft", default="none",
                    choices=["none", "dense", "top1"],
                    help="speculative decoding draft model: the dense "
                         "parent sliced from the MoE, or a top-1 routing "
                         "truncation (chunked admission)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per verify pass (--draft)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated (--paged)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    rb = ap.add_argument_group("robustness (chunked admission)")
    rb.add_argument("--queue-limit", type=int, default=0,
                    help="max visible waiting requests (0 = unbounded)")
    rb.add_argument("--queue-policy", default="block",
                    choices=["block", "shed-newest", "shed-oldest"])
    rb.add_argument("--shed-occupancy", type=float, default=None,
                    help="pool-occupancy fraction that triggers shedding")
    rb.add_argument("--shed-stall-ticks", type=int, default=0,
                    help="consecutive block-starved ticks that trigger "
                         "shedding (0 = off)")
    rb.add_argument("--preempt", action="store_true",
                    help="preempt-and-requeue lower-priority requests "
                         "under pool exhaustion")
    rb.add_argument("--ttft-deadline", type=int, default=None,
                    help="default first-token deadline (ticks after "
                         "arrival)")
    rb.add_argument("--deadline", type=int, default=None,
                    help="default completion deadline (ticks after "
                         "arrival)")
    rb.add_argument("--watchdog-ticks", type=int, default=32,
                    help="zero-progress ticks before the watchdog fails "
                         "the stuck head")
    rb.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="arm the seeded fault injector")
    fl = ap.add_argument_group("fleet (paged + chunked admission)")
    fl.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through N replica sessions behind the "
                         "health-checked router (0/1 = solo engine)")
    fl.add_argument("--fleet-kill", action="append", default=[],
                    metavar="TICK:EID",
                    help="kill engine EID at fleet tick TICK "
                         "(repeatable; work migrates to survivors)")
    fl.add_argument("--fleet-hedge-after", type=int, default=0,
                    help="ticks without progress before a hedged "
                         "duplicate dispatch (0 = off)")
    fl.add_argument("--fleet-restart-after", type=int, default=0,
                    help="ticks after death before a fresh engine "
                         "rejoins (0 = never; with --ckpt-dir the "
                         "replacement reloads the latest checkpoint)")
    fl.add_argument("--fleet-timeline", default="", metavar="PATH",
                    help="write the per-tick routing-signal JSONL here")
    fl.add_argument("--fleet-autoscale", type=int, default=0,
                    metavar="MAX",
                    help="autoscale replicas between --fleet and MAX "
                         "from exported overload/idle signals (0 = off)")
    ob = ap.add_argument_group("observability")
    ob.add_argument("--obs-jsonl", default="", metavar="PATH",
                    help="stream tracker rows (engine series, spans, "
                         "counters) here")
    args = ap.parse_args(argv)
    # --fleet 1 alone is a solo engine; with --fleet-autoscale MAX it is
    # a fleet that starts at one replica and grows.
    fleet_mode = args.fleet > 1 or (
        args.fleet >= 1 and args.fleet_autoscale > args.fleet)
    if fleet_mode and not (args.paged and args.admission == "chunked"):
        ap.error("--fleet needs --paged with --admission chunked")

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.obs import JsonlSink, Tracker
    from repro_torch.serve import (
        ChaosConfig,
        Request,
        ServeConfig,
        ServeEngine,
    )

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    # ONE manager a process: a fleet restart restores through it, and
    # its health() feeds the fleet's store-health-aware restart gate.
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    params, step = load_params(cfg, device=device, manager=manager)
    if step is not None:
        print(f"[serve] loaded checkpoint step {step}")
    chaos = (ChaosConfig(seed=args.chaos, evict_prob=0.1, hold_prob=0.15,
                         burst_prob=0.1, storm_prob=0.05)
             if args.chaos is not None else None)
    sc = ServeConfig(max_batch=args.max_batch, max_len=256,
                     temperature=args.temperature, paged=args.paged,
                     block_size=args.block_size, admission=args.admission,
                     chunk_size=args.chunk_size,
                     chunks_per_step=args.chunks_per_step,
                     prefix_cache=not args.no_prefix_cache,
                     draft=args.draft, spec_k=args.spec_k,
                     queue_limit=args.queue_limit,
                     queue_policy=args.queue_policy,
                     shed_occupancy=args.shed_occupancy,
                     shed_stall_ticks=args.shed_stall_ticks,
                     preempt=args.preempt,
                     default_ttft_deadline=args.ttft_deadline,
                     default_deadline=args.deadline,
                     watchdog_ticks=args.watchdog_ticks, chaos=chaos)
    tracker = (Tracker((JsonlSink(args.obs_jsonl),))
               if args.obs_jsonl else None)
    eng = ServeEngine(params, cfg, sc, device=device, tracker=tracker)
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

    if args.admission != "chunked":
        on_event = None  # prefill-on-join streams no lifecycle events
    if fleet_mode:
        serve_fleet(args, eng, reqs, demo, cfg, sc, device, manager,
                    tracker, on_token, on_event)
        return
    outs, stats = eng.serve(reqs, on_token=on_token, on_event=on_event)
    for i, p in enumerate(demo):
        s = stats[i]
        print(f"[serve] req{i}: {p} -> {outs[i][len(p):]} "
              f"({s.get('status', 'completed')}/{s['reason']} "
              f"admitted@{s['admitted_at']} done@{s['finished_at']} "
              f"prefix_hit={s['prefix_tokens']})")
    es = eng.last_stats
    extra = ""
    if args.admission == "chunked":
        extra = (f" status_counts={es['status_counts']} "
                 f"preemptions={es['preemptions']} "
                 f"peak_occupancy={es['peak_occupancy']:.2f}")
        if chaos is not None:
            extra += f" chaos={es['chaos']}"
    if args.draft != "none":
        extra += (f" draft={args.draft} spec_k={args.spec_k} "
                  f"acceptance_rate={es['acceptance_rate']:.2f} "
                  f"drafted={es['spec_drafted']} "
                  f"accepted={es['spec_accepted']}")
    print(f"[serve] engine: device={device} mode={es['mode']} "
          f"steps={es['mixed_steps']} compile_count={es['compile_count']} "
          f"prefix_hit_frac={es['prefix_hit_frac']:.2f}" + extra)
    if tracker is not None:
        tracker.close()


def serve_fleet(args, eng, reqs, demo, cfg, sc, device, manager, tracker,
                on_token, on_event) -> None:
    """``--fleet N``: the requests through N replica sessions of
    ``eng`` behind the router; prints each request's record and the
    fleet's stats line."""
    from repro_torch.serve import (
        AutoscaleConfig,
        Fleet,
        FleetChaosConfig,
        FleetConfig,
        ServeEngine,
    )

    kills = tuple((int(t), int(e))
                  for t, e in (spec.split(":") for spec in args.fleet_kill))
    restart_factory = None
    if args.fleet_restart_after:
        def restart_factory(eid):
            # Restart-from-checkpoint: a rejoining engine is rebuilt
            # from the newest valid step (or fresh params), not from the
            # dead replica's memory.
            print(f"[serve] engine {eid}: rebuilding replica from "
                  f"{args.ckpt_dir or 'fresh params'}")
            params, _ = load_params(cfg, device=device, manager=manager)
            return ServeEngine(params, cfg, sc, device=device)
    autoscale = None
    if args.fleet_autoscale > args.fleet:
        autoscale = AutoscaleConfig(
            min_engines=args.fleet, max_engines=args.fleet_autoscale)
    fleet = Fleet(eng, FleetConfig(
        num_engines=args.fleet,
        hedge_after=args.fleet_hedge_after,
        restart_after=args.fleet_restart_after,
        timeline_path=args.fleet_timeline or None,
        chaos=FleetChaosConfig(kills=kills) if kills else None,
        autoscale=autoscale,
    ), restart_factory=restart_factory,
        store_health=manager.health if manager is not None else None,
        tracker=tracker)
    outs, stats = fleet.run(reqs, on_token=on_token, on_event=on_event)
    for i, p in enumerate(demo):
        s = stats[i]
        print(f"[serve] req{i}: {p} -> {outs[i][len(p):]} "
              f"({s['status']}/{s['reason']} engine={s['engine']} "
              f"migrations={s['migrations']} retries={s['retries']})")
    es = fleet.last_stats
    print(f"[serve] fleet: device={device} engines={es['num_engines']} "
          f"ticks={es['ticks']} status_counts={es['status_counts']} "
          f"migrations={es['migrations']} retries={es['retries']} "
          f"kills={es['kills']} restarts={es['restarts']} "
          f"hedges={es['hedges']}"
          + (f" timeline={es['timeline_path']}"
             if es["timeline_path"] else "")
          + (f" scale_ups={es['scale_ups']} "
             f"scale_downs={es['scale_downs']}"
             if autoscale is not None else ""))
    if tracker is not None:
        tracker.close()


if __name__ == "__main__":
    main()
