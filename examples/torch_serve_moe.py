"""Serve an upcycled MoE, PyTorch port: static batch, or paged
continuous batching (the counterpart of ``examples/serve_moe.py``).

    PYTHONPATH=src python examples/torch_serve_moe.py [--paged] \
        [--block-size 8] [--stream] [--device cpu]

Builds a small upcycled model, then serves prompts through the
ServeEngine. Default mode demonstrates the static batch (Top-K decode
routing per paper §3.1, KV-cache decode, greedy + temperature sampling);
``--paged`` demonstrates the production path: paged KV cache, staggered
request arrivals admitted mid-flight through the chunked MIXED step
(decode rows + prefill chunk lanes in one step per tick, shared prompt
prefixes served from the block-level prefix cache), per-token
streaming, and early-finish eviction freeing KV blocks for the queue.
Decode runs dropless (capacity >= experts) so continuous batching is
output-identical to serving each request alone.

Robustness knobs (paged mode; see the failure-modes table in
``repro_torch/serve/__init__.py``): ``--queue-limit`` + ``--queue-policy``
bound the wait queue, ``--shed-occupancy`` / ``--shed-stall-ticks``
drive load shedding, ``--preempt`` enables preempt-and-requeue under
pool exhaustion, ``--ttft-deadline`` / ``--deadline`` set default
per-request deadlines (ticks after arrival), ``--watchdog-ticks``
bounds zero-progress spins, ``--chaos SEED`` turns on the seeded fault
injector. ``--overload`` serves a deliberately over-subscribed trace so
sheds/timeouts/preemptions actually fire and the per-status accounting
is visible.

``--fleet`` demonstrates the replica pool (``repro_torch/serve/fleet.py``):
the same requests served solo and through 3 replica sessions of the
same engine with replica 0 killed mid-decode — its queued + active
work migrates to the survivors with saved progress and the outputs are
verified token-identical to the unchaosed solo run (sampling is keyed
on (rid, position), so re-execution elsewhere replays the same
stream).

Runs on the card (decode, paged prefill and grouped kernels paged; flash
and expert-FFN kernels static) unless ``--device cpu`` asks for the
plain PyTorch path; raises without a card otherwise.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import MoECfg, get_reduced
from repro_torch.core.upcycle import upcycle_params
from repro_torch.models.model_zoo import init_params
from repro_torch.serve import (
    ChaosConfig, Fleet, FleetChaosConfig, FleetConfig, Request,
    ServeConfig, ServeEngine, blocks_needed,
)


def build(device):
    dense_cfg = get_reduced("granite-moe-1b-a400m").dense_parent()
    sparse_cfg = dataclasses.replace(
        dense_cfg,
        name="granite-upcycled",
        moe=MoECfg(num_experts=4, router="top_k", top_k=2,
                   capacity_factor=4.0, group_size=64,
                   layer_pattern="all"),
    )
    dense = init_params(0, dense_cfg, device=device)
    params = upcycle_params(dense, dense_cfg, sparse_cfg, 1)
    return params, sparse_cfg


def serve_overload(params, sparse_cfg, sc, args):
    """Over-subscribed trace through 2 slots + a deliberately small
    block pool: 10 staggered requests at ~2 arrivals/tick, two of them
    high-priority late arrivals. With the robustness knobs off this
    would just queue without bound; with them on, the lifecycle events
    show shedding / timeouts / preempt-and-requeue as they happen and
    every request still ends in exactly one terminal status."""
    if sc.queue_limit == 0 and sc.queue_policy == "block" \
            and sc.default_ttft_deadline is None and not sc.preempt:
        print("[serve] --overload with no robustness knobs: defaulting "
              "--queue-limit 3 --queue-policy shed-oldest --preempt")
        sc = dataclasses.replace(sc, queue_limit=3,
                                 queue_policy="shed-oldest",
                                 preempt=True)
    # Pool sized to ONE resident request plus a spare block, so block
    # starvation (and with --preempt, preempt-and-requeue of the
    # lower-priority resident) actually fires.
    need = blocks_needed(12, 8, sc.block_size)
    sc = dataclasses.replace(sc, num_blocks=1 + need + 1)
    eng = ServeEngine(params, sparse_cfg, sc, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, arrival=i // 2,
                prompt=[int(t) for t in rng.integers(1, 250, size=12)],
                max_new=8,
                priority=1 if i >= 8 else 0)
        for i in range(10)
    ]
    print(f"[serve] overload: {len(reqs)} requests, "
          f"{sc.max_batch} slots, {sc.num_blocks - 1} usable KV blocks, "
          f"policy={sc.queue_policy} queue_limit={sc.queue_limit} "
          f"preempt={sc.preempt} ttft_deadline={sc.default_ttft_deadline}")
    outs, stats = eng.serve(
        reqs,
        on_event=lambda rid, ev, detail: print(
            f"  [event] req{rid}: {ev}" + (f" ({detail})" if detail else "")
        ),
    )
    for r in reqs:
        s = stats[r.rid]
        print(f"  request {r.rid}: status={s['status']} "
              f"reason={s['reason']} generated={s['generated']} "
              f"preemptions={s['preemptions']} "
              f"prefix_hit={s['prefix_tokens']}")
    es = eng.last_stats
    print(f"  engine: status_counts={es['status_counts']} "
          f"preemptions={es['preemptions']} "
          f"watchdog_failures={es['watchdog_failures']} "
          f"peak_occupancy={es['peak_occupancy']:.2f} "
          f"compile_count={es['compile_count']}")
    if sc.chaos is not None:
        print(f"  chaos: {es['chaos']}")


def serve_fleet(params, sparse_cfg, sc, device):
    """3 replicas of ONE engine (sessions are self-contained, so they
    share only params and jitted steps), replica 0 killed at tick 6 —
    mid-decode for the early arrivals. The fleet migrates its work and
    the outputs match the unchaosed solo run token for token."""
    eng = ServeEngine(params, sparse_cfg, sc)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 250, size=10) for _ in range(6)]

    def mk():
        return [
            Request(rid=i, arrival=2 * i,
                    prompt=[int(t) for t in prompts[i]], max_new=8)
            for i in range(6)
        ]
    print("[serve] solo baseline (1 engine, no chaos):")
    solo_outs, solo_stats = eng.serve(mk())
    print(f"  {len(solo_outs)} requests completed, "
          f"{eng.last_stats['mixed_steps']} mixed steps")

    print("[serve] fleet: 3 replicas, engine 0 killed at tick 6:")
    fleet = Fleet(eng, FleetConfig(
        num_engines=3,
        chaos=FleetChaosConfig(kills=((6, 0),)),
    ))
    outs, stats = fleet.run(
        mk(),
        on_event=lambda rid, ev, detail: print(
            f"  [event] req{rid}: {ev}" + (f" ({detail})" if detail else "")
        ),
    )
    for rid in sorted(stats):
        s = stats[rid]
        match = "==" if outs[rid] == solo_outs[rid] else "!="
        print(f"  request {rid}: status={s['status']} "
              f"engine={s['engine']} migrations={s['migrations']} "
              f"tokens {match} solo")
        assert outs[rid] == solo_outs[rid], (
            f"rid {rid}: fleet output diverged from solo"
        )
    es = fleet.last_stats
    print(f"  fleet: ticks={es['ticks']} "
          f"status_counts={es['status_counts']} kills={es['kills']} "
          f"migrations={es['migrations']} retries={es['retries']}")
    print("  all outputs token-identical to the solo run")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--stream", action="store_true")
    rb = ap.add_argument_group("robustness (paged mode)")
    rb.add_argument("--overload", action="store_true",
                    help="serve an over-subscribed trace so the "
                         "robustness paths (shed/timeout/preempt) fire")
    rb.add_argument("--fleet", action="store_true",
                    help="serve through 3 replicas with one killed "
                         "mid-decode; outputs verified token-identical "
                         "to the unchaosed solo run")
    rb.add_argument("--queue-limit", type=int, default=0,
                    help="max visible waiting requests (0 = unbounded)")
    rb.add_argument("--queue-policy", default="block",
                    choices=["block", "shed-newest", "shed-oldest"])
    rb.add_argument("--shed-occupancy", type=float, default=None,
                    help="pool-occupancy fraction that triggers "
                         "load shedding")
    rb.add_argument("--shed-stall-ticks", type=int, default=0,
                    help="consecutive block-starved ticks that trigger "
                         "load shedding (0 = off)")
    rb.add_argument("--preempt", action="store_true",
                    help="preempt-and-requeue lower-priority requests "
                         "under pool exhaustion")
    rb.add_argument("--ttft-deadline", type=int, default=None,
                    help="default first-token deadline, ticks after "
                         "arrival")
    rb.add_argument("--deadline", type=int, default=None,
                    help="default completion deadline, ticks after "
                         "arrival")
    rb.add_argument("--watchdog-ticks", type=int, default=32,
                    help="zero-progress ticks before the watchdog "
                         "fails the stuck head")
    rb.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="enable the seeded fault injector")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    params, sparse_cfg = build(args.device)
    prompts = [[10, 42, 7], [99, 3], [5, 5, 5, 5], [200, 17]]

    if (args.overload or args.fleet) and not args.paged:
        ap.error("--overload/--fleet require --paged")
    if args.paged:
        chaos = (ChaosConfig(seed=args.chaos, evict_prob=0.1,
                             hold_prob=0.15, burst_prob=0.1,
                             storm_prob=0.05)
                 if args.chaos is not None else None)
        sc = ServeConfig(
            max_batch=2, max_len=128, paged=True,
            block_size=args.block_size, chunk_size=args.chunk_size,
            queue_limit=args.queue_limit,
            queue_policy=args.queue_policy,
            shed_occupancy=args.shed_occupancy,
            shed_stall_ticks=args.shed_stall_ticks,
            preempt=args.preempt,
            default_ttft_deadline=args.ttft_deadline,
            default_deadline=args.deadline,
            watchdog_ticks=args.watchdog_ticks,
            chaos=chaos,
        )
        if args.overload:
            return serve_overload(params, sparse_cfg, sc, args)
        if args.fleet:
            return serve_fleet(params, sparse_cfg, sc, args.device)
        eng = ServeEngine(params, sparse_cfg, sc, device=args.device)
        # 5 requests through 2 slots: later arrivals queue and are
        # admitted mid-flight as earlier requests finish and free their
        # blocks; rid 4 repeats rid 3's prompt prefix AFTER rid 3's
        # blocks are registered, so its full prefix blocks come from
        # the prefix cache instead of being recomputed (prefix_hit > 0
        # on its line below — rids 0-3 are first sightings and pay).
        shared = prompts[0] + [11, 12, 13, 14, 15, 16, 17, 18]
        reqs = [
            Request(rid=i, prompt=p, max_new=6 + 3 * i, arrival=i)
            for i, p in enumerate(prompts[:3])
        ] + [Request(rid=3, prompt=shared + [21, 22], max_new=6,
                     arrival=0),
             Request(rid=4, prompt=shared + [31], max_new=6,
                     arrival=8)]
        on_token = (
            (lambda rid, t: print(f"  req{rid} += {t}", flush=True))
            if args.stream else None
        )
        print("[serve] continuous batching, 2 slots, staggered arrivals:")
        outs, stats = eng.serve(reqs, on_token=on_token)
        for r in reqs:
            s = stats[r.rid]
            p = r.prompt
            print(f"  request {r.rid}: prompt={p} -> {outs[r.rid][len(p):]} "
                  f"(arrived@{s['arrival']} admitted@{s['admitted_at']} "
                  f"done@{s['finished_at']} prefix_hit={s['prefix_tokens']})")
        es = eng.last_stats
        print(f"  engine: {es['mixed_steps']} mixed steps, "
              f"{es['compile_count']} compile(s), "
              f"prefix_hit_frac={es['prefix_hit_frac']:.2f}")
        return outs

    eng = ServeEngine(
        params, sparse_cfg,
        ServeConfig(max_batch=4, max_len=128, temperature=0.0),
        device=args.device,
    )
    print("[serve] greedy generation, batch of 4:")
    greedy = eng.generate(prompts, max_new=12)
    for i, seq in enumerate(greedy):
        print(f"  request {i}: prompt={prompts[i]} -> {seq[len(prompts[i]):]}")

    eng_t = ServeEngine(
        params, sparse_cfg,
        ServeConfig(max_batch=4, max_len=128, temperature=0.8),
        device=args.device,
    )
    print("[serve] temperature 0.8 sampling:")
    for i, seq in enumerate(eng_t.generate(prompts[:2], max_new=12,
                                           seed=3)):
        print(f"  request {i}: {seq[len(prompts[i]):]}")
    return greedy


if __name__ == "__main__":
    main()
