"""Port parity for the robustness layer of the paged engine on the
reduced granite model: bounded queues and shedding, deadlines,
preempt-and-requeue, the watchdog, per-tick pool audits and seeded chaos
(``ChaosConfig``), each against the JAX package's engine on the same
weights and trace. The chaos draws are host-side numpy in the
reference's order, so one seed gives one fault schedule in both
packages: terminal records (status, reason, ticks), tokens and the
engine's counters are held equal."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_reduced as jax_reduced
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.serve import ChaosConfig as JChaosConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.models.convert import from_jax_values
from repro_torch.serve import (
    BlockPool,
    ChaosConfig,
    Request,
    Scheduler,
    ServeConfig,
    ServeEngine,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

BS = 8
BASE = dict(max_batch=3, max_len=64, paged=True, block_size=BS,
            chunk_size=8, chunks_per_step=2)
# The reference's chaos sweep (tests/test_serve_chaos.py).
CHAOS = dict(evict_prob=0.15, hold_prob=0.2, hold_max_blocks=3,
             hold_ticks=2, burst_prob=0.1, burst_size=2, burst_plen=9,
             burst_max_new=3, storm_prob=0.05, storm_ttft=10)
ROBUST = dict(num_blocks=1 + 12, preempt=True, queue_limit=8,
              queue_policy="shed-newest", shed_occupancy=0.95,
              shed_stall_ticks=6, default_ttft_deadline=60,
              default_deadline=120, watchdog_ticks=16)
COUNTERS = ("mixed_steps", "preemptions", "watchdog_failures",
            "status_counts", "peak_occupancy", "stall_ticks_max", "audits",
            "prefix_hit_tokens", "chunk_rows_used", "compile_count",
            "events")


def _dropless(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@pytest.fixture(scope="module")
def granite():
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    return (jcfg, vals, _dropless(get_reduced("granite-moe-1b-a400m")),
            from_jax_values(jax.tree.map(np.asarray, vals)))


def _req(R, rid, plen=8, arrival=0, max_new=8, **kw):
    prompt = [(37 * rid + 11 * i) % 97 + 1 for i in range(plen)]
    return R(rid=rid, prompt=prompt, max_new=max_new, arrival=arrival, **kw)


def _serve_both(granite, mk, *, chaos=None, on_event=False, **kw):
    """``mk(Request)`` through both engines (greedy). Returns the
    reference's and the port's (outputs, records, stats, events)."""
    jcfg, vals, cfg, tvals = granite
    out = []
    for Eng, SC, R, C, extra in (
            (JServeEngine, JServeConfig, JRequest, JChaosConfig, {}),
            (ServeEngine, ServeConfig, Request, ChaosConfig,
             dict(device="cpu"))):
        params, c = (vals, jcfg) if Eng is JServeEngine else (tvals, cfg)
        sc = SC(**{**BASE, **kw},
                chaos=None if chaos is None else C(**chaos))
        eng = Eng(params, c, sc, **extra)
        events = []
        cb = (lambda rid, ev, d: events.append((rid, ev, d))) \
            if on_event else None
        outs, fin = eng.serve(mk(R), on_event=cb)
        out.append((outs, fin, eng.last_stats, events))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_chaos_sweep_matches_the_reference(granite, seed):
    """The reference's chaos sweep (evictions, pool holds, admission
    bursts, deadline storms over a contended trace): the same terminal
    records and tokens, bursts included, and the same counters and
    event stream, audited every tick."""
    mk = lambda R: [_req(R, rid, plen=10 + (3 * rid) % 12, arrival=rid,  # noqa
                         max_new=4 + rid % 4) for rid in range(6)]
    (jo, jf, js, _), (to, tf, ts, _) = _serve_both(
        granite, mk, chaos=dict(seed=seed, **CHAOS), **ROBUST)
    assert to == jo and tf == jf
    assert ts["chaos"] == js["chaos"]
    for key in COUNTERS:
        assert ts[key] == js[key], key
    assert ts["audits"] > ts["mixed_steps"]
    assert sum(ts["status_counts"].values()) == len(tf)


def test_overload_trace_matches_the_reference(granite):
    """``examples/serve_moe.py --overload``'s trace (2 slots, a pool of
    one request and a spare block, two arrivals a tick, late
    high-priority requests) with shedding, preemption, deadlines and
    chaos, the smoke's phase 15 settings at reduced width."""
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 250, size=12)]
               for _ in range(10)]
    mk = lambda R: [R(rid=i, arrival=i // 2, prompt=prompts[i],  # noqa
                      max_new=8, priority=1 if i >= 8 else 0)
                    for i in range(10)]
    kw = dict(ROBUST, queue_limit=3, num_blocks=1 + 2 + 1, max_batch=2)
    (jo, jf, js, je), (to, tf, ts, te) = _serve_both(
        granite, mk, chaos=dict(seed=0, **CHAOS), on_event=True, **kw)
    assert to == jo and tf == jf and te == je
    assert ts["status_counts"] == js["status_counts"]
    assert {"shed", "completed"} <= set(ts["status_counts"])


def test_preempt_and_requeue_matches_the_reference(granite):
    """Pool exhaustion with ``preempt``: the lower-priority request is
    preempted, requeued, recovers its blocks from the prefix cache and
    completes with the reference's tokens and records."""
    mk = lambda R: [_req(R, 0, plen=16, max_new=16, arrival=0, priority=0),  # noqa
                    _req(R, 1, plen=16, max_new=16, arrival=8, priority=1)]
    (jo, jf, js, je), (to, tf, ts, te) = _serve_both(
        granite, mk, on_event=True, num_blocks=1 + 7, preempt=True)
    assert to == jo and tf == jf and te == je
    assert tf[0]["preemptions"] == 1 and ts["preemptions"] == 1


@pytest.mark.parametrize("policy", ["shed-oldest", "shed-newest", "block"])
def test_backpressure_and_deadlines_match_the_reference(granite, policy):
    """Bounded queues under each policy, with deadlines: the same sheds,
    timeouts and completions in the same ticks, and the events streamed
    once each."""
    mk = lambda R: [_req(R, rid, plen=9, arrival=rid // 3, max_new=4)  # noqa
                    for rid in range(8)]
    (jo, jf, js, je), (to, tf, ts, te) = _serve_both(
        granite, mk, on_event=True, num_blocks=1 + 6, queue_limit=2,
        queue_policy=policy, preempt=True, audit_invariants=True,
        default_ttft_deadline=30, default_deadline=60)
    assert to == jo and tf == jf and te == je
    assert ts["status_counts"] == js["status_counts"]
    assert ts["audits"] == js["audits"]


def test_watchdog_fails_an_unadmittable_request(granite):
    """A request whose footprint exceeds the whole pool fails through
    the watchdog with the reference's diagnostic; the rest complete."""
    mk = lambda R: [_req(R, 0, plen=40, max_new=8), _req(R, 1, plen=4)]  # noqa
    (jo, jf, _, je), (to, tf, _, te) = _serve_both(
        granite, mk, on_event=True, num_blocks=1 + 4, watchdog_ticks=4)
    assert to == jo and tf == jf and te == je
    assert tf[0]["status"] == "failed" and tf[1]["status"] == "completed"


def test_storm_deadlines_and_fleet_hooks_match_the_reference():
    """The scheduler's chaos and fleet hooks (``storm_deadlines``,
    ``cancel``, ``extract_queue``, ``forget``, ``resubmit``) on the
    host, side by side with the reference's scheduler."""
    from repro.serve import BlockPool as JBlockPool
    from repro.serve import Scheduler as JScheduler

    def drive(Pool, Sched, R):
        pool = Pool(1 + 6, BS)
        s = Sched(1, pool, 64, reject_oversized=False)
        for rid in range(4):
            s.submit(_req(R, rid, arrival=rid, max_new=4))
        log = [len(s.admit(0)), s.storm_deadlines(3, 2)]
        log.append(s.cancel(0, 3, "cancelled"))  # the active one
        log.append(s.cancel(2, 3, "raced-out"))  # a queued one
        log.append(s.cancel(9, 3, "nope"))
        moved = s.extract_queue()
        log.append([(r.rid, res) for r, res in moved])
        s.forget(0)
        s.resubmit(_req(R, 0, max_new=4), {
            "seq": [1, 2, 3, 4, 5], "generated": 2, "first_done": True,
            "first_token_at": 1, "admitted_at": 0, "preemptions": 1})
        log.append(len(s.admit(4)))
        log.append({r: (v["status"], v["reason"]) for r, v in
                    s.finished.items()})
        log.append([(e[1], e[2]) for e in s.events])
        return log

    assert drive(BlockPool, Scheduler, Request) == \
        drive(JBlockPool, JScheduler, JRequest)
