"""Port parity for the serving fleet (``serve/router.py``,
``serve/fleet.py``) on the reduced granite model: replica sessions of
one engine behind the health-checked router, with kills, heartbeat loss,
slow engines, hedged re-dispatch, drains, restarts and shed retries,
each against the JAX package's ``Fleet`` on the same weights, trace and
chaos seed. The fleet is host logic and its fault draws are the
reference's, so per-request records, tokens, fleet counters and the
timeline's fleet rows are held equal one for one."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_reduced as jax_reduced
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.fleet import AutoscaleConfig as JAutoscaleConfig
from repro.serve.fleet import Fleet as JFleet
from repro.serve.fleet import FleetChaosConfig as JFleetChaosConfig
from repro.serve.fleet import FleetConfig as JFleetConfig
from repro.serve.router import Router as JRouter
from repro.serve.router import RouterConfig as JRouterConfig
from repro_torch.configs import get_reduced
from repro_torch.models.convert import from_jax_values
from repro_torch.serve import (
    AutoscaleConfig,
    Fleet,
    FleetChaosConfig,
    FleetConfig,
    Request,
    Router,
    RouterConfig,
    ServeConfig,
    ServeEngine,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

BS = 8
BASE = dict(max_batch=3, max_len=64, paged=True, block_size=BS,
            chunk_size=8, chunks_per_step=2, audit_invariants=True)
# The session seed the reference's fleet derives from its default rng.
SEED = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 2 ** 31 - 1))
FLEET_STATS = ("num_engines", "ticks", "status_counts", "hedges",
               "timeline_rows", "timeline_engine_rows", "tokens",
               "engines", "migrations", "retries", "kills", "hb_failovers",
               "restarts", "drains", "scale_ups", "scale_downs")


def _dropless(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@pytest.fixture(scope="module")
def engines():
    """(reference engine, port engine) over the same weights."""
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = _dropless(get_reduced("granite-moe-1b-a400m"))
    tvals = from_jax_values(jax.tree.map(np.asarray, vals))
    return (lambda **kw: JServeEngine(vals, jcfg,
                                      JServeConfig(**{**BASE, **kw})),
            lambda **kw: ServeEngine(tvals, cfg,
                                     ServeConfig(**{**BASE, **kw}),
                                     device="cpu"))


def _req(R, rid, plen=8, arrival=0, max_new=8, **kw):
    prompt = [(37 * rid + 11 * i) % 97 + 1 for i in range(plen)]
    return R(rid=rid, prompt=prompt, max_new=max_new, arrival=arrival, **kw)


def _trace(R):
    return [_req(R, r, arrival=r // 2) for r in range(8)]


def _run_both(engines, fc: dict, trace=_trace, *, eng_kw=None,
              factory=False, hook=None, tmp_path=None):
    """The same fleet run in both packages; ``fc`` holds FleetConfig
    fields, its ``chaos``/``router``/``autoscale`` as dicts. ``hook(fleet,
    rid, tok)`` runs on every fleet token (drains). Returns the
    reference's and the port's (outputs, records, fleet)."""
    out = []
    for side, mk_eng in zip(("jax", "torch"), engines):
        J = side == "jax"
        kw = dict(fc)
        for key, cls in (("chaos", (JFleetChaosConfig, FleetChaosConfig)),
                         ("router", (JRouterConfig, RouterConfig)),
                         ("autoscale", (JAutoscaleConfig, AutoscaleConfig))):
            if key in kw:
                kw[key] = cls[0 if J else 1](**kw[key])
        if tmp_path is not None:
            kw["timeline_path"] = str(tmp_path / f"{side}.jsonl")
        eng = mk_eng(**(eng_kw or {}))
        built = []

        def restart(eid, _e=eng, _b=built):
            _b.append(eid)
            return _e

        fleet = (JFleet if J else Fleet)(
            eng, (JFleetConfig if J else FleetConfig)(**kw),
            restart_factory=restart if factory else None)
        on_tok = None
        if hook is not None:
            on_tok = lambda rid, tok, _f=fleet: hook(_f, rid, tok)  # noqa
        reqs = trace(JRequest if J else Request)
        outs, fin = (fleet.run(reqs, on_token=on_tok) if J else
                     fleet.run(reqs, seed=SEED, on_token=on_tok))
        out.append((outs, fin, fleet, built))
    return out


def _same(a, b):
    (jo, jf, jfl, jb), (to, tf, tfl, tb) = a, b
    assert to == jo
    assert tf == jf
    assert jb == tb
    for key in FLEET_STATS:
        assert tfl.last_stats[key] == jfl.last_stats[key], key
    jrows = [r for r in jfl.timeline.rows if r.get("kind") == "fleet"]
    trows = [r for r in tfl.timeline.rows if r.get("kind") == "fleet"]
    assert trows == jrows


# ---------------------------------------------------------------------------
# the router (host policy)
# ---------------------------------------------------------------------------


def test_router_decisions_match_the_reference():
    rng = np.random.default_rng(0)
    kw = dict(hb_degraded=3, hb_dead=10, degraded_occupancy=0.9,
              degraded_queue=4, degraded_stall_ticks=2, degraded_weight=4.0)
    r, jr = Router(RouterConfig(**kw)), JRouter(JRouterConfig(**kw))
    for _ in range(200):
        sig = dict(occupancy=float(rng.random()),
                   queue_depth=int(rng.integers(0, 6)),
                   active=int(rng.integers(0, 4)),
                   stall_ticks=int(rng.integers(0, 3)))
        hb = int(rng.integers(0, 12))
        assert r.derive_state(hb, sig) == jr.derive_state(hb, sig)
        cands = [(e, ("live", "degraded")[int(rng.integers(2))], dict(
            queue_depth=int(rng.integers(0, 4)),
            active=int(rng.integers(0, 3)),
            occupancy=float(rng.random()))) for e in range(4)]
        assert r.pick(cands) == jr.pick(cands)
    assert [r.backoff(a) for a in range(6)] == \
        [jr.backoff(a) for a in range(6)] == [1, 2, 4, 8, 16, 16]
    assert r.pick([]) is None


# ---------------------------------------------------------------------------
# failover, hedging, drain, restart, retries
# ---------------------------------------------------------------------------


def test_kill_mid_decode_matches_the_reference(engines, tmp_path):
    """A seeded kill of replica 0 at tick 3: the same migrations, records
    and tokens, and the same timeline written to disk, as the
    reference's fleet; the survivors' pools audited every tick."""
    a, b = _run_both(engines, dict(num_engines=3, chaos=dict(
        seed=1, kills=((3, 0),))), tmp_path=tmp_path)
    _same(a, b)
    to, tf, tfl, _ = b
    assert tfl.last_stats["kills"] == 1
    assert any(rec["migrations"] for rec in tf.values())
    assert all(rec["status"] == "completed" for rec in tf.values())
    assert tfl.last_stats["engines"][1]["audits"] > 0
    rows = [json.loads(line) for line in
            (tmp_path / "torch.jsonl").read_text().splitlines()]
    jrows = [json.loads(line) for line in
             (tmp_path / "jax.jsonl").read_text().splitlines()]
    strip = lambda rs: [{k: v for k, v in r.items()  # noqa: E731
                         if k != "dur_ms"} for r in rs]
    assert strip(rows) == strip(jrows)


def test_hedge_matches_the_reference(engines):
    """Slow-engine chaos with hedged re-dispatch: the same hedges
    dispatched, won and lost, the losers cancelled with their blocks
    freed, and the same records and tokens."""
    a, b = _run_both(engines, dict(num_engines=2, hedge_after=4, chaos=dict(
        seed=3, slow_prob=0.25, slow_ticks=6)))
    _same(a, b)
    st = b[2].last_stats
    assert st["hedges"]["dispatched"] >= 1
    assert st["hedges"]["won"] + st["hedges"]["lost"] == \
        st["hedges"]["dispatched"]


def test_drain_matches_the_reference(engines):
    """``Fleet.drain(0)`` at the first token: queued work migrates, the
    replica retires through the leak-checked close, as the
    reference's."""
    def hook(fleet, rid, tok):
        if not fleet.stats["drains"]:
            fleet.drain(0)

    a, b = _run_both(engines, dict(num_engines=2), hook=hook)
    _same(a, b)
    assert b[2].last_stats["drains"] == 1
    assert b[2].last_stats["engines"][0]["state"] == "dead"


@pytest.mark.parametrize("seed", range(2))
def test_fleet_chaos_sweep_matches_the_reference(engines, seed):
    """Probabilistic kills, heartbeat loss and slow engines (the
    reference's sweep): one fault schedule in both packages."""
    _same(*_run_both(engines, dict(
        num_engines=3, router=dict(hb_dead=6), chaos=dict(
            seed=seed, kill_prob=0.02, max_kills=1, hb_loss_prob=0.02,
            hb_loss_ticks=8, slow_prob=0.05, slow_ticks=3))))


def test_restart_and_retry_match_the_reference(engines):
    """A killed replica rejoins through the restart factory after 3
    ticks; shed requests are retried with backoff on the other replica;
    the autoscaler's decisions. All as the reference's."""
    _same(*_run_both(engines, dict(
        num_engines=2, restart_after=3,
        chaos=dict(seed=5, kills=((2, 1),))),
        trace=lambda R: [_req(R, r, arrival=r) for r in range(8)],
        factory=True))
    _same(*_run_both(engines, dict(num_engines=2, max_retries=4),
                     trace=lambda R: [_req(R, r, max_new=4)
                                      for r in range(10)],
                     eng_kw=dict(queue_limit=2, queue_policy="shed-newest")))
    _same(*_run_both(engines, dict(
        num_engines=1, autoscale=dict(min_engines=1, max_engines=3,
                                      up_backlog=2, up_ticks=2,
                                      cooldown=3, down_ticks=4)),
        trace=lambda R: [_req(R, r, arrival=r // 3) for r in range(9)],
        factory=True))


def test_fleet_rejects_what_the_reference_rejects(engines):
    _, mk = engines
    fl = Fleet(mk(), FleetConfig(num_engines=2))
    with pytest.raises(ValueError, match="per-request callbacks"):
        fl.run([Request(rid=0, prompt=[1, 2], max_new=2,
                        on_token=lambda r, t: None)])
    with pytest.raises(ValueError, match="admission='chunked'"):
        Fleet(mk(admission="prefill_on_join", audit_invariants=False),
              FleetConfig())
