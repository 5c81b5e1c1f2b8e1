r"""Multi-engine serve fleet: replica pool, failover, request
migration, hedged retries, fleet-level chaos (port of
``repro/serve/fleet.py``: host logic over sessions in one process, so
replica sessions of one engine share one card).

A :class:`Fleet` drives N :class:`~repro_torch.serve.engine.ServeEngine`
replicas as tick-interleaved
:class:`~repro_torch.serve.engine.ChunkedSession` objects on ONE global
clock — the same deterministic CPU-testable discipline as the engine
itself. Per tick it:

1. injects fleet-level chaos (seeded engine kills, heartbeat loss,
   slow-engine degradation — :class:`FleetChaosConfig`);
2. re-derives per-engine health (``live`` / ``degraded`` / ``draining``
   / ``dead``) from heartbeat age + the engine's own routing signals
   (:class:`repro_torch.serve.router.Router`), failing over engines whose
   heartbeat went stale;
3. dispatches pending requests to the least-loaded healthy replica,
   retrying shed/failed requests with capped exponential backoff and
   (optionally) hedging stragglers onto a second replica;
4. ticks every surviving session exactly once (slowed engines
   ``skip_tick`` so deadlines keep running in global time), posting a
   heartbeat per completed tick;
5. exports the routing signals as a JSON-lines timeline row
   (:class:`repro_torch.serve.router.TimelineWriter` documents the schema).

**Failover & migration.** When an engine dies (chaos kill, or
heartbeat older than ``hb_dead``), the fleet drops the corpse without
touching it again and re-admits its unfinished requests on survivors
with saved progress: the fleet's own canonical per-request token log
becomes a preempt-and-requeue ``resume`` record (``seq = prompt +
generated``), so the survivor re-prefills the sequence so far (prefix
cache makes this tail-cheap when warm) and decoding continues at token
index ``generated``. Deadlines are NOT reset — ``Scheduler.submit``
anchors them at the request's ORIGINAL arrival tick.

**Token identity.** Sampling is keyed on ``(rid, generated)`` with the
same session seed on every replica, so a
migrated, retried, or hedged continuation produces the SAME tokens the
original would have: re-execution is idempotent. The fleet enforces
this at runtime — every token a secondary copy emits for an index the
primary already produced is asserted equal — and hedge losers are
cancelled (engine-local terminal status ``cancelled``) with their
blocks freed the moment a winner completes.

**Exactly-one-terminal, fleet-wide.** Engine-local statuses
(``shed``/``failed`` retried elsewhere, ``cancelled`` hedge losers)
are not user-visible; the fleet records exactly ONE terminal status
per request in ``Fleet.finished`` — ``completed``, ``timeout``
(deadlines are a user contract: never retried), ``shed``/``failed``
(terminal only once the retry budget is spent or no healthy engine
remains) — and ``Fleet.run`` asserts total coverage on exit.

Requests routed through a fleet must not carry per-request
``on_token``/``on_event`` callbacks (an engine would fire them per
COPY, duplicating tokens under hedging); pass fleet-level callbacks to
:meth:`Fleet.run` instead, which fire exactly once per token/terminal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.tracker import NULL, Tracker
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import (
    DEAD, DEGRADED, DRAINING, LIVE, Router, RouterConfig, TimelineWriter,
)
from repro_torch.serve.scheduler import Request

# Fleet-terminal statuses mirror the scheduler's user-visible ones.
COMPLETED = "completed"
SHED = "shed"
TIMEOUT = "timeout"
FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class FleetChaosConfig:
    """Seeded fleet-level fault injection (engine granularity — the
    per-engine :class:`~repro_torch.serve.engine.ChaosConfig` stays
    available for block/queue-level faults underneath). Draws come from
    one ``np.random.default_rng(seed)`` in the reference's order."""

    seed: int = 0
    # Deterministic kills: ((tick, engine_id), ...) — the engine is
    # destroyed at the START of that fleet tick (mid-decode for any
    # in-flight request), its work migrated to survivors.
    kills: tuple = ()
    # Probabilistic kills: per-engine per-tick probability, capped at
    # max_kills total (deterministic kills don't count against the cap).
    kill_prob: float = 0.0
    max_kills: int = 1
    # Heartbeat loss: the engine keeps running but its heartbeat is
    # suppressed for hb_loss_ticks — long enough and the fleet declares
    # it dead (false-positive failover: work migrates, the corpse is
    # no longer ticked so no duplicate tokens are ever emitted).
    # max_hb_losses caps the blast radius (None = unlimited; losing
    # every replica's heartbeat kills the whole fleet, by design).
    hb_loss_prob: float = 0.0
    hb_loss_ticks: int = 12
    max_hb_losses: Optional[int] = None
    # Slow engine: skip_tick() for slow_ticks (clock advances, no work,
    # no heartbeat) — drives the degraded / hedging paths.
    slow_prob: float = 0.0
    slow_ticks: int = 3


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Deterministic fleet autoscaling policy, evaluated once per
    fleet tick from the exported routing signals (occupancy, queue
    depth, pending backlog, shed-driven retries). NO wall-clock reads
    — decisions are a pure function of the tick clock and seeded
    signals, so chaos tests stay seeded-reproducible."""

    min_engines: int = 1
    max_engines: int = 4
    # Scale UP when, for up_ticks consecutive ticks, mean live-replica
    # occupancy >= up_occupancy OR dispatchable backlog (pending +
    # queued) >= up_backlog OR any shed/fail retry fired that tick.
    up_occupancy: float = 0.85
    up_backlog: int = 4
    up_ticks: int = 3
    # Scale DOWN when, for down_ticks consecutive ticks, the fleet is
    # idle: zero backlog, zero active slots, mean occupancy <=
    # down_occupancy. The drained replica retires through the
    # leak-checked close().
    down_occupancy: float = 0.10
    down_ticks: int = 8
    # Minimum ticks between any two scaling actions.
    cooldown: int = 8


class Autoscaler:
    """Streak-counting scale policy over :class:`AutoscaleConfig`.

    ``decide`` is called once per fleet tick with host-side signals
    only; it returns ``"up"``, ``"down"``, or ``None``. Sustained
    overload (``up_ticks``) spawns a replica, sustained idleness
    (``down_ticks``) drains one; a cooldown separates actions so a
    spawn gets time to absorb load before the next decision."""

    def __init__(self, asc: Optional[AutoscaleConfig] = None):
        self.asc = asc or AutoscaleConfig()
        self.up_streak = 0
        self.down_streak = 0
        self.last_action_at: Optional[int] = None

    def decide(self, tick: int, *, n_live: int, signals: list,
               backlog: int, shed_delta: int) -> Optional[str]:
        asc = self.asc
        if not signals:
            return None  # nothing alive to measure
        occ = sum(s["occupancy"] for s in signals) / len(signals)
        overload = (occ >= asc.up_occupancy
                    or backlog >= asc.up_backlog
                    or shed_delta > 0)
        idle = (backlog == 0 and occ <= asc.down_occupancy
                and all(s["active"] == 0 for s in signals))
        self.up_streak = self.up_streak + 1 if overload else 0
        self.down_streak = self.down_streak + 1 if idle else 0
        if (self.last_action_at is not None
                and tick - self.last_action_at < asc.cooldown):
            return None
        if self.up_streak >= asc.up_ticks and n_live < asc.max_engines:
            self.last_action_at = tick
            self.up_streak = 0
            return "up"
        if (self.down_streak >= asc.down_ticks
                and n_live > asc.min_engines):
            self.last_action_at = tick
            self.down_streak = 0
            return "down"
        return None


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    num_engines: int = 2
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    # Retry policy for engine-local shed/failed: total re-dispatch
    # attempts per request before the status becomes fleet-terminal.
    max_retries: int = 3
    # Hedging: a request with no progress (no new token, not yet
    # dispatched output) for hedge_after ticks gets a duplicate copy on
    # another healthy engine (0 = off). At most max_hedges extra copies
    # may be live at once; first completed copy wins, losers are
    # cancelled.
    hedge_after: int = 0
    max_hedges: int = 1
    # Dead-engine restart: restart_after ticks after death a FRESH
    # session rejoins the pool (0 = never). The replacement engine
    # comes from Fleet's restart_factory (restart-from-checkpoint) or
    # reuses the original engine object (params still resident).
    restart_after: int = 0
    # Store-health-aware restarts: when a ``store_health`` probe is
    # wired (launch/serve.py passes CheckpointManager.health), a due
    # restart whose store is mid-failure is DEFERRED by store_backoff
    # ticks instead of paying for a doomed restore — and after
    # max_restart_deferrals consecutive deferrals the restart is
    # REFUSED outright (the replica stays dead; restarting from a
    # store that cannot serve reads would thrash forever).
    store_backoff: int = 8
    max_restart_deferrals: int = 5
    # JSONL routing-signal timeline (None = in-memory only; schema
    # documented on repro_torch.serve.router.TimelineWriter).
    timeline_path: Optional[str] = None
    # Wedged-fleet guard: hard failure if the run exceeds this.
    max_ticks: int = 100_000
    chaos: Optional[FleetChaosConfig] = None
    # Signal-driven autoscaling (None = fixed fleet). Scale-ups build
    # the new replica via Fleet's restart_factory when given, else
    # share replica 0's engine object (sessions are self-contained, so
    # sharing costs only the params).
    autoscale: Optional[AutoscaleConfig] = None


class _Replica:
    """Fleet-side view of one engine replica."""

    def __init__(self, eid: int, engine: ServeEngine):
        self.eid = eid
        self.engine = engine
        self.sess = None
        self.state = LIVE
        self.last_hb = 0
        self.slow_until = -1      # chaos: skip_tick through this tick
        self.hb_lost_until = -1   # chaos: heartbeat suppressed through
        self.killed_at = -1
        self.restarts = 0
        self.stats: Optional[dict] = None  # snapshot at close/kill
        self.closed = False


class _FleetReq:
    """Fleet-side canonical record of one request."""

    def __init__(self, req: Request):
        self.req = req
        self.tokens: list[int] = []     # canonical generated tokens
        self.first_token_at: int = -1
        # eid -> this copy's progress index into self.tokens (how many
        # generated tokens that engine has emitted for this rid).
        self.copies: dict[int, int] = {}
        self.hedge_eids: set[int] = set()
        self.attempts = 0               # retry dispatches consumed
        self.migrations = 0
        self.hedges = 0
        self.dispatched_at = -1
        self.last_progress_at = req.arrival
        self.done: Optional[dict] = None


class Fleet:
    """N tick-interleaved ServeEngine replicas behind one router.

    ``engines`` is either a list of :class:`ServeEngine` (one per
    replica) or a single engine replicated ``fc.num_engines`` times —
    sessions are fully self-contained (own pool, scheduler, KV cache),
    so replicas sharing one engine object share only its params (and its
    built kernels).

    ``restart_factory(eid) -> ServeEngine``, if given, builds the
    replacement engine for a post-death restart — the
    restart-from-checkpoint hook (see ``launch/serve.py``); default is
    reusing the dead replica's engine object.
    """

    def __init__(self, engines, fc: Optional[FleetConfig] = None, *,
                 restart_factory: Optional[
                     Callable[[int], ServeEngine]] = None,
                 store_health: Optional[Callable[[], dict]] = None,
                 tracker: Optional[Tracker] = None):
        self.fc = fc or FleetConfig()
        if isinstance(engines, ServeEngine):
            engines = [engines] * self.fc.num_engines
        if not engines:
            raise ValueError("fleet needs at least one engine")
        for e in engines:
            if not (e.sc.paged and e.sc.admission == "chunked"):
                raise ValueError(
                    "fleet replicas need ServeConfig(paged=True, "
                    "admission='chunked')"
                )
        self.replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self.router = Router(self.fc.router)
        self.restart_factory = restart_factory
        # Probe returning CheckpointManager.health()-shaped dicts; a
        # restart-from-checkpoint consults it before rebuilding (see
        # FleetConfig.store_backoff / max_restart_deferrals).
        self.store_health = store_health
        self._restart_deferrals: dict[int, int] = {}  # eid -> streak
        self.finished: dict[int, dict] = {}
        self.outs: dict[int, list] = {}
        self.last_stats: dict = {}
        self._reqs: dict[int, _FleetReq] = {}
        self._pending: list[dict] = []  # {"rid", "at", "exclude"}
        self._restart_at: dict[int, int] = {}  # eid -> rejoin tick
        self._tick = 0
        self._seed = 0
        self._on_token_user = None
        self._on_event_user = None
        self._crng = (np.random.default_rng(self.fc.chaos.seed)
                      if self.fc.chaos is not None else None)
        self._prob_kills = 0
        self._hb_losses = 0
        self.stats = {
            "migrations": 0, "retries": 0, "kills": 0,
            "hb_failovers": 0, "restarts": 0, "drains": 0,
            "hedges_dispatched": 0, "hedges_won": 0, "hedges_lost": 0,
            "scale_ups": 0, "scale_downs": 0,
            "restart_deferrals": 0, "restart_refusals": 0,
        }
        # Observability: user-supplied tracker (optional); run() binds
        # it to the fleet tick clock and attaches the TimelineWriter as
        # one more sink of the same protocol.
        self.tracker = tracker
        self.trk: Tracker = NULL
        self.timeline: Optional[TimelineWriter] = None
        self.autoscaler = (Autoscaler(self.fc.autoscale)
                           if self.fc.autoscale is not None else None)
        self._as_last_retries = 0
        self._tokens = 0  # cumulative canonical (frontier) tokens

    # -- session plumbing ----------------------------------------------
    def _open(self, rep: _Replica) -> None:
        eid = rep.eid
        rep.sess = rep.engine.open_session(
            on_token=lambda rid, tok, _e=eid: self._on_token(
                _e, rid, tok),
            on_event=lambda rid, ev, detail, _e=eid: self._on_event(
                _e, rid, ev, detail),
            seed=self._seed, fleet_mode=True,
            # Per-replica child tracker: same sinks (timeline
            # included), fleet tick clock, tagged engine=<eid> — the
            # per-tick "engine" rows of the timeline schema.
            tracker=self.trk.bind(engine=eid),
        )
        rep.closed = False

    def _candidates(self, exclude=()) -> list:
        """(eid, state, signals) for every replica accepting NEW work,
        dropping ``exclude`` only if someone else remains."""
        cands = [
            (r.eid, r.state, r.sess.signals())
            for r in self.replicas
            if r.state in (LIVE, DEGRADED) and r.sess is not None
        ]
        kept = [c for c in cands if c[0] not in exclude]
        return kept or cands

    # -- fleet <- engine callbacks --------------------------------------
    def _on_token(self, eid: int, rid: int, tok: int) -> None:
        fr = self._reqs.get(rid)
        if fr is None:
            return
        prog = fr.copies.get(eid)
        if prog is None:
            return
        if prog == len(fr.tokens):
            # The frontier copy: this token index is new fleet-wide.
            fr.tokens.append(tok)
            self._tokens += 1
            if fr.first_token_at < 0:
                fr.first_token_at = self._tick + 1
            if self._on_token_user is not None:
                self._on_token_user(rid, tok)
        else:
            # A trailing copy (hedge, or a replay after migration)
            # re-derives an index the frontier already emitted — the
            # idempotent-re-execution contract says it MUST match.
            assert tok == fr.tokens[prog], (
                f"hedge divergence: rid={rid} idx={prog} engine={eid} "
                f"emitted {tok}, canonical {fr.tokens[prog]}"
            )
        fr.copies[eid] = prog + 1
        fr.last_progress_at = self._tick + 1

    def _on_event(self, eid: int, rid: int, ev: str, detail: str
                  ) -> None:
        if ev in ("preempted-requeued", "cancelled"):
            return  # engine-internal / fleet-initiated
        fr = self._reqs.get(rid)
        if fr is None:
            return
        if fr.done is not None:
            fr.copies.pop(eid, None)  # late terminal on a stale copy
            return
        if ev == COMPLETED or ev == TIMEOUT:
            rec = dict(self.replicas[eid].sess.sched.finished[rid])
            fr.copies.pop(eid, None)
            if ev == COMPLETED and eid in fr.hedge_eids:
                self.stats["hedges_won"] += 1
            self._finish(fr, rec, winner=eid)
            for other in list(fr.copies):
                self._cancel_copy(fr, other, "raced-out")
        elif ev == SHED or ev == FAILED:
            fr.copies.pop(eid, None)
            was_hedge = eid in fr.hedge_eids
            fr.hedge_eids.discard(eid)
            if fr.copies:
                # Another copy still runs this request. A shed/failed
                # hedge copy resolves as lost; a shed PRIMARY just
                # promotes the surviving hedge, no retry needed.
                if was_hedge:
                    self.stats["hedges_lost"] += 1
                return
            if fr.attempts >= self.fc.max_retries:
                rec = dict(self.replicas[eid].sess.sched.finished[rid])
                self._finish(fr, rec, winner=eid)
                return
            delay = self.router.backoff(fr.attempts)
            fr.attempts += 1
            self.stats["retries"] += 1
            self._pend(rid, self._tick + 1 + delay, exclude={eid})

    def _cancel_copy(self, fr: _FleetReq, eid: int, reason: str
                     ) -> None:
        rep = self.replicas[eid]
        if rep.state != DEAD and rep.sess is not None:
            rep.sess.cancel(fr.req.rid, reason)
        fr.copies.pop(eid, None)
        if eid in fr.hedge_eids:  # the cancelled loser was the hedge
            self.stats["hedges_lost"] += 1
        fr.hedge_eids.discard(eid)

    def _finish(self, fr: _FleetReq, rec: dict, winner: int) -> None:
        assert fr.done is None and fr.req.rid not in self.finished, (
            f"rid {fr.req.rid} reached two fleet-terminal statuses"
        )
        rec["engine"] = winner
        rec["migrations"] = fr.migrations
        rec["hedges"] = fr.hedges
        rec["retries"] = fr.attempts
        fr.done = rec
        self.finished[fr.req.rid] = rec
        if self._on_event_user is not None:
            self._on_event_user(fr.req.rid, rec["status"], rec["reason"])

    # -- dispatch -------------------------------------------------------
    def _pend(self, rid: int, at: int, exclude=frozenset()) -> None:
        self._pending.append(
            {"rid": rid, "at": at, "exclude": set(exclude)}
        )

    def _resume_record(self, fr: _FleetReq) -> Optional[dict]:
        """Rebuild a preempt-and-requeue resume record from the
        fleet's canonical token log — what a survivor needs to continue
        a migrated/hedged request token-identically."""
        if not fr.tokens:
            return None
        return {
            "seq": list(fr.req.prompt) + list(fr.tokens),
            "generated": len(fr.tokens),
            "first_done": True,
            "first_token_at": fr.first_token_at,
            "admitted_at": fr.dispatched_at,
            "preemptions": fr.migrations,
        }

    def _submit(self, eid: int, fr: _FleetReq, tick: int,
                hedge: bool = False) -> None:
        rep = self.replicas[eid]
        rid = fr.req.rid
        # A previous life of this rid on this engine (shed there, or a
        # cancelled hedge copy) left a terminal record — clear it so
        # the duplicate-rid guard admits the retry.
        rep.sess.forget(rid)
        rep.sess.submit(fr.req, self._resume_record(fr))
        fr.copies[eid] = len(fr.tokens)
        if hedge:
            fr.hedge_eids.add(eid)
            fr.hedges += 1
            self.stats["hedges_dispatched"] += 1
        if fr.dispatched_at < 0:
            fr.dispatched_at = tick
        fr.last_progress_at = tick

    def _dispatch(self, tick: int) -> None:
        still = []
        for p in self._pending:
            fr = self._reqs[p["rid"]]
            if fr.done is not None:
                continue
            if p["at"] > tick:
                still.append(p)
                continue
            cands = self._candidates(p["exclude"])
            if not cands:
                # Draining replicas take no NEW work and never come
                # back; only a live/degraded replica or a scheduled
                # restart counts as capacity worth waiting for.
                if self._restart_at or any(
                        r.state in (LIVE, DEGRADED)
                        for r in self.replicas):
                    still.append(p)  # capacity may come back
                else:
                    self._finish(fr, {
                        "status": FAILED, "reason": "no healthy engines",
                        "arrival": fr.req.arrival, "finished_at": tick,
                        "admitted_at": -1,
                        "first_token_at": fr.first_token_at,
                        "generated": len(fr.tokens), "prefix_tokens": 0,
                        "preemptions": 0, "drafted": 0, "accepted": 0,
                    }, winner=-1)
                continue
            self._submit(self.router.pick(cands), fr, tick)
        self._pending = still

    def _hedge(self, tick: int) -> None:
        fc = self.fc
        if fc.hedge_after <= 0:
            return
        for fr in self._reqs.values():
            if fr.done is not None or not fr.copies:
                continue
            if len(fr.copies) >= 1 + fc.max_hedges:
                continue
            if tick - fr.last_progress_at < fc.hedge_after:
                continue
            cands = self._candidates(exclude=set(fr.copies))
            cands = [c for c in cands if c[0] not in fr.copies]
            if not cands:
                continue
            self._submit(self.router.pick(cands), fr, tick, hedge=True)

    # -- failure / lifecycle --------------------------------------------
    def _snapshot(self, rep: _Replica) -> dict:
        stats = dict(rep.sess.stats)
        counts: dict = {}
        for rec in rep.sess.sched.finished.values():
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        stats["status_counts"] = counts
        return stats

    def kill(self, eid: int, tick: int, reason: str = "chaos-kill"
             ) -> None:
        """Engine death: drop the corpse (its pool dies with it — no
        audits, no leak check on dead memory) and migrate every
        unfinished request that had a copy there onto survivors with
        fleet-side resume records."""
        rep = self.replicas[eid]
        if rep.state == DEAD:
            return
        rep.state = DEAD
        rep.killed_at = tick
        if rep.sess is not None:
            # A request can finish in the corpse's LAST working tick
            # with its terminal event still undelivered (terminal
            # bookkeeping runs after that tick's event dispatch).
            # Flush before migrating, or the fleet would re-dispatch a
            # COMPLETE token log and the survivor would decode one
            # token past the budget.
            rep.sess.flush_events()
            rep.stats = self._snapshot(rep)
            rep.stats["death"] = reason
        rep.sess = None
        self.stats["kills"] += 1
        if self.fc.restart_after > 0:
            self._restart_at[eid] = tick + self.fc.restart_after
        for rid, fr in self._reqs.items():
            if fr.done is not None or eid not in fr.copies:
                continue
            fr.copies.pop(eid)
            was_hedge = eid in fr.hedge_eids
            fr.hedge_eids.discard(eid)
            if fr.copies:
                # A surviving copy elsewhere keeps the request going —
                # the dead copy (a hedge, or a primary whose hedge now
                # takes over) resolves without a migration.
                if was_hedge:
                    self.stats["hedges_lost"] += 1
                continue
            fr.migrations += 1
            self.stats["migrations"] += 1
            if not any(p["rid"] == rid for p in self._pending):
                # Migration is failover, not a retry: it consumes no
                # retry budget and re-dispatches immediately.
                self._pend(rid, tick, exclude={eid})

    def drain(self, eid: int, tick: Optional[int] = None) -> None:
        """Graceful drain: stop routing NEW work to ``eid``, migrate
        its queued (unadmitted) requests to the other replicas now, let
        in-flight requests finish, then retire the engine through the
        full close() checks (block-leak audit included)."""
        tick = self._tick if tick is None else tick
        rep = self.replicas[eid]
        if rep.state == DEAD or rep.sess is None:
            return
        rep.state = DRAINING
        self.stats["drains"] += 1
        for req, _res in rep.sess.extract_queue():
            fr = self._reqs.get(req.rid)
            if fr is None or fr.done is not None:
                continue
            fr.copies.pop(eid, None)
            was_hedge = eid in fr.hedge_eids
            fr.hedge_eids.discard(eid)
            if fr.copies:
                if was_hedge:
                    self.stats["hedges_lost"] += 1
                continue
            fr.migrations += 1
            self.stats["migrations"] += 1
            if not any(p["rid"] == req.rid for p in self._pending):
                self._pend(req.rid, tick, exclude={eid})

    def _retire(self, rep: _Replica, tick: int) -> None:
        rep.stats = self._snapshot(rep)
        rep.sess.close()
        rep.stats["death"] = "drained"
        rep.sess = None
        rep.state = DEAD
        rep.killed_at = tick
        rep.closed = True

    def _restart_allowed(self, eid: int, tick: int) -> bool:
        """Store-health gate for a due restart-from-checkpoint. A
        restart that would hit a failing checkpoint store is deferred
        (rescheduled ``store_backoff`` ticks out); once a replica has
        been deferred ``max_restart_deferrals`` times in a row it is
        refused — left dead rather than thrashing the store."""
        if self.restart_factory is None or self.store_health is None:
            return True  # no store involved / no probe wired
        health = self.store_health()
        if health.get("healthy", True):
            self._restart_deferrals.pop(eid, None)
            return True
        streak = self._restart_deferrals.get(eid, 0) + 1
        if streak > self.fc.max_restart_deferrals:
            self._restart_deferrals.pop(eid, None)
            self.stats["restart_refusals"] += 1
            self.trk.count("fleet.restart_refusals", t=tick)
            self.trk.event(
                "restart_refused", t=tick, engine=eid,
                deferrals=streak - 1,
                consecutive_failures=int(
                    health.get("consecutive_failures", -1)),
            )
            return False
        self._restart_deferrals[eid] = streak
        self._restart_at[eid] = tick + max(1, self.fc.store_backoff)
        self.stats["restart_deferrals"] += 1
        self.trk.count("fleet.restart_deferrals", t=tick)
        self.trk.event(
            "restart_deferred", t=tick, engine=eid, streak=streak,
            retry_at=self._restart_at[eid],
        )
        return False

    def _restart(self, eid: int, tick: int) -> None:
        rep = self.replicas[eid]
        if self.restart_factory is not None:
            rep.engine = self.restart_factory(eid)
        self._open(rep)  # fresh session: empty pool, same seed
        rep.state = LIVE
        rep.last_hb = tick
        rep.slow_until = -1
        rep.hb_lost_until = -1
        rep.restarts += 1
        self.stats["restarts"] += 1

    def _chaos(self, tick: int) -> None:
        ch = self.fc.chaos
        if ch is None:
            return
        for t, eid in ch.kills:
            if t == tick:
                self.kill(eid, tick)
        crng = self._crng
        for rep in self.replicas:
            if rep.state == DEAD:
                continue
            if ch.kill_prob and self._prob_kills < ch.max_kills \
                    and crng.random() < ch.kill_prob:
                self._prob_kills += 1
                self.kill(rep.eid, tick)
                continue
            if ch.hb_loss_prob and rep.hb_lost_until < tick \
                    and (ch.max_hb_losses is None
                         or self._hb_losses < ch.max_hb_losses) \
                    and crng.random() < ch.hb_loss_prob:
                self._hb_losses += 1
                rep.hb_lost_until = tick + ch.hb_loss_ticks
            if ch.slow_prob and rep.slow_until < tick \
                    and crng.random() < ch.slow_prob:
                rep.slow_until = tick + ch.slow_ticks

    def _health(self, tick: int) -> None:
        for rep in self.replicas:
            if rep.state == DEAD or rep.sess is None:
                continue
            hb_age = tick - rep.last_hb
            state = self.router.derive_state(hb_age, rep.sess.signals())
            if state == DEAD:
                # Failover on a stale heartbeat. Possibly a false
                # positive (heartbeat-loss chaos) — but the fleet stops
                # ticking the engine the moment it is declared dead, so
                # migration never races a still-running copy.
                self.stats["hb_failovers"] += 1
                self.kill(rep.eid, tick, "heartbeat lost")
            elif rep.state != DRAINING:
                rep.state = state

    # -- autoscaling ----------------------------------------------------
    def _alive(self) -> list:
        return [r for r in self.replicas
                if r.state in (LIVE, DEGRADED) and r.sess is not None]

    def _autoscale(self, tick: int) -> None:
        """One autoscaler decision per fleet tick: sustained overload
        spawns a replica (restart_factory or shared engine object),
        sustained idleness drains the newest LIVE replica through the
        leak-checked retire path. Deterministic: signals and the tick
        clock only."""
        alive = self._alive()
        sigs = [r.sess.signals() for r in alive]
        backlog = (sum(s["queue_depth"] for s in sigs)
                   + sum(1 for p in self._pending if p["at"] <= tick))
        shed_delta = self.stats["retries"] - self._as_last_retries
        self._as_last_retries = self.stats["retries"]
        dec = self.autoscaler.decide(
            tick, n_live=len(alive), signals=sigs,
            backlog=backlog, shed_delta=shed_delta,
        )
        if dec == "up":
            eid = len(self.replicas)
            engine = (self.restart_factory(eid)
                      if self.restart_factory is not None
                      else self.replicas[0].engine)
            rep = _Replica(eid, engine)
            rep.last_hb = tick
            self.replicas.append(rep)
            self._open(rep)
            self.stats["scale_ups"] += 1
            self.trk.count("fleet.scale_ups", t=tick)
            self.trk.event("scale_up", t=tick, engine=eid)
        elif dec == "down":
            victims = [r for r in self._alive() if r.state == LIVE]
            if victims:
                eid = max(r.eid for r in victims)  # newest first
                self.drain(eid, tick)
                self.stats["scale_downs"] += 1
                self.trk.count("fleet.scale_downs", t=tick)
                self.trk.event("scale_down", t=tick, engine=eid)

    # -- the run loop ---------------------------------------------------
    def run(self, requests: list, *, seed: int = 0, on_token=None,
            on_event=None):
        """Serve ``requests`` across the replica pool (every session's
        sampling seed is ``seed``: the reference derives it from its
        rng); returns ``(outputs, finished)`` shaped exactly like
        ``ServeEngine.serve`` — ``outputs[rid]`` is prompt + generated
        tokens, ``finished[rid]`` the fleet-terminal record (plus
        ``engine``/``migrations``/``hedges``/``retries``). Fleet-level
        stats land in ``self.last_stats`` (per-engine + aggregated)."""
        for r in requests:
            if r.on_token is not None or r.on_event is not None:
                raise ValueError(
                    f"request {r.rid}: per-request callbacks fire once "
                    "per engine COPY under hedging — pass fleet-level "
                    "on_token/on_event to Fleet.run instead"
                )
            if r.rid in self._reqs:
                raise ValueError(f"duplicate rid {r.rid}")
            self._reqs[r.rid] = _FleetReq(r)
            self._pend(r.rid, r.arrival)
        self._seed = int(seed)
        self._on_token_user = on_token
        self._on_event_user = on_event
        # The timeline is one more sink of the tracker protocol; the
        # fleet tracker binds the user's tracker (if any) to the fleet
        # tick clock, so every exported row — engine and fleet alike —
        # is stamped on the global tick, never wall-clock.
        tl = TimelineWriter(self.fc.timeline_path)
        self.timeline = tl
        base = self.tracker if self.tracker is not None else NULL
        self.trk = base.bind(extra_sinks=(tl,),
                             clock=lambda: self._tick)
        tick = 0
        try:
            for rep in self.replicas:
                self._open(rep)
            while len(self.finished) < len(self._reqs):
                if tick >= self.fc.max_ticks:
                    raise RuntimeError(
                        f"fleet wedged: {len(self._reqs) - len(self.finished)}"
                        f" requests unresolved after {tick} ticks"
                    )
                self._tick = tick
                self._chaos(tick)
                for eid, at in list(self._restart_at.items()):
                    if at <= tick:
                        del self._restart_at[eid]
                        if self._restart_allowed(eid, tick):
                            self._restart(eid, tick)
                self._health(tick)
                if self.autoscaler is not None:
                    self._autoscale(tick)
                self._dispatch(tick)
                self._hedge(tick)
                for rep in self.replicas:
                    if rep.state == DEAD or rep.sess is None:
                        continue
                    if rep.slow_until >= tick:
                        rep.sess.skip_tick()
                        continue  # stalled: no work, no heartbeat
                    rep.sess.tick()
                    if rep.hb_lost_until < tick:
                        rep.last_hb = tick
                for rep in self.replicas:
                    if rep.state == DRAINING and rep.sess is not None \
                            and not rep.sess.has_work:
                        self._retire(rep, tick)
                self.trk.row("fleet", **self._timeline_row(tick))
                tick += 1
            # Drain survivors through the full close() contract: block
            # leak check + engine-local exactly-one-terminal audit.
            for rep in self.replicas:
                if rep.sess is not None and not rep.closed:
                    rep.stats = self._snapshot(rep)
                    rep.sess.close()
                    rep.closed = True
        finally:
            tl.close()
        for rid, fr in self._reqs.items():
            self.outs[rid] = list(fr.req.prompt) + list(fr.tokens)
        missing = set(self._reqs) - set(self.finished)
        assert not missing, (
            f"requests without a fleet-terminal status: {sorted(missing)}"
        )
        self._aggregate(tick, tl)
        return self.outs, self.finished

    # -- observability --------------------------------------------------
    def _timeline_row(self, tick: int) -> dict:
        engines = {}
        for rep in self.replicas:
            row = {"state": rep.state,
                   "hb_age": tick - rep.last_hb}
            if rep.sess is not None:
                sig = rep.sess.signals()
                row.update(
                    occupancy=round(sig["occupancy"], 4),
                    free_blocks=sig["free_blocks"],
                    queue_depth=sig["queue_depth"],
                    active=sig["active"],
                    decoding=sig["decoding"],
                    stall_ticks=sig["stall_ticks"],
                )
            engines[str(rep.eid)] = row
        inflight = sum(1 for fr in self._reqs.values()
                       if fr.done is None and fr.copies)
        return {
            "tick": tick,
            "engines": engines,
            "fleet": {
                "pending": len(self._pending),
                "inflight": inflight,
                "finished": len(self.finished),
                "tokens": self._tokens,
                "replicas": len(self._alive()),
                "migrations": self.stats["migrations"],
                "retries": self.stats["retries"],
                "hedges": self.stats["hedges_dispatched"],
                "scale_ups": self.stats["scale_ups"],
                "scale_downs": self.stats["scale_downs"],
            },
        }

    def _aggregate(self, ticks: int, tl: TimelineWriter) -> None:
        """The cross-replica ``last_stats`` aggregation: per-engine
        snapshots plus fleet-wide terminal-status counts, so the bench
        artifact never hand-sums engine dicts."""
        counts: dict = {}
        for rec in self.finished.values():
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        per_engine = {}
        for rep in self.replicas:
            st = rep.stats if rep.stats is not None else (
                self._snapshot(rep) if rep.sess is not None else {})
            per_engine[rep.eid] = {
                "state": rep.state,
                "restarts": rep.restarts,
                "killed_at": rep.killed_at,
                "mixed_steps": st.get("mixed_steps", 0),
                "preemptions": st.get("preemptions", 0),
                "audits": st.get("audits", 0),
                "status_counts": st.get("status_counts", {}),
                "prefix_hit_frac": st.get("prefix_hit_frac", 0.0),
            }
        self.last_stats = {
            "mode": "fleet",
            "num_engines": len(self.replicas),
            "ticks": ticks,
            "status_counts": counts,
            "hedges": {
                "dispatched": self.stats["hedges_dispatched"],
                "won": self.stats["hedges_won"],
                "lost": self.stats["hedges_lost"],
            },
            "timeline_rows": sum(1 for r in tl.rows
                                 if r.get("kind", "fleet") == "fleet"),
            "timeline_engine_rows": sum(1 for r in tl.rows
                                        if r.get("kind") == "engine"),
            "timeline_path": self.fc.timeline_path,
            "tokens": self._tokens,
            "engines": per_engine,
            **{k: self.stats[k] for k in
               ("migrations", "retries", "kills", "hb_failovers",
                "restarts", "drains", "scale_ups", "scale_downs",
                "restart_deferrals", "restart_refusals")},
        }
