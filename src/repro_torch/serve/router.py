r"""Health-checked routing for a multi-engine serve fleet.

This module (a copy of ``repro/serve/router.py``) is the pure-policy
half of :mod:`repro_torch.serve.fleet`: given
per-engine health signals (the :meth:`ChunkedSession.signals` dict plus
heartbeat age), it derives a health state and picks a replica for the
next request. It owns no engines and mutates nothing — the
:class:`~repro_torch.serve.fleet.Fleet` feeds it observations once per tick,
which keeps the policy unit-testable without building a model.

Health states (per engine)::

    live      heartbeating, signals under every threshold
    degraded  heartbeating but slow: stale heartbeat, pool occupancy,
              queue depth, or admission-stall streak over threshold —
              still routable, but load-weighted DOWN by
              ``degraded_weight``
    draining  operator-initiated: no NEW admissions, in-flight work
              finishes, queue migrates (set by Fleet.drain, never
              derived here)
    dead      heartbeat older than ``hb_dead`` ticks (failover) or
              killed by chaos — never routed, queued + active work is
              migrated to survivors

Routing is weighted least-loaded: each candidate's load is its queue
depth plus active slots plus pool occupancy (three cheap host-side
reads), multiplied by ``degraded_weight`` when degraded; the minimum
wins, ties broken by lowest engine id so replays are deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.tracker import JsonlSink

LIVE = "live"
DEGRADED = "degraded"
DRAINING = "draining"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Health thresholds + routing weights + retry backoff policy."""

    # Heartbeat age (fleet ticks since the engine last completed a
    # tick) before the engine is considered degraded / declared dead.
    hb_degraded: int = 3
    hb_dead: int = 10
    # Signal thresholds that mark a heartbeating engine degraded.
    degraded_occupancy: float = 0.92
    degraded_queue: int = 8
    degraded_stall_ticks: int = 4
    # Load multiplier applied to degraded engines when routing.
    degraded_weight: float = 4.0
    # Retry backoff (ticks): min(cap, base * 2**attempt).
    retry_backoff: int = 1
    retry_backoff_cap: int = 16


class Router:
    """Stateless health derivation + replica selection policy."""

    def __init__(self, rc: Optional[RouterConfig] = None):
        self.rc = rc or RouterConfig()

    # -- health ---------------------------------------------------------
    def derive_state(self, hb_age: int, signals: dict) -> str:
        """LIVE / DEGRADED / DEAD from heartbeat age + engine signals.

        DRAINING is operator state, never derived. A DEAD verdict here
        is a *failover decision* — the engine may actually be healthy
        with a lost heartbeat; the fleet stops ticking it either way,
        so a false positive costs a migration, never a duplicate token.
        """
        rc = self.rc
        if hb_age >= rc.hb_dead:
            return DEAD
        if hb_age >= rc.hb_degraded:
            return DEGRADED
        if signals["occupancy"] >= rc.degraded_occupancy:
            return DEGRADED
        if signals["queue_depth"] >= rc.degraded_queue:
            return DEGRADED
        if signals["stall_ticks"] >= rc.degraded_stall_ticks:
            return DEGRADED
        return LIVE

    # -- routing --------------------------------------------------------
    def load(self, state: str, signals: dict) -> float:
        """Scalar load score; smaller is better."""
        raw = (signals["queue_depth"] + signals["active"]
               + signals["occupancy"])
        return raw * (self.rc.degraded_weight if state == DEGRADED
                      else 1.0)

    def pick(self, candidates: list) -> Optional[int]:
        """Least-loaded engine id from ``[(eid, state, signals), ...]``
        (healthy replicas only — the fleet pre-filters). Ties break on
        lowest eid for deterministic replays. None if empty."""
        best = None
        best_key = None
        for eid, state, signals in candidates:
            key = (self.load(state, signals), eid)
            if best_key is None or key < best_key:
                best, best_key = eid, key
        return best

    # -- retry policy ---------------------------------------------------
    def backoff(self, attempt: int) -> int:
        """Capped exponential backoff in ticks for retry ``attempt``
        (0-based): min(cap, base * 2**attempt)."""
        rc = self.rc
        return min(rc.retry_backoff_cap,
                   rc.retry_backoff * (2 ** attempt))


class TimelineWriter(JsonlSink):
    """Per-tick JSON-lines export of the fleet's routing signals — the
    ROADMAP's "autoscaling triggers" artifact, now a kind-filtered
    :class:`repro_torch.obs.tracker.JsonlSink` of the tracker protocol.

    The timeline carries the two structured time-series row kinds
    (anything else a shared tracker emits — spans, counters — is
    filtered out so the artifact stays a pure time series):

    ``{"kind": "engine", ...}`` — one row per LIVE replica per tick,
    emitted by the replica's own session; schema documented in
    ``src/repro/obs/README.md``.

    ``{"kind": "fleet", ...}`` — one row per fleet tick::

        {
          "kind": "fleet",
          "t": int,                   # global fleet tick (== "tick")
          "tick": int,
          "engines": {                # one entry per replica (dead too)
            "<eid>": {
              "state": "live" | "degraded" | "draining" | "dead",
              "hb_age": int,          # ticks since last heartbeat
              # present only while the replica has an open session:
              "occupancy": float,     # used blocks / pool capacity
              "free_blocks": int,
              "queue_depth": int,     # unadmitted requests waiting
              "active": int,          # occupied slots
              "decoding": int,        # slots past prefill
              "stall_ticks": int      # consecutive block-starved ticks
            }, ...
          },
          "fleet": {
            "pending": int,           # requests awaiting (re)dispatch
            "inflight": int,          # requests with >= 1 live copy
            "finished": int,          # fleet-terminal so far
            "tokens": int,            # cumulative canonical tokens
            "replicas": int,          # live + degraded replica count
            "migrations": int,        # cumulative
            "retries": int,           # cumulative
            "hedges": int,            # cumulative hedge dispatches
            "scale_ups": int,         # cumulative autoscaler spawns
            "scale_downs": int        # cumulative autoscaler drains
          }
        }

    An autoscaler watches ``queue_depth`` / ``occupancy`` /
    ``stall_ticks`` trends to add replicas, and ``state`` flips for
    alerting (:class:`repro_torch.serve.fleet.Autoscaler` consumes exactly
    these signals). ``path=None`` keeps rows in memory only (tests
    read ``.rows``); with a path, every row is written AND flushed
    immediately — a crash mid-run loses nothing already emitted — and
    rows are also kept in memory.

    Lifecycle: a context manager; ``close`` is idempotent and the
    ``with`` exit guarantees close-on-exception (the old
    open-in-init/close-if-you-remember shape leaked the file handle
    when a fleet run raised mid-trace).
    """

    KINDS = ("engine", "fleet")

    def __init__(self, path: Optional[str] = None,
                 kinds: tuple = KINDS):
        super().__init__(path, keep_rows=True)
        self.kinds = kinds

    def write(self, row: dict) -> None:
        if "kind" in row and row["kind"] not in self.kinds:
            return
        super().write(row)
