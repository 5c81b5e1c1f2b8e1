r"""Continuous-batching scheduler: slots, priority/FCFS admission,
chunked prefill, deadlines, backpressure, preempt-and-requeue (copy of
``repro/serve/scheduler.py``).

Pure host-side bookkeeping so the policy is unit-testable in
isolation. The clock is the engine's step counter: one tick per mixed
step (or per batched decode step in prefill-on-join mode), request
arrivals and deadlines are expressed in ticks.

Slot lifecycle::

    FREE --admit (best visible queue entry, slot free, blocks available;
                  shared prefix blocks mapped copy-free)-->
    ACTIVE/prefilling --chunks (token-budget lanes, FCFS)-->
    ACTIVE/decoding --finish (EOS / token budget / max_len)--> FREE
             \--preempt (higher-priority admission under pool
                exhaustion, or chaos eviction): non-shared blocks
                released, computed full blocks stay matchable in the
                prefix index, request REQUEUED --> re-admitted later,
                recovering its prefix copy-free --> FREE
             \--timeout (TTFT/total deadline exceeded) --> FREE

Every submitted request reaches exactly ONE terminal status in
``finished[rid]["status"]``:

    ``completed``  EOS or token budget (``reason`` keeps the detail)
    ``shed``       refused by backpressure (bounded queue / overload)
    ``timeout``    TTFT or total deadline exceeded (queued or active)
    ``failed``     watchdog: the request can never make progress (e.g.
                   its worst-case footprint exceeds the whole pool);
                   ``reason`` carries the diagnostic

Preemption is NOT terminal — a preempted request is requeued (a
``preempted-requeued`` event fires, ``finished[rid]["preemptions"]``
counts them) and later completes / times out / is shed like any other.

Admission policy:

* **decode priority** — the mixed step's token budget reserves one row
  per decode slot; prefill chunks ride the separate chunk lanes, so an
  admission NEVER stalls in-flight decodes.
* **priority, then strict FCFS** — queue order is ``(-priority,
  arrival, submission seq)``; with equal priorities (the default) this
  is the old strict arrival-order FCFS. If the best *visible* (arrived)
  entry cannot be admitted, nothing behind it is (no overtaking).
* **starvation bound** — FCFS chunk assignment means the oldest
  prefilling request takes every tick's first chunk lane until its
  prompt completes (see :meth:`prefilling`).

Backpressure (``queue_policy`` ``"block"`` | ``"shed-newest"`` |
``"shed-oldest"``): with ``block`` requests wait indefinitely; the
shedding policies bound the wait queue at ``queue_limit`` visible
entries and additionally refuse work while an overload signal is up —
pool occupancy ``>= shed_occupancy`` or the admission-stall streak
``>= shed_stall_ticks`` (consecutive ticks the best visible entry sat
block-starved with a free slot — the ROADMAP's autoscaling signal).
``shed-newest`` drops the newest-arriving entries, ``shed-oldest`` the
stalest ones (age order, priority-blind).

Preempt-and-requeue (``preempt=True``): when the best visible entry
cannot get blocks, the youngest active slot with STRICTLY lower
priority is preempted — its computed full blocks are registered in the
prefix index, its blocks freed (shared ones survive for their other
holders), and the request requeued with its emitted tokens intact. On
re-admission the prefix cache recovers the full blocks copy-free, so
preemption costs only the uncached tail re-prefill. Strictly-lower
priority avoids livelock: the victim can never immediately preempt its
preemptor back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.obs.tracker import NULL
from repro_torch.serve.paged_cache import BlockPool, _chain, blocks_needed

FREE = "free"
ACTIVE = "active"

# Terminal statuses (finished[rid]["status"]).
COMPLETED = "completed"
SHED = "shed"
TIMEOUT = "timeout"
FAILED = "failed"

QUEUE_POLICIES = ("block", "shed-newest", "shed-oldest")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 32
    eos_id: Optional[int] = None
    arrival: int = 0  # tick the request becomes visible
    # Higher = more important: sorts ahead in the queue and (with
    # preempt=True) may preempt strictly-lower-priority active slots.
    priority: int = 0
    # Deadlines in ticks AFTER arrival (None = engine default / none):
    # first token by arrival + ttft_deadline, finished by arrival +
    # deadline; exceeded -> terminal status "timeout".
    ttft_deadline: Optional[int] = None
    deadline: Optional[int] = None
    # Streaming callbacks: on_token(rid, token) per new token;
    # on_event(rid, event, detail) per lifecycle event.
    on_token: Optional[Callable[[int, int], None]] = None
    on_event: Optional[Callable[[int, str, str], None]] = None


@dataclasses.dataclass
class Slot:
    index: int
    state: str = FREE
    request: Optional[Request] = None
    blocks: tuple = ()
    length: int = 0  # tokens currently in the slot's KV blocks
    generated: int = 0  # new tokens emitted so far (across preemptions)
    budget: int = 0  # max new tokens (request.max_new clamped to max_len)
    admitted_at: int = 0  # FIRST admission tick (stable across requeues)
    admit_seq: int = 0  # FCFS tiebreaker for chunk-lane assignment
    first_token_at: int = 0
    decoding: bool = False  # prompt fully prefilled THIS admission
    prefix_tokens: int = 0  # prompt tokens served from the prefix cache
    # Copy-on-write donor for the partial tail block: (src_block,
    # dst_block, tokens) — the ENGINE applies the device copy, then
    # bumps slot.length by tokens.
    cow: Optional[tuple[int, int, int]] = None
    # Prefix-registration resume point (blocks indexed so far + chain
    # hash there) so per-chunk registration never re-hashes the prefix.
    reg_blocks: int = 0
    reg_parent: str = ""
    # --- robustness bookkeeping ---------------------------------------
    priority: int = 0
    # The token sequence to (re)prefill: the prompt, or prompt +
    # already-generated tokens after a preempt-and-requeue.
    eff_prompt: list = dataclasses.field(default_factory=list)
    first_done: bool = False  # first token emitted (any admission)
    preemptions: int = 0
    ttft_at: Optional[int] = None  # absolute deadline ticks
    deadline_at: Optional[int] = None
    sub_seq: int = 0  # original submission seq (stable requeue order)
    # --- speculative decoding (Scheduler(spec=True)) -------------------
    # Private draft-model KV blocks (same pool, same footprint as the
    # target blocks, never prefix-indexed) and the draft cache's valid
    # coverage: draft_length == length means the draft is in lockstep
    # and may speculate this tick.
    draft_blocks: tuple = ()
    draft_length: int = 0
    drafted: int = 0  # draft tokens proposed (across preemptions)
    accepted: int = 0  # draft tokens accepted by the target
    # --- in-flight prefix sharing --------------------------------------
    # Blocks shared from a STILL-PREFILLING donor slot, pending until
    # the donor's chunks actually write them: [(end_tokens, donor_slot,
    # donor_admit_seq)] in contiguous order. While non-empty the slot
    # takes no chunk lanes (it must not write into/past the pending
    # region); the engine promotes entries as the donor's length
    # crosses each end, or preempts-and-requeues the slot if the donor
    # dies first.
    pending_shared: list = dataclasses.field(default_factory=list)
    # Chain hashes this slot registered in the in-flight map (pruned on
    # _clear).
    inflight_keys: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _QEntry:
    req: Request
    seq: int  # submission order (FCFS tiebreaker)
    ttft_at: Optional[int]
    deadline_at: Optional[int]

    @property
    def key(self):
        return (-self.req.priority, self.req.arrival, self.seq)


class Scheduler:
    """Priority/FCFS continuous-batching admission over a fixed slot
    array + the shared refcounted :class:`BlockPool` (prefix-aware),
    with bounded-queue backpressure, deadlines and preempt-and-requeue
    (all off by default — the bare constructor is the old FCFS
    scheduler)."""

    def __init__(
        self,
        max_batch: int,
        pool: BlockPool,
        max_len: int,
        *,
        queue_limit: int = 0,  # 0 = unbounded
        queue_policy: str = "block",
        shed_occupancy: Optional[float] = None,
        shed_stall_ticks: int = 0,  # 0 = off
        preempt: bool = False,
        default_ttft_deadline: Optional[int] = None,
        default_deadline: Optional[int] = None,
        reject_oversized: bool = True,
        on_evict: Optional[Callable[[Slot], None]] = None,
        spec: bool = False,
        inflight_share: bool = False,
    ):
        if queue_policy not in QUEUE_POLICIES:
            raise ValueError(
                f"unknown queue_policy {queue_policy!r} {QUEUE_POLICIES}"
            )
        self.pool = pool
        self.max_len = max_len
        # Speculative decoding: every admission additionally allocates a
        # same-size private draft-lane block set, so admission and the
        # structural-failure watchdog account a 2x footprint.
        self.spec = spec
        # In-flight prefix sharing: admissions may map blocks a
        # still-prefilling donor slot has PLANNED (same-tick bursts),
        # recorded as pending until the donor writes them.
        self.inflight_share = inflight_share
        # chain hash -> (donor_slot, block_id, end_tokens, admit_seq).
        self._inflight: dict[str, tuple] = {}
        self.queue_limit = queue_limit
        self.queue_policy = queue_policy
        self.shed_occupancy = shed_occupancy
        self.shed_stall_ticks = shed_stall_ticks
        self.preempt = preempt
        self.default_ttft_deadline = default_ttft_deadline
        self.default_deadline = default_deadline
        self.reject_oversized = reject_oversized
        # Called whenever a slot is forcibly vacated (preempt/timeout)
        # so the engine can clear its host-side lane buffers.
        self.on_evict = on_evict
        self.slots = [Slot(index=i) for i in range(max_batch)]
        self.queue: list[_QEntry] = []  # kept sorted by entry.key
        self._seq = 0
        self._admit_seq = 0
        self._rids: set[int] = set()
        self.finished: dict[int, dict] = {}
        # Lifecycle events: (tick, rid, event, detail). The engine
        # drains these into stats + streaming callbacks each tick.
        self.events: list[tuple[int, int, str, str]] = []
        # Preempt-and-requeue resume state per rid.
        self._resume: dict[int, dict] = {}
        # Consecutive ticks the best visible entry sat block-starved
        # with a free slot (the backpressure / autoscaling signal).
        self.stall_ticks = 0
        # Observability: the owning session points this at its
        # Tracker; lifecycle counters (admissions, preemptions,
        # terminal statuses) are emitted here, at the source.
        self.tracker = NULL

    # -- submission -----------------------------------------------------
    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if req.rid in self._rids:
            raise ValueError(
                f"duplicate request id {req.rid}: outputs and stats are "
                "keyed by rid"
            )
        if plen == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new < 1:
            raise ValueError(
                f"request {req.rid}: max_new must be >= 1 (the first "
                "token is sampled from the prefill logits)"
            )
        if plen >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({plen}) >= max_len "
                f"({self.max_len})"
            )
        budget = min(req.max_new, self.max_len - plen)
        need = blocks_needed(plen, budget, self.pool.block_size)
        if self.spec:
            need *= 2  # target blocks + same-size draft lanes
        if self.reject_oversized and need > self.pool.capacity:
            raise ValueError(
                f"request {req.rid}: needs {need} KV blocks, pool holds "
                f"{self.pool.capacity} — raise num_blocks or max_len"
            )
        self._rids.add(req.rid)
        ttft = (req.ttft_deadline if req.ttft_deadline is not None
                else self.default_ttft_deadline)
        total = (req.deadline if req.deadline is not None
                 else self.default_deadline)
        self._enqueue(_QEntry(
            req=req, seq=self._seq,
            ttft_at=None if ttft is None else req.arrival + ttft,
            deadline_at=None if total is None else req.arrival + total,
        ))
        self._seq += 1

    def _enqueue(self, entry: _QEntry) -> None:
        self.queue.append(entry)
        self.queue.sort(key=lambda e: e.key)

    def _visible(self, now: int) -> list[_QEntry]:
        return [e for e in self.queue if e.req.arrival <= now]

    def best_visible(self, now: int) -> Optional[_QEntry]:
        for e in self.queue:  # queue is kept sorted by key
            if e.req.arrival <= now:
                return e
        return None

    # -- terminal records -----------------------------------------------
    def _record(self, req: Request, now: int, status: str, reason: str,
                *, slot: Optional[Slot] = None) -> None:
        res = self._resume.pop(req.rid, None)
        if slot is not None:
            rec = {
                "admitted_at": slot.admitted_at,
                "first_token_at": (slot.first_token_at
                                   if slot.first_done else -1),
                "generated": slot.generated,
                "prefix_tokens": slot.prefix_tokens,
                "preemptions": slot.preemptions,
                "drafted": slot.drafted,
                "accepted": slot.accepted,
            }
        elif res is not None:  # preempted earlier, died in the queue
            rec = {
                "admitted_at": res["admitted_at"],
                "first_token_at": (res["first_token_at"]
                                   if res["first_done"] else -1),
                "generated": res["generated"],
                "prefix_tokens": 0,
                "preemptions": res["preemptions"],
                "drafted": res.get("drafted", 0),
                "accepted": res.get("accepted", 0),
            }
        else:  # never admitted
            rec = {"admitted_at": -1, "first_token_at": -1,
                   "generated": 0, "prefix_tokens": 0, "preemptions": 0,
                   "drafted": 0, "accepted": 0}
        rec.update(arrival=req.arrival, finished_at=now, status=status,
                   reason=reason)
        self.finished[req.rid] = rec
        self.events.append((now, req.rid, status, reason))
        self.tracker.count(f"serve.terminal.{status}", t=now)

    def _drop_entry(self, entry: _QEntry, now: int, status: str,
                    reason: str) -> None:
        self.queue.remove(entry)
        self._record(entry.req, now, status, reason)

    # -- deadlines (one host-side sweep per tick) -----------------------
    def expire(self, now: int) -> int:
        """Fail every queued/active request past its TTFT or total
        deadline with terminal status ``timeout``. Called once per tick
        — pure host bookkeeping, no device syncs."""
        n = 0
        for e in list(self.queue):
            res = self._resume.get(e.req.rid)
            first_done = bool(res and res["first_done"])
            if e.ttft_at is not None and now > e.ttft_at and not first_done:
                self._drop_entry(e, now, TIMEOUT, "ttft")
                n += 1
            elif e.deadline_at is not None and now > e.deadline_at:
                self._drop_entry(e, now, TIMEOUT, "deadline")
                n += 1
        for slot in self.active:
            if (slot.ttft_at is not None and now > slot.ttft_at
                    and not slot.first_done):
                self._evict(slot, now, TIMEOUT, "ttft")
                n += 1
            elif slot.deadline_at is not None and now > slot.deadline_at:
                self._evict(slot, now, TIMEOUT, "deadline")
                n += 1
        return n

    # -- backpressure ----------------------------------------------------
    def enforce(self, now: int, occupancy: float) -> int:
        """Apply the bounded-queue + overload shedding policy; returns
        the number of requests shed this tick."""
        if self.queue_policy == "block":
            return 0
        n = 0
        if self.queue_limit:
            while True:
                vis = self._visible(now)
                if len(vis) <= self.queue_limit:
                    break
                victim = (max if self.queue_policy == "shed-newest"
                          else min)(
                    vis, key=lambda e: (e.req.arrival, e.seq)
                )
                self._drop_entry(victim, now, SHED, "queue-full")
                n += 1
        overloaded = (
            (self.shed_occupancy is not None
             and occupancy >= self.shed_occupancy)
            or (self.shed_stall_ticks > 0
                and self.stall_ticks >= self.shed_stall_ticks)
        )
        if overloaded:
            fresh = [e for e in self._visible(now)
                     if e.req.arrival == now]
            for _ in fresh:
                vis = self._visible(now)
                if not vis:
                    break
                victim = (
                    max(vis, key=lambda e: (e.req.arrival, e.seq))
                    if self.queue_policy == "shed-newest"
                    else min(vis, key=lambda e: (e.req.arrival, e.seq))
                )
                self._drop_entry(victim, now, SHED, "overload")
                n += 1
        return n

    # -- admission ------------------------------------------------------
    def admit(self, now: int,
              seq_of: Optional[Callable[[int], list]] = None
              ) -> list[Slot]:
        """Admit queued requests (priority order, strict FCFS within a
        priority) into free slots while blocks last, mapping shared
        prompt-prefix blocks copy-free. ``seq_of(rid)`` (required for
        preemption) returns a request's full token sequence so far so a
        preempted victim's computed blocks can be registered for
        copy-free recovery. Returns the slots to prefill."""
        out = []
        while True:
            entry = self.best_visible(now)
            if entry is None:
                self.stall_ticks = 0
                break
            slot = next(
                (s for s in self.slots if s.state == FREE), None
            )
            if slot is None:
                break
            req = entry.req
            res = self._resume.get(req.rid)
            eff = list(res["seq"]) if res is not None else list(req.prompt)
            generated = res["generated"] if res is not None else 0
            plen0 = len(req.prompt)
            budget = min(req.max_new, self.max_len - plen0)
            need = blocks_needed(
                len(eff), budget - generated, self.pool.block_size
            )
            total_need = need * 2 if self.spec else need
            if total_need > self.pool.capacity:
                # Structurally stuck: no amount of waiting or preemption
                # frees enough blocks. Fail fast with the diagnostic the
                # watchdog would otherwise produce by spinning.
                self._drop_entry(
                    entry, now, FAILED,
                    f"watchdog: request {req.rid} needs {total_need} KV "
                    f"blocks but the pool only holds "
                    f"{self.pool.capacity} — raise num_blocks or lower "
                    "max_new",
                )
                continue
            match = self.pool.match_prefix(eff)
            shared = list(match.blocks)
            # Acquire the shared blocks FIRST so the fresh allocation
            # below cannot evict their content out from under us; roll
            # back if the pool cannot cover the rest.
            self.pool.share(shared)
            # In-flight extension: walk full blocks PAST the indexed
            # match through the in-flight map — blocks a still-active
            # donor slot holds for the same content chain. Hits are
            # shared now but stay PENDING until the donor's prefill
            # actually writes them (engine promotion pass).
            pending = self._inflight_walk(eff, shared)
            self.pool.share([blk for blk, _, _, _ in pending])
            fresh = self.pool.alloc(need - len(shared) - len(pending))
            draft_fresh: Optional[list] = None
            if fresh is not None and self.spec:
                draft_fresh = self.pool.alloc(need)
            if fresh is None or (self.spec and draft_fresh is None):
                self.pool.free(shared)
                self.pool.free([blk for blk, _, _, _ in pending])
                if fresh is not None:
                    self.pool.free(fresh)
                victim = self._pick_victim(req) if self.preempt else None
                if victim is not None and seq_of is not None:
                    self.preempt_slot(victim, now, seq_of)
                    continue  # retry the same head against freed blocks
                self.stall_ticks += 1
                break
            self.stall_ticks = 0
            cow = None
            if (
                not pending  # pending region starts where cow would
                and match.cow_block is not None
                # The donor may have been evicted by our own alloc.
                and self.pool.is_indexed(match.cow_block)
            ):
                cow = (match.cow_block, fresh[0], match.cow_tokens)
            self.queue.remove(entry)
            slot.state = ACTIVE
            slot.request = req
            slot.blocks = (
                tuple(shared)
                + tuple(blk for blk, _, _, _ in pending)
                + tuple(fresh)
            )
            slot.length = match.tokens  # prefix-cached tokens
            slot.prefix_tokens = match.tokens + (cow[2] if cow else 0)
            slot.cow = cow
            slot.pending_shared = [
                (end, dslot, dseq) for _, end, dslot, dseq in pending
            ]
            if self.spec:
                slot.draft_blocks = tuple(draft_fresh)
                slot.draft_length = 0
                slot.drafted = res.get("drafted", 0) if res else 0
                slot.accepted = res.get("accepted", 0) if res else 0
            slot.generated = generated
            slot.budget = budget
            slot.admitted_at = (res["admitted_at"] if res is not None
                                else now)
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
            slot.decoding = False
            slot.first_token_at = (res["first_token_at"]
                                   if res is not None else 0)
            slot.first_done = bool(res and res["first_done"])
            slot.preemptions = res["preemptions"] if res is not None else 0
            slot.reg_blocks = 0
            slot.reg_parent = ""
            slot.priority = req.priority
            slot.eff_prompt = eff
            slot.ttft_at = entry.ttft_at
            slot.deadline_at = entry.deadline_at
            slot.sub_seq = entry.seq
            self._resume.pop(req.rid, None)
            self._inflight_register(slot)
            self.events.append((
                now, req.rid,
                "re-admitted" if res is not None else "admitted",
                f"prefix_tokens={slot.prefix_tokens}"
                + (f" inflight_blocks={len(pending)}" if pending else ""),
            ))
            self.tracker.count("serve.admissions", t=now)
            out.append(slot)
        return out

    # -- in-flight prefix map -------------------------------------------
    def _full_chains(self, eff: list):
        """Chain hashes of eff's full blocks, capped (like the pool's
        prefix index) so at least one token is left to prefill:
        [(chain, end_tokens)] for blocks wholly inside [0, len-1)."""
        bs = self.pool.block_size
        out = []
        parent = ""
        b = 0
        while (b + 1) * bs <= len(eff) - 1:
            parent = _chain(parent, eff[b * bs:(b + 1) * bs])
            out.append((parent, (b + 1) * bs))
            b += 1
        return out

    def _inflight_walk(self, eff: list, shared: list):
        """Extend a pool prefix match through the in-flight map:
        starting at the first full block the index did NOT cover, chase
        the content chain through blocks still-active slots hold.
        Returns [(block_id, end_tokens, donor_slot, donor_admit_seq)]
        for contiguous hits with a valid donor."""
        if not self.inflight_share:
            return []
        hits = []
        for chain, end in self._full_chains(eff)[len(shared):]:
            ent = self._inflight.get(chain)
            if ent is None:
                break
            dslot, blk, dend, dseq = ent
            if (
                dslot.state != ACTIVE
                or dslot.admit_seq != dseq
                or dend != end
                or blk not in dslot.blocks
            ):
                break
            hits.append((blk, end, dslot, dseq))
        return hits

    def _inflight_register(self, slot: Slot) -> None:
        """Publish the slot's full-block content chains so later
        admissions (same tick or while this slot is still prefilling)
        can share its blocks before the prefix index sees them."""
        if not self.inflight_share:
            return
        for bi, (chain, end) in enumerate(
            self._full_chains(slot.eff_prompt)
        ):
            if bi >= len(slot.blocks):
                break
            self._inflight[chain] = (
                slot, slot.blocks[bi], end, slot.admit_seq
            )
            slot.inflight_keys.append(chain)

    def _inflight_prune(self, slot: Slot) -> None:
        for chain in slot.inflight_keys:
            ent = self._inflight.get(chain)
            if (ent is not None and ent[0] is slot
                    and ent[3] == slot.admit_seq):
                del self._inflight[chain]
        slot.inflight_keys = []

    def _pick_victim(self, req: Request) -> Optional[Slot]:
        """Youngest active slot with STRICTLY lower priority than the
        incoming request (strictness prevents preemption livelock)."""
        cands = [s for s in self.active if s.priority < req.priority]
        return max(cands, key=lambda s: s.admit_seq) if cands else None

    # -- preempt-and-requeue --------------------------------------------
    def preempt_slot(self, slot: Slot, now: int,
                     seq_of: Callable[[int], list]) -> None:
        """Evict ``slot`` mid-flight and requeue its request. The
        computed FULL blocks (prompt + generated tokens) are registered
        in the prefix index before the free, so re-admission recovers
        them copy-free and re-prefills only the uncached tail."""
        req = slot.request
        seq = list(seq_of(req.rid))
        assert len(seq) >= slot.length, (
            f"seq_of({req.rid}) returned {len(seq)} tokens but the slot "
            f"holds {slot.length}"
        )
        slot.reg_blocks, slot.reg_parent = self.pool.register_prefix(
            seq, slot.blocks, slot.length,
            start_block=slot.reg_blocks, parent=slot.reg_parent,
        )
        self.pool.free(slot.blocks)
        if slot.draft_blocks:
            # Draft lanes are private and never prefix-indexed: their
            # content is simply recomputed (catch-up) on re-admission.
            self.pool.free(slot.draft_blocks)
        self._resume[req.rid] = {
            "seq": seq,
            "generated": slot.generated,
            "first_done": slot.first_done,
            "first_token_at": slot.first_token_at,
            "admitted_at": slot.admitted_at,
            "preemptions": slot.preemptions + 1,
            "drafted": slot.drafted,
            "accepted": slot.accepted,
        }
        self._enqueue(_QEntry(
            req=req, seq=slot.sub_seq,
            ttft_at=slot.ttft_at, deadline_at=slot.deadline_at,
        ))
        self.events.append((
            now, req.rid, "preempted-requeued",
            f"generated={slot.generated} cached={slot.length}",
        ))
        self.tracker.count("serve.preemptions", t=now)
        if self.on_evict is not None:
            self.on_evict(slot)
        self._clear(slot)

    def _evict(self, slot: Slot, now: int, status: str,
               reason: str) -> None:
        self.pool.free(slot.blocks)
        if slot.draft_blocks:
            self.pool.free(slot.draft_blocks)
        self._record(slot.request, now, status, reason, slot=slot)
        if self.on_evict is not None:
            self.on_evict(slot)
        self._clear(slot)

    # -- watchdog --------------------------------------------------------
    def fail_stuck(self, now: int, diagnostic: str) -> bool:
        """Fail the best visible queue entry with terminal status
        ``failed`` (stuck-tick watchdog: the engine detected zero
        progress for its threshold). Returns False if there was nothing
        to fail (the engine should raise — that is a scheduler bug)."""
        entry = self.best_visible(now)
        if entry is None:
            return False
        self._drop_entry(entry, now, FAILED, f"watchdog: {diagnostic}")
        return True

    # -- chunked prefill ------------------------------------------------
    def prefilling(self) -> list[Slot]:
        """ACTIVE slots whose (effective) prompt is not fully in the
        cache yet, in strict FCFS order (admission order) — the
        chunk-lane assignment order."""
        return sorted(
            (
                s for s in self.slots
                if s.state == ACTIVE and s.length < len(s.eff_prompt)
            ),
            key=lambda s: s.admit_seq,
        )

    # -- completion -----------------------------------------------------
    def finish(self, slot: Slot, now: int, reason: str) -> None:
        # One free per admission, shared and fresh blocks alike — the
        # refcounted pool keeps shared prefix blocks alive for their
        # other holders (and caches the content of fully released ones).
        self.pool.free(slot.blocks)
        if slot.draft_blocks:
            self.pool.free(slot.draft_blocks)
        self._record(slot.request, now, COMPLETED, reason, slot=slot)
        self._clear(slot)

    def _clear(self, slot: Slot) -> None:
        self._inflight_prune(slot)
        slot.state = FREE
        slot.request = None
        slot.blocks = ()
        slot.length = 0
        slot.generated = 0
        slot.budget = 0
        slot.decoding = False
        slot.prefix_tokens = 0
        slot.cow = None
        slot.reg_blocks = 0
        slot.reg_parent = ""
        slot.priority = 0
        slot.eff_prompt = []
        slot.first_done = False
        slot.preemptions = 0
        slot.ttft_at = None
        slot.deadline_at = None
        slot.sub_seq = 0
        slot.draft_blocks = ()
        slot.draft_length = 0
        slot.drafted = 0
        slot.accepted = 0
        slot.pending_shared = []

    # -- queries --------------------------------------------------------
    @property
    def active(self) -> list[Slot]:
        return [s for s in self.slots if s.state == ACTIVE]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(
            s.state == ACTIVE for s in self.slots
        )

    def next_arrival(self) -> Optional[int]:
        return (min(e.req.arrival for e in self.queue)
                if self.queue else None)
