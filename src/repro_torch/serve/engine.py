"""Serving engines (port of ``repro/serve/engine.py``): the static-batch
engine, ``ServeEngine(paged=False)`` (the default, as in the
reference), and the paged continuous-batching engine,
``ServeEngine(paged=True)``, in its two admission modes.

The static engine's ``generate`` packs up to ``max_batch`` prompts into
one batch, right-pads them with token 0, runs one ``zoo.prefill`` over
a dense cache of ``plen + max_new`` positions and then the decode loop,
sampling every row at the padded last position (as the reference does:
for an RWKV or mamba stack the pad tokens enter the recurrent state and
a mamba layer's conv window). It serves every decoder-only stack the
port runs: attention, jamba's mamba and attention hybrid, and rwkv6.
Neither
engine serves an encoder-decoder model (neither of the reference's
does): they refuse it at construction.

The paged engine serves attention-only stacks over a refcounted block
pool (``ServeConfig(paged=True)`` on a mamba or rwkv6 stack raises at
construction, naming the static engine):

* ``admission="chunked"`` (the default): every tick runs ONE fixed-shape
  ``zoo.paged_mixed_step``: one decode row per slot plus
  ``chunks_per_step`` prefill chunk lanes of ``chunk_size`` prompt
  tokens. Admission maps shared prompt-prefix blocks copy-free
  (copy-on-write for a partial tail block, done in place on the pools),
  same-tick followers share a donor's in-flight blocks, and each tick
  pays one host->device copy of its lane buffers and ONE device->host
  copy of the logits. ``ChunkedSession`` is one such session, advanced
  a tick at a time (the fleet's hook).
* ``admission="prefill_on_join"``: the pre-chunking baseline, one
  bucketed B = 1 ``zoo.paged_prefill`` per admission (stalling the
  decodes in flight) and one batched ``zoo.paged_decode_step`` a tick.
* **robustness** (chunked only): a bounded queue with shedding,
  deadlines, preempt-and-requeue, the stuck-tick watchdog, per-tick
  pool audits and seeded host-side fault injection (:class:`ChaosConfig`).
* **speculative decoding** (chunked only, ``draft != "none"``): a draft
  model (the dense parent sliced out of the MoE, or its top-1
  truncation: ``models/draft.py``) drafts ``spec_k`` tokens a decoding
  slot in its own paged lanes, and ``zoo.paged_verify_step`` replaces
  the mixed step (``serve/speculative.py``).

Where the reference counts jit compiles, the engine counts the distinct
input shapes each step function ran (``compile_count``).

Under a mesh (``ServeEngine(ctx=)``, a ``ShardCtx`` with process
groups; decoder-only stacks of attention, rwkv and mamba mixers)
every rank builds the same engine: its weights are placed once at
construction (``sharding.serve_layout``: joined over their FSDP dims,
cut to the rank's blocks over ``model``), the static engine's cache by
the act rules (rows over the data axes, ``cache_seq`` or ``kv_heads``
over ``model``, a mamba layer's ``d_in`` over ``model``) and the paged
pools with their KV heads over ``model``, the
paged rows replicated over the data axes. Every step returns whole
logits on every rank, so every rank runs the same scheduler, samples
the same tokens and keeps the same block tables.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.obs.tracker import NULL, Tracker
from repro_torch.serve.paged_cache import BlockPool, bucket_len
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.speculative import sample_token, verify_accept

__all__ = ["ChaosConfig", "ChunkedSession", "Request", "ServeConfig",
           "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded, deterministic fault injection for the chunked serve loop.

    Every probability is evaluated once per tick from a single
    ``np.random.default_rng(seed)`` stream, in the reference's order
    (evict, hold, burst, storm), so a (trace, ChaosConfig) pair replays
    the same fault schedule in both packages. All faults are host-side
    (scheduler and pool state); the device sees them only as different
    admission patterns.
    """

    seed: int = 0
    # Random eviction: preempt-and-requeue a random ACTIVE slot.
    evict_prob: float = 0.0
    # Pool exhaustion: grab random free blocks for hold_ticks ticks.
    hold_prob: float = 0.0
    hold_max_blocks: int = 4
    hold_ticks: int = 3
    # Admission burst: inject burst_size synthetic requests at once.
    burst_prob: float = 0.0
    burst_size: int = 2
    burst_plen: int = 12
    burst_max_new: int = 4
    burst_priority: int = 0
    rid_base: int = 1 << 30  # synthetic rids start here: keep real rids below
    # Deadline storm: clamp every queued request's TTFT deadline.
    storm_prob: float = 0.0
    storm_ttft: int = 2


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    temperature: float = 0.0  # 0 => greedy
    cache_dtype: str = "float32"  # float32 | bfloat16
    # False: the static-batch engine (``generate``); True: the paged
    # continuous-batching engine (``serve``).
    paged: bool = False
    block_size: int = 16
    # 0 => 1 trash block + max_batch * ceil(max_len / block_size), twice
    # that when speculating (the draft lanes).
    num_blocks: int = 0
    eos_id: Optional[int] = None
    # "chunked": one mixed step a tick; "prefill_on_join": one bucketed
    # B = 1 prefill per admission plus a batched decode step.
    admission: str = "chunked"
    chunk_size: int = 32
    chunks_per_step: int = 1
    prefix_cache: bool = True
    # --- robustness (chunked admission only; all off by default) -------
    # Bounded wait queue: max VISIBLE (arrived, unadmitted) requests,
    # 0 = unbounded. "block" waits; "shed-newest" / "shed-oldest" shed
    # to the bound and while overloaded.
    queue_limit: int = 0
    queue_policy: str = "block"
    # Overload signals for a shed-* policy: pool occupancy >=
    # shed_occupancy, or the best visible request block-starved for >=
    # shed_stall_ticks consecutive ticks.
    shed_occupancy: Optional[float] = None
    shed_stall_ticks: int = 0  # 0 = off
    # Preempt-and-requeue the youngest strictly-lower-priority active
    # request under pool exhaustion instead of waiting.
    preempt: bool = False
    # Default deadlines (ticks after arrival); exceeded -> "timeout".
    default_ttft_deadline: Optional[int] = None
    default_deadline: Optional[int] = None
    # Zero-progress ticks with a visible queue head before the watchdog
    # fails that head instead of spinning.
    watchdog_ticks: int = 32
    # --- speculative decoding (chunked admission only) -----------------
    # draft != "none": the draft ("dense": the expert-0 parent, "top1":
    # top-1 routing; or ServeEngine's draft_params/draft_cfg) drafts
    # spec_k tokens a decoding slot, the target verifies spec_k + 1
    # positions in one pass, exact rejection sampling keeps the output
    # distribution. Admission reserves a second same-size block set a
    # request for the draft lanes.
    spec_k: int = 4
    draft: str = "none"  # none | dense | top1
    # BlockPool.check_invariants at every tick boundary (always on with
    # chaos). O(capacity) a tick.
    audit_invariants: bool = False
    chaos: Optional[ChaosConfig] = None


class ServeEngine:
    """The static-batch engine (``sc.paged`` False) or the paged engine
    over ``params`` (a tensor tree on ``device``, which defaults to
    "cuda" and raises without a card). ``draft_params``/``draft_cfg``
    override the draft that ``sc.draft`` builds; ``tracker`` is the
    sessions' default tracker. ``ctx``: a ``ShardCtx`` with process
    groups to serve under the rules' placement (``params`` the global
    tree, or the rank's blocks under the param rules, on any device:
    ``ServeLayout.place`` moves each leaf's block to ``device`` one leaf
    at a time, so a rank never holds the whole model on the card);
    None, or a ctx without process groups, serves in one process."""

    def __init__(self, params, cfg: ArchConfig,
                 sc: Optional[ServeConfig] = None, *,
                 ac: zoo.ApplyCfg = zoo.ApplyCfg(), device=None,
                 draft_params=None, draft_cfg: Optional[ArchConfig] = None,
                 tracker: Optional[Tracker] = None, ctx=None):
        sc = ServeConfig() if sc is None else sc
        if cfg.structure == "encoder_decoder":
            # The reference's engines cannot serve one either: its static
            # generate never passes the encoder's input (a KeyError on
            # "enc_tokens"), its paged cache refuses the family.
            raise NotImplementedError(
                f"{cfg.name} is an encoder-decoder model: ServeEngine "
                "(static or paged) serves decoder-only models, as the "
                "reference's does; drive zoo.prefill and zoo.decode_step "
                "with the encoder's input instead")
        # The reference's validation, in its order and with its messages.
        if sc.paged and sc.admission not in ("chunked", "prefill_on_join"):
            raise ValueError(
                f"unknown admission mode {sc.admission!r} "
                "(chunked | prefill_on_join)"
            )
        if sc.paged and sc.admission == "chunked" and (
            sc.chunk_size < 1 or sc.chunks_per_step < 1
        ):
            raise ValueError(
                "chunked admission needs chunk_size >= 1 and "
                f"chunks_per_step >= 1; got {sc.chunk_size}, "
                f"{sc.chunks_per_step}"
            )
        if sc.paged and sc.admission != "chunked" and (
            sc.queue_limit or sc.queue_policy != "block"
            or sc.shed_occupancy is not None or sc.shed_stall_ticks
            or sc.preempt or sc.default_ttft_deadline is not None
            or sc.default_deadline is not None or sc.audit_invariants
            or sc.chaos is not None
        ):
            raise ValueError(
                "robustness features (backpressure / deadlines / "
                "preemption / chaos / audits) require "
                "admission='chunked'; prefill_on_join is the frozen "
                "pre-chunking baseline"
            )
        from repro_torch.models.draft import DRAFT_KINDS, make_draft

        if sc.draft not in DRAFT_KINDS:
            raise ValueError(
                f"unknown draft kind {sc.draft!r} (want {DRAFT_KINDS})"
            )
        self._spec = sc.paged and sc.draft != "none"
        if self._spec and sc.admission != "chunked":
            raise ValueError(
                "speculative decoding rides the chunked mixed step; "
                "set admission='chunked'"
            )
        if self._spec and sc.spec_k < 1:
            raise ValueError(
                f"speculative decoding needs spec_k >= 1; got {sc.spec_k}"
            )
        if sc.cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown cache_dtype {sc.cache_dtype!r}")
        self.device = resolve_device(device)
        mesh = ctx is not None and bool(ctx.groups)
        if not mesh and params["embed"]["tokens"].device.type \
                != self.device.type:
            raise ValueError(
                f"params live on {params['embed']['tokens'].device}, the "
                f"engine on {self.device}"
            )
        self.params, self.cfg, self.sc = params, cfg, sc
        if sc.paged and cfg.moe is not None and ac.dispatch == "gather":
            # The paged serving hot path: the live-token ragged dispatch
            # instead of the padded capacity buffer ("gather" is only
            # ApplyCfg's generic default; an explicit "einsum" stays as
            # asked). The static engine keeps "gather", as the
            # reference's does.
            ac = dataclasses.replace(ac, dispatch="sorted")
        self.ac = ac.resolve(self.device)
        self.cache_dtype = getattr(torch, sc.cache_dtype)
        self.tracker = tracker if tracker is not None else NULL
        if sc.paged:
            # Fail fast on stacks the paged engine cannot serve.
            zoo.init_paged_serve_cache(cfg, 2, sc.block_size,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        self.layout = self._draft_layout = self._pctx = self._dctx = None
        if mesh:
            from repro_torch.sharding import serve_layout

            self.layout = serve_layout(ctx, cfg, params)
            if self._spec:  # the draft is made from the global tree
                params = self.layout.join(params)
            if sc.paged:
                self._pctx = self._paged_layout(self.layout)[0].ctx
        if self._spec:
            if draft_params is None or draft_cfg is None:
                draft_params, draft_cfg = make_draft(params, cfg, sc.draft)
        if self.layout is not None:
            self.params = params = self.layout.place(params,
                                                     device=self.device)
            if self._spec:
                self._draft_layout = serve_layout(ctx, draft_cfg,
                                                  draft_params)
                draft_params = self._draft_layout.place(
                    draft_params, device=self.device)
                self._dctx = self._paged_layout(self._draft_layout)[0].ctx
        self._draft_params, self._draft_cfg = draft_params, draft_cfg
        self.last_stats: dict = {}
        # Distinct input shapes each step function ran over the engine's
        # life (the reference's jit cache sizes).
        self._signatures: set = set()  # mixed step
        self._verify_signatures: set = set()
        self._draft_signatures: set = set()  # draft decode + catch-up
        self._pp_signatures: set = set()  # prefill-on-join + its decode

    def _paged_layout(self, layout, num_blocks: int = 2):
        """``layout`` with the paged pools' placement (the pools of
        ``num_blocks`` blocks on the meta device)."""
        meta = zoo.init_paged_serve_cache(layout.cfg, num_blocks,
                                          self.sc.block_size,
                                          dtype=self.cache_dtype,
                                          device="meta")
        return layout.for_cache(meta, paged=True), meta

    def _paged_cache(self, cfg, num_blocks: int, layout=None):
        """KV block pools: the global pools, or this rank's block of
        them under ``layout``."""
        if layout is None:
            return zoo.init_paged_serve_cache(cfg, num_blocks,
                                              self.sc.block_size,
                                              dtype=self.cache_dtype,
                                              device=self.device)
        lay, meta = self._paged_layout(layout, num_blocks)
        return lay.alloc(meta, device=self.device)

    # -- the static-batch engine --------------------------------------------
    def generate(self, prompts: list[list[int]], max_new: int = 32, *,
                 seed: int = 0) -> list[list[int]]:
        """The static engine: generate ``max_new`` tokens for each prompt
        as one fixed batch (right-padded prompts, one prefill, then the
        decode loop over a dense cache; every row samples at the padded
        last position, as the reference's does); returns prompt +
        generated tokens per prompt. ``seed`` keys the temperature
        sampling (a ``torch.Generator``: it matches the reference's
        greedy outputs only). ``last_stats`` gets the host seconds of the
        prefill (to the first sampled tokens on the host) and of the
        decode steps. A paged engine serves through :meth:`serve`."""
        if self.sc.paged:
            raise ValueError("generate() is the static engine's; the paged "
                             "engine runs serve()")
        B = len(prompts)
        if not 1 <= B <= self.sc.max_batch:
            raise ValueError(f"the static engine serves 1..{self.sc.max_batch}"
                             f" prompts at once, got {B}")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p  # right padding with token 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        with torch.no_grad():
            cache, ctx, (lo, hi) = self.static_cache(B, plen + max_new)
            cache, logits = zoo.prefill(
                self.params, {"tokens": torch.from_numpy(toks[lo:hi]).to(
                    self.device)}, cache, self.cfg, ac=self.ac, ctx=ctx)
            cur = self._sample(logits, gen)
            cur_host = cur.cpu()
            t1 = time.perf_counter()
            out = [list(p) for p in prompts]
            for t in range(max_new):
                for i in range(B):
                    out[i].append(int(cur_host[i, 0]))
                if t == max_new - 1:
                    break
                cache, logits = zoo.decode_step(self.params, cur[lo:hi],
                                                cache, plen + t, self.cfg,
                                                ac=self.ac, ctx=ctx)
                cur = self._sample(logits, gen)
                cur_host = cur.cpu()
        self.last_stats = {
            "mode": "static", "batch": B, "prompt_len": plen,
            "decode_steps": max(max_new - 1, 0),
            "prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1,
        }
        return out

    def static_cache(self, batch: int, max_len: int):
        """The static engine's cache for ``batch`` rows of ``max_len``
        positions: (the cache, the ctx its steps run under, this rank's
        ``[lo, hi)`` of the rows). In one process the whole cache, None
        and every row; under a mesh the rank's block of each (the
        cache's placement, ``ServeLayout.for_cache``)."""
        kw = dict(dtype=self.cache_dtype)
        if self.layout is None:
            return (zoo.init_serve_cache(self.cfg, batch, max_len,
                                         device=self.device, **kw),
                    None, (0, batch))
        meta = zoo.init_serve_cache(self.cfg, batch, max_len, device="meta",
                                    **kw)
        lay = self.layout.for_cache(meta)
        i, n = lay.rows()
        return (lay.alloc(meta, device=self.device), lay.ctx,
                (i * batch // n, (i + 1) * batch // n))

    def _sample(self, logits, gen):
        """Next tokens (B, 1) from the last position's logits: argmax, or
        a draw at ``temperature`` from ``gen``."""
        lg = logits[:, -1]
        if self.sc.temperature <= 0.0:
            return torch.argmax(lg, dim=-1)[:, None]
        probs = torch.softmax(lg.float() / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    # -- device side ------------------------------------------------------
    def _h2d(self, arrs):
        """ONE host->device copy of int32 host arrays; returns device
        views of the same shapes."""
        flat = torch.from_numpy(
            np.concatenate([np.asarray(a).ravel() for a in arrs])
            .astype(np.int32)
        ).to(self.device)
        parts = torch.split(flat, [np.asarray(a).size for a in arrs])
        return [p.reshape(np.shape(a)) for p, a in zip(parts, arrs)]

    @staticmethod
    def _sig(tag, arrs):
        return (tag,) + tuple(np.shape(a) for a in arrs)

    def _mixed_step(self, cache, lanes: dict):
        """One mixed step from host lane buffers: one host->device copy,
        the fused step, ONE device->host copy of the logits."""
        names = ("cur", "ctoks", "dec_tables", "dec_lengths", "ctab",
                 "cstart", "clen")
        arrs = [lanes[n] for n in names]
        self._signatures.add(self._sig("mixed", arrs))
        t = dict(zip(names, self._h2d(arrs)))
        cache, logits = zoo.paged_mixed_step(
            self.params, t["cur"], t["ctoks"], cache, t["dec_tables"],
            t["dec_lengths"], t["ctab"], t["cstart"], t["clen"], self.cfg,
            ac=self.ac, ctx=self._pctx,
        )
        return cache, logits.cpu().numpy()

    def _verify_step(self, cache, lanes: dict):
        """The speculative session's only target step: verify lanes plus
        chunk lanes (``zoo.paged_verify_step``), one copy each way."""
        names = ("vtoks", "ctoks", "vtab", "vstart", "vlen", "ctab",
                 "cstart", "clen")
        arrs = [lanes[n] for n in names]
        self._verify_signatures.add(self._sig("verify", arrs))
        t = dict(zip(names, self._h2d(arrs)))
        cache, logits = zoo.paged_verify_step(
            self.params, t["vtoks"], t["ctoks"], cache, t["vtab"],
            t["vstart"], t["vlen"], t["ctab"], t["cstart"], t["clen"],
            self.cfg, ac=self.ac, ctx=self._pctx,
        )
        return cache, logits.cpu().numpy()

    def _draft_step(self, params, tokens, cache, tables, lengths):
        """One draft decode step over the slot batch (host lanes in,
        host logits (B, 1, V) out)."""
        arrs = (tokens, tables, lengths)
        self._draft_signatures.add(self._sig("draft", arrs))
        t = self._h2d(arrs)
        cache, logits = zoo.paged_decode_step(params, *t[:1], cache, *t[1:],
                                              self._draft_cfg, ac=self.ac,
                                              ctx=self._dctx)
        return cache, logits.cpu().numpy()

    def _draft_prefill(self, params, ctoks, cache, ctab, cstart, clen):
        """Draft catch-up: a mixed step with ZERO decode rows, just chunk
        lanes over the draft cache. The logits stay on the device."""
        arrs = (ctoks, ctab, cstart, clen)
        self._draft_signatures.add(self._sig("catch_up", arrs))
        ct, tab, st, ln = self._h2d(arrs)
        nb = tab.shape[1]
        z = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return zoo.paged_mixed_step(
            params, z.reshape(0, 1), ct, cache, z.reshape(0, nb), z, tab,
            st, ln, self._draft_cfg, ac=self.ac, ctx=self._dctx,
        )

    def _paged_prefill(self, cache, toks, table, length: int):
        """Prefill-on-join's B = 1 prefill; returns (cache, logits row
        (V,) on the host)."""
        self._pp_signatures.add(self._sig("prefill", (toks, table)))
        t, tab = self._h2d((toks, table))
        cache, logits = zoo.paged_prefill(self.params, t, cache, tab,
                                          length, self.cfg, ac=self.ac,
                                          ctx=self._pctx)
        return cache, logits[0, 0].cpu().numpy()

    def _paged_step(self, cache, cur, tables, lengths):
        """Prefill-on-join's batched decode step; host logits (B, V)."""
        arrs = (cur, tables, lengths)
        self._pp_signatures.add(self._sig("decode", arrs))
        t = self._h2d(arrs)
        cache, logits = zoo.paged_decode_step(self.params, *t[:1], cache,
                                              *t[1:], self.cfg, ac=self.ac,
                                              ctx=self._pctx)
        return cache, logits[:, 0].cpu().numpy()

    @staticmethod
    def _copy_block(cache, src: int, dst: int) -> None:
        """Copy one pool block across every layer, in place (the prefix
        cache's copy-on-write for a partial tail block). Pool leaves
        carry a leading layer-stack dim: (reps, P, bs, Kh, dh)."""
        for seg in cache["stack"]["segments"]:
            for pos in seg.values():
                for pool in pos["mixer"].values():
                    pool[:, dst] = pool[:, src]

    # -- sessions ---------------------------------------------------------
    def serve(self, requests: list[Request], *,
              on_token: Optional[Callable[[int, int], None]] = None,
              on_event: Optional[Callable[[int, str, str], None]] = None,
              seed: int = 0, tracker: Optional[Tracker] = None):
        """Run a continuous-batching session over ``requests``; returns
        ``(outputs, finished)``: ``outputs[rid]`` is prompt + generated
        tokens, ``finished[rid]`` the terminal record (every request gets
        exactly one). ``seed`` keys the temperature-sampling streams (the
        reference draws it from its rng; pass the same value to
        reproduce its samples). Lifecycle events stream through
        ``on_event`` in chunked mode."""
        if not self.sc.paged:
            raise ValueError("serve() needs ServeConfig(paged=True); the "
                             "static engine runs generate()")
        if self.sc.admission == "prefill_on_join":
            return self._serve_prefill_on_join(requests, on_token=on_token,
                                               seed=seed)
        sess = self.open_session(on_token=on_token, on_event=on_event,
                                 seed=seed, tracker=tracker)
        for r in requests:
            sess.submit(r)
        while sess.tick():
            pass
        return sess.close()

    def open_session(self, *, on_token=None, on_event=None, seed: int = 0,
                     fleet_mode: bool = False,
                     tracker: Optional[Tracker] = None) -> "ChunkedSession":
        """A tick-steppable chunked session. ``fleet_mode``: the clock
        advances exactly one tick a call and an empty queue keeps the
        session open for later routing (``serve/fleet.py``)."""
        if not (self.sc.paged and self.sc.admission == "chunked"):
            raise ValueError(
                "sessions need ServeConfig(paged=True, "
                "admission='chunked')"
            )
        return ChunkedSession(self, on_token=on_token, on_event=on_event,
                              seed=seed, fleet_mode=fleet_mode,
                              tracker=tracker)

    def _session(self):
        """Shared session set-up: pool, scheduler, KV cache."""
        sc = self.sc
        bs = sc.block_size
        nb = -(-sc.max_len // bs)
        # Speculation doubles the per-request footprint (the draft
        # lanes), so the full-capacity auto-sizing doubles too.
        lanes = 2 if self._spec else 1
        num_blocks = sc.num_blocks or (1 + lanes * sc.max_batch * nb)
        pool = BlockPool(
            num_blocks, bs,
            prefix_cache=sc.prefix_cache and sc.admission == "chunked",
        )
        if sc.admission == "chunked":
            sched = Scheduler(
                sc.max_batch, pool, sc.max_len,
                queue_limit=sc.queue_limit, queue_policy=sc.queue_policy,
                shed_occupancy=sc.shed_occupancy,
                shed_stall_ticks=sc.shed_stall_ticks, preempt=sc.preempt,
                default_ttft_deadline=sc.default_ttft_deadline,
                default_deadline=sc.default_deadline,
                # The watchdog (not a submit-time raise) owns the
                # oversized-request failure, so every request gets a
                # terminal status.
                reject_oversized=False, spec=self._spec,
                inflight_share=sc.prefix_cache,
            )
        else:
            sched = Scheduler(sc.max_batch, pool, sc.max_len)
        cache = self._paged_cache(self.cfg, num_blocks, self.layout)
        return pool, sched, cache, nb, num_blocks

    def _finisher(self, sched, clear_slot):
        """The finish policy of both paged loops (EOS / token budget):
        ``maybe_finish(slot, tok, step)``; ``clear_slot(i)`` zeroes the
        caller's host lane buffers for the freed slot."""
        sc = self.sc

        def maybe_finish(slot, tok, step):
            req = slot.request
            eos = req.eos_id if req.eos_id is not None else sc.eos_id
            if eos is not None and tok == eos:
                reason = "eos"
            elif slot.generated >= slot.budget:
                reason = "budget"
            else:
                return False
            clear_slot(slot.index)
            sched.finish(slot, step, reason)
            return True

        return maybe_finish

    def _sample_one(self, logits_row, seed0: int, rid: int, n: int) -> int:
        """Per-request sampling from a host logits row, keyed on (session
        seed, rid, token index): independent of slot placement, so
        staggered admission reproduces solo runs."""
        return sample_token(logits_row, self.sc.temperature, seed0, rid, n)

    # -- prefill-on-join (the pre-chunking baseline) ---------------------
    def _serve_prefill_on_join(self, requests, *, on_token, seed: int):
        sc = self.sc
        bs = sc.block_size
        pool, sched, cache, nb, _ = self._session()
        for r in requests:
            sched.submit(r)
        seed0 = int(seed)
        outs = {r.rid: list(r.prompt) for r in requests}

        def emit(req, slot, tok):
            outs[req.rid].append(tok)
            slot.generated += 1
            if on_token is not None:
                on_token(req.rid, tok)
            if req.on_token is not None:
                req.on_token(req.rid, tok)

        B = sc.max_batch
        tables = np.zeros((B, nb), np.int32)
        lengths = np.zeros((B,), np.int32)
        cur = np.zeros((B, 1), np.int32)
        stats = {
            "mode": "prefill_on_join",
            "mixed_steps": 0,
            "compile_events": [],
            "decode_stall_ticks": 0,
            "prefix_hit_tokens": 0,
            "prompt_tokens": 0,
            "chunk_rows_used": 0,
            "tick_wall": {},
        }
        self.last_stats = stats

        def clear_slot(i):
            tables[i, :] = 0
            lengths[i] = 0
            cur[i, 0] = 0

        maybe_finish = self._finisher(sched, clear_slot)
        step = 0
        while sched.has_work:
            stats["tick_wall"].setdefault(step, time.perf_counter())
            # -- admission: prefill-on-join into freshly allocated blocks
            for slot in sched.admit(step):
                i, req = slot.index, slot.request
                plen = len(req.prompt)
                sp = bucket_len(plen, bs)
                tables[i, :] = 0
                tables[i, :len(slot.blocks)] = slot.blocks
                toks = np.zeros((1, sp), np.int32)
                toks[0, :plen] = req.prompt
                # Each admission is an EXTRA device call that every
                # decoding slot sits out: the stall chunking removes.
                if any(s.decoding for s in sched.active if s is not slot):
                    stats["decode_stall_ticks"] += 1
                cache, lg = self._paged_prefill(cache, toks,
                                                tables[i:i + 1], plen)
                slot.length = plen
                lengths[i] = plen
                slot.first_token_at = step
                stats["prompt_tokens"] += plen
                tok = self._sample_one(lg, seed0, req.rid, 0)
                emit(req, slot, tok)
                if not maybe_finish(slot, tok, step):
                    slot.decoding = True
                    cur[i, 0] = tok

            active = sched.active
            if not active:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                step = max(step + 1, nxt)  # idle: fast-forward the clock
                continue
            # -- one batched decode step over the slot array (free slots
            # masked out of routing; their writes hit the trash block)
            cache, lg_host = self._paged_step(cache, cur, tables, lengths)
            step += 1
            stats["mixed_steps"] += 1
            for slot in active:
                i, req = slot.index, slot.request
                slot.length += 1  # cur token entered the cache
                lengths[i] += 1
                tok = self._sample_one(lg_host[i], seed0, req.rid,
                                       slot.generated)
                emit(req, slot, tok)
                if not maybe_finish(slot, tok, step):
                    cur[i, 0] = tok

        stats["compile_count"] = len(self._pp_signatures)
        stats["prefix_hit_frac"] = 0.0
        stats["free_blocks_at_close"] = pool.num_free
        if pool.num_free != pool.capacity:
            raise RuntimeError(
                f"leaked KV blocks: {pool.capacity - pool.num_free} of "
                f"{pool.capacity} still held at close"
            )
        return outs, sched.finished


class ChunkedSession:
    """One open chunked-serve session, advanced one tick at a time: the
    solo ``serve()`` is ``open_session`` + ``submit`` + ``while tick()``
    + ``close()``. The fleet's hooks: :meth:`submit` with ``resume`` (a
    migrated request continues at token index ``generated``,
    token-identical because sampling is keyed on (rid, generated)),
    :meth:`cancel`, :meth:`forget`, :meth:`extract_queue`,
    :meth:`signals`, :meth:`skip_tick` and :meth:`flush_events`.
    ``fleet_mode`` keeps the session open when its queue is empty and
    never fast-forwards the clock."""

    def __init__(self, engine: ServeEngine, *, on_token=None,
                 on_event=None, seed: int = 0, fleet_mode: bool = False,
                 tracker: Optional[Tracker] = None):
        self.eng = engine
        sc = self.sc = engine.sc
        self.fleet_mode = fleet_mode
        self.on_token, self.on_event = on_token, on_event
        self.seed0 = int(seed)
        self.bs = sc.block_size
        B, NC, C = self.B, self.NC, self.C = (
            sc.max_batch, sc.chunks_per_step, sc.chunk_size
        )
        (self.pool, self.sched, self.cache, self.nb,
         self.nblk) = engine._session()
        nb = self.nb
        self.outs: dict[int, list] = {}
        self.req_map: dict[int, Request] = {}
        self.slot_tables = np.zeros((B, nb), np.int32)
        self.lengths = np.zeros((B,), np.int32)
        self.lanes = {
            "cur": np.zeros((B, 1), np.int32),
            "dec_tables": np.zeros((B, nb), np.int32),
            "dec_lengths": np.zeros((B,), np.int32),
            "ctoks": np.zeros((NC, C), np.int32),
            "ctab": np.zeros((NC, nb), np.int32),
            "cstart": np.zeros((NC,), np.int32),
            "clen": np.zeros((NC,), np.int32),
        }
        self.cur = self.lanes["cur"]
        # -- speculative decoding: the draft runner and the verify lanes
        self.spec = engine._spec
        self.runner = None
        self.K1 = sc.spec_k + 1
        if self.spec:
            from repro_torch.serve.speculative import SpecRunner

            dcache = engine._paged_cache(engine._draft_cfg, self.nblk,
                                         engine._draft_layout)
            self.runner = SpecRunner(
                draft_step=engine._draft_step,
                draft_prefill=engine._draft_prefill,
                params=engine._draft_params, cache=dcache,
                spec_k=sc.spec_k, temperature=sc.temperature,
                seed0=self.seed0, max_batch=B, num_chunks=NC,
                chunk_size=C, nb=nb, signatures=engine._draft_signatures,
            )
            self.lanes.update(
                vtoks=np.zeros((B, self.K1), np.int32),
                vtab=np.zeros((B, nb), np.int32),
                vstart=np.zeros((B,), np.int32),
                vlen=np.zeros((B,), np.int32),
            )
        self.chaos = sc.chaos
        self.audit = sc.audit_invariants or self.chaos is not None
        self.last_logits: Optional[np.ndarray] = None
        self.stats: dict = {
            "mode": "chunked",
            "mixed_steps": 0,
            "compile_events": [],
            "decode_stall_ticks": 0,  # structurally 0: decode rows ride
            "prefix_hit_tokens": 0,   # every mixed step
            "prompt_tokens": 0,
            "chunk_rows_used": 0,
            "tick_wall": {},
            "events": [],  # (tick, rid, event, detail)
            "preemptions": 0,
            "watchdog_failures": 0,
            "status_counts": {},
            "peak_occupancy": 0.0,
            "stall_ticks_max": 0,
            "audits": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "inflight_promotions": 0,
        }
        if self.chaos is not None:
            self.stats["chaos"] = {"evictions": 0, "holds": 0,
                                   "held_blocks": 0, "bursts": 0,
                                   "burst_reqs": 0, "storms": 0}
        engine.last_stats = self.stats
        self._compiled = 0
        self._maybe_finish = engine._finisher(self.sched, self._clear_slot)
        # Forced evictions (preempt / timeout / cancel) clear the
        # victim's host lanes exactly like a normal finish.
        self.sched.on_evict = lambda slot: self._clear_slot(slot.index)
        self._ev_cursor = 0
        self._crng = (np.random.default_rng(self.chaos.seed)
                      if self.chaos is not None else None)
        self.holds: list[list] = []  # [release_tick, blocks]
        self.step = 0
        self._stuck = 0
        self._closed = False
        self._tokens_emitted = 0
        # Session tracker: explicit > engine default > NULL; solo
        # sessions stamp rows on their own step clock.
        trk = tracker if tracker is not None else engine.tracker
        if trk.enabled and trk.clock is None:
            trk = trk.bind(clock=lambda: self.step)
        self.trk = trk
        self.sched.tracker = trk

    # -- request plumbing --------------------------------------------------
    def submit(self, req: Request, resume: Optional[dict] = None) -> None:
        """Submit a request; ``resume`` (a preempt-and-requeue record with
        the whole sequence so far) makes this a fleet re-admission that
        re-prefills prompt + generated tokens and continues at index
        ``generated``. Deadlines stay anchored to the original
        arrival."""
        if resume is not None:
            self.sched.resubmit(req, resume)
            self.outs[req.rid] = list(resume["seq"])
        else:
            self.sched.submit(req)
            self.outs[req.rid] = list(req.prompt)
        self.req_map[req.rid] = req

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel this session's copy of ``rid`` (queued or active):
        blocks freed, engine-local terminal status ``cancelled``."""
        return self.sched.cancel(rid, self.step, reason)

    def forget(self, rid: int) -> None:
        """Drop a TERMINAL rid's record so the fleet may resubmit it."""
        self.sched.forget(rid)
        self.outs.pop(rid, None)
        self.req_map.pop(rid, None)

    def extract_queue(self):
        """Pull every queued (unadmitted) request, with any saved
        preemption progress, out of this session, without terminal
        records (migration)."""
        out = self.sched.extract_queue()
        for req, _ in out:
            self.outs.pop(req.rid, None)
            self.req_map.pop(req.rid, None)
        return out

    @property
    def active_requests(self) -> list:
        return [s.request for s in self.sched.active
                if s.request is not None]

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    def signals(self) -> dict:
        """Per-tick routing / health / autoscaling signals (host reads)."""
        pool, sched = self.pool, self.sched
        return {
            "occupancy": (pool.capacity - pool.num_free) / pool.capacity,
            "free_blocks": pool.num_free,
            "queue_depth": len(sched.queue),
            "active": len(sched.active),
            "decoding": sum(1 for s in sched.active if s.decoding),
            "stall_ticks": sched.stall_ticks,
            "step": self.step,
        }

    def skip_tick(self) -> None:
        """Advance the clock WITHOUT doing any work (the fleet's
        slow-engine chaos; deadlines keep ticking)."""
        self.step += 1

    def flush_events(self) -> int:
        """Deliver undelivered lifecycle events now (a fleet killing this
        engine flushes first, or it would migrate finished work)."""
        return self._dispatch_events()

    # -- internals ---------------------------------------------------------
    def _clear_slot(self, i: int) -> None:
        self.slot_tables[i, :] = 0
        self.lengths[i] = 0
        self.cur[i, 0] = 0
        if self.runner is not None:
            self.runner.clear_slot(i)

    def _seq_of(self, rid: int) -> list:
        # The whole sequence so far: what a preempted victim re-prefills.
        return self.outs[rid]

    def _emit(self, req, slot, tok: int) -> None:
        self.outs[req.rid].append(tok)
        slot.generated += 1
        self._tokens_emitted += 1
        if self.on_token is not None:
            self.on_token(req.rid, tok)
        if req.on_token is not None:
            req.on_token(req.rid, tok)

    def _dispatch_events(self) -> int:
        """Drain scheduler events into stats and callbacks; returns how
        many fired (the watchdog's progress signal)."""
        new = self.sched.events[self._ev_cursor:]
        self._ev_cursor = len(self.sched.events)
        for tick, rid, ev, detail in new:
            self.stats["events"].append((tick, rid, ev, detail))
            if ev == "preempted-requeued":
                self.stats["preemptions"] += 1
            elif ev == "failed":
                self.stats["watchdog_failures"] += 1
            if self.on_event is not None:
                self.on_event(rid, ev, detail)
            req = self.req_map.get(rid)
            if req is not None and req.on_event is not None:
                req.on_event(rid, ev, detail)
        return len(new)

    def _chaos_tick(self, step: int) -> None:
        """Inject this tick's faults: the draws and their order are the
        reference's, so one seed gives one schedule in both packages."""
        chaos, crng, pool, sched = (
            self.chaos, self._crng, self.pool, self.sched
        )
        cs = self.stats["chaos"]
        for h in self.holds[:]:
            if step >= h[0]:
                pool.free(h[1])
                self.holds.remove(h)
        if chaos.evict_prob and crng.random() < chaos.evict_prob:
            victims = sched.active
            if victims:
                v = victims[int(crng.integers(len(victims)))]
                sched.preempt_slot(v, step, self._seq_of)
                cs["evictions"] += 1
        if chaos.hold_prob and crng.random() < chaos.hold_prob:
            avail = pool.num_free
            if avail > 0:
                k = int(crng.integers(
                    1, min(chaos.hold_max_blocks, avail) + 1
                ))
                blks = pool.alloc(k)
                if blks is not None:
                    self.holds.append([step + chaos.hold_ticks, blks])
                    cs["holds"] += 1
                    cs["held_blocks"] += k
        if chaos.burst_prob and crng.random() < chaos.burst_prob:
            cs["bursts"] += 1
            for _ in range(chaos.burst_size):
                rid = chaos.rid_base + cs["burst_reqs"]
                cs["burst_reqs"] += 1
                prompt = [int(t) for t in
                          crng.integers(1, 97, size=chaos.burst_plen)]
                breq = Request(
                    rid=rid, prompt=prompt, max_new=chaos.burst_max_new,
                    arrival=step, priority=chaos.burst_priority,
                )
                self.outs[rid] = list(prompt)
                self.req_map[rid] = breq
                sched.submit(breq)
        if chaos.storm_prob and crng.random() < chaos.storm_prob:
            if sched.storm_deadlines(step, chaos.storm_ttft):
                cs["storms"] += 1

    def _tick_audit(self) -> None:
        if self.audit:
            sched = self.sched
            self.pool.check_invariants(
                [s.blocks for s in sched.active]
                + [s.draft_blocks for s in sched.active if s.draft_blocks]
                + [h[1] for h in self.holds]
            )
            self.stats["audits"] += 1

    # -- the tick ----------------------------------------------------------
    def tick(self) -> bool:
        """Run ONE serve tick (chaos -> deadlines -> backpressure ->
        admission -> in-flight prefix promotion -> chunk planning -> [the
        draft] -> one mixed or verify step -> bookkeeping -> audit).
        Returns whether the session still has work. With a tracker, the
        tick is a ``tick`` span and emits one ``engine`` row (host reads
        only)."""
        trk = self.trk
        if not trk.enabled:
            return self._tick_inner()
        with trk.span("tick"):
            alive = self._tick_inner()
        sig = self.signals()
        trk.row(
            "engine",
            occupancy=round(sig["occupancy"], 4),
            free_blocks=sig["free_blocks"],
            queue_depth=sig["queue_depth"],
            active=sig["active"],
            decoding=sig["decoding"],
            stall_ticks=sig["stall_ticks"],
            tokens=self._tokens_emitted,
            mixed_steps=self.stats["mixed_steps"],
            compiles=len(self.stats["compile_events"]),
        )
        return alive

    def _tick_inner(self) -> bool:
        eng, sc = self.eng, self.sc
        sched, pool, stats = self.sched, self.pool, self.stats
        bs, B, NC, C = self.bs, self.B, self.NC, self.C
        if not sched.has_work:
            # Terminal events of the last working tick's bookkeeping are
            # still undelivered: flush them here.
            self._dispatch_events()
            if self.fleet_mode:
                self.step += 1  # idle fleet tick: the clock stays global
            return False
        step = self.step
        stats["tick_wall"].setdefault(step, time.perf_counter())
        if self._crng is not None:
            self._chaos_tick(step)
        occ = (pool.capacity - pool.num_free) / pool.capacity
        stats["peak_occupancy"] = max(stats["peak_occupancy"], occ)
        with self.trk.span("admission"):
            sched.expire(step)
            sched.enforce(step, occ)
            # -- admission: slots + blocks, shared prefix mapped
            # copy-free; CoW partial tails copied on the device, in
            # place. May preempt lower-priority actives (preempt=True).
            for slot in sched.admit(step, seq_of=self._seq_of):
                i = slot.index
                self.slot_tables[i, :] = 0
                self.slot_tables[i, :len(slot.blocks)] = slot.blocks
                if slot.cow is not None:
                    src, dst, ntok = slot.cow
                    eng._copy_block(self.cache, src, dst)
                    slot.length += ntok
                    slot.cow = None
                self.lengths[i] = slot.length
                stats["prefix_hit_tokens"] += slot.prefix_tokens
                stats["prompt_tokens"] += len(slot.eff_prompt)
                if self.runner is not None:
                    self.runner.set_slot(slot)
        # -- in-flight prefix promotion: a follower's shared-but-pending
        # blocks become readable once the donor has computed past their
        # end; a dead or recycled donor preempts-and-requeues it.
        with self.trk.span("prefix"):
            for slot in list(sched.active):
                while slot.pending_shared:
                    end, donor, dseq = slot.pending_shared[0]
                    if donor.request is None or donor.admit_seq != dseq:
                        sched.preempt_slot(slot, step, self._seq_of)
                        break
                    if donor.length < end or slot.length + bs != end:
                        break
                    slot.pending_shared.pop(0)
                    slot.length = end
                    self.lengths[slot.index] = end
                    slot.prefix_tokens += bs
                    stats["prefix_hit_tokens"] += bs
                    stats["inflight_promotions"] += 1
        stats["stall_ticks_max"] = max(stats["stall_ticks_max"],
                                       sched.stall_ticks)
        progress = self._dispatch_events() > 0

        # -- chunk lanes: strict FCFS over prefilling slots; one slot may
        # take several lanes (later lanes attend earlier lanes' writes).
        # eff_prompt (prompt + recovered tokens after a preemption) is
        # what must be in the cache.
        chunks = []  # (slot, start, ntok)
        planned = {}
        for slot in sched.prefilling():
            if slot.pending_shared:
                continue  # waiting on a donor's in-flight writes
            plen = len(slot.eff_prompt)
            pos = planned.get(slot.index, slot.length)
            while len(chunks) < NC and pos < plen:
                n = min(C, plen - pos)
                chunks.append((slot, pos, n))
                pos += n
            planned[slot.index] = pos
            if len(chunks) >= NC:
                break

        decoding = [s for s in sched.active if s.decoding]
        if not decoding and not chunks:
            pend = [s for s in sched.active if s.pending_shared]
            if pend:
                # A wedged donor chain must not spin the watchdog.
                for s in pend:
                    sched.preempt_slot(s, step, self._seq_of)
                self._dispatch_events()
                self._tick_audit()
                self.step = step + 1
                return True
            nxt = sched.next_arrival()
            if nxt is None:
                if self.fleet_mode:
                    self.step = step + 1
                return False
            # -- stuck-tick watchdog: a visible head nothing will unblock
            # fails with a diagnostic instead of spinning the clock.
            if progress or nxt > step:
                self._stuck = 0
            else:
                self._stuck += 1
                if self._stuck >= max(1, sc.watchdog_ticks):
                    free_slots = sum(1 for s in sched.slots
                                     if s.request is None)
                    diag = (f"no progress for {self._stuck} ticks: "
                            f"free_blocks={pool.num_free}/{pool.capacity}, "
                            f"free_slots={free_slots}, "
                            f"queued={len(sched.queue)}, "
                            f"preempt={sc.preempt}")
                    if not sched.fail_stuck(step, diag):
                        raise RuntimeError(f"serve watchdog wedged: {diag}")
                    self._dispatch_events()
                    self._stuck = 0
            self._tick_audit()
            # idle: fast-forward the clock (solo only)
            self.step = step + 1 if self.fleet_mode else max(step + 1, nxt)
            return True
        self._stuck = 0

        # -- fixed-shape lanes. Non-decoding slots are masked out of the
        # decode (or verify) lane: zero table row, length 0.
        lanes = self.lanes
        for k in ("ctoks", "ctab", "cstart", "clen"):
            lanes[k][:] = 0
        for ci, (slot, start, n) in enumerate(chunks):
            lanes["ctoks"][ci, :n] = slot.eff_prompt[start:start + n]
            lanes["ctab"][ci] = self.slot_tables[slot.index]
            lanes["cstart"][ci] = start
            lanes["clen"][ci] = n
        if self.spec:
            # The draft first: catch behind draft caches up, then the
            # lockstep k-token draft loop; decode slots become
            # width-(1 + k_eff) verify lanes on the target.
            with self.trk.span("draft"):
                runner = self.runner
                runner.catch_up(sched.active, self._seq_of)
                dmap = runner.draft(decoding, self.cur)
                for k in ("vtoks", "vtab", "vstart", "vlen"):
                    lanes[k][:] = 0
                for s in decoding:
                    i = s.index
                    drafted = dmap[i][0] if i in dmap else []
                    lanes["vtoks"][i, 0] = self.cur[i, 0]
                    lanes["vtoks"][i, 1:1 + len(drafted)] = drafted
                    lanes["vtab"][i] = self.slot_tables[i]
                    lanes["vstart"][i] = self.lengths[i]
                    lanes["vlen"][i] = 1 + len(drafted)
            with self.trk.span("mixed_step"):
                self.cache, lg_host = eng._verify_step(self.cache, lanes)
            chunk_off = B * self.K1
            n_compiled = len(eng._verify_signatures)
        else:
            lanes["dec_tables"][:] = 0
            lanes["dec_lengths"][:] = 0
            for s in decoding:
                lanes["dec_tables"][s.index] = self.slot_tables[s.index]
                lanes["dec_lengths"][s.index] = self.lengths[s.index]
            with self.trk.span("mixed_step"):
                self.cache, lg_host = eng._mixed_step(self.cache, lanes)
            chunk_off = B
            n_compiled = len(eng._signatures)
        self.last_logits = lg_host
        step += 1
        self.step = step
        stats["mixed_steps"] += 1
        stats["chunk_rows_used"] += int(lanes["clen"].sum())
        if n_compiled != self._compiled:
            self._compiled = n_compiled
            stats["compile_events"].append(step)
            self.trk.count("serve.compile_events", t=step)

        with self.trk.span("emit"):
            # -- chunk bookkeeping first: lengths advance, prefix blocks
            # register, completed prompts sample their next token (the
            # first for fresh admissions; for re-admitted preemption
            # victims, the continuation at index generated).
            for ci, (slot, start, n) in enumerate(chunks):
                i, req = slot.index, slot.request
                slot.length = start + n
                self.lengths[i] = slot.length
                slot.reg_blocks, slot.reg_parent = pool.register_prefix(
                    slot.eff_prompt, slot.blocks, slot.length,
                    start_block=slot.reg_blocks, parent=slot.reg_parent,
                )
                if slot.length == len(slot.eff_prompt):
                    if not slot.first_done:
                        slot.first_token_at = step
                        slot.first_done = True
                    tok = eng._sample_one(lg_host[chunk_off + ci],
                                          self.seed0, req.rid,
                                          slot.generated)
                    self._emit(req, slot, tok)
                    if not self._maybe_finish(slot, tok, step):
                        slot.decoding = True
                        self.cur[i, 0] = tok
            # -- decode bookkeeping
            for slot in decoding:
                if slot.request is None:
                    continue  # evicted this tick (deadline / chaos)
                i, req = slot.index, slot.request
                if self.spec:
                    # Exact rejection sampling over this slot's verify
                    # rows: m accepted drafts + 1 correction or bonus.
                    # Rollback is overwrite-and-mask: the length stops
                    # after the last emitted token.
                    drafted, qrows = dmap.get(i, ([], []))
                    K1 = self.K1
                    p_rows = lg_host[i * K1:i * K1 + 1 + len(drafted)]
                    emitted, acc = verify_accept(
                        drafted, qrows, p_rows, sc.temperature,
                        self.seed0, req.rid, slot.generated,
                    )
                    stats["spec_drafted"] += len(drafted)
                    stats["spec_accepted"] += acc
                    slot.drafted += len(drafted)
                    slot.accepted += acc
                    fin = False
                    for tok in emitted:
                        slot.length += 1  # the verified token is cached
                        self.lengths[i] += 1
                        self._emit(req, slot, tok)
                        if self._maybe_finish(slot, tok, step):
                            fin = True
                            break
                    if not fin:
                        self.cur[i, 0] = emitted[-1]
                        if i in dmap:
                            # The draft wrote positions length ..
                            # length + k_eff in lockstep: the accepted
                            # region is valid.
                            slot.draft_length = slot.length
                    continue
                slot.length += 1  # the current token entered the cache
                self.lengths[i] += 1
                tok = eng._sample_one(lg_host[i], self.seed0, req.rid,
                                      slot.generated)
                self._emit(req, slot, tok)
                if not self._maybe_finish(slot, tok, step):
                    self.cur[i, 0] = tok
        self._tick_audit()
        return True

    def close(self):
        """Drain: release chaos holds, flush events, audit, and check that
        every submitted request reached exactly one terminal status and
        no KV block leaked. Returns ``(outputs, finished)`` like
        ``serve()``."""
        if self._closed:
            raise RuntimeError("session already closed")
        self._closed = True
        pool, sched, stats = self.pool, self.sched, self.stats
        for h in self.holds:
            pool.free(h[1])
        self.holds.clear()
        self._dispatch_events()
        if self.audit:
            pool.check_invariants([])
            stats["audits"] += 1
        counts: dict = {}
        for rec in sched.finished.values():
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        stats["status_counts"] = counts
        stats["compile_count"] = len(self.eng._verify_signatures
                                     if self.spec else self.eng._signatures)
        if self.spec:
            stats["spec"] = {"k": self.sc.spec_k, "draft": self.sc.draft,
                             **self.runner.stats}
            stats["acceptance_rate"] = (
                stats["spec_accepted"] / max(stats["spec_drafted"], 1)
            )
            stats["draft_compile_count"] = self.runner.compile_count()
        stats["prefix_hit_frac"] = (
            stats["prefix_hit_tokens"] / max(stats["prompt_tokens"], 1)
        )
        stats["free_blocks_at_close"] = pool.num_free
        if pool.num_free != pool.capacity:
            raise RuntimeError(
                f"leaked KV blocks: {pool.capacity - pool.num_free} of "
                f"{pool.capacity} still held at close"
            )
        missing = set(self.outs) - set(sched.finished)
        if missing:
            raise RuntimeError(
                f"requests without a terminal status: {sorted(missing)}"
            )
        self.trk.summarize()
        return self.outs, sched.finished
