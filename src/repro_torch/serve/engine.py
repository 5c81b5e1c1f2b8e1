"""Serving engines (port of ``repro/serve/engine.py``): the static-batch
engine, ``ServeEngine(paged=False)`` (the default, as in the
reference), and the paged continuous-batching engine with chunked-prefill
mixed steps, ``ServeEngine(paged=True, admission="chunked")`` and
``ChunkedSession``.

The static engine's ``generate`` packs up to ``max_batch`` prompts into
one batch, right-pads them with token 0, runs one ``zoo.prefill`` over
a dense cache of ``plen + max_new`` positions and then the decode loop,
sampling every row at the padded last position (as the reference does:
for an RWKV stack the pad tokens enter the recurrent state). It serves
every decoder-only stack the port runs, attention and rwkv6. Neither
engine serves an encoder-decoder model (neither of the reference's
does): they refuse it at construction.

In the paged engine every tick runs ONE fixed-shape
``zoo.paged_mixed_step``: one decode row per slot plus
``chunks_per_step`` prefill chunk lanes of ``chunk_size`` prompt tokens.
Admission maps shared prompt-prefix blocks copy-free (copy-on-write for
a partial tail block, done in place on the pools), same-tick followers
share a donor's in-flight blocks, and each tick pays one host->device
copy of its lane buffers and ONE device->host copy of the logits. It
serves attention-only stacks.

Not ported yet (they raise, see ROADMAP.md): ``admission=
"prefill_on_join"``, speculative decoding (``draft != "none"``), chaos
injection and the fleet hooks.
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
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.speculative import sample_token

__all__ = ["ChunkedSession", "Request", "ServeConfig", "ServeEngine"]

# Zero-progress ticks with a visible queue head before the watchdog
# fails that head instead of spinning (the reference's default).
WATCHDOG_TICKS = 32


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
    # 0 => 1 trash block + max_batch * ceil(max_len / block_size).
    num_blocks: int = 0
    eos_id: Optional[int] = None
    admission: str = "chunked"
    chunk_size: int = 32
    chunks_per_step: int = 1
    prefix_cache: bool = True
    # Accepted only at their off values until ported (ROADMAP.md).
    draft: str = "none"
    chaos: Optional[object] = None


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (see ROADMAP.md, queue 1)"
    )


class ServeEngine:
    """The static-batch engine (``sc.paged`` False) or the paged chunked
    engine over ``params`` (a tensor tree on ``device``, which defaults
    to "cuda" and raises without a card)."""

    def __init__(self, params, cfg: ArchConfig,
                 sc: Optional[ServeConfig] = None, *,
                 ac: zoo.ApplyCfg = zoo.ApplyCfg(), device=None):
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
        if sc.paged:
            if sc.admission != "chunked":
                raise _unported(f"admission={sc.admission!r}")
            if sc.draft != "none":
                raise _unported("speculative decoding (draft != 'none')")
            if sc.chaos is not None:
                raise _unported("chaos injection")
            if sc.chunk_size < 1 or sc.chunks_per_step < 1:
                raise ValueError(
                    "chunked admission needs chunk_size >= 1 and "
                    f"chunks_per_step >= 1; got {sc.chunk_size}, "
                    f"{sc.chunks_per_step}"
                )
        if sc.cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown cache_dtype {sc.cache_dtype!r}")
        self.device = resolve_device(device)
        if params["embed"]["tokens"].device.type != self.device.type:
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
        if sc.paged:
            # Fail fast on stacks the paged engine cannot serve.
            zoo.init_paged_serve_cache(cfg, 2, sc.block_size,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        self.last_stats: dict = {}
        self._signatures: set = set()

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
            cache = zoo.init_serve_cache(self.cfg, B, plen + max_new,
                                         dtype=self.cache_dtype,
                                         device=self.device)
            cache, logits = zoo.prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(
                    self.device)}, cache, self.cfg, ac=self.ac)
            cur = self._sample(logits, gen)
            cur_host = cur.cpu()
            t1 = time.perf_counter()
            out = [list(p) for p in prompts]
            for t in range(max_new):
                for i in range(B):
                    out[i].append(int(cur_host[i, 0]))
                if t == max_new - 1:
                    break
                cache, logits = zoo.decode_step(self.params, cur, cache,
                                                plen + t, self.cfg,
                                                ac=self.ac)
                cur = self._sample(logits, gen)
                cur_host = cur.cpu()
        self.last_stats = {
            "mode": "static", "batch": B, "prompt_len": plen,
            "decode_steps": max(max_new - 1, 0),
            "prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1,
        }
        return out

    def _sample(self, logits, gen):
        """Next tokens (B, 1) from the last position's logits: argmax, or
        a draw at ``temperature`` from ``gen``."""
        lg = logits[:, -1]
        if self.sc.temperature <= 0.0:
            return torch.argmax(lg, dim=-1)[:, None]
        probs = torch.softmax(lg.float() / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    # -- device side ------------------------------------------------------
    def _mixed_step(self, cache, lanes: dict):
        """One mixed step from host lane buffers: ONE host->device copy
        of all int32 lanes, the fused step, ONE device->host copy of the
        logits. Records the input signature (compile_count)."""
        names = ("cur", "ctoks", "dec_tables", "dec_lengths", "ctab",
                 "cstart", "clen")
        arrs = [lanes[n] for n in names]
        self._signatures.add(tuple((a.shape, a.dtype.str) for a in arrs))
        flat = torch.from_numpy(
            np.concatenate([a.ravel() for a in arrs]).astype(np.int32)
        ).to(self.device)
        parts = torch.split(flat, [a.size for a in arrs])
        t = {n: p.reshape(a.shape) for n, p, a in zip(names, parts, arrs)}
        cache, logits = zoo.paged_mixed_step(
            self.params, t["cur"], t["ctoks"], cache, t["dec_tables"],
            t["dec_lengths"], t["ctab"], t["cstart"], t["clen"], self.cfg,
            ac=self.ac,
        )
        return cache, logits.cpu().numpy()

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
              seed: int = 0):
        """Run a continuous-batching session over ``requests``; returns
        ``(outputs, finished)``: ``outputs[rid]`` is prompt + generated
        tokens, ``finished[rid]`` the terminal record. ``seed`` keys the
        temperature-sampling streams (the reference draws it from its
        rng; pass the same value to reproduce its samples)."""
        sess = self.open_session(on_token=on_token, on_event=on_event,
                                 seed=seed)
        for r in requests:
            sess.submit(r)
        while sess.tick():
            pass
        return sess.close()

    def open_session(self, *, on_token=None, on_event=None,
                     seed: int = 0) -> "ChunkedSession":
        if not self.sc.paged:
            raise ValueError("serve() needs ServeConfig(paged=True); the "
                             "static engine runs generate()")
        return ChunkedSession(self, on_token=on_token, on_event=on_event,
                              seed=seed)


class ChunkedSession:
    """One open chunked-serve session, advanced one tick at a time: the
    solo ``serve()`` is ``open_session`` + ``submit`` + ``while tick()``
    + ``close()``."""

    def __init__(self, engine: ServeEngine, *, on_token=None,
                 on_event=None, seed: int = 0):
        self.eng = engine
        sc = self.sc = engine.sc
        self.on_token, self.on_event = on_token, on_event
        self.seed0 = int(seed)
        bs = self.bs = sc.block_size
        B, NC, C = self.B, self.NC, self.C = (
            sc.max_batch, sc.chunks_per_step, sc.chunk_size
        )
        nb = self.nb = -(-sc.max_len // bs)
        num_blocks = sc.num_blocks or (1 + B * nb)
        self.pool = BlockPool(num_blocks, bs, prefix_cache=sc.prefix_cache)
        self.sched = Scheduler(
            B, self.pool, sc.max_len,
            # The watchdog (not a submit-time raise) owns the oversized-
            # request failure, so every request gets a terminal status.
            reject_oversized=False, inflight_share=sc.prefix_cache,
        )
        self.cache = zoo.init_paged_serve_cache(
            engine.cfg, num_blocks, bs, dtype=engine.cache_dtype,
            device=engine.device,
        )
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
        self.last_logits: Optional[np.ndarray] = None
        self.stats: dict = {
            "mode": "chunked",
            "mixed_steps": 0,
            "prefix_hit_tokens": 0,
            "prompt_tokens": 0,
            "chunk_rows_used": 0,
            "events": [],
            "preemptions": 0,
            "watchdog_failures": 0,
            "status_counts": {},
            "inflight_promotions": 0,
        }
        engine.last_stats = self.stats
        engine._signatures = set()
        self._maybe_finish = self._finisher()
        self.sched.on_evict = lambda slot: self._clear_slot(slot.index)
        self._ev_cursor = 0
        self.step = 0
        self._stuck = 0
        self._closed = False

    # -- request plumbing --------------------------------------------------
    def submit(self, req: Request) -> None:
        self.sched.submit(req)
        self.outs[req.rid] = list(req.prompt)
        self.req_map[req.rid] = req

    # -- internals ---------------------------------------------------------
    def _clear_slot(self, i: int) -> None:
        self.slot_tables[i, :] = 0
        self.lengths[i] = 0
        self.lanes["cur"][i, 0] = 0

    def _seq_of(self, rid: int) -> list:
        return self.outs[rid]

    def _finisher(self):
        sc, sched = self.sc, self.sched

        def maybe_finish(slot, tok, step):
            req = slot.request
            eos = req.eos_id if req.eos_id is not None else sc.eos_id
            if eos is not None and tok == eos:
                reason = "eos"
            elif slot.generated >= slot.budget:
                reason = "budget"
            else:
                return False
            self._clear_slot(slot.index)
            sched.finish(slot, step, reason)
            return True

        return maybe_finish

    def _emit(self, req, slot, tok: int) -> None:
        self.outs[req.rid].append(tok)
        slot.generated += 1
        if self.on_token is not None:
            self.on_token(req.rid, tok)
        if req.on_token is not None:
            req.on_token(req.rid, tok)

    def _sample(self, row, rid: int, n: int) -> int:
        return sample_token(row, self.sc.temperature, self.seed0, rid, n)

    def _dispatch_events(self) -> int:
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

    # -- the tick ----------------------------------------------------------
    def tick(self) -> bool:
        """Run ONE serve tick (admission -> in-flight prefix promotion ->
        chunk planning -> one mixed step -> bookkeeping). Returns whether
        the session still has work."""
        eng, sched, pool, stats = self.eng, self.sched, self.pool, self.stats
        bs, NC, C = self.bs, self.NC, self.C
        if not sched.has_work:
            self._dispatch_events()
            return False
        step = self.step
        # -- admission: slots + blocks, shared prefix mapped copy-free;
        # CoW partial tails copied on the device, in place.
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
        # -- in-flight prefix promotion: a follower's shared-but-pending
        # blocks become readable once the donor has computed past their
        # end; a dead or recycled donor preempts-and-requeues it.
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
        progress = self._dispatch_events() > 0

        # -- chunk lanes: strict FCFS over prefilling slots; one slot may
        # take several lanes (later lanes attend earlier lanes' writes).
        chunks = []  # (slot, start, ntok)
        for slot in sched.prefilling():
            if slot.pending_shared:
                continue  # waiting on a donor's in-flight writes
            plen = len(slot.eff_prompt)
            pos = slot.length
            while len(chunks) < NC and pos < plen:
                n = min(C, plen - pos)
                chunks.append((slot, pos, n))
                pos += n
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
                self.step = step + 1
                return True
            nxt = sched.next_arrival()
            if nxt is None:
                return False
            if progress or nxt > step:
                self._stuck = 0
            else:
                self._stuck += 1
                if self._stuck >= WATCHDOG_TICKS:
                    free_slots = sum(1 for s in sched.slots
                                     if s.request is None)
                    diag = (f"no progress for {self._stuck} ticks: "
                            f"free_blocks={pool.num_free}/{pool.capacity}, "
                            f"free_slots={free_slots}, "
                            f"queued={len(sched.queue)}")
                    if not sched.fail_stuck(step, diag):
                        raise RuntimeError(f"serve watchdog wedged: {diag}")
                    self._dispatch_events()
                    self._stuck = 0
            self.step = max(step + 1, nxt)  # idle: fast-forward the clock
            return True
        self._stuck = 0

        # -- fixed-shape lanes. Non-decoding slots are masked out of the
        # decode lane (zero table row, length 0 -> trash-block write).
        lanes = self.lanes
        for k in ("ctoks", "ctab", "cstart", "clen", "dec_tables",
                  "dec_lengths"):
            lanes[k][:] = 0
        for ci, (slot, start, n) in enumerate(chunks):
            lanes["ctoks"][ci, :n] = slot.eff_prompt[start:start + n]
            lanes["ctab"][ci] = self.slot_tables[slot.index]
            lanes["cstart"][ci] = start
            lanes["clen"][ci] = n
        for s in decoding:
            lanes["dec_tables"][s.index] = self.slot_tables[s.index]
            lanes["dec_lengths"][s.index] = self.lengths[s.index]
        self.cache, lg_host = eng._mixed_step(self.cache, lanes)
        self.last_logits = lg_host
        step += 1
        self.step = step
        stats["mixed_steps"] += 1
        stats["chunk_rows_used"] += int(lanes["clen"].sum())

        # -- chunk bookkeeping first: lengths advance, prefix blocks
        # register, completed prompts sample their first token.
        B = self.B
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
                tok = self._sample(lg_host[B + ci], req.rid, slot.generated)
                self._emit(req, slot, tok)
                if not self._maybe_finish(slot, tok, step):
                    slot.decoding = True
                    lanes["cur"][i, 0] = tok
        # -- decode bookkeeping
        for slot in decoding:
            if slot.request is None:
                continue
            i, req = slot.index, slot.request
            slot.length += 1  # the current token entered the cache
            self.lengths[i] += 1
            tok = self._sample(lg_host[i], req.rid, slot.generated)
            self._emit(req, slot, tok)
            if not self._maybe_finish(slot, tok, step):
                lanes["cur"][i, 0] = tok
        return True

    def close(self):
        """Drain: flush events and check that every submitted request
        reached exactly one terminal status and no KV block leaked.
        Returns ``(outputs, finished)`` like ``serve()``."""
        if self._closed:
            raise RuntimeError("session already closed")
        self._closed = True
        pool, sched, stats = self.pool, self.sched, self.stats
        self._dispatch_events()
        counts: dict = {}
        for rec in sched.finished.values():
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        stats["status_counts"] = counts
        # One fixed-shape mixed step per session: the count of distinct
        # input signatures it saw (the reference counts jit compiles).
        stats["compile_count"] = len(self.eng._signatures)
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
        return self.outs, sched.finished
