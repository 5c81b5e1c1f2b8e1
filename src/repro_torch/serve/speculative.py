"""Speculative decoding on the paged engine: draft k, verify k+1 in one
mixed-step pass (port of ``repro/serve/speculative.py``).

Upcycling gives the serving stack a free, unusually well-matched draft
model — the dense parent checkpoint the MoE was initialized from (or a
top-1 truncation of the MoE itself; models/draft.py builds both from
the checkpoint the engine already holds). Per tick:

1. **draft** — the draft model autoregressively drafts up to
   ``spec_k`` tokens per decoding slot against its OWN paged KV lanes
   (``slot.draft_blocks``, allocated from the same :class:`BlockPool`
   but written only by the draft model's cache, updated in place). The
   loop runs ``max(k_eff) + 1`` fixed-shape decode steps: step 0 writes the
   slot's pending token and samples draft 1, step j writes draft j and
   samples draft j+1, and the FINAL step writes the last draft without
   sampling — so the draft cache covers every position the target may
   accept and stays in lockstep with the target for ANY acceptance
   count (rejection rollback is overwrite-and-mask: stale positions
   past the rewound length are never attended and are overwritten by
   later steps).
2. **verify** — the full MoE scores all ``k+1`` positions (pending
   token + k drafts) in ONE multi-token pass reusing the mixed step's
   chunk-lane machinery: verify rows ARE chunk lanes
   (``zoo.paged_verify_step`` -> ``MixedMeta(num_verify=...)`` ->
   ``ops.prefill_attention``), their k/v scatter through the shared
   ``paged_row_write`` path, and rejected-token rows land in the trash
   block / the slot's own private decode-region blocks, so no pool
   state leaks. Prefill chunk lanes ride the same call — in spec mode
   the engine's ONLY target-model step function is the verify step.
3. **accept** — exact rejection sampling (:func:`verify_accept`) keeps
   the output distribution identical to vanilla decoding: greedy
   speculative == greedy vanilla token-for-token, and at temperature
   the drafted token for output index n is sampled from the SAME
   ``(seed0, rid, n)`` Gumbel stream as the vanilla engine, so a draft
   that equals the target (q == p) accepts every token and reproduces
   the vanilla sequence exactly (the rejection-sampling identity the
   parity tests pin).

Sampling streams (all host-side numpy, independent of batch
composition and slot placement, like the engine's ``_sample_one``):

====================  =============================  ====================
draw                  rng seed                       law
====================  =============================  ====================
draft token n         ``(seed0, rid, n)``            Gumbel-max over q
accept test           ``(seed0, rid, n, 2)``         U[0,1) < min(1,p/q)
residual on reject    ``(seed0, rid, n, 1)``         Gumbel-max over
                                                     norm(max(p-q,0))
bonus on full accept  ``(seed0, rid, n)``            Gumbel-max over p
====================  =============================  ====================

The bonus draw reuses the vanilla stream on purpose: a full accept ends
with exactly the draw vanilla decoding would have made at that index.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = [
    "SpecRunner",
    "draft_probs",
    "draft_sample",
    "sample_token",
    "verify_accept",
]


def sample_token(logits_row: np.ndarray, temperature: float,
                 seed0: int, rid: int, n: int) -> int:
    """The canonical per-request host-side sample: greedy argmax, or
    Gumbel-max temperature sampling (== categorical in law) seeded on
    (session seed, rid, output index). ``ServeEngine._sample_one``
    delegates here so vanilla and speculative paths share one
    definition."""
    if temperature <= 0.0:
        return int(logits_row.argmax())
    g = np.random.default_rng((seed0, rid, n)).gumbel(
        size=logits_row.shape
    )
    return int((logits_row / temperature + g).argmax())


def draft_probs(logits_row: np.ndarray,
                temperature: float) -> np.ndarray:
    """Softmax of a logits row at ``temperature`` (float64 on host — the
    rejection test divides these, so keep the full precision)."""
    z = logits_row.astype(np.float64) / temperature
    z = z - z.max()
    e = np.exp(z)
    return e / e.sum()


def draft_sample(logits_row: np.ndarray, temperature: float,
                 seed0: int, rid: int, n: int):
    """Sample the draft's candidate for output index ``n``.

    Returns ``(token, q_probs)``; ``q_probs`` is None for greedy (the
    accept test degenerates to argmax equality). Uses the SAME
    ``(seed0, rid, n)`` stream as :func:`sample_token`, which is what
    makes the q == p identity reproduce vanilla token-for-token."""
    tok = sample_token(logits_row, temperature, seed0, rid, n)
    if temperature <= 0.0:
        return tok, None
    return tok, draft_probs(logits_row, temperature)


def verify_accept(
    drafted: list,
    q_rows: list,
    p_rows: np.ndarray,
    temperature: float,
    seed0: int,
    rid: int,
    n0: int,
):
    """Exact (Leviathan-style) rejection sampling over one slot's
    verify-lane logits.

    drafted: the k_eff draft tokens, candidates for output indices
    ``n0 .. n0 + k_eff - 1``; q_rows: their draft distributions (None
    entries when greedy); p_rows: ``(>= k_eff + 1, V)`` target LOGITS —
    row j is the target's distribution for the token FOLLOWING verify
    position j (row 0 follows the pending token).

    Returns ``(emitted, accepted)``: ``emitted`` holds the accepted
    drafts plus exactly one trailing correction (on reject: a sample
    from ``norm(max(p - q, 0))``) or bonus token (on full accept: the
    vanilla draw from row k_eff); ``accepted`` counts accepted drafts.
    Greedy accepts a draft iff it IS the target argmax, which makes the
    emitted chain bitwise-equal to vanilla greedy decoding regardless
    of draft quality. k_eff == 0 degenerates to one vanilla draw."""
    emitted: list[int] = []
    for j, d in enumerate(drafted):
        n = n0 + j
        if temperature <= 0.0:
            t = int(p_rows[j].argmax())
            if t == d:
                emitted.append(d)
                continue
            emitted.append(t)  # greedy "residual" IS the argmax
            return emitted, j
        p = draft_probs(p_rows[j], temperature)
        q = q_rows[j]
        u = float(np.random.default_rng((seed0, rid, n, 2)).random())
        if u < min(1.0, p[d] / max(q[d], 1e-300)):
            emitted.append(d)
            continue
        res = np.maximum(p - q, 0.0)
        s = res.sum()
        if s <= 0.0:  # q == p numerically; any residual draw is exact
            res, s = p, p.sum()
        g = np.random.default_rng((seed0, rid, n, 1)).gumbel(
            size=res.shape
        )
        with np.errstate(divide="ignore"):
            emitted.append(int((np.log(res / s) + g).argmax()))
        return emitted, j
    k = len(drafted)
    emitted.append(
        sample_token(p_rows[k], temperature, seed0, rid, n0 + k)
    )
    return emitted, k


class SpecRunner:
    """Per-session runner of the draft model's paged lanes.

    Owns the draft KV cache (on the device, updated in place by the
    step functions), the host mirror of each slot's draft block table,
    and the per-tick draft workflow:

    * :meth:`catch_up` — one fixed-shape chunk-lane pass over the draft
      cache bringing behind slots toward the target's cached coverage
      (``slot.draft_length -> slot.length``). Fresh admissions (the
      draft cache has no prefix cache: its blocks are private and never
      content-indexed), prefix-cache hits and post-rejection holes are
      all just "draft_length < length".
    * :meth:`draft` — the lockstep k+1-step draft loop described in the
      module docstring; only slots with ``draft_length == length`` (and
      budget headroom) take part, the others ride a width-1 verify lane
      this tick (= vanilla decoding).

    ``draft_step(params, tokens, cache, tables, lengths)`` and
    ``draft_prefill(params, ctoks, cache, ctab, cstart, clen)`` take
    host (numpy) lane buffers and return ``(cache, logits)``, the
    logits as a host array; ``signatures`` is the set of distinct step
    shapes they ran (the engine's, shared by its sessions). The engine
    owns acceptance (``verify_accept``), emission and all scheduler
    state; the runner never touches the target cache.
    """

    def __init__(
        self,
        *,
        draft_step: Callable,
        draft_prefill: Callable,
        params,
        cache,
        spec_k: int,
        temperature: float,
        seed0: int,
        max_batch: int,
        num_chunks: int,
        chunk_size: int,
        nb: int,
        signatures: Optional[set] = None,
    ):
        self._step = draft_step
        self._prefill = draft_prefill
        self.params = params
        self.cache = cache
        self.spec_k = spec_k
        self.temperature = temperature
        self.seed0 = seed0
        self.B, self.NC, self.C, self.nb = (
            max_batch, num_chunks, chunk_size, nb
        )
        self.signatures = set() if signatures is None else signatures
        # Host mirror of slot.draft_blocks (written at admission, zeroed
        # at clear): the draft-lane analog of the session's slot tables.
        self.draft_tables = np.zeros((max_batch, nb), np.int32)
        # Fixed-shape scratch for the decode loop.
        self._dt = np.zeros((max_batch, 1), np.int32)
        self._dtab = np.zeros((max_batch, nb), np.int32)
        self._dlen = np.zeros((max_batch,), np.int32)
        self._ct = np.zeros((num_chunks, chunk_size), np.int32)
        self._ctab = np.zeros((num_chunks, nb), np.int32)
        self._cstart = np.zeros((num_chunks,), np.int32)
        self._clen = np.zeros((num_chunks,), np.int32)
        self.stats = {"draft_steps": 0, "catch_up_steps": 0,
                      "catch_up_rows": 0}

    def clear_slot(self, i: int) -> None:
        self.draft_tables[i, :] = 0

    def set_slot(self, slot) -> None:
        self.draft_tables[slot.index, :] = 0
        self.draft_tables[slot.index, :len(slot.draft_blocks)] = (
            slot.draft_blocks
        )

    def k_eff(self, slot) -> int:
        """Drafts worth making for this slot: capped by spec_k and by
        the remaining token budget (the verify pass emits at most
        k_eff + 1 tokens, and budget - generated may already be 1)."""
        return max(0, min(self.spec_k, slot.budget - slot.generated - 1))

    # -- catch-up chunk lanes -------------------------------------------
    def catch_up(self, slots, seq_of: Callable[[int], list]) -> int:
        """One chunk-lane pass (<= NC lanes, FCFS by admit_seq) moving
        draft caches toward the target's coverage; returns rows used.
        Content comes from ``seq_of(rid)``: position p of a slot's cache
        always holds ``seq_of(rid)[p]``, prompt and generated region
        alike."""
        behind = sorted(
            (s for s in slots if s.draft_length < s.length),
            key=lambda s: s.admit_seq,
        )
        if not behind:
            return 0
        self._ct[:] = 0
        self._ctab[:] = 0
        self._cstart[:] = 0
        self._clen[:] = 0
        chunks = []  # (slot, start, n)
        for slot in behind:
            pos = slot.draft_length
            while len(chunks) < self.NC and pos < slot.length:
                n = min(self.C, slot.length - pos)
                chunks.append((slot, pos, n))
                pos += n
            if len(chunks) >= self.NC:
                break
        for ci, (slot, start, n) in enumerate(chunks):
            seq = seq_of(slot.request.rid)
            self._ct[ci, :n] = seq[start:start + n]
            self._ctab[ci] = self.draft_tables[slot.index]
            self._cstart[ci] = start
            self._clen[ci] = n
        self.cache, _ = self._prefill(
            self.params, self._ct, self.cache, self._ctab, self._cstart,
            self._clen,
        )
        for slot, start, n in chunks:
            slot.draft_length = start + n
        rows = int(self._clen.sum())
        self.stats["catch_up_steps"] += 1
        self.stats["catch_up_rows"] += rows
        return rows

    # -- the k+1-step draft loop ----------------------------------------
    def draft(self, decoding, cur: np.ndarray) -> dict:
        """Draft up to spec_k tokens per lockstep decoding slot.

        Returns ``{slot.index: (drafted, q_rows)}`` for the slots taking
        part. Runs ``max(k_eff) + 1`` fixed-shape draft decode steps;
        slot i joins steps ``0 .. k_eff_i`` (its final step writes its
        last draft without sampling). After the loop the draft cache
        covers positions ``length .. length + k_eff`` for every
        participant; the engine re-establishes ``draft_length =
        length`` after acceptance rewinds."""
        parts = [
            s for s in decoding
            if s.draft_length == s.length and self.k_eff(s) >= 1
        ]
        if not parts:
            return {}
        keff = {s.index: self.k_eff(s) for s in parts}
        feed = {s.index: int(cur[s.index, 0]) for s in parts}
        out = {s.index: ([], []) for s in parts}
        for j in range(max(keff.values()) + 1):
            self._dt[:] = 0
            self._dtab[:] = 0
            self._dlen[:] = 0
            stepping = [s for s in parts if j <= keff[s.index]]
            for s in stepping:
                i = s.index
                self._dt[i, 0] = feed[i]
                self._dtab[i] = self.draft_tables[i]
                self._dlen[i] = s.length + j
            self.cache, lg = self._step(
                self.params, self._dt, self.cache, self._dtab, self._dlen,
            )  # lg: (B, 1, V) on the host, one sync a step
            self.stats["draft_steps"] += 1
            for s in stepping:
                i = s.index
                if j >= keff[i]:
                    continue  # final step: write-only, no sample
                tok, q = draft_sample(
                    lg[i, 0], self.temperature, self.seed0,
                    s.request.rid, s.generated + j,
                )
                out[i][0].append(tok)
                out[i][1].append(q)
                feed[i] = tok
        return out

    def compile_count(self) -> int:
        """Distinct draft step shapes run (the reference counts the jit
        compiles of its draft decode and catch-up steps)."""
        return len(self.signatures)
