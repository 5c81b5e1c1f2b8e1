"""Host-side KV block pool: refcounted allocator + content-hash prefix
index behind the paged serve cache (copy of
``repro/serve/paged_cache.py``; host-only code, no torch).

The device side is a per-layer global pool ``(num_blocks, block_size,
Kh, dh)`` (``models/attention.init_paged_cache``); this module owns the
*bookkeeping*: which blocks are free, which sequence owns which blocks,
and which blocks hold known prompt-prefix content. Blocks are allocated
atomically on request admission and freed on completion — the
continuous-batching engine never fragments a sequence's worst-case
footprint across admissions, so an admitted request can always run to
its token budget.

Block 0 is the **trash block**: never allocated, written by dead rows of
the mixed step (free decode slots, padded chunk rows), never read.

Prefix caching
--------------
Blocks are **refcounted**: admissions whose prompt shares a prefix with
content already in the pool map the shared FULL blocks into their block
table copy-free (``match_prefix`` + ``share``) instead of recomputing
them; ``free`` only returns a block to the free lists when its last
holder releases it. The index is a chain of content hashes — block ``i``
is keyed by ``sha256(parent_chain_hash | its block_size tokens)`` — so a
hit guarantees both identical content AND identical absolute positions
(KV values depend on both). Freed blocks keep their content and stay in
the index ("cached-free"): they remain matchable until the allocator
hands them out again, at which point their index entry is evicted
(allocation prefers never-cached blocks, then the oldest cached-free
ones — an LRU-flavored eviction). A match never covers the WHOLE prompt:
at least one token is left for the prefill chunks so the engine always
has logits to sample the first token from.

The partial tail is the one copy case: when the next block's cached
content extends the match by ``1 <= t < block_size`` tokens,
``match_prefix`` reports a **copy-on-write** donor — the engine copies
that block's pool rows into the request's own fresh block (device-side
``ServeEngine._copy_block``) and the request appends into its private
copy; the donor is never written.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

TRASH_BLOCK = 0


def bucket_len(prompt_len: int, block_size: int) -> int:
    """Bucketed prefill length: prompts round up to whole blocks (one
    jit specialization per bucket; prefill writes whole blocks). The
    single source of truth shared by the allocator (``blocks_needed``)
    and the prefill-on-join engine's prefill padding — they must agree
    or prefill would write blocks the allocator never reserved. (The
    chunked mixed step has no buckets: chunk lanes are fixed-shape.)"""
    return -(-max(prompt_len, 1) // block_size) * block_size


def blocks_needed(prompt_len: int, max_new: int, block_size: int) -> int:
    """Worst-case block footprint of a request: the bucketed prompt
    plus its full token budget."""
    bucket = bucket_len(prompt_len, block_size)
    return -(-max(bucket, prompt_len + max_new) // block_size)


def _chain(parent: str, tokens) -> str:
    h = hashlib.sha256()
    h.update(parent.encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of :meth:`BlockPool.match_prefix` (pure lookup, no side
    effects — acquire the shared blocks with :meth:`BlockPool.share`).

    ``blocks``: full prefix blocks to map copy-free (in order);
    ``tokens``: prompt tokens they cover (``len(blocks) * block_size``);
    ``cow_block`` / ``cow_tokens``: optional copy-on-write donor — a
    block whose cached content extends the match by ``cow_tokens`` more
    tokens if the engine copies it into the request's own next block.
    """

    blocks: tuple = ()
    tokens: int = 0
    cow_block: Optional[int] = None
    cow_tokens: int = 0


class BlockPool:
    """Refcounted free-list allocator + prefix index over the global KV
    block pool.

    Never-cached blocks are handed out LIFO (recently freed = cache-warm
    on real hardware); cached-free blocks (still matchable prefix
    content) are only consumed when the plain list runs dry, oldest
    first, and lose their index entry at that point. ``num_free`` must
    return to ``capacity`` when the engine drains.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(
                "BlockPool needs >= 2 blocks (block 0 is the reserved "
                f"trash block); got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._free_cached: list[int] = []  # oldest-freed first
        self._refs: dict[int, int] = {}
        # prefix index: chain hash -> block, block -> (chain, parent,
        # tokens) and parent chain -> [(tokens, block)] for tail lookups.
        self._by_hash: dict[str, int] = {}
        self._block_meta: dict[int, tuple[str, str, tuple]] = {}
        self._children: dict[str, list[tuple[tuple, int]]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._free_cached)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the trash block)."""
        return self.num_blocks - 1

    @property
    def num_cached(self) -> int:
        """Free blocks still holding matchable prefix content."""
        return len(self._free_cached)

    # -- allocation -----------------------------------------------------

    def alloc(self, n: int):
        """Atomically take ``n`` blocks; returns their ids, or None if
        the pool cannot satisfy the request right now (the scheduler
        defers admission — never partial allocations). Cached-free
        blocks consumed here are evicted from the prefix index (their
        content is about to be overwritten)."""
        if n <= 0:
            raise ValueError(f"alloc({n})")
        if n > self.num_free:
            return None
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b = self._free_cached.pop(0)  # oldest cached first
                self._evict(b)
            self._refs[b] = 1
            out.append(b)
        return out

    def free(self, blocks) -> None:
        """Release one reference per block; a block returns to the free
        lists only when its LAST holder frees it (shared prefix blocks
        survive their first owner). Freed blocks keep their prefix-index
        entry — matchable until reallocated."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(
                    f"double free / foreign block {b} (allocated: "
                    f"{sorted(self._refs)})"
                )
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                if b in self._block_meta:
                    self._free_cached.append(b)
                else:
                    self._free.append(b)

    def share(self, blocks) -> None:
        """Acquire one more reference on each block: live blocks bump
        their refcount, cached-free blocks are resurrected out of the
        free list (content intact — that is the whole point)."""
        for b in blocks:
            if b in self._refs:
                self._refs[b] += 1
            elif b in self._free_cached:
                self._free_cached.remove(b)
                self._refs[b] = 1
            else:
                raise ValueError(
                    f"block {b} is neither live nor cached — cannot share"
                )

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    # -- prefix index ---------------------------------------------------

    def _evict(self, block: int) -> None:
        chain, parent, toks = self._block_meta.pop(block)
        self._by_hash.pop(chain, None)
        kids = self._children.get(parent)
        if kids is not None:
            self._children[parent] = [
                kv for kv in kids if kv[1] != block
            ]
            if not self._children[parent]:
                del self._children[parent]

    def is_indexed(self, block: int) -> bool:
        return block in self._block_meta

    def match_prefix(self, prompt) -> PrefixMatch:
        """Longest indexed prefix of ``prompt``: full blocks whose chain
        hash (content + position) is cached, capped so at least ONE
        prompt token is left to prefill, plus an optional copy-on-write
        donor extending the match into the next (partial) block. Pure
        lookup — no refcounts move until :meth:`share`."""
        if not self.prefix_cache:
            return PrefixMatch()
        bs = self.block_size
        plen = len(prompt)
        blocks: list[int] = []
        parent = ""
        # Full blocks, capped at plen - 1 matched tokens.
        i = 0
        while (i + 1) * bs <= plen - 1:
            chain = _chain(parent, prompt[i * bs:(i + 1) * bs])
            b = self._by_hash.get(chain)
            if b is None:
                break
            blocks.append(b)
            parent = chain
            i += 1
        matched = i * bs
        # Copy-on-write donor: a cached child block whose content starts
        # with our next tokens buys up to block_size - 1 more (never the
        # whole prompt — the cap above leaves >= 1 token to prefill).
        cow_block, cow_tokens = None, 0
        tail = tuple(int(t) for t in prompt[matched:plen - 1])[:bs]
        if tail:
            for toks, b in self._children.get(parent, ()):
                t = 0
                for a, c in zip(tail, toks):
                    if a != c:
                        break
                    t += 1
                if t > cow_tokens:
                    cow_block, cow_tokens = b, t
        return PrefixMatch(
            blocks=tuple(blocks), tokens=matched,
            cow_block=cow_block, cow_tokens=cow_tokens,
        )

    def register_prefix(self, prompt, blocks, covered: int, *,
                        start_block: int = 0, parent: str = ""):
        """Index the prompt's full blocks whose content is now in the
        pool (``covered`` tokens written so far). Idempotent: chains
        already indexed (e.g. shared blocks) are skipped, and a block
        carries at most one key.

        ``start_block``/``parent`` resume the chain walk from a prior
        call's return value ``(n_blocks, parent_chain)`` so the serve
        engine's per-chunk registration stays O(prompt/block_size)
        TOTAL per request instead of re-hashing the whole prefix every
        chunk."""
        if not self.prefix_cache:
            return 0, ""
        bs = self.block_size
        n = min(covered, len(prompt)) // bs
        for i in range(start_block, n):
            toks = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
            chain = _chain(parent, toks)
            b = blocks[i]
            if chain not in self._by_hash and b not in self._block_meta:
                self._by_hash[chain] = b
                self._block_meta[b] = (chain, parent, toks)
                self._children.setdefault(parent, []).append((toks, b))
            parent = chain
        return max(n, start_block), parent

    # -- fault-injection audit -------------------------------------------

    def check_invariants(self, holders=None) -> None:
        """Audit the pool's internal consistency; raises AssertionError
        with a full diagnostic on any violation. Called at tick
        boundaries by the chaos/robustness harness — O(capacity), pure
        host state, no device work.

        ``holders``: optional iterable of block-id collections (one per
        live owner — slot block tables, chaos block holds). When given,
        per-block refcounts must equal the number of holder lists that
        contain the block, i.e. refcount sums match the block tables.
        """
        errs = []
        free_s = set(self._free)
        cached_s = set(self._free_cached)
        live_s = set(self._refs)
        if len(free_s) != len(self._free):
            errs.append(f"duplicate ids on the free list: {self._free}")
        if len(cached_s) != len(self._free_cached):
            errs.append(
                f"duplicate ids on the cached-free list: "
                f"{self._free_cached}"
            )
        for name, s in (("free", free_s), ("cached-free", cached_s),
                        ("live", live_s)):
            if TRASH_BLOCK in s:
                errs.append(f"trash block {TRASH_BLOCK} on the {name} list")
        for a, b, what in (
            (free_s, cached_s, "free ∩ cached-free"),
            (free_s, live_s, "live block on the free list"),
            (cached_s, live_s, "live block on the cached-free list"),
        ):
            both = a & b
            if both:
                errs.append(f"{what}: {sorted(both)}")
        every = free_s | cached_s | live_s
        want = set(range(1, self.num_blocks))
        if every != want:
            leaked = sorted(want - every)
            phantom = sorted(every - want)
            if leaked:
                errs.append(f"leaked blocks (nowhere at all): {leaked}")
            if phantom:
                errs.append(f"out-of-range blocks tracked: {phantom}")
        bad_refs = {b: c for b, c in self._refs.items() if c < 1}
        if bad_refs:
            errs.append(f"non-positive refcounts: {bad_refs}")
        if holders is not None:
            counts: dict[int, int] = {}
            for hold in holders:
                for b in hold:
                    counts[b] = counts.get(b, 0) + 1
            if counts != self._refs:
                errs.append(
                    f"refcounts {dict(sorted(self._refs.items()))} != "
                    f"block-table holds {dict(sorted(counts.items()))}"
                )
        # Index consistency: cached-free blocks must still be indexed
        # (free() routes unindexed blocks to the plain list), the
        # hash<->block maps must agree, and every indexed block must
        # appear under its parent's children.
        stale = cached_s - set(self._block_meta)
        if stale:
            errs.append(f"cached-free blocks without index meta: "
                        f"{sorted(stale)}")
        for b, (chain, parent, toks) in self._block_meta.items():
            if self._by_hash.get(chain) != b:
                errs.append(
                    f"block {b}: _by_hash[{chain[:12]}…] = "
                    f"{self._by_hash.get(chain)}"
                )
            if (toks, b) not in self._children.get(parent, ()):
                errs.append(f"block {b} missing from parent's children")
        for chain, b in self._by_hash.items():
            if b not in self._block_meta:
                errs.append(f"_by_hash entry {chain[:12]}… -> {b} has "
                            "no block meta")
        if errs:
            raise AssertionError(
                "BlockPool invariant violation:\n  " + "\n  ".join(errs)
            )
