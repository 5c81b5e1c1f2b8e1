"""Deterministic synthetic LM data (port of the language-model part of
``repro/data/synthetic.py``; numpy only, batches identical to the
reference's for the same task and step).

The task is a **clustered-bigram language model**: K latent clusters,
each with its own bigram transition table; a sequence starts with its
cluster-id token and then follows that cluster's bigram chain, so
experts can specialise per cluster. Everything is generated from
(seed, stream, step) through ``np.random.Philox``, so iteration is
stateless-resumable: the iterator state is one step counter.

The tables are (K, V, V) float64: 155 GB at a 49k-token vocabulary, so
a full-width model trains on a task over its first few thousand ids
(``make_iterator(task=...)``). The span-corruption, patch and frame
batches of the other families are queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusteredBigramTask:
    vocab_size: int
    n_clusters: int = 8
    concentration: float = 0.3  # lower => peakier (more learnable) bigrams
    seed: int = 1234

    def tables(self) -> np.ndarray:
        """(K, V, V) row-stochastic transition tables (deterministic)."""
        rng = np.random.Generator(np.random.Philox(self.seed))
        V, K = self.vocab_size, self.n_clusters
        # Peaky rows: each token has a handful of likely successors.
        logits = rng.gumbel(size=(K, V, V)) * (1.0 / self.concentration)
        # keep top-4 successors per row, renormalize
        kth = np.partition(logits, -4, axis=-1)[..., -4:-3]
        logits = np.where(logits >= kth, logits, -np.inf)
        z = logits - logits.max(-1, keepdims=True)
        p = np.exp(z)
        return p / p.sum(-1, keepdims=True)

    def sample(self, batch: int, seq_len: int, step: int,
               stream: int = 0) -> np.ndarray:
        """(batch, seq_len+1) token ids; column 0 encodes the cluster."""
        tables = _cached_tables(self)
        rng = np.random.Generator(
            np.random.Philox(key=self.seed + 1,
                             counter=[0, 0, stream, step])
        )
        K, V = self.n_clusters, self.vocab_size
        clusters = rng.integers(0, K, size=batch)
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = clusters  # cluster-id token (ids 0..K-1 reserved)
        cur = rng.integers(K, V, size=batch)
        toks[:, 1] = cur
        # vectorized ancestral sampling
        u = rng.random(size=(batch, seq_len))
        for t in range(1, seq_len):
            rows = tables[clusters, toks[:, t]]  # (batch, V)
            cdf = np.cumsum(rows, axis=-1)
            toks[:, t + 1] = (u[:, t - 1, None] > cdf).sum(-1)
        return toks


_TABLE_CACHE: dict = {}


def _cached_tables(task: ClusteredBigramTask) -> np.ndarray:
    key = (task.vocab_size, task.n_clusters, task.concentration, task.seed)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = task.tables()
    return _TABLE_CACHE[key]


def lm_batch(task: ClusteredBigramTask, batch: int, seq_len: int,
             step: int) -> dict:
    toks = task.sample(batch, seq_len, step)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "targets": toks[:, 1:].astype(np.int32),
    }
