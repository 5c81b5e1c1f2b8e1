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
(``make_iterator(task=...)``).

The encoder-only (ViT) family trains on ``patch_batch``, the reference's
synthetic vision task; the encoder-decoder family on
``span_corruption_batch`` (T5) or ``frame_batch`` (whisper's stub
frames), both drawn from the bigram stream.
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


def span_corruption_batch(task: ClusteredBigramTask, batch: int,
                          enc_len: int, dec_len: int, step: int, *,
                          noise_density: float = 0.15, mean_span: int = 3,
                          n_sentinels: int = 32) -> dict:
    """T5-style span corruption over the bigram stream.

    Sentinels use the top ``n_sentinels`` ids of the task's vocabulary.
    The encoder sees the corrupted stream; the decoder predicts the
    sentinel-delimited spans (``dec_tokens`` is ``targets`` shifted right
    by one, from a 0 start token; -1 marks padded targets)."""
    V = task.vocab_size
    sentinel0 = V - n_sentinels
    toks = task.sample(batch, enc_len, step)[:, :enc_len]
    rng = np.random.Generator(
        np.random.Philox(key=task.seed + 2, counter=[0, 0, 0, step]))
    enc = np.full((batch, enc_len), 0, np.int64)
    dec_in = np.zeros((batch, dec_len), np.int64)
    tgt = np.full((batch, dec_len), -1, np.int64)
    n_spans = max(1, int(enc_len * noise_density / mean_span))
    for b in range(batch):
        starts = np.sort(rng.choice(np.arange(1, enc_len - mean_span),
                                    size=n_spans, replace=False))
        mask = np.zeros(enc_len, bool)
        for s in starts:
            mask[s:s + mean_span] = True
        # encoder: unmasked tokens with sentinels at span starts
        out, di, sent = [], [], 0
        t = 0
        while t < enc_len:
            if mask[t]:
                out.append(sentinel0 + sent)
                di.append(sentinel0 + sent)
                while t < enc_len and mask[t]:
                    di.append(toks[b, t])
                    t += 1
                sent += 1
            else:
                out.append(toks[b, t])
                t += 1
        out = out[:enc_len]
        enc[b, :len(out)] = out
        di = di[:dec_len]
        dec_in[b, 1:len(di) + 1 if len(di) < dec_len else dec_len] = \
            di[: dec_len - 1]
        tgt[b, :len(di)] = di
    return {
        "enc_tokens": enc.astype(np.int32),
        "dec_tokens": dec_in.astype(np.int32),
        "targets": tgt.astype(np.int32),
    }


def patch_batch(batch: int, n_patches: int, d_model: int, n_classes: int,
                step: int, *, seed: int = 99) -> dict:
    """Synthetic vision task: label = argmax of a fixed random linear
    functional of the mean patch embedding (learnable by GAP + head)."""
    rng = np.random.Generator(
        np.random.Philox(key=seed, counter=[0, 0, 0, step]))
    wrng = np.random.Generator(np.random.Philox(seed + 1))
    w = wrng.normal(size=(d_model, n_classes))
    x = rng.normal(size=(batch, n_patches, d_model)).astype(np.float32)
    labels = (x.mean(1) @ w).argmax(-1).astype(np.int32)
    return {"patch_embeds": x, "labels": labels}


def frame_batch(task: ClusteredBigramTask, batch: int, enc_len: int,
                dec_len: int, d_model: int, step: int) -> dict:
    """Audio stub: frames are fixed random embeddings (from the task's
    seed) of a token stream; the decoder transcribes the stream
    (whisper-shaped)."""
    toks = task.sample(batch, max(enc_len, dec_len), step)
    rng = np.random.Generator(np.random.Philox(task.seed + 3))
    emb = rng.normal(size=(task.vocab_size, d_model)).astype(np.float32)
    frames = emb[toks[:, :enc_len] % task.vocab_size]
    dec = toks[:, :dec_len]
    tgt = np.concatenate([dec[:, 1:], np.full((batch, 1), -1, np.int64)],
                         axis=1)
    return {
        "frames": frames.astype(np.float32),
        "dec_tokens": dec.astype(np.int32),
        "targets": tgt.astype(np.int32),
    }
