"""Sharded, checkpointable data iteration (port of
``repro/data/pipeline.py``).

``DataIterator`` wraps a (step -> global numpy batch) function and
yields the per-host slice: with ``host_count > 1`` each process keeps
the contiguous rows ``[host_index * per, (host_index + 1) * per)`` of
every leaf, ``per`` the global batch over ``host_count``. Its state is the step
counter and the count of batches skipped past — not the host slice — so
data order is exactly-once across restarts, divergence rollbacks and a
resized fleet, which recomputes its slice from the current topology.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.data import synthetic as syn


@dataclasses.dataclass
class DataIterator:
    batch_fn: Callable[[int], dict]  # step -> global batch (numpy)
    host_index: int = 0
    host_count: int = 1
    step: int = 0
    # Batches fast-forwarded past without being consumed (PaLM-style
    # divergence-rollback skips); bookkeeping only — the stream is a
    # pure function of ``step``, so position + skip count is the whole
    # story.
    skipped_batches: int = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.batch_fn(self.step)
        self.step += 1
        if self.host_count > 1:
            per = len(next(iter(batch.values()))) // self.host_count
            lo = self.host_index * per
            batch = {k: v[lo:lo + per] for k, v in batch.items()}
        return batch

    def skip(self, n: int) -> None:
        """Fast-forward ``n`` batches without materialising them — the
        batch window a divergence rollback retires never recurs."""
        if n < 0:
            raise ValueError(f"cannot skip a negative count: {n}")
        self.step += n
        self.skipped_batches += n

    # -- checkpointable state ------------------------------------------
    def state(self) -> dict:
        return {"step": int(self.step),
                "skipped_batches": int(self.skipped_batches)}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        # Older checkpoints predate skip bookkeeping.
        self.skipped_batches = int(state.get("skipped_batches", 0))


def make_iterator(
    cfg: ArchConfig,
    *,
    global_batch: int,
    seq_len: int,
    task: Optional[syn.ClusteredBigramTask] = None,
    host_index: Optional[int] = None,
    host_count: Optional[int] = None,
) -> DataIterator:
    """The arch's synthetic stream: the clustered-bigram LM stream of a
    decoder-only model (with a ``patch`` frontend, plus ``patch_embeds``
    (B, min(n_frontend_positions, seq_len), d): standard normals from
    ``Philox(key=task.seed + 7, counter=[0, 0, 0, step])``, float32, as
    the reference draws them); the patch task of an encoder-only one (whose
    sequence is its ``n_frontend_positions`` patches: ``seq_len`` is not
    read); for an encoder-decoder model, span corruption (or stub frames
    with a ``frame`` frontend) with ``seq_len`` encoder positions and
    ``max(seq_len // 4, 8)`` decoder positions, as the reference's.

    ``host_index`` and ``host_count`` default to ``torch.distributed``'s
    rank and world size when a process group is initialised, else to 0
    and 1 (one process). A ``Trainer`` under a mesh sets them to its
    layout's row blocks (``TreeLayout.batch_rows``: under the rules'
    placement the data coordinate and the data size, so that ``model``
    peers read the same rows)."""
    if host_index is None or host_count is None:
        rank, world = _process_topology()
        host_index = rank if host_index is None else host_index
        host_count = world if host_count is None else host_count
    hosts = dict(host_index=host_index, host_count=host_count)
    if cfg.structure == "encoder_only":
        return DataIterator(batch_fn=lambda step: syn.patch_batch(
            global_batch, cfg.n_frontend_positions, cfg.d_model,
            cfg.vocab_size, step), **hosts)
    task = task or syn.ClusteredBigramTask(vocab_size=cfg.vocab_size)
    if cfg.structure == "encoder_decoder":
        dec_len = max(seq_len // 4, 8)
        if cfg.frontend == "frame":
            return DataIterator(batch_fn=lambda step: syn.frame_batch(
                task, global_batch, seq_len, dec_len, cfg.d_model, step),
                **hosts)
        return DataIterator(batch_fn=lambda step: syn.span_corruption_batch(
            task, global_batch, seq_len, dec_len, step), **hosts)

    def lm(step):
        b = syn.lm_batch(task, global_batch, seq_len, step)
        if cfg.frontend == "patch":
            rng = np.random.Generator(np.random.Philox(
                key=task.seed + 7, counter=[0, 0, 0, step]))
            n = min(cfg.n_frontend_positions, seq_len)
            b["patch_embeds"] = rng.normal(
                size=(global_batch, n, cfg.d_model)).astype(np.float32)
        return b

    return DataIterator(batch_fn=lm, **hosts)


def _process_topology() -> tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed``
    process group, or (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
