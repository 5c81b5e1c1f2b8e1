"""Checkpointable data iteration (port of the single-process part of
``repro/data/pipeline.py``; per-host slicing comes with the multi-GPU
port).

``DataIterator`` wraps a (step -> global numpy batch) function. Its
state is the step counter and the count of batches skipped past, so data
order is exactly-once across restarts and divergence rollbacks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs import ArchConfig
from repro_torch.data import synthetic as syn


@dataclasses.dataclass
class DataIterator:
    batch_fn: Callable[[int], dict]  # step -> global batch (numpy)
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
) -> DataIterator:
    """The arch's synthetic stream: the clustered-bigram LM stream of a
    decoder-only model, the patch task of an encoder-only one (whose
    sequence is its ``n_frontend_positions`` patches: ``seq_len`` is not
    read). The encoder-decoder family's streams are queued in
    ROADMAP.md."""
    if cfg.structure == "encoder_only":
        return DataIterator(batch_fn=lambda step: syn.patch_batch(
            global_batch, cfg.n_frontend_positions, cfg.d_model,
            cfg.vocab_size, step))
    if cfg.structure != "decoder_only" or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port's data pipeline serves decoder-only "
            "language models and encoder-only vision models (other "
            "families are queued in ROADMAP.md)")
    task = task or syn.ClusteredBigramTask(vocab_size=cfg.vocab_size)
    return DataIterator(
        batch_fn=lambda step: syn.lm_batch(task, global_batch, seq_len,
                                           step))
