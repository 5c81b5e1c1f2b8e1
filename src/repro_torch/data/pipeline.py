"""Checkpointable data iteration (port of the single-process part of
``repro/data/pipeline.py``; per-host slicing and the rollback skip
bookkeeping come with the multi-GPU and Trainer ports).

``DataIterator`` wraps a (step -> global numpy batch) function. Its
state is one integer step counter, so data order is exactly-once across
restarts.
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

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.batch_fn(self.step)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": int(self.step)}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])


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
