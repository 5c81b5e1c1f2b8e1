"""Per-request host-side sampling (port of ``sample_token`` from
``repro/serve/speculative.py``; the draft/verify machinery is queued in
ROADMAP.md)."""
from __future__ import annotations

import numpy as np


def sample_token(logits_row: np.ndarray, temperature: float,
                 seed0: int, rid: int, n: int) -> int:
    """Greedy argmax, or Gumbel-max temperature sampling seeded on
    (session seed, rid, output index) — independent of slot placement
    and batch composition, and the same stream as the reference engine,
    so equal logits give equal samples."""
    if temperature <= 0.0:
        return int(logits_row.argmax())
    g = np.random.default_rng((seed0, rid, n)).gumbel(
        size=logits_row.shape
    )
    return int((logits_row / temperature + g).argmax())
