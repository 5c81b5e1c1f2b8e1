"""Training-health instruments: the divergence (loss-spike) detector
(port of ``repro/training/health.py``, a copy of its own: pure Python).

Upcycled-MoE fine-tunes diverge in two distinguishable ways. A router
blowup that reaches NaN/inf is caught by the non-finite guard inside
the train step (``train_loop.make_train_step``); a FINITE loss spike —
the loss jumps well above its recent trajectory but stays
representable — silently wrecks the optimizer state long before
anything overflows. :class:`SpikeDetector` watches the per-step loss
against a trailing baseline and flags the spike so the
:class:`~repro_torch.training.train_loop.Trainer` can roll back to the
last known-good checkpoint and skip the offending batch window
(PaLM-style).

Two baselines are available:

* ``mode="median"`` (default): median of the last ``window`` finite
  losses — robust, a single spike cannot drag the baseline toward
  itself;
* ``mode="ewma"``: exponential moving average with decay ``ewma`` —
  cheaper, tracks a falling loss curve more tightly, but a cluster of
  near-threshold steps inflates it.

The detector arms only after ``min_history`` finite samples, so the
noisy first steps of a fresh (or freshly upcycled) run never trigger a
rollback. Its entire state is the trailing history — serialised into
checkpoint metadata (``state()`` / ``restore()``) so a crash-resumed
run sees bit-identical detector decisions to an uninterrupted one.
"""
from __future__ import annotations

import math
from typing import Optional


class SpikeDetector:
    """Flags a finite loss ``> threshold × trailing baseline``.

    ``threshold <= 0`` disables the detector entirely (``enabled`` is
    False, ``is_spike`` never fires) — the default TrainConfig keeps it
    off so short smoke runs with naturally jumpy early losses are
    unaffected unless a run opts in.
    """

    def __init__(self, threshold: float, *, window: int = 32,
                 min_history: int = 5, mode: str = "median",
                 ewma: float = 0.9):
        if mode not in ("median", "ewma"):
            raise ValueError(f"unknown spike detector mode: {mode!r}")
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_history = int(min_history)
        self.mode = mode
        self.ewma = float(ewma)
        self.history: list[float] = []
        self._ewma_val: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.threshold > 0.0

    @property
    def armed(self) -> bool:
        return self.enabled and len(self.history) >= self.min_history

    def baseline(self) -> Optional[float]:
        """Trailing baseline the threshold multiplies, or None while
        unarmed."""
        if not self.armed:
            return None
        if self.mode == "ewma":
            return self._ewma_val
        h = sorted(self.history)
        n = len(h)
        mid = n // 2
        return h[mid] if n % 2 else 0.5 * (h[mid - 1] + h[mid])

    def is_spike(self, loss: float) -> bool:
        """True when ``loss`` is finite and exceeds threshold×baseline.
        Non-finite losses are the non-finite guard's job, never a
        spike."""
        if not self.armed or not math.isfinite(loss):
            return False
        base = self.baseline()
        # A baseline at/below zero can't anchor a multiplicative
        # threshold; stay quiet rather than divide by nothing.
        if base is None or base <= 0.0:
            return False
        return loss > self.threshold * base

    def update(self, loss: float) -> None:
        """Feed one observed step loss (skipped for non-finite values;
        the Trainer never feeds a loss it decided was a spike)."""
        if not math.isfinite(loss):
            return
        self.history.append(float(loss))
        if len(self.history) > self.window:
            self.history = self.history[-self.window:]
        if self._ewma_val is None:
            self._ewma_val = float(loss)
        else:
            self._ewma_val = (self.ewma * self._ewma_val
                              + (1.0 - self.ewma) * float(loss))

    # -- checkpointable state ------------------------------------------
    def state(self) -> dict:
        return {
            "history": list(self.history),
            "ewma_val": self._ewma_val,
        }

    def restore(self, state: dict) -> None:
        self.history = [float(x) for x in state.get("history", [])]
        v = state.get("ewma_val")
        self._ewma_val = None if v is None else float(v)
