"""Seeded fault injection for the training path (port of
``repro/training/chaos.py``; the train-side mirror of the reference's
``serve.ChaosConfig``). The seeded coins are the reference's: the same
seed gives the same faults in both packages.

:class:`TrainChaosConfig` describes WHAT can go wrong; every decision
is a pure function of ``(seed, kind, index)`` (hash-keyed
``np.random.default_rng``, no shared stream), so a fault schedule is
reproducible regardless of how many times the trainer crashes and
replays the surrounding steps. :class:`ChaosState` carries the
cross-incarnation bookkeeping (fired sets, blast-radius caps, audit
counts) and is owned by the HARNESS — it survives the simulated
process crashes that destroy the Trainer itself.

Fault kinds
-----------

=================  =====================================================
loss spike         the OBSERVED loss for a batch is multiplied by
                   ``spike_scale`` before the divergence detector sees
                   it (keyed on the batch index, so the PaLM-style
                   batch-window skip after a rollback retires the fault)
process crash      :class:`SimulatedCrash` raised after a step's
                   bookkeeping but BEFORE its checkpoint save — the
                   worst case: everything since the last checkpoint is
                   lost and must replay bit-identically on resume
preemption         the cooperative :class:`~repro_torch.training.
                   train_loop.PreemptionSignal` fires (save + clean exit; the
                   harness restarts and the run resumes)
transient IO       the CheckpointManager ``fault_hook`` raises on a
                   store op's FIRST attempt only — always succeeds
                   within the manager's retry budget
corrupt store      a just-COMMITted checkpoint's first leaf file is
                   truncated in place — the next restore must fall back
                   to the last known-good step
=================  =====================================================

:func:`run_chaotic` is the save/teardown/rebuild driver: it builds a
fresh Trainer after every crash/preemption (the caller's
``make_trainer`` must create a NEW ``PreemptionSignal`` and data
iterator each time — exactly what a restarted process would do) and
returns the completed run plus the chaos ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


class SimulatedCrash(RuntimeError):
    """Injected process death: the trainer vanishes mid-interval with
    no final checkpoint; only ``run_chaotic`` may catch it."""


# Stable per-kind salts so decisions for different fault kinds at the
# same index never correlate.
_KIND_SALT = {"spike": 1, "crash": 2, "preempt": 3, "io": 4,
              "corrupt": 5}


@dataclasses.dataclass(frozen=True)
class TrainChaosConfig:
    seed: int = 0
    # Finite loss spikes, keyed on the BATCH index (DataIterator.step
    # of the consumed batch): deterministic list + seeded probability.
    spike_batches: tuple = ()
    spike_prob: float = 0.0
    spike_scale: float = 100.0
    max_spikes: int = 4
    # Simulated process crashes, keyed on the optimizer step that just
    # completed (fires before that step's checkpoint save).
    crash_steps: tuple = ()
    crash_prob: float = 0.0
    max_crashes: int = 2
    # Preemption storm: the cooperative SIGTERM path (save + exit).
    preempt_steps: tuple = ()
    preempt_prob: float = 0.0
    max_preempts: int = 2
    # Transient store IO faults (first attempt of an op fails; the
    # manager's capped-backoff retry path absorbs it).
    io_fault_prob: float = 0.0
    max_io_faults: int = 8
    # Corrupt-after-COMMIT store faults, keyed on the checkpoint step
    # (never fired on the step-0 rollback anchor).
    corrupt_steps: tuple = ()
    corrupt_prob: float = 0.0
    max_corrupts: int = 1
    # Audit trainer invariants every step (Trainer.audit).
    audit: bool = True


class ChaosState:
    """Harness-owned fault ledger, shared across Trainer incarnations."""

    def __init__(self, chaos: TrainChaosConfig):
        self.chaos = chaos
        self.spikes = 0
        self.crashes = 0
        self.preempts = 0
        self.io_faults = 0
        self.io_ops = 0
        self.corrupts = 0
        self.audits = 0
        self.rebuilds = 0
        self._fired: set = set()  # (kind, idx) for deterministic lists

    def _coin(self, kind: str, idx: int, prob: float) -> bool:
        if prob <= 0.0:
            return False
        rng = np.random.default_rng(
            (int(self.chaos.seed), _KIND_SALT[kind], int(idx)))
        return bool(rng.random() < prob)

    def _fire(self, kind: str, idx: int, listed: tuple, prob: float,
              count: int, cap: int) -> bool:
        if count >= cap:
            return False
        if idx in listed:
            # Deterministic faults fire once per harness lifetime —
            # a crash-replayed step must not re-raise the same fault
            # forever.
            if (kind, idx) in self._fired:
                return False
            self._fired.add((kind, idx))
            return True
        return self._coin(kind, idx, prob)

    # -- decision points (called by Trainer) ---------------------------
    def spike_at(self, batch_idx: int) -> bool:
        ch = self.chaos
        if self._fire("spike", batch_idx, ch.spike_batches,
                      ch.spike_prob, self.spikes, ch.max_spikes):
            self.spikes += 1
            return True
        return False

    def crash_at(self, step: int) -> bool:
        ch = self.chaos
        if self._fire("crash", step, ch.crash_steps, ch.crash_prob,
                      self.crashes, ch.max_crashes):
            self.crashes += 1
            return True
        return False

    def preempt_at(self, step: int) -> bool:
        ch = self.chaos
        if self._fire("preempt", step, ch.preempt_steps,
                      ch.preempt_prob, self.preempts, ch.max_preempts):
            self.preempts += 1
            return True
        return False

    def fault_hook(self, op: str, attempt: int) -> None:
        """CheckpointManager hook: transient-only — never fails a
        retry, so the op always lands within the retry budget."""
        if attempt > 0:
            return
        self.io_ops += 1
        if self.chaos.io_fault_prob <= 0.0 \
                or self.io_faults >= self.chaos.max_io_faults:
            return
        if self._coin("io", self.io_ops, self.chaos.io_fault_prob):
            self.io_faults += 1
            raise OSError(f"chaos: transient store fault ({op})")

    def maybe_corrupt(self, manager, step: int) -> bool:
        """Tear the just-written checkpoint's first leaf in place
        (COMMIT stays — the torn payload is only discovered at
        restore, which must fall back to an older step)."""
        ch = self.chaos
        if step <= 0:  # never corrupt the rollback anchor
            return False
        if not self._fire("corrupt", step, ch.corrupt_steps,
                          ch.corrupt_prob, self.corrupts,
                          ch.max_corrupts):
            return False
        from repro_torch.checkpoint import store

        manager.wait()  # the async writer must finish first
        path = manager.step_path(step)
        leaves = store.leaf_files(path)
        if not leaves or not store.is_valid(path):
            return False
        with open(leaves[0], "wb") as f:
            f.write(b"\x93NUMPY")  # torn: magic only, no header/data
        self.corrupts += 1
        return True

    def summary(self) -> dict:
        return {
            "spikes": self.spikes, "crashes": self.crashes,
            "preempts": self.preempts, "io_faults": self.io_faults,
            "corrupts": self.corrupts, "audits": self.audits,
            "rebuilds": self.rebuilds,
        }


def run_chaotic(
    make_trainer: Callable[[TrainChaosConfig, ChaosState], "object"],
    num_steps: int,
    chaos: TrainChaosConfig,
    *,
    state: Optional[ChaosState] = None,
    max_rebuilds: int = 64,
) -> tuple[dict, ChaosState]:
    """Drive a Trainer to completion through injected crashes and
    preemptions: build, run, and on every :class:`SimulatedCrash` or
    preemption exit tear the whole Trainer down and rebuild it from
    scratch (auto-resume does the rest). Returns ``(out, chaos_state)``
    where ``out`` is the final ``Trainer.run`` result.
    """
    st = state if state is not None else ChaosState(chaos)
    for _ in range(max_rebuilds):
        tr = make_trainer(chaos, st)
        try:
            out = tr.run(num_steps)
        except SimulatedCrash:
            # The crashed Trainer's writer may still be committing its
            # last checkpoint (an async save of a large state outlasts
            # the steps after it): join it, so the restart resumes from
            # that checkpoint — everything after it is what the crash
            # loses — and no writer of the old Trainer races the new one.
            tr.manager.wait()
            st.rebuilds += 1
            continue
        if tr.preemption and int(out["state"]["step"]) < num_steps:
            st.rebuilds += 1
            continue
        out = dict(out)
        out["chaos"] = st.summary()
        return out, st
    raise RuntimeError(
        f"train chaos harness wedged: {max_rebuilds} rebuilds without "
        f"completing {num_steps} steps ({st.summary()})"
    )
