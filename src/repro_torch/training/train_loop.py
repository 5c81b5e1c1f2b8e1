"""The train step, the train state and the fault-tolerant Trainer (port
of ``make_train_step``, ``init_train_state``, ``TrainConfig``,
``PreemptionSignal`` and ``Trainer`` in ``repro/training/train_loop.py``).

``make_train_step`` builds ``train_step(state, batch[, lr_scale]) ->
(state, metrics)``: loss and gradients through autograd (the flash and
grouped-GEMM backward kernels on a CUDA device), the optimizer update,
the non-finite guard and the optional LR scale, with no host sync — the
metrics stay on the device until the caller reads them. Where the JAX
step is functional and donates its input state, this one updates the
parameter tensors IN PLACE and returns the new state dict; the caller
drops the old one, as it would have dropped the donated JAX state.

``Trainer`` is the fault-tolerant driver. Failure modes it survives:

* **finite loss spike** (divergence) — the :class:`SpikeDetector`
  flags ``loss > spike_threshold × trailing baseline``; the Trainer
  restores the last known-good checkpoint, fast-forwards the data
  iterator past the offending batch window (PaLM-style batch skip),
  optionally decays the LR for a cooldown, and aborts with the full
  rollback history after ``max_rollbacks``;
* **NaN/inf loss** — the in-step non-finite guard drops the update at
  no extra host sync; abort after ``max_consecutive_skips`` consecutive
  skips;
* **crash / kill** — every checkpoint carries ALL resume-relevant state
  (data-iterator position, skip counters, rollback history, LR cooldown,
  detector window) so kill-at-step-k + auto-resume replays the same
  steps: bit-identical on the CPU (tests/test_torch_trainer.py);
* **preemption** — cooperative SIGTERM: final blocking save + clean
  exit; the restarted job resumes;
* **flaky / corrupt checkpoint store** — the CheckpointManager retries
  transient IO with capped backoff and ``restore_latest`` falls back
  past torn payloads to the last known-good step.

Fault injection for all of the above lives in
``repro_torch.training.chaos`` (:class:`TrainChaosConfig` +
``run_chaotic``). Gradient accumulation, gradient compression and remat
are queued in ROADMAP.md (queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchConfig
from repro_torch.data.pipeline import DataIterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.param import (
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zip_map,
)
from repro_torch.obs.tracker import NULL, Tracker
from repro_torch.optim.base import Optimizer, global_norm
from repro_torch.training.chaos import (
    ChaosState,
    SimulatedCrash,
    TrainChaosConfig,
)
from repro_torch.training.health import SpikeDetector


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's ``TrainConfig``. The port's step runs
    ``grad_accum=1`` and ``compression="none"``; other values raise
    (ROADMAP.md queue 1 item 5)."""

    grad_accum: int = 1
    compression: str = "none"
    checkpoint_every: int = 100
    log_every: int = 10
    max_to_keep: int = 3
    # straggler watchdog: warn when a step takes > factor * median
    straggler_factor: float = 3.0
    # Non-finite loss guard: a NaN/inf loss or grad norm skips the
    # optimizer update (params and opt state keep their old values, the
    # step counter still advances); the Trainer aborts after this many
    # CONSECUTIVE skips. 0 disables the guard.
    max_consecutive_skips: int = 10
    # Divergence (FINITE loss spike) detection + rollback. A loss >
    # spike_threshold × trailing baseline (median of the last
    # spike_window finite losses, armed after spike_min_history steps)
    # triggers restore-from-last-known-good + a batch-window skip.
    # 0.0 disables detection.
    spike_threshold: float = 0.0
    spike_window: int = 32
    spike_min_history: int = 5
    spike_mode: str = "median"  # median | ewma
    # Rollback policy: skip the data stream to offending_batch +
    # rollback_skip, decay LR by rollback_lr_decay for rollback_cooldown
    # steps after the restore, and abort with the full rollback history
    # after max_rollbacks rollbacks.
    max_rollbacks: int = 3
    rollback_skip: int = 8
    rollback_lr_decay: float = 1.0
    rollback_cooldown: int = 0

    def __post_init__(self):
        if self.grad_accum != 1 or self.compression != "none":
            raise NotImplementedError(
                f"grad_accum={self.grad_accum}, compression="
                f"{self.compression!r}: the port's step runs grad_accum=1 "
                "and compression='none' (the rest is queued in ROADMAP.md "
                "queue 1 item 5)")


def batch_to(batch: dict, device) -> dict:
    """numpy (or tensor) batch -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def loss_and_grads(params, batch, cfg: ArchConfig, *,
                   ac: zoo.ApplyCfg = zoo.ApplyCfg()):
    """(grads tree, metrics) of ``zoo.loss_fn`` at ``params`` — the
    port of ``jax.value_and_grad(loss_fn, has_aux=True)``; the metrics
    include ``loss`` and ``ce``. ``params`` is left as it was."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, mets = zoo.loss_fn(params, batch, cfg, ac=ac)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in mets.items()})


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    ac: zoo.ApplyCfg = zoo.ApplyCfg(),
                    tc: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch, lr_scale=None) -> (state,
    metrics)``. ``ac``'s "auto" implementations resolve by the params'
    device when the step runs. ``lr_scale`` (optional scalar tensor)
    multiplies the optimizer updates."""

    @torch.no_grad()
    def train_step(state, batch, lr_scale=None):
        params = state["params"]
        device = tree_leaves(params)[0].device
        grads, mets = loss_and_grads(params, batch_to(batch, device), cfg,
                                     ac=ac)
        updates, opt_state = optimizer.update(
            grads, state["opt_state"], params)
        grad_norm = global_norm(grads)
        mets["grad_norm"] = grad_norm
        if tc.max_consecutive_skips > 0:
            ok = torch.isfinite(mets["loss"]) & torch.isfinite(grad_norm)
            mets["skipped"] = (~ok).to(torch.float32)
        else:
            ok = torch.ones((), dtype=torch.bool, device=device)
            mets["skipped"] = torch.zeros((), device=device)

        def apply(p, u):
            if lr_scale is not None:
                u = u * lr_scale
            p.copy_(torch.where(ok, (p + u).to(p.dtype), p))

        tree_zip_map(apply, params, updates)
        # The guard keeps the old optimizer state (its step included).
        opt_state = tree_zip_map(lambda new, old: torch.where(ok, new, old),
                                 opt_state, state["opt_state"])
        new_state = dict(state)
        new_state.update(opt_state=opt_state, step=state["step"] + 1)
        return new_state, mets

    return train_step


def init_train_state(gen, cfg: ArchConfig, optimizer: Optimizer, *,
                     dtype=torch.float32, params: Any = None, device=None):
    """``params``: optional pre-built values tree (e.g. upcycled), used
    as it is; otherwise ``zoo.init_params(gen, cfg)``."""
    if params is None:
        params = zoo.init_params(gen, cfg, dtype=dtype, device=device)
    device = tree_leaves(params)[0].device
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


class PreemptionSignal:
    """Cooperative preemption flag (SIGTERM handler or test hook). The
    handler is installed by ``install()`` only — the launcher's
    ``main`` calls it, never an import."""

    def __init__(self):
        self._flag = False

    def install(self):
        import signal

        def handler(signum, frame):
            self._flag = True

        signal.signal(signal.SIGTERM, handler)
        return self

    def trigger(self):
        self._flag = True

    def __bool__(self):
        return self._flag


def read_metrics(mets: dict) -> dict:
    """Every (scalar) metric tensor as a Python float in ONE device ->
    host copy: the metrics are stacked on their device and read
    together (the reference's one ``jax.device_get`` a step)."""
    names = list(mets)
    vals = torch.stack([mets[k].detach().reshape(()).to(torch.float32)
                        for k in names]).cpu().tolist()
    return dict(zip(names, vals))


@dataclasses.dataclass
class Trainer:
    """The fault-tolerant training driver (see the module docstring).
    ``device`` places a fresh train state (the card by default; it
    raises without one unless the caller asks for ``"cpu"``); the step's
    "auto" kernels follow the state's device."""

    cfg: ArchConfig
    optimizer: Optimizer
    data: DataIterator
    ckpt_dir: str
    ac: zoo.ApplyCfg = zoo.ApplyCfg()
    tc: TrainConfig = TrainConfig()
    preemption: Optional[PreemptionSignal] = None
    log_fn: Callable[[str], None] = print
    # Observability: one "train" row per step (loss / ce / grad_norm /
    # skipped / skipped_steps / spike / rollbacks / lr_scale / step_ms)
    # plus checkpoint retry/fallback counters and rollback events.
    tracker: Optional[Tracker] = None
    # Seeded fault injection (training/chaos.py). chaos_state is
    # harness-owned so its ledger survives simulated process crashes;
    # a bare chaos config gets a private state.
    chaos: Optional[TrainChaosConfig] = None
    chaos_state: Optional[ChaosState] = None
    device: Any = None

    def __post_init__(self):
        self.trk = self.tracker if self.tracker is not None else NULL
        if self.chaos is not None and self.chaos_state is None:
            self.chaos_state = ChaosState(self.chaos)
        self.manager = CheckpointManager(
            self.ckpt_dir, max_to_keep=self.tc.max_to_keep,
            tracker=self.trk,
            fault_hook=(self.chaos_state.fault_hook
                        if self.chaos_state is not None else None),
        )
        self._step_times: list[float] = []
        self.detector = SpikeDetector(
            self.tc.spike_threshold, window=self.tc.spike_window,
            min_history=self.tc.spike_min_history,
            mode=self.tc.spike_mode,
        )
        self._skipped_steps = 0
        self._consecutive_skips = 0
        self._rollbacks: list[dict] = []
        self._cooldown_left = 0
        self.stats: dict = {}

    # -- resume-relevant trainer state ----------------------------------
    # Everything the loop needs beyond the param/opt tree rides in
    # checkpoint metadata, so kill-at-step-k + resume replays the same
    # steps: data-iterator position (+ skip history), skip counters,
    # rollback history, LR cooldown, detector window.
    def _trainer_meta(self) -> dict:
        return {
            "skipped_steps": self._skipped_steps,
            "consecutive_skips": self._consecutive_skips,
            "rollbacks": list(self._rollbacks),
            "cooldown_left": self._cooldown_left,
            "detector": self.detector.state(),
        }

    def _restore_trainer_meta(self, meta: dict, *,
                              keep_rollbacks: bool = False) -> None:
        tm = meta.get("trainer", {})
        self._skipped_steps = int(tm.get("skipped_steps", 0))
        self._consecutive_skips = int(tm.get("consecutive_skips", 0))
        if not keep_rollbacks:
            self._rollbacks = list(tm.get("rollbacks", []))
        self._cooldown_left = int(tm.get("cooldown_left", 0))
        self.detector.restore(tm.get("detector", {}))

    def _save(self, step: int, state, *, blocking: bool) -> None:
        self.manager.save(
            step, state,
            metadata={"data": self.data.state(),
                      "arch": self.cfg.name,
                      "trainer": self._trainer_meta()},
            blocking=blocking,
        )

    # -- divergence rollback --------------------------------------------
    def _rollback(self, like, bad_step: int, bad_batch: int,
                  obs_loss: float):
        """Restore the last known-good checkpoint, rewind the trainer
        bookkeeping to that checkpoint's view, and fast-forward the
        data iterator past the offending batch window. Returns the
        restored state tree and its step."""
        base = self.detector.baseline()
        self.manager.wait()  # an async save may still be writing
        restored, gstep, meta = self.manager.restore_latest(like)
        if restored is None:
            raise RuntimeError(
                f"training diverged at step {bad_step} "
                f"(loss={obs_loss:.6g}, baseline={base}) and no valid "
                "checkpoint exists to roll back to — every candidate "
                "was corrupt or missing"
            )
        # Rewind bookkeeping to the checkpoint's view — but the
        # rollback HISTORY is cumulative across the run (the
        # max_rollbacks bound must see every rollback, including ones
        # newer than the restored step).
        self.data.restore(meta.get("data", {"step": gstep}))
        self._restore_trainer_meta(meta, keep_rollbacks=True)
        # PaLM-style batch-window skip: the stream resumes PAST the
        # offending batch, so a deterministic bad batch cannot re-fire.
        skip_to = bad_batch + max(1, self.tc.rollback_skip)
        if skip_to > self.data.step:
            self.data.skip(skip_to - self.data.step)
        self._cooldown_left = max(0, self.tc.rollback_cooldown)
        rec = {
            "step": int(bad_step),
            "loss": float(obs_loss),
            "baseline": None if base is None else float(base),
            "restored_to": int(gstep),
            "batch": int(bad_batch),
            "data_skipped_to": int(self.data.step),
        }
        self._rollbacks.append(rec)
        self.trk.count("train.rollbacks", t=bad_step)
        self.trk.event("rollback", t=bad_step, **rec)
        self.log_fn(
            f"[trainer] step {bad_step} DIVERGED "
            f"(loss={obs_loss:.4g} > {self.tc.spike_threshold:g}× "
            f"baseline {0.0 if base is None else base:.4g}); rolled "
            f"back to step {gstep}, data skipped to batch "
            f"{self.data.step} ({len(self._rollbacks)}/"
            f"{self.tc.max_rollbacks} rollbacks)"
        )
        return restored, gstep

    def _abort_diverged(self, bad_step: int, obs_loss: float) -> None:
        base = self.detector.baseline()
        hist = "; ".join(
            f"step {r['step']}: loss {r['loss']:.4g} -> restored to "
            f"{r['restored_to']}, skipped to batch "
            f"{r['data_skipped_to']}" for r in self._rollbacks
        )
        raise RuntimeError(
            f"training diverged: loss spike at step {bad_step} "
            f"(loss={obs_loss:.6g} > {self.tc.spike_threshold:g}× "
            f"baseline {0.0 if base is None else base:.6g}) after "
            f"{len(self._rollbacks)} rollbacks "
            f"[{hist}] — lower the learning rate, widen "
            "rollback_skip past the bad data window, or raise router "
            "z-loss before resuming"
        )

    # -- chaos audit -----------------------------------------------------
    def audit(self, step: int) -> None:
        """Per-step invariant audit (chaos harness): bookkeeping the
        self-healing machinery relies on must hold after every step,
        rollback, resume, and fault."""
        assert len(self.detector.history) <= self.detector.window
        assert len(self._rollbacks) <= self.tc.max_rollbacks
        assert 0 <= self._cooldown_left <= max(
            0, self.tc.rollback_cooldown)
        assert self.data.step >= step, (
            f"data iterator at batch {self.data.step} is behind "
            f"optimizer step {step}"
        )
        steps = self.manager.all_steps()
        assert steps == sorted(set(steps))
        assert self._consecutive_skips <= self._skipped_steps \
            or self._skipped_steps == 0
        if self.chaos_state is not None:
            self.chaos_state.audits += 1

    def run(self, num_steps: int, *, gen: Optional[torch.Generator] = None,
            init_params=None) -> dict:
        """Train to ``num_steps`` (resuming from the newest valid
        checkpoint in ``ckpt_dir``). ``gen`` seeds a fresh init (default
        seed 0 on the device); ``init_params`` (e.g. upcycled) is copied,
        not trained in place. Returns {"state", "metrics" (host floats
        of the last step), "stats"}. ``stats`` has no "compile_count":
        the port's step is not compiled."""
        if init_params is not None:
            init_params = tree_map(torch.clone, init_params)
            device = tree_leaves(init_params)[0].device
        else:
            device = resolve_device(self.device)
        gen = torch.Generator(device=device).manual_seed(0) \
            if gen is None else gen
        state = init_train_state(gen, self.cfg, self.optimizer,
                                 params=init_params, device=device)
        # ---- auto-resume -------------------------------------------------
        restored, step0, meta = self.manager.restore_latest(state)
        if restored is not None:
            state = restored
            self.data.restore(meta.get("data", {"step": step0}))
            self._restore_trainer_meta(meta)
            self.log_fn(f"[trainer] resumed from step {step0}")
        train_step = make_train_step(self.cfg, self.optimizer, ac=self.ac,
                                     tc=self.tc)
        # Rollback anchor: divergence before the first periodic save
        # still needs a known-good restore target.
        if self.detector.enabled and self.manager.latest_step() is None:
            self._save(0, state, blocking=True)
        mets = {}
        step = int(state["step"])
        while step < num_steps:
            i = step
            batch = next(self.data)
            bidx = self.data.step - 1  # index of the batch just consumed
            lr_scale = (self.tc.rollback_lr_decay
                        if self._cooldown_left > 0 else 1.0)
            t0 = time.perf_counter()
            state, mets = train_step(
                state, batch,
                torch.tensor(lr_scale, dtype=torch.float32, device=device))
            # ONE host pull per step (blocking until the step finishes):
            # the guard, the tracker and the log below read host floats.
            mets = read_metrics(mets)
            dt = time.perf_counter() - t0
            self._watchdog(i, dt)
            obs_loss = mets["loss"]
            if self.chaos_state is not None \
                    and self.chaos_state.spike_at(bidx):
                obs_loss = obs_loss * self.chaos.spike_scale
            skipped = mets.get("skipped", 0.0) > 0
            if skipped:
                self._skipped_steps += 1
                self._consecutive_skips += 1
                self.log_fn(
                    f"[trainer] step {i + 1} SKIPPED non-finite update "
                    f"(loss={mets['loss']}, grad_norm={mets['grad_norm']}; "
                    f"{self._consecutive_skips} consecutive)"
                )
                if (self.tc.max_consecutive_skips > 0
                        and self._consecutive_skips
                        >= self.tc.max_consecutive_skips):
                    raise RuntimeError(
                        f"training diverged: {self._consecutive_skips} "
                        "consecutive non-finite losses (last loss="
                        f"{mets['loss']}, grad_norm={mets['grad_norm']}) "
                        "— lower the learning rate, raise router z-loss, "
                        "or resume from the last checkpoint with a "
                        "different data seed"
                    )
            else:
                self._consecutive_skips = 0
            mets["skipped_steps"] = self._skipped_steps
            spike = (not skipped) and self.detector.is_spike(obs_loss)
            # Tracker: every step, spike steps included (their row
            # precedes the rollback).
            self.trk.row(
                "train", t=i + 1,
                loss=obs_loss, ce=mets["ce"],
                grad_norm=mets["grad_norm"],
                skipped=mets.get("skipped", 0.0),
                skipped_steps=self._skipped_steps,
                spike=float(spike),
                rollbacks=len(self._rollbacks),
                lr_scale=lr_scale,
                step_ms=dt * 1e3,
            )
            if skipped:
                self.trk.count("train.skipped_steps", t=i + 1)
            if spike:
                # Divergence: restore last-known-good + batch-window
                # skip, or abort with the full history once the
                # rollback budget is spent.
                if len(self._rollbacks) >= self.tc.max_rollbacks:
                    self._abort_diverged(i + 1, obs_loss)
                state, step = self._rollback(state, i + 1, bidx, obs_loss)
                if self.chaos is not None and self.chaos.audit:
                    self.audit(step)
                continue
            self.detector.update(obs_loss)
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
            step = i + 1
            if step % self.tc.log_every == 0:
                self.log_fn(
                    f"[trainer] step {step} loss={mets['loss']:.4f} "
                    f"ce={mets['ce']:.4f} {dt * 1e3:.0f}ms"
                )
            if self.chaos_state is not None and self.preemption is not None \
                    and self.chaos_state.preempt_at(step):
                self.preemption.trigger()
            # A chaos crash fires BEFORE this step's checkpoint — the
            # worst case: everything since the last save is lost and
            # must replay on resume.
            if self.chaos_state is not None \
                    and self.chaos_state.crash_at(step):
                raise SimulatedCrash(f"chaos: crash after step {step}")
            want_ckpt = step % self.tc.checkpoint_every == 0
            if want_ckpt or self.preemption:
                self._save(step, state, blocking=bool(self.preemption))
                if self.chaos_state is not None:
                    self.chaos_state.maybe_corrupt(self.manager, step)
            if self.chaos is not None and self.chaos.audit:
                self.audit(step)
            if self.preemption:
                self.log_fn(
                    f"[trainer] preempted at step {step}; "
                    "checkpoint saved, exiting cleanly"
                )
                break
        self.manager.wait()
        self.stats = {
            "skipped_steps": self._skipped_steps,
            "rollbacks": list(self._rollbacks),
            "cooldown_left": self._cooldown_left,
            "resumed_from": step0,
            "store": self.manager.health(),
        }
        return {"state": state, "metrics": mets, "stats": self.stats}

    def _watchdog(self, step: int, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) < 8:
            return
        med = float(np.median(self._step_times[-64:]))
        if dt > self.tc.straggler_factor * med:
            self.log_fn(
                f"[trainer][straggler] step {step} took {dt * 1e3:.0f}ms "
                f"(median {med * 1e3:.0f}ms) — on a pod this triggers the "
                "slow-host report"
            )
