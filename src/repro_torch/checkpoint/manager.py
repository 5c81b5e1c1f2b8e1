"""CheckpointManager: rotation, async save, auto-resume (port of
``repro/checkpoint/manager.py``).

Fault-tolerance contract:
  * every save is atomic (COMMIT marker) — a preempted/killed writer can
    never corrupt the latest valid checkpoint;
  * ``restore_latest`` scans for the newest *valid* step, skipping
    partial directories left by crashes;
  * transient store IO failures are retried with capped exponential
    backoff (``io_retries`` / ``io_backoff`` / ``io_backoff_cap``)
    before the error escapes — and ``restore_latest`` then still falls
    back to the last-known-good step;
  * ``save_async`` snapshots to host memory synchronously and writes on
    a background thread so the train loop keeps stepping — ``wait()``
    joins before the next save or process exit. The port's train step
    updates parameter tensors IN PLACE, so the snapshot copies every
    leaf into memory of its own (a CPU tensor's numpy view would alias
    it, and the thread would write later steps' values);
  * rotation keeps ``max_to_keep`` newest plus every multiple of
    ``keep_period`` (archival).
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.models.param import tree_map
from repro_torch.obs.tracker import NULL, Tracker

_STEP_RE = re.compile(r"^step_(\d{8})$")


def host_snapshot(tree):
    """A copy of ``tree`` in host memory that owns its storage: tensors
    (on any device) are copied to the CPU, other leaves kept as they
    are."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return x

    return tree_map(copy, tree)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int = 3,
        keep_period: Optional[int] = None,
        io_retries: int = 2,
        io_backoff: float = 0.05,
        io_backoff_cap: float = 1.0,
        fault_hook: Optional[Callable[[str, int], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
        tracker: Optional[Tracker] = None,
    ):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        # Transient-IO retry policy: each store read/write gets
        # io_retries extra attempts with min(cap, backoff * 2**attempt)
        # seconds between them. fault_hook(op, attempt) is called before
        # EVERY attempt — tests inject transient failures by raising
        # from it; sleep is injectable so backoff tests don't wait.
        self.io_retries = io_retries
        self.io_backoff = io_backoff
        self.io_backoff_cap = io_backoff_cap
        self.fault_hook = fault_hook
        self._sleep = sleep
        # Retries/fallbacks are exported as counters (the reference's
        # metric names, src/repro/obs/README.md).
        self.tracker = tracker if tracker is not None else NULL
        # Store-health ledger: the same counts the tracker exports,
        # plus a consecutive-failure streak, readable via health().
        self.stats = {"io_retries": 0, "fallbacks": 0, "ops_ok": 0}
        self._consecutive_failures = 0
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def health(self) -> dict:
        """Point-in-time store health: cumulative retry/fallback counts
        and the current consecutive-failure streak. ``healthy`` flips
        False while attempts are failing back-to-back and recovers on
        the next successful op."""
        return {
            "io_retries": self.stats["io_retries"],
            "fallbacks": self.stats["fallbacks"],
            "ops_ok": self.stats["ops_ok"],
            "consecutive_failures": self._consecutive_failures,
            "healthy": self._consecutive_failures == 0,
        }

    # -- transient-IO retry ---------------------------------------------
    def _with_retries(self, op: str, fn: Callable[[], Any]) -> Any:
        """Run a store IO op, retrying transient failures with capped
        exponential backoff. ValueError (structure/shape mismatch — a
        caller bug, deterministic) is never retried."""
        attempt = 0
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(op, attempt)
                out = fn()
                self.stats["ops_ok"] += 1
                self._consecutive_failures = 0
                return out
            except ValueError:
                raise
            except Exception as e:
                self._consecutive_failures += 1
                if attempt >= self.io_retries:
                    raise
                delay = min(self.io_backoff_cap,
                            self.io_backoff * (2 ** attempt))
                self.stats["io_retries"] += 1
                self.tracker.count("checkpoint.io_retries")
                print(
                    f"[checkpoint] {op} failed "
                    f"({type(e).__name__}: {e}); retry "
                    f"{attempt + 1}/{self.io_retries} in {delay:.3f}s"
                )
                self._sleep(delay)
                attempt += 1

    # -- paths ----------------------------------------------------------
    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and store.is_valid(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        # Snapshot to host memory synchronously: the caller updates its
        # tensors in place right after.
        host_tree = host_snapshot(tree)
        meta = dict(metadata or {})
        meta["step"] = step

        def _write():
            self._with_retries("save", lambda: store.save_tree(
                self.step_path(step), host_tree, metadata=meta))
            self._gc()

        if blocking:
            _write()
        else:
            def _run():
                try:
                    _write()
                except BaseException as e:  # re-raised by wait()
                    self._thread_error = e

            self._thread = threading.Thread(target=_run, daemon=False)
            self._thread.start()

    def save_async(self, step: int, tree: Any,
                   *, metadata: Optional[dict] = None) -> None:
        self.save(step, tree, metadata=metadata, blocking=False)

    def wait(self) -> None:
        """Join the background save, and raise what it raised (after
        its retries)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._thread_error = self._thread_error, None
        if err is not None:
            raise err

    # -- restore ---------------------------------------------------------
    def restore(self, step: int, like: Any, *, device=None,
                key: Optional[str] = None):
        """The checkpoint of ``step`` shaped like ``like`` (``key``: only
        that top-level subtree, see ``store.load_tree``)."""
        return self._with_retries("restore", lambda: store.load_tree(
            self.step_path(step), like, device=device, key=key))

    def restore_latest(self, like: Any, *, device=None,
                       key: Optional[str] = None):
        """Returns (tree, step, metadata) or (None, None, None).

        Falls back to the last-known-good step: if the newest COMMITted
        checkpoint fails to load anyway (torn leaf file, bit rot,
        truncation), it is logged and the next-newest valid checkpoint
        is tried instead of killing the restart loop. Transient IO
        errors are retried with backoff FIRST (``_with_retries``); only
        a persistently failing step falls back. Structure/shape
        mismatches (ValueError) still raise — that is a caller bug, and
        silently resuming an older incompatible state would hide it.
        ``key`` restores only that top-level subtree (``like`` is its
        structure), e.g. ``key="params"`` of a params-only checkpoint
        or of a Trainer's full train state.
        """
        last_err = None
        for step in reversed(self.all_steps()):
            path = self.step_path(step)
            try:
                return (
                    self._with_retries(
                        "restore_latest",
                        lambda p=path: store.load_tree(
                            p, like, device=device, key=key),
                    ),
                    step,
                    store.load_metadata(path),
                )
            except ValueError:
                raise
            except Exception as e:  # torn/corrupt payload
                last_err = e
                self.stats["fallbacks"] += 1
                self._consecutive_failures += 1
                self.tracker.count("checkpoint.fallbacks")
                print(
                    f"[checkpoint] step {step} at {path} is corrupt "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous checkpoint"
                )
        if last_err is not None:
            print("[checkpoint] no loadable checkpoint found; "
                  "starting fresh")
        return None, None, None

    # -- rotation ---------------------------------------------------------
    def _gc(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        for s in steps[: -self.max_to_keep]:
            if self.keep_period and s % self.keep_period == 0:
                continue
            shutil.rmtree(self.step_path(s), ignore_errors=True)
