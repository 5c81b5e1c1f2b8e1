r"""Unified observability (port of ``repro/obs/tracker.py``, kept as a
copy of its own: the port imports nothing of ``repro``): a lightweight
tracker protocol with pluggable sinks, counters / gauges / histograms,
nestable spans, and a deterministic row schema shared by the trainer and
the serve scheduler.

Everything is a **row**: a flat-ish JSON-serialisable dict with a
``kind`` discriminator and a logical timestamp ``t`` (trainer step,
engine step — whatever clock the emitting component runs on; NEVER
wall-clock). A :class:`Tracker` turns instrument calls into rows and
fans them out to every attached :class:`Sink`. The row schema, the
metric names and :data:`WALL_FIELDS` are the reference's
(``src/repro/obs/README.md``), so the two packages' rows compare
directly.

Row kinds
---------

======== ==========================================================
kind     fields (beyond ``kind``/``t`` and any bound tags)
======== ==========================================================
counter  ``name``, ``inc`` (this increment), ``value`` (cumulative)
gauge    ``name``, ``value``
observe  ``name``, ``value`` (one histogram sample)
summary  ``name``, ``count``, ``sum``, ``min``, ``max``, ``p50``,
         ``p99`` (fixed-bucket estimates — see :class:`Histogram`)
span     ``name``, ``path`` (slash-joined nesting), ``depth``,
         ``dur_ms`` (wall-clock; the ONLY wall field in the schema)
event    ``name`` plus free-form fields
engine   per-tick engine time series (see ``repro/obs/README.md``)
fleet    per-tick fleet time series (see ``repro/obs/README.md``)
train    per-step trainer metrics (see ``repro/obs/README.md``)
======== ==========================================================

Determinism contract
--------------------

Fleet-mode chaos tests are seeded-reproducible, and the exported
metrics must be too: every row is deterministic given the seed EXCEPT
span rows (wall-clock durations) and the fields named in
:data:`WALL_FIELDS`. :func:`deterministic_rows` strips exactly that
nondeterminism; two identical seeded runs must agree on the result
(tested in ``tests/test_torch_obs.py``).

Sinks
-----

:class:`MemorySink` (tests), :class:`JsonlSink` (one JSON object per
line, flushed on every row, close-on-exception via the context-manager
protocol), :class:`ConsoleSink`, and an optional
:class:`TensorBoardSink` that is import-gated — constructing it
without a TensorBoard provider installed raises ``ImportError``; no
new dependency is required for any other sink.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Callable, Iterable, Optional

# Wall-clock-derived row fields, stripped by deterministic_rows().
WALL_FIELDS = ("dur_ms", "step_ms", "tokens_per_s")


def deterministic_rows(rows: Iterable[dict]) -> list[dict]:
    """The seeded-reproducible projection of a row stream: drop span
    rows (pure wall-clock) and strip :data:`WALL_FIELDS` plus summary
    rows derived from span histograms from everything else."""
    out = []
    for r in rows:
        kind = r.get("kind")
        if kind == "span":
            continue
        if kind == "summary" and str(r.get("name", "")).startswith("span."):
            continue
        out.append({k: v for k, v in r.items() if k not in WALL_FIELDS})
    return out


# -- sinks ----------------------------------------------------------------


class Sink:
    """Protocol base: receives rows, flushes, closes. Context-manager
    enter/exit guarantees close-on-exception."""

    def write(self, row: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MemorySink(Sink):
    """Keeps every row in ``.rows`` — the test sink."""

    def __init__(self):
        self.rows: list[dict] = []
        self.closed = False

    def write(self, row: dict) -> None:
        self.rows.append(row)

    def close(self) -> None:
        self.closed = True


class JsonlSink(Sink):
    """One JSON object per line. Flushes on EVERY row so a crash mid-
    run loses nothing already emitted; ``close`` is idempotent and the
    context-manager exit closes even when the body raises.

    ``path=None`` keeps rows in memory only; with a path, rows are
    written to the file and also kept in memory when ``keep_rows``."""

    def __init__(self, path: Optional[str] = None, *,
                 keep_rows: bool = False):
        self.path = path
        self.rows: Optional[list[dict]] = (
            [] if (keep_rows or path is None) else None)
        self._fh = open(path, "w") if path else None

    def write(self, row: dict) -> None:
        if self.rows is not None:
            self.rows.append(row)
        if self._fh is not None:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    @property
    def closed(self) -> bool:
        return self.path is not None and self._fh is None


class ConsoleSink(Sink):
    """Compact one-line-per-row console output (stderr by default so
    token streams on stdout stay clean)."""

    def __init__(self, stream=None, kinds: Optional[tuple] = None):
        self.stream = stream if stream is not None else sys.stderr
        self.kinds = kinds

    def write(self, row: dict) -> None:
        if self.kinds is not None and row.get("kind") not in self.kinds:
            return
        print(json.dumps(row, sort_keys=True), file=self.stream)


class TensorBoardSink(Sink):
    """Optional TensorBoard export of scalar rows (counter / gauge /
    observe / summary). Import-gated: constructing it without a
    TensorBoard provider raises ImportError — callers that want a soft
    dependency should catch it. Not used by any default path."""

    def __init__(self, logdir: str):
        writer_cls = None
        try:  # torch ships a SummaryWriter
            from torch.utils.tensorboard import SummaryWriter as writer_cls  # noqa: F401
        except Exception:
            try:
                from tensorboardX import SummaryWriter as writer_cls  # noqa: F401
            except Exception:
                writer_cls = None
        if writer_cls is None:
            raise ImportError(
                "TensorBoardSink needs torch.utils.tensorboard or "
                "tensorboardX; neither is installed"
            )
        self._w = writer_cls(logdir)

    def write(self, row: dict) -> None:
        kind = row.get("kind")
        t = row.get("t") or 0
        name = row.get("name", kind)
        if kind in ("counter", "gauge", "observe"):
            self._w.add_scalar(name, row["value"], t)
        elif kind == "summary":
            for k in ("p50", "p99"):
                self._w.add_scalar(f"{name}/{k}", row[k], t)

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()


# -- histogram ------------------------------------------------------------

# Default bounds: sqrt(2)-geometric from 2^-10 (~1e-3) to 2^20 (~1e6),
# covering sub-ms spans through token counts at <= ~20% quantile error.
DEFAULT_BOUNDS = tuple(2.0 ** (i / 2.0) for i in range(-20, 41))


class Histogram:
    """Fixed-bucket histogram with p50/p99 summaries.

    Buckets are half-open ``(bounds[i-1], bounds[i]]`` with an
    underflow bucket below ``bounds[0]`` and an overflow bucket above
    ``bounds[-1]``; quantiles linearly interpolate inside the bucket
    containing the target rank (exact ``min``/``max`` tighten the edge
    buckets), so the estimate is within one bucket width of the true
    percentile."""

    def __init__(self, bounds: Optional[Iterable[float]] = None):
        self.bounds = tuple(sorted(bounds)) if bounds else DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def record(self, value: float) -> None:
        import bisect
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.min if i == 0 else max(self.min, self.bounds[i - 1])
            hi = self.max if i == len(self.bounds) else min(
                self.max, self.bounds[i])
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            cum += c
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "p50": self.percentile(50), "p99": self.percentile(99),
        }


# -- tracker --------------------------------------------------------------

_NULL_CTX = contextlib.nullcontext()


class Tracker:
    """Instrument calls -> rows -> sinks.

    ``clock`` is a zero-arg callable returning the component's logical
    time (trainer step / engine step / fleet tick); rows are stamped
    with it unless an explicit ``t`` is passed. ``tags`` are merged
    into every row (the fleet binds ``engine=<eid>`` per replica).

    :meth:`bind` makes a child tracker sharing the parent's sinks
    (plus ``extra_sinks``) with its own instrument state — children
    never close shared sinks; :meth:`close` only closes sinks this
    tracker created/owns (``owns_sinks``)."""

    def __init__(self, sinks: Iterable[Sink] = (), *,
                 clock: Optional[Callable[[], int]] = None,
                 tags: Optional[dict] = None,
                 hist_bounds: Optional[Iterable[float]] = None,
                 owns_sinks: bool = True):
        self.sinks = list(sinks)
        self.clock = clock
        self.tags = dict(tags or {})
        self.hist_bounds = hist_bounds
        self.owns_sinks = owns_sinks
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Histogram] = {}
        self._stack: list[str] = []

    @property
    def enabled(self) -> bool:
        return True

    # -- plumbing ------------------------------------------------------
    def _t(self, t):
        if t is None and self.clock is not None:
            return self.clock()
        return t

    def emit(self, row: dict) -> None:
        if self.tags:
            row = {**row, **self.tags}
        for s in self.sinks:
            s.write(row)

    def bind(self, *, extra_sinks: Iterable[Sink] = (),
             clock: Optional[Callable[[], int]] = None,
             **tags) -> "Tracker":
        return Tracker(
            list(self.sinks) + list(extra_sinks),
            clock=clock if clock is not None else self.clock,
            tags={**self.tags, **tags},
            hist_bounds=self.hist_bounds,
            owns_sinks=False,
        )

    # -- instruments ---------------------------------------------------
    def count(self, name: str, inc: float = 1, *, t=None) -> None:
        total = self.counters.get(name, 0) + inc
        self.counters[name] = total
        self.emit({"kind": "counter", "name": name, "t": self._t(t),
                   "inc": inc, "value": total})

    def gauge(self, name: str, value: float, *, t=None) -> None:
        self.gauges[name] = value
        self.emit({"kind": "gauge", "name": name, "t": self._t(t),
                   "value": value})

    def _hist(self, name: str) -> Histogram:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(self.hist_bounds)
        return h

    def observe(self, name: str, value: float, *, t=None,
                emit: bool = True) -> None:
        """Record one histogram sample. ``emit=False`` accumulates
        without a row (used for span durations, which already emit a
        span row and must not leak wall-clock into observe rows)."""
        self._hist(name).record(value)
        if emit:
            self.emit({"kind": "observe", "name": name, "t": self._t(t),
                       "value": value})

    def event(self, name: str, *, t=None, **fields) -> None:
        self.emit({"kind": "event", "name": name, "t": self._t(t),
                   **fields})

    def row(self, kind: str, *, t=None, **fields) -> None:
        """Emit a structured time-series row (engine / fleet / train)."""
        self.emit({"kind": kind, "t": self._t(t), **fields})

    @contextlib.contextmanager
    def span(self, name: str):
        """Nestable wall-clock span. Emits one span row on exit (path
        slash-joined through enclosing spans) and accumulates the
        duration into the ``span.<path>`` histogram."""
        self._stack.append(name)
        path = "/".join(self._stack)
        depth = len(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur_ms = (time.perf_counter() - t0) * 1e3
            self._stack.pop()
            self.observe(f"span.{path}", dur_ms, emit=False)
            self.emit({"kind": "span", "name": name, "path": path,
                       "depth": depth, "t": self._t(None),
                       "dur_ms": dur_ms})

    # -- lifecycle -----------------------------------------------------
    def summarize(self, *, t=None) -> None:
        """Emit one summary row per histogram (p50/p99 etc.)."""
        for name in sorted(self.hists):
            self.emit({"kind": "summary", "name": name, "t": self._t(t),
                       **self.hists[name].summary()})

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self, *, summarize: bool = True) -> None:
        if summarize:
            self.summarize()
        if self.owns_sinks:
            for s in self.sinks:
                s.close()
        else:
            self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracker(Tracker):
    """Zero-overhead default: every instrument is a no-op and span
    returns a shared null context. ``tracker or NULL`` keeps hot loops
    branch-free."""

    def __init__(self):
        super().__init__(owns_sinks=False)

    @property
    def enabled(self) -> bool:
        return False

    def emit(self, row: dict) -> None:
        pass

    def count(self, name, inc=1, *, t=None) -> None:
        pass

    def gauge(self, name, value, *, t=None) -> None:
        pass

    def observe(self, name, value, *, t=None, emit=True) -> None:
        pass

    def event(self, name, *, t=None, **fields) -> None:
        pass

    def row(self, kind, *, t=None, **fields) -> None:
        pass

    def span(self, name):
        return _NULL_CTX

    def bind(self, *, extra_sinks=(), clock=None, **tags):
        if extra_sinks:
            return Tracker(extra_sinks, clock=clock, tags=tags,
                           owns_sinks=False)
        return self

    def summarize(self, *, t=None) -> None:
        pass

    def close(self, *, summarize=True) -> None:
        pass


NULL = NullTracker()
