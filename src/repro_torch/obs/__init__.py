"""Unified observability layer (port of ``repro/obs``): tracker
protocol, pluggable sinks, histograms, nestable spans. The metrics
reference is the JAX package's ``src/repro/obs/README.md``;
``repro_torch.obs.tracker`` has the row schema and determinism contract.
The metric-name lint (``repro/obs/lint.py``) is queued in ROADMAP.md."""

from repro_torch.obs.tracker import (
    DEFAULT_BOUNDS,
    NULL,
    WALL_FIELDS,
    ConsoleSink,
    Histogram,
    JsonlSink,
    MemorySink,
    NullTracker,
    Sink,
    TensorBoardSink,
    Tracker,
    deterministic_rows,
)

__all__ = [
    "DEFAULT_BOUNDS",
    "NULL",
    "WALL_FIELDS",
    "ConsoleSink",
    "Histogram",
    "JsonlSink",
    "MemorySink",
    "NullTracker",
    "Sink",
    "TensorBoardSink",
    "Tracker",
    "deterministic_rows",
]
