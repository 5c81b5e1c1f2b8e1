"""Unified observability layer (port of ``repro/obs``): tracker
protocol, pluggable sinks, histograms, nestable spans. The metrics
reference is ``src/repro_torch/obs/README.md`` (the port's copy of the
JAX package's); ``repro_torch.obs.tracker`` has the row schema and
determinism contract; ``python -m repro_torch.obs.lint`` fails on any
emitted name the README lacks."""

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
