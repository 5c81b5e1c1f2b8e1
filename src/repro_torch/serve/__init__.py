"""Serving (port of ``repro/serve``): the refcounted block pool with
prefix caching, the scheduler, the static and paged engines (chunked
mixed steps or prefill-on-join; robustness knobs and seeded chaos;
speculative decoding with the upcycled model's dense parent as its
draft), and the replica fleet behind a health-checked router."""
from repro_torch.serve.engine import (
    ChaosConfig,
    ChunkedSession,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serve.fleet import (
    AutoscaleConfig,
    Autoscaler,
    Fleet,
    FleetChaosConfig,
    FleetConfig,
)
from repro_torch.serve.paged_cache import (
    BlockPool,
    PrefixMatch,
    blocks_needed,
    bucket_len,
)
from repro_torch.serve.router import Router, RouterConfig, TimelineWriter
from repro_torch.serve.scheduler import Request, Scheduler, Slot
from repro_torch.serve.speculative import (
    SpecRunner,
    sample_token,
    verify_accept,
)

__all__ = [
    "AutoscaleConfig",
    "Autoscaler",
    "BlockPool",
    "ChaosConfig",
    "ChunkedSession",
    "Fleet",
    "FleetChaosConfig",
    "FleetConfig",
    "PrefixMatch",
    "Request",
    "Router",
    "RouterConfig",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "Slot",
    "SpecRunner",
    "TimelineWriter",
    "blocks_needed",
    "bucket_len",
    "sample_token",
    "verify_accept",
]
