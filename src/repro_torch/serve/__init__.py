"""Paged continuous-batching serving (port of the chunked-engine subset
of ``repro/serve``): the refcounted block pool with prefix caching, the
scheduler, and the mixed-step engine."""
from repro_torch.serve.engine import ChunkedSession, ServeConfig, ServeEngine
from repro_torch.serve.paged_cache import (
    BlockPool,
    PrefixMatch,
    blocks_needed,
    bucket_len,
)
from repro_torch.serve.scheduler import Request, Scheduler, Slot
from repro_torch.serve.speculative import sample_token

__all__ = [
    "BlockPool",
    "ChunkedSession",
    "PrefixMatch",
    "Request",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "Slot",
    "blocks_needed",
    "bucket_len",
    "sample_token",
]
