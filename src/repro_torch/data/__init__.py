"""Deterministic synthetic training data (port of ``repro/data``): the
clustered-bigram LM task, span corruption and stub frames over it, the
patch vision task and their checkpointable iterator, in numpy."""
from repro_torch.data.pipeline import DataIterator, make_iterator  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    ClusteredBigramTask,
    frame_batch,
    lm_batch,
    patch_batch,
    span_corruption_batch,
)
