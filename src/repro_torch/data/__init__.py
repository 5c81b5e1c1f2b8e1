"""Deterministic synthetic training data (port of ``repro/data``): the
clustered-bigram LM task and its checkpointable iterator, in numpy."""
from repro_torch.data.pipeline import DataIterator, make_iterator  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    ClusteredBigramTask,
    lm_batch,
)
