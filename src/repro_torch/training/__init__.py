"""Training: the train step and state (port of the step path of
``repro/training``). The fault-tolerant ``Trainer`` runtime (checkpoints,
health, chaos, observability) is queued in ROADMAP.md."""
from repro_torch.training.train_loop import (  # noqa: F401
    TrainConfig,
    init_train_state,
    make_train_step,
)
