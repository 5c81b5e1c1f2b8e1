"""Training (port of ``repro/training``): the train step and state
(gradient accumulation, gradient compression with error feedback in
``compression``), the self-healing Trainer, the divergence detector and
seeded fault injection. ``training.serve`` re-exports the serving
engine, as the reference's shim does.

Failure modes the train path survives (and how):

=====================  ==============================================
failure                response
=====================  ==============================================
finite loss spike      ``SpikeDetector`` (threshold × trailing
                       median/EWMA baseline) → restore last-known-good
                       checkpoint, PaLM-style skip past the offending
                       batch window, optional LR-decay cooldown;
                       abort with the full rollback history after
                       ``TrainConfig.max_rollbacks``
NaN/inf loss or grad   non-finite guard inside the step skips the
                       optimizer update in place (no rollback); abort
                       after ``max_consecutive_skips`` in a row
process crash          auto-resume from the newest valid checkpoint;
                       ALL resume-relevant state (data position, skip
                       counters, rollback history, LR cooldown,
                       detector window) rides in checkpoint metadata
preemption (SIGTERM)   cooperative ``PreemptionSignal``: blocking
                       save, clean exit, resume on restart
flaky checkpoint IO    ``CheckpointManager`` capped-backoff retries
                       (transient) and restore fallback to an older
                       step (corrupt payload); both exported as
                       counters and via ``manager.health()``
=====================  ==============================================

``repro_torch.training.chaos`` injects all five (seeded, replay-stable)
and ``run_chaotic`` drives a Trainer to completion through them.
"""
from repro_torch.training.chaos import (  # noqa: F401
    ChaosState,
    SimulatedCrash,
    TrainChaosConfig,
    run_chaotic,
)
from repro_torch.training.health import SpikeDetector  # noqa: F401
from repro_torch.training.train_loop import (  # noqa: F401
    PreemptionSignal,
    TrainConfig,
    Trainer,
    init_train_state,
    make_train_step,
)
