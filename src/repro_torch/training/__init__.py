"""AdamW, step functions and fault tolerance. Port of
``src/repro/training/`` (``abstract_state`` / ``state_axes`` wait for the
sharded-LM slice)."""
from repro_torch.training.fault import (ElasticScaler, FaultInjector,
                                        InjectedFault, StragglerMonitor,
                                        TrainController)
from repro_torch.training.optimizer import (AdamWState, OptimizerConfig,
                                            apply_updates, init_state)
from repro_torch.training.step import (make_eval_step, make_prefill_step,
                                       make_serve_step, make_train_step)

__all__ = [
    "ElasticScaler", "FaultInjector", "InjectedFault", "StragglerMonitor",
    "TrainController",
    "AdamWState", "OptimizerConfig", "apply_updates", "init_state",
    "make_eval_step", "make_prefill_step", "make_serve_step",
    "make_train_step",
]
