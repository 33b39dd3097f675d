"""AdamW, step functions and fault tolerance. Port of
``src/repro/training/``."""
from repro_torch.training.fault import (ElasticScaler, FaultInjector,
                                        InjectedFault, StragglerMonitor,
                                        TrainController)
from repro_torch.training.optimizer import (AdamWState, OptimizerConfig,
                                            abstract_state, apply_updates,
                                            init_state, state_axes)
from repro_torch.training.step import (make_eval_step, make_prefill_step,
                                       make_serve_step, make_train_step)

__all__ = [
    "ElasticScaler", "FaultInjector", "InjectedFault", "StragglerMonitor",
    "TrainController",
    "AdamWState", "OptimizerConfig", "abstract_state", "apply_updates",
    "init_state", "state_axes", "make_eval_step", "make_prefill_step",
    "make_serve_step", "make_train_step",
]
