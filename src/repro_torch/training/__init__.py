"""Step functions and fault tolerance. Port of ``src/repro/training/``
(the prefill and serve steps and ``fault.py``; the optimizer and the train
step wait for the training slice)."""
from repro_torch.training.fault import (ElasticScaler, FaultInjector,
                                        InjectedFault, StragglerMonitor,
                                        TrainController)
from repro_torch.training.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step",
           "ElasticScaler", "FaultInjector", "InjectedFault",
           "StragglerMonitor", "TrainController"]
