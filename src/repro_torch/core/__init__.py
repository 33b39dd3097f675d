"""The paper's primary contribution: task-centric model selection
(NMF transferability subspace + online projection), the task registry,
and the mini zoo/transfer substrate used to validate it.

Port of ``src/repro/core/__init__.py``.
"""
from repro_torch.core.features import TaskFeaturizer
from repro_torch.core.forest import (DecisionTreeRegressor, RandomForestRegressor,
                                     RidgeRegressor)
from repro_torch.core.nmf import NMFResult, nmf, reconstruction_error
from repro_torch.core.selection import (ModelSelector, SelectionReport,
                                        selection_regret)
from repro_torch.core.task import TaskRegistry, TaskSpec
from repro_torch.core.zoo import (FAMILIES, Task, ZooModel, build_tasks, build_zoo,
                                  linear_probe_accuracy, make_task, pretrain_model,
                                  transfer_matrix)

__all__ = [
    "TaskFeaturizer", "DecisionTreeRegressor", "RandomForestRegressor",
    "RidgeRegressor", "NMFResult", "nmf", "reconstruction_error",
    "ModelSelector", "SelectionReport", "selection_regret", "TaskRegistry",
    "TaskSpec", "FAMILIES", "Task", "ZooModel", "build_tasks", "build_zoo",
    "linear_probe_accuracy", "make_task", "pretrain_model", "transfer_matrix",
]
