"""Task-centric interface (paper §2.1, Table 1): CREATE TASK / PREDICT.

``TaskRegistry`` is the declarative layer: users register high-level tasks
(input type, output labels, kind) and the system resolves each task to a
model via the two-phase selector + catalog, caching resolutions.

Port of ``src/repro/core/task.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class TaskSpec:
    name: str                       # e.g. "sentiment_classifier"
    input_type: str                 # text | image | series
    output_labels: tuple            # e.g. ("POS", "NEG", "NEU")
    kind: str = "classification"    # classification | regression
    constraints: Dict[str, Any] = field(default_factory=dict, hash=False)


class TaskRegistry:
    """CREATE TASK / REGISTER TASK / PREDICT <task> resolution."""

    def __init__(self, selector=None, zoo: Optional[list] = None):
        self.selector = selector
        self.zoo = zoo or []
        self._tasks: Dict[str, TaskSpec] = {}
        self._resolution: Dict[str, int] = {}       # task -> zoo index

    def create_task(self, spec: TaskSpec) -> None:
        if spec.name in self._tasks:
            raise ValueError(f"task {spec.name} already exists")
        self._tasks[spec.name] = spec

    def drop_task(self, name: str) -> None:
        self._tasks.pop(name, None)
        self._resolution.pop(name, None)

    def get(self, name: str) -> TaskSpec:
        return self._tasks[name]

    def list_tasks(self) -> List[TaskSpec]:
        return list(self._tasks.values())

    def resolve(self, name: str, X: np.ndarray, y: np.ndarray,
                force: bool = False) -> int:
        """Select the model for a task from sample data (cached)."""
        if name not in self._tasks:
            raise KeyError(f"unknown task {name}; CREATE TASK first")
        if not force and name in self._resolution:
            return self._resolution[name]
        if self.selector is None:
            raise RuntimeError("no selector attached")
        rep = self.selector.select(X, y)
        self._resolution[name] = rep.chosen
        return rep.chosen

    def predict_fn(self, name: str) -> Callable:
        """Returns the resolved model's inference callable for the DAG."""
        idx = self._resolution.get(name)
        if idx is None:
            raise RuntimeError(f"task {name} not resolved yet")
        model = self.zoo[idx]

        def fn(X: np.ndarray) -> np.ndarray:
            return model.features(np.asarray(X, np.float32))

        return fn
