"""Parameter specs: one source of truth for shapes, init and logical axes.

Port of ``src/repro/models/spec.py``. Each model family builds a nested
dict of ``P`` specs; :func:`init_params` materializes tensors on a device
from an explicit ``torch.Generator``. ``torch`` and ``jax.random`` give
different numbers from one seed, so parity with the reference goes
through :func:`repro_torch.convert.lm_params_from_numpy`, not through init.
:func:`axes_tree` gives the logical-axes tree that places each param on a
device mesh (``repro_torch.distributed.sharding.shard_params``), and
:func:`abstract_params` gives ``meta`` tensors, the port's
``ShapeDtypeStruct``: shape and dtype, no storage.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed | small
    dtype: Optional[str] = None  # default: cfg.param_dtype
    fan_in: Optional[int] = None  # override for scaled init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def tree_map_specs(fn, specs):
    """Apply ``fn`` to every ``P`` of a nested dict of specs."""
    if isinstance(specs, P):
        return fn(specs)
    return {k: tree_map_specs(fn, v) for k, v in specs.items()}


def _make(spec: P, gen: torch.Generator, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    def normal():
        return torch.randn(spec.shape, generator=gen, device=device,
                           dtype=torch.float32)

    def uniform(lo, hi):
        u = torch.rand(spec.shape, generator=gen, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("small", "embed"):
        return normal().to(dtype) * 0.02
    if spec.init == "rglru_a":
        # A parameter: softplus^-1 of decay in [0.9, 0.999]
        a = -0.5 * torch.log(uniform(0.9, 0.999))
        return torch.log(torch.expm1(torch.clamp(a / 8.0, min=1e-6))).to(dtype)
    if spec.init == "mamba_alog":
        return torch.log(uniform(1.0, 16.0)).to(dtype)
    if spec.init == "mamba_dt":
        dt0 = torch.exp(uniform(0.0, 1.0) * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
        return (dt0 + torch.log(-torch.expm1(-dt0))).to(dtype)  # inv softplus
    # fan-in scaled normal
    fan = spec.fan_in if spec.fan_in else (spec.shape[0] if spec.shape else 1)
    return (normal() / math.sqrt(max(fan, 1))).to(dtype)


def init_params(specs, gen: torch.Generator, default_dtype: str = "float32",
                device=None):
    """Materialize parameter tensors from the spec tree, drawing from
    ``gen`` on ``device`` (default: the generator's device), leaves in
    sorted key order."""
    device = torch.device(device) if device is not None else gen.device

    def walk(node):
        if isinstance(node, P):
            return _make(node, gen, DTYPES[node.dtype or default_dtype],
                         device)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(specs)


def abstract_params(specs, default_dtype: str = "float32"):
    """``meta`` tensors of each spec's shape and dtype (no allocation)."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype or default_dtype],
                              device="meta"), specs)


def axes_tree(specs):
    """Tree of logical-axes tuples, matching the params tree."""
    return tree_map_specs(lambda s: s.axes, specs)


def stack_specs(spec: P, n: int, axis_name: str = "layers") -> P:
    """Add a leading stacked-layers dimension to a spec."""
    return P((n,) + spec.shape, (axis_name,) + spec.axes,
             init=spec.init, dtype=spec.dtype,
             fan_in=spec.fan_in or (spec.shape[0] if spec.shape else None))


def stack_tree(specs, n: int):
    return tree_map_specs(lambda s: stack_specs(s, n), specs)
