"""Logical-axis sharding rules (MaxText-style).

Model code names tensor dims with *logical* axes ("batch", "embed",
"q_heads", ...). A rule table maps logical names to physical mesh axes.
Rules are installed with the ``axis_rules`` context manager.

FSDP+TP layout:
  - params' embed dim            -> fsdp axes ("data",) or ("pod","data")
  - heads / mlp / vocab /experts -> "model" (TP / EP)
  - activations' batch           -> ("data",) or ("pod","data")

A spec is a :class:`PartitionSpec`, the port's own tuple type: entry i
names the mesh axis (or tuple of axes, major first) that tensor dim i
splits over, ``None`` for a replicated dim. Its entries equal the
reference's ``tuple(jax.sharding.PartitionSpec)`` for the same axes and
rules. :func:`to_placements` turns a spec into the DTensor ``Placement``
of each mesh dim (``Shard(d)`` / ``Replicate()``); it is pure, so it needs
no process group.

Left out of the port: ``lshard`` (a sharding constraint inside the model:
it waits for models that carry logical axes, in the sharded-LM slice),
and ``axis_size`` / ``shard_map``, which bridge jax versions; a port
caller reads a group's size with ``torch.distributed.get_world_size``.

Port of ``src/repro/distributed/sharding.py``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

AxisVal = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def _current() -> Optional[Dict[str, AxisVal]]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, AxisVal], mesh=None):
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_r
        _state.mesh = prev_m


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

def make_rules(*, multi_pod: bool = False,
               shard_attn_heads: bool = True,
               fsdp: bool = True,
               overrides: Optional[Dict[str, AxisVal]] = None) -> Dict[str, AxisVal]:
    """Default logical->physical table for the production meshes."""
    dp: AxisVal = ("pod", "data") if multi_pod else ("data",)
    fs: AxisVal = dp if fsdp else None
    rules: Dict[str, AxisVal] = {
        # --- parameters -----------------------------------------------
        "embed": fs,           # FSDP: shard d_model dim of weights over data
        "q_heads": "model" if shard_attn_heads else None,
        "kv_heads": None,      # kv heads in {1,8,16} -> replicated under TP=16
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",    # EP
        "expert_embed": fs,    # FSDP dim of expert weights (gathered in block)
        "expert_mlp": None,
        "rnn": "model",        # RG-LRU width TP (elementwise recurrence)
        "ssm_heads": "model",  # mamba heads TP
        "ssm_state": None,
        "conv": None,
        "layers": None,        # scan axis, never sharded
        # --- activations ----------------------------------------------
        "batch": dp,
        "seq": None,
        "cache_seq": None,   # decode overrides: ('model',) flash-decode
        # sequence-parallel residual stream: shard the seq dim of the
        # residual over 'model' between TP blocks. Off by default.
        "residual_seq": None,
        "act_embed": None,
        "act_heads": "model" if shard_attn_heads else None,
        "act_kv_heads": None,
        "act_mlp": "model",
        "act_vocab": "model",
        "act_rnn": "model",
        "act_ssm_heads": "model",
    }
    if overrides:
        rules.update(overrides)
    return rules


def rules_for_config(cfg, *, multi_pod: bool = False,
                     overrides: Optional[Dict[str, AxisVal]] = None) -> Dict[str, AxisVal]:
    return make_rules(multi_pod=multi_pod,
                      shard_attn_heads=cfg.shard_attn_heads,
                      overrides=overrides)


SERVING_MESH_AXES: Tuple[str, ...] = ("data",)


def serving_rules(overrides: Optional[Dict[str, AxisVal]] = None
                  ) -> Dict[str, AxisVal]:
    """Logical->physical table for the *serving* mesh (a 1-D "data" axis
    over the inference devices). Trunk embed is data-parallel: activation
    batches split over "data" while every weight axis stays replicated —
    the trunks the zoo serves are small enough that staging one copy per
    device is cheaper than cross-device weight gathers on the hot path.
    """
    rules: Dict[str, AxisVal] = {
        # trunk weights: replicated (staged once per device)
        "embed": None,          # input width dim of W / centers
        "mlp": None,            # output width dim of W
        "vocab": None,
        # activations: rows split across the mesh
        "batch": ("data",),
        "act_embed": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


def serving_batch_sharding(mesh) -> Tuple:
    """Placements of a [rows, width] activation batch on the serving
    mesh: rows split over "data"."""
    return named_sharding(mesh, ("batch", "act_embed"), serving_rules())


def serving_weight_sharding(mesh, ndim: int) -> Tuple:
    """Placements of a staged weight tensor (any rank): replicated."""
    axes = ("embed", "mlp")[:ndim] if ndim <= 2 else (None,) * ndim
    return named_sharding(mesh, axes, serving_rules())


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """Per tensor dim: the mesh axis, a tuple of axes (major first), or
    ``None`` (replicated). Trailing ``None``s are trimmed by
    :func:`to_pspec`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def to_pspec(axes: Sequence[Optional[str]],
             rules: Optional[Dict[str, AxisVal]] = None) -> PartitionSpec:
    """Logical axes tuple -> PartitionSpec under the active rules."""
    rules = rules if rules is not None else (_current() or {})
    parts = []
    used: set = set()
    for name in axes:
        val = rules.get(name) if name is not None else None
        # one mesh axis may appear only once in a spec
        if val is None:
            parts.append(None)
            continue
        vals = (val,) if isinstance(val, str) else tuple(val)
        vals = tuple(v for v in vals if v not in used)
        used.update(vals)
        if not vals:
            parts.append(None)
        elif len(vals) == 1:
            parts.append(vals[0])
        else:
            parts.append(vals)
    # trim trailing Nones for tidiness
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def to_placements(axes: Sequence[Optional[str]],
                  rules: Dict[str, AxisVal],
                  mesh_dim_names: Sequence[str]) -> Tuple:
    """The DTensor placement of each mesh dim for a tensor with logical
    ``axes``: ``Shard(d)`` where the spec splits tensor dim d over that
    mesh dim, else ``Replicate()``. A dim split over several mesh axes
    takes them major first, which DTensor expresses only in mesh order."""
    names = tuple(mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, part in enumerate(to_pspec(axes, rules)):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else part
        missing = [a for a in group if a not in names]
        if missing:
            raise ValueError(f"axes {tuple(axes)}: mesh axes {missing} are "
                             f"not in the mesh {names}")
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"axes {tuple(axes)}: {group} is not in the "
                             f"mesh's order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return tuple(placements)


def named_sharding(mesh, axes: Sequence[Optional[str]],
                   rules: Dict[str, AxisVal]) -> Tuple:
    """:func:`to_placements` over ``mesh``'s dim names (a ``DeviceMesh``
    or a serving mesh)."""
    return to_placements(axes, rules, mesh.mesh_dim_names)


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(a is None or isinstance(a, str)
                                        for a in v)


def _map_axes(fn, tree):
    """``fn`` over every logical-axes tuple of nested dicts, lists and
    tuples (an axes tuple is a leaf, as in the reference's tree map)."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_axes(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return tree


def tree_pspecs(axes_tree, rules: Dict[str, AxisVal]):
    """Map a tree of logical-axes tuples to PartitionSpecs."""
    return _map_axes(lambda axes: to_pspec(axes, rules), axes_tree)


def tree_shardings(mesh, axes_tree, rules: Dict[str, AxisVal]):
    """Map a tree of logical-axes tuples to ``mesh``'s placements."""
    return _map_axes(lambda axes: named_sharding(mesh, axes, rules),
                     axes_tree)
