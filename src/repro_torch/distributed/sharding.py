"""Logical-axis sharding rules (MaxText-style).

Model code names tensor dims with *logical* axes ("batch", "embed",
"q_heads", ...). A rule table maps logical names to physical mesh axes.
Rules are installed with the ``axis_rules`` context manager; when no rules
are active (single-device runs) every annotation is a no-op.

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

DTensor stands where the reference has GSPMD: a sharded param is a
``DTensor`` (:func:`shard_params`), plain torch ops propagate its
placements, and :func:`lshard` (the reference's sharding constraint)
redistributes an activation to its logical axes' placements. Under
``axis_rules(rules, mesh=DeviceMesh)`` a plain tensor that meets a DTensor
counts as replicated (DTensor's ``implicit_replication``): the positions,
masks and constants the model builds on every rank are the same on each.
:func:`shard_map` stands where the reference has ``shard_map``: it runs a
function on each rank's local shards through DTensor's ``local_map``.

Port of ``src/repro/distributed/sharding.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

AxisVal = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def _current() -> Optional[Dict[str, AxisVal]]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> Optional[Dict[str, AxisVal]]:
    """The rules installed by the innermost :func:`axis_rules` (None
    outside one)."""
    return _current()


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


@contextlib.contextmanager
def _installed(rules, mesh):
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_r
        _state.mesh = prev_m


@contextlib.contextmanager
def axis_rules(rules: Dict[str, AxisVal], mesh=None):
    """Install ``rules`` (and ``mesh``) for the block, in this thread. With
    a ``DeviceMesh``, plain tensors mixed with DTensors count as
    replicated inside it (entered once, by the outermost such block)."""
    outer = not _is_device_mesh(current_mesh())
    with _installed(rules, mesh), contextlib.ExitStack() as stack:
        if _is_device_mesh(mesh) and outer:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
        yield


def carry_rules(fn: Callable) -> Callable:
    """``fn`` run under the rules and mesh current where this is called,
    in whatever thread calls it: a remat recompute runs in autograd's
    device thread, and must place its tensors as the forward did. The
    recompute runs inside the backward, under the autograd node whose
    saved tensor it rebuilds, so while the counting modes are active
    (:func:`track_shard_bodies`) ``fn`` is marked as forward work
    (:func:`in_replayed_forward`): an op of it belongs to a
    :func:`shard_map` body only if it runs in one."""
    rules, mesh = _current(), current_mesh()
    if rules is None:
        return fn

    def run(*args, **kwargs):
        with _installed(rules, mesh), _replaying():
            return fn(*args, **kwargs)
    return run


def axis_size(axis_name: str, mesh=None) -> int:
    """The size of mesh axis ``axis_name`` of ``mesh`` (default: the
    current mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError(f"axis_size({axis_name!r}): no mesh is current")
    names = tuple(mesh.mesh_dim_names)
    if axis_name not in names:
        raise ValueError(f"axis {axis_name!r} is not in the mesh {names}")
    return int(mesh.shape[names.index(axis_name)])


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
    """``fn`` over every logical-axes tuple of nested dicts, lists, tuples
    and dataclasses (a decode state; an axes tuple is a leaf, as in the
    reference's tree map)."""
    if _is_axes(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_axes(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
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


# ---------------------------------------------------------------------------
# DTensor: annotation, sharded params, shard-local functions
# ---------------------------------------------------------------------------

def lshard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axes: a DTensor under
    ``axis_rules`` with a ``DeviceMesh`` is redistributed to the axes'
    placements (a ``Partial`` sum is reduced on the way); anything else is
    returned as it is, as the reference's is without rules."""
    rules = _current()
    if rules is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"lshard: axes {axes} vs rank {x.ndim}")
    mesh = current_mesh()
    if not isinstance(x, DTensor) or not _is_device_mesh(mesh):
        return x
    want = to_placements(axes, rules, mesh.mesh_dim_names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def spec_placements(mesh, spec: Sequence,
                    partial: Sequence[str] = ()) -> Tuple:
    """The placements of a tensor split as the physical ``spec`` says
    (entry i: the mesh axis, or axes major first, that dim i splits over,
    or ``None``) and holding a partial sum over the mesh axes ``partial``:
    ``Shard(d)``, ``Partial()`` or ``Replicate()`` a mesh dim."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else part or ()):
            if a in names:
                out[names.index(a)] = Shard(d)
    for a in partial:
        if a in names:
            out[names.index(a)] = Partial()
    return tuple(out)


# Counting modes (repro_torch.analysis) that attribute the work of a
# shard-local body to the ranks: how many are active, and the distinct
# shards of the body running in this thread (0 outside one).
_TRACKING = [0]


@contextlib.contextmanager
def track_shard_bodies():
    """While active, :func:`shard_map` marks what its bodies do: in the
    forward :func:`shard_body_size` is the body's count of distinct pieces
    of work (:func:`distinct_shards`), and every autograd node a body
    creates carries it as ``metadata["shards"]``, so a counter sees how
    many ranks run a backward op's distinct work."""
    _TRACKING[0] += 1
    try:
        yield
    finally:
        _TRACKING[0] -= 1


def shard_body_size() -> int:
    """The count of distinct pieces of work (:func:`distinct_shards`) of
    the :func:`shard_map` body running in this thread while
    :func:`track_shard_bodies` is active, else 0."""
    return getattr(_state, "body", 0)


@contextlib.contextmanager
def _replaying():
    """Marks the block as a remat unit's forward work while the counting
    modes are active (see :func:`carry_rules`)."""
    if not _TRACKING[0]:
        yield
        return
    prev = getattr(_state, "replay", 0)
    _state.replay = prev + 1
    try:
        yield
    finally:
        _state.replay = prev


def in_replayed_forward() -> bool:
    """Whether a remat unit's replay (:func:`carry_rules`) is running in
    this thread while the counting modes are active."""
    return getattr(_state, "replay", 0) > 0


def _tag_body_nodes(outputs, inputs, size: int) -> None:
    """``metadata["shards"] = size`` on every autograd node between a
    body's outputs and its inputs."""
    stop = {t.grad_fn for t in inputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    outs = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
    todo = [t.grad_fn for t in outs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen:
            continue
        seen.add(node)
        node.metadata["shards"] = size
        todo.extend(fn for fn, _ in node.next_functions)


def _tracked(f: Callable, size: int) -> Callable:
    def body(*args, **kwargs):
        if not _TRACKING[0]:
            return f(*args, **kwargs)
        prev = getattr(_state, "body", 0)
        _state.body = size
        try:
            out = f(*args, **kwargs)
        finally:
            _state.body = prev
        if torch.is_grad_enabled():
            _tag_body_nodes(out, args, size)
        return out
    return body


def _is_placements(spec) -> bool:
    """One placement tuple (a spec), not a tuple of them."""
    return all(isinstance(p, Placement) for p in spec)


def distinct_shards(mesh, in_specs) -> int:
    """How many distinct pieces of work a :func:`shard_map` body with
    ``in_specs`` does over ``mesh``: the product of the sizes of the mesh
    dims along which some input is split (or a partial sum). Along a dim
    where every input is replicated each rank repeats the same work, which
    is one piece of the global program, as the reference's jaxpr count has
    it (its compiled step repeats such work too, e.g. gemma-2b's attention
    over ``"model"``). A body whose work depends on the rank's place along
    a dim takes an input split along it."""
    n = 1
    for i in range(mesh.ndim):
        if any(spec is not None and not isinstance(spec[i], Replicate)
               for spec in in_specs):
            n *= mesh.size(i)
    return n


def shard_map(f: Callable, *, mesh, in_specs, out_specs,
              in_grad_specs=None) -> Callable:
    """``f`` run on each rank's local shards: the reference's
    ``shard_map`` through DTensor's ``local_map``. Each spec is a tuple of
    placements, one a mesh dim (:func:`spec_placements` builds one from
    mesh axes), or ``None`` for an argument that is not a tensor;
    ``out_specs`` is one spec, or a tuple of them when ``f`` returns a
    tuple. DTensor arguments are redistributed to ``in_specs`` first;
    ``f``'s outputs become DTensors of ``out_specs``. ``in_grad_specs``
    gives the placements of an input's local gradient where it differs
    from the input's (``None`` where it does not): a replicated input
    whose local gradient is a partial sum, for one."""
    from torch.distributed.tensor.experimental import local_map

    grads = None if in_grad_specs is None else tuple(
        i if g is None else g for g, i in zip(in_grad_specs, in_specs))
    # local_map reads a tuple as one placement list an output
    outs = list(out_specs) if _is_placements(out_specs) else out_specs
    return local_map(_tracked(f, distinct_shards(mesh, in_specs)),
                     out_placements=outs,
                     in_placements=tuple(in_specs),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def shard_params(tree, mesh, axes_tree, rules: Dict[str, AxisVal]):
    """Every tensor leaf of ``tree`` (nested dicts, or a decode state's
    dataclasses, of full tensors, the same on every rank) as a DTensor
    with the placements of its logical axes in ``axes_tree``: each rank
    keeps its own shard, no data moves; where its shard is the whole
    tensor (no split over a mesh dim of more than one rank) the DTensor
    wraps the tensor itself. Other leaves (a decode state's index, an
    absent cache) stay as they are."""
    plc = tree_shardings(mesh, axes_tree, rules)

    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(t[k], pl[k]) for k in t}
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: walk(getattr(t, f.name), getattr(pl, f.name))
                for f in dataclasses.fields(t)})
        if not isinstance(t, torch.Tensor):
            return t
        if all(mesh.size(i) == 1 for i, p in enumerate(pl)
               if isinstance(p, Shard)):
            # this rank's shard is the whole tensor: no copy (a 32 GB
            # cache on one card is placed where it lies)
            return DTensor.from_local(t, mesh, pl, run_check=False)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return walk(tree, plc)
