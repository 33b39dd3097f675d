"""Multi-pod dry-run: trace every (arch x shape) on the production meshes
and record memory, cost and collective analyses as JSON.

Port of ``src/repro/launch/dryrun.py``. The reference forces 512 host
devices and lowers and compiles each cell with XLA on the CPU. The port
does the same job with a fake world: where no process group is running,
:func:`lower_cell` starts ``init_process_group("fake")`` over a
``FakeStore`` with the mesh's rank count (256, or 512 for two pods),
builds the production mesh (``repro_torch.launch.mesh``), places fake
params, optimizer state, batch and decode cache on it as DTensors, and
runs the step once on fake tensors (``FakeTensorMode``: shapes and dtypes,
no data, no memory) under the counting modes of
:mod:`repro_torch.analysis`. This process is rank 0: every per-device
number is rank 0's. Importing this module touches no process group.

The model is traced on its plain route, ``build_model(cfg,
use_kernels=False)``, as the reference lowers its XLA path
(``impl="chunked"``) and never its Pallas kernels; the kernel wrappers
refuse fake tensors. Where CUDA is present the fake world's mesh is a
``"cuda"`` one (DTensor then redistributes as NCCL ranks do: expert
parallelism's all-to-all shows); elsewhere it is ``"cpu"``, on which
DTensor stands an all-gather and a chunk for a shard-to-shard move, so an
all-to-all is recorded as all-gathers. The record names the mesh's
device type (``mesh_device``).

The record keeps every key of the reference's (``report.py`` reads
both). What they hold here:

- ``compile_s``: seconds spent tracing;
- ``flops_per_device``: global matmul FLOPs (the counter) / ranks;
- ``hlo_dot_flops_per_device``, ``bytes_accessed_per_device``,
  ``collectives``: rank 0's traced ops (:mod:`~repro_torch.analysis.
  op_cost`): every op's operand and result bytes, unfused;
- ``xla_cost_flops_loop_once``, ``xla_bytes_loop_once``: ``null`` (no XLA
  cost analysis);
- ``memory_analysis``: ``argument_size_in_bytes`` the local bytes of the
  params, optimizer state, batch and cache on rank 0,
  ``output_size_in_bytes`` the same of the outputs,
  ``temp_size_in_bytes`` the peak of the fake allocations live above the
  arguments (``torch.distributed._tools.mem_tracker.MemTracker``), the
  code and alias sizes ``null``;
- ``hlo_bytes``: the count of traced ops; ``loop_trip_counts``: ``[]``;
- ``mesh_device``: the mesh's device type; ``collective_ops``: rank 0's
  collectives by kind, operand shape and dtype (what each term is made
  of; not a reference key).

Usage (records go to ``artifacts/dryrun_torch/``, never to the
reference's ``artifacts/dryrun/``):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.analysis.flops import in_meta_propagation
from repro_torch.analysis.op_cost import OpCostMode
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.distributed.sharding import (axis_rules, rules_for_config,
                                              shard_params)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import dp_size
from repro_torch.models import batch_axes, build_model, input_specs
from repro_torch.training import (OptimizerConfig, init_state,
                                  make_prefill_step, make_serve_step,
                                  make_train_step)
from repro_torch.training.optimizer import tree_map

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

_BF16_OPT = {"llama3-405b", "kimi-k2-1t-a32b"}  # bf16 moments (HBM budget)
_OWN_WORLD = []     # the fake world's size, when this module started it


def _rule_overrides(cfg, shape, mesh):
    """Shape-aware rule tweaks, the reference's.

    Decode shards the KV cache length over 'model' (flash-decode style);
    per-token q-head compute is tiny, so heads are replicated — sharding
    both would force an all-gather of the cache over 'model'.
    """
    ov = {}
    if shape.kind in ("train", "prefill") and cfg.seq_parallel:
        ov["residual_seq"] = ("model",)
    if shape.kind == "decode":
        ov["act_heads"] = None
        ov["act_kv_heads"] = None
        dp = dp_size(mesh)
        if shape.global_batch % dp != 0:  # long_500k: batch 1
            ov["batch"] = None
            ov["cache_seq"] = ("data", "model")
        else:
            ov["cache_seq"] = ("model",)
    return ov


def _ensure_world(ranks: int) -> None:
    """A fake world of ``ranks`` ranks, this process rank 0, unless a
    process group that this module did not start is running."""
    if dist.is_initialized():
        if not _OWN_WORLD or _OWN_WORLD[0] == ranks:
            return
        dist.destroy_process_group()
        _OWN_WORLD.clear()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    _OWN_WORLD.append(ranks)


def _local_bytes(tree) -> int:
    """Bytes of rank 0's share of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _device_total(snapshot) -> int:
    return sum(int(v.get("Total", 0)) for v in snapshot.values())


def _mem_tracker():
    """A ``MemTracker`` that ignores what DTensor's sharding propagator
    runs at global shapes to find an op's output shapes: only this rank's
    own (local) tensors count."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_meta_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _trace(step, args, mesh, rules):
    """Run ``step(*args)`` under the rules and the counting modes: (out,
    OpCost, seconds, temp bytes)."""
    from torch.distributed.tensor import DTensor
    t0 = time.time()
    tracker = _mem_tracker()
    # the arguments' local tensors are live before the step: counted in
    # the base, so the peak above it is the step's own
    tracker.track_external(*[t.to_local() if isinstance(t, DTensor) else t
                             for t in _leaves(args)])
    with axis_rules(rules, mesh=mesh), tracker:
        base = _device_total(tracker.get_tracker_snapshot("current"))
        with OpCostMode() as mode:
            out = step(*args)
        peak = _device_total(tracker.get_tracker_snapshot("peak"))
    return out, mode.cost(), time.time() - t0, max(0, peak - base)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_overrides=None, variant: str = "opt",
               rule_extra=None, cfg_overrides=None):
    """Build, place and trace one cell on fake tensors; returns (record,
    the step's outputs).

    variant='baseline' reproduces the paper-faithful naive implementation
    (f32-upcast decode, replicated KV length) for §Perf before/after;
    '+bf16coll' rounds MoE collectives to bf16, '+sp' shards the residual
    stream's sequence over 'model'.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.attention import set_decode_f32_upcast
    from repro_torch.models.moe import set_moe_bf16_collectives
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    _ensure_world(512 if multi_pod else 256)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    tags = set(variant.split("+"))
    if "baseline" in tags:
        set_decode_f32_upcast(True)
        set_moe_bf16_collectives(False)
        overrides = {}  # naive: cache replicated over 'model'
    else:
        set_decode_f32_upcast(False)
        set_moe_bf16_collectives("bf16coll" in tags)
        overrides = _rule_overrides(cfg, shape, mesh)
        if "sp" in tags:  # sequence-parallel residual stream
            overrides["residual_seq"] = ("model",)
    if rule_extra:
        overrides.update(rule_extra)
    rules = rules_for_config(cfg, multi_pod=multi_pod, overrides=overrides)
    model = build_model(cfg, use_kernels=False)
    opt_cfg = OptimizerConfig(
        opt_dtype="bfloat16" if arch in _BF16_OPT else "float32")
    if opt_overrides:
        opt_cfg = dataclasses.replace(opt_cfg, **opt_overrides)
    dev = torch.device(mesh.device_type)

    def fake(meta):
        return torch.empty(meta.shape, dtype=meta.dtype, device=dev)

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = shard_params(tree_map(fake, model.abstract()), mesh,
                              model.param_axes(), rules)
        batch = {k: shard_params(fake(v), mesh, batch_axes(cfg)[k], rules)
                 for k, v in input_specs(cfg, shape).items()}
        if shape.kind == "train":
            accum = min(cfg.grad_accum,
                        max(1, shape.global_batch // dp_size(mesh)))
            step = make_train_step(model, opt_cfg, accum_steps=accum)
            args = (params, init_state(params, opt_cfg.opt_dtype), batch)
        elif shape.kind == "prefill":
            step = make_prefill_step(model)
            args = (params, batch)
        else:  # decode
            step = make_serve_step(model)
            B = shape.global_batch
            cache = shard_params(
                model.init_cache(B, shape.seq_len, device=dev), mesh,
                model.cache_axes(), rules)
            tok = shard_params(
                torch.zeros((B, 1), dtype=torch.int32, device=dev), mesh,
                ("batch", None), rules)
            args = (params, cache, tok)
        arg_bytes = _local_bytes(args)
        with (torch.no_grad() if shape.kind != "train"
              else contextlib.nullcontext()):
            out, hc, trace_s, temp = _trace(step, args, mesh, rules)
        out_bytes = _local_bytes(out)

    flops_pd = hc.global_flops / chips
    terms = roofline_terms(flops_pd, hc.bytes_accessed,
                           hc.collective_operand_bytes)
    mf = model_flops(cfg, shape, per_device=True, chips=chips)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": chips,
        "compile_s": trace_s,
        "flops_per_device": flops_pd,
        "hlo_dot_flops_per_device": hc.dot_flops,
        "xla_cost_flops_loop_once": None,
        "bytes_accessed_per_device": hc.bytes_accessed,
        "xla_bytes_loop_once": None,
        "collectives": hc.to_dict(),
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": temp,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": None,
        },
        "roofline": terms,
        "model_flops_per_device": mf,
        "useful_flops_ratio": (mf / flops_pd) if flops_pd else None,
        "hlo_bytes": hc.ops,
        "loop_trip_counts": hc.loop_trip_counts[:32],
        "mesh_device": mesh.device_type,
        "collective_ops": hc.collective_ops,
    }
    return rec, out


def run_cell(arch, shape_name, multi_pod, out_dir: Path, tag: str = ""):
    key = f"{arch}/{shape_name}/{'multi' if multi_pod else 'single'}"
    out = out_dir / ("multi" if multi_pod else "single") / arch
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{shape_name}{tag}.json"
    try:
        rec, _ = lower_cell(arch, shape_name, multi_pod)
        print(rec["memory_analysis"])
        print({k: rec["collectives"][k] for k in ("collective_counts",
                                                   "total_collective_bytes")})
        path.write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        print(f"OK  {key}: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
              f"dominant={r['dominant']} "
              f"useful={rec['useful_flops_ratio'] and rec['useful_flops_ratio']:.3f} "
              f"(trace {rec['compile_s']:.0f}s)")
        return True
    except Exception as e:
        traceback.print_exc()
        path.with_suffix(".err").write_text(
            f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
        print(f"FAIL {key}: {type(e).__name__}: {e}")
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    archs = [args.arch] if args.arch else list_archs()
    for mp in meshes:           # one fake world size at a time
        for a in archs:
            cfg = get_config(a)
            shapes = ([args.shape] if args.shape
                      else [s.name for s in shapes_for(cfg)])
            for s in shapes:
                cells.append((a, s, mp))

    ok = fail = skip = 0
    for a, s, mp in cells:
        p = (out_dir / ("multi" if mp else "single") / a / f"{s}.json")
        if args.skip_existing and p.exists():
            skip += 1
            continue
        if run_cell(a, s, mp, out_dir):
            ok += 1
        else:
            fail += 1
    print(f"done: ok={ok} fail={fail} skipped={skip}")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
