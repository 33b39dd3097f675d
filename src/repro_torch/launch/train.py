"""Training launcher: config -> mesh -> sharded train loop with
checkpoint / restart, straggler monitoring and metrics logging.

Port of ``src/repro/launch/train.py``. Runs on the card unless told
otherwise; there is no CPU fallback:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --smoke --device cpu --steps 30 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 4 --batch 8 --seq 4096 --accum 4 --ckpt-every 100
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch h2o-danube-1.8b --mesh host --steps 4 --batch 8 --seq 4096

The flags are the reference's plus ``--device`` (default ``cuda``).
``--mesh host|single|multi`` trains on a ``("data", "model")`` (or
``("pod", "data", "model")``) device mesh over the process group: the one
``torchrun`` describes in the environment (``WORLD_SIZE``; each rank on
``cuda:LOCAL_RANK``), or else a world of one rank started here (NCCL on
the card, gloo on the CPU), or one the caller started already. ``host`` is
``make_host_mesh(max(1, n // 2), min(2, n))`` over n ranks; ``single`` and
``multi`` are the production meshes and need 256 and 512 ranks. Params,
optimizer state and batches are DTensors placed by
``rules_for_config(cfg)`` (the reference's in / out shardings), and the
step runs under ``axis_rules``. Checkpoints hold whole values: every rank
gathers, rank 0 writes.

Weights are random, drawn from seed 0 on the device (the same on every
rank, then sharded); batches come from ``SyntheticCorpus`` (numpy) and are
moved to the device each step. A restored checkpoint (host tensors) is
moved back to the device, and onto the mesh, by the step.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.distributed.sharding import (axis_rules, rules_for_config,
                                              tree_shardings)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import batch_axes, build_model
from repro_torch.pipeline.backend import resolve_device
from repro_torch.storage import CheckpointManager
from repro_torch.storage.stores import flatten_params, unflatten_like
from repro_torch.training import (AdamWState, OptimizerConfig, init_state,
                                  make_train_step, state_axes)
from repro_torch.training.fault import StragglerMonitor, TrainController
from repro_torch.training.optimizer import tree_map


class TrainRun(NamedTuple):
    """What :func:`train` ends with: the final params and optimizer state;
    each step's loss, grad norm and host seconds (from the step's start to
    its loss read back, which waits for the device); the last step's
    metrics; the controller's events; the step reached and the loop's wall
    seconds."""
    params: Any
    opt: AdamWState
    losses: List[float]
    grad_norms: List[float]
    step_seconds: List[float]
    metrics: Dict[str, torch.Tensor]
    events: List[Tuple[str, dict]]
    step: int
    seconds: float


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", choices=["none", "host", "single", "multi"],
                    default="none")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    return ap.parse_args(argv)


def _to(state, device: torch.device, plc=None):
    """(params, opt) on ``device``; a restored checkpoint's leaves are host
    arrays or tensors, the others are there already (a no-op). With
    ``plc`` (the (params, opt) placements on ``mesh``) a whole leaf is
    placed on the mesh; a DTensor stays as it is."""
    params, opt = state

    def move(t):
        if isinstance(t, DTensor):
            return t
        if isinstance(t, torch.Tensor):
            return t.to(device)
        return torch.from_numpy(np.array(t)).to(device)

    if plc is None:
        return (tree_map(move, params),
                AdamWState(move(opt.step), tree_map(move, opt.m),
                           tree_map(move, opt.v)))
    mesh, (pp, op) = plc

    def place(t, pl):
        t = move(t)
        return t if isinstance(t, DTensor) else \
            distribute_tensor(t, mesh, pl, src_data_rank=None)

    return (tree_map(place, params, pp),
            AdamWState(move(opt.step), tree_map(place, opt.m, op.m),
                       tree_map(place, opt.v, op.v)))


def _initial_state(model, opt_cfg: OptimizerConfig, device: torch.device,
                   plc=None):
    """(random params from seed 0 on ``device``, placed on the mesh with
    ``plc``; fresh AdamW state like them)."""
    params = model.init(torch.Generator(device=device).manual_seed(0))
    if plc is not None:
        mesh, (pp, _) = plc
        params = tree_map(lambda t, pl: distribute_tensor(
            t, mesh, pl, src_data_rank=None), params, pp)
    return params, init_state(params, opt_cfg.opt_dtype)


class _GatheredCheckpoints(CheckpointManager):
    """Checkpoints of a sharded run: every rank gathers each DTensor leaf
    whole (a collective) and rank 0 writes it, before any rank goes on."""

    def save_async(self, step: int, state, *, num_shards: int = 1) -> None:
        flat = {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in flatten_params(state).items()}
        if dist.get_rank() == 0:
            self.save(step, unflatten_like(state, flat),
                      num_shards=num_shards)
        dist.barrier()


def _start_world(device: torch.device) -> bool:
    """Start the process group unless one is up: from ``torchrun``'s
    environment when ``WORLD_SIZE`` is set, else a world of one rank (NCCL
    for a CUDA device, bound to it; gloo on the CPU). True if started
    here."""
    if dist.is_initialized():
        return False
    if device.type == "cuda":
        kw = {"backend": "nccl", "device_id": device}
    else:
        kw = {"backend": "gloo"}
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(**kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return True


def _mesh_for(kind: str):
    if kind == "host":
        n = dist.get_world_size()
        return make_host_mesh(max(1, n // 2), min(2, n))
    return make_production_mesh(multi_pod=kind == "multi")


def _device(args) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` for ``--device cuda`` under
    a mesh, else ``--device`` as given."""
    device = resolve_device(args.device)
    if args.mesh != "none" and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def train(args: argparse.Namespace) -> TrainRun:
    """The training loop of :func:`main`, for ``parse_args``' flags."""
    device = _device(args)
    started = args.mesh != "none" and _start_world(device)
    try:
        return _train(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, device: torch.device) -> TrainRun:
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, attn_impl="naive" if args.smoke else "chunked")
    opt_cfg = OptimizerConfig(learning_rate=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    root = Path(args.ckpt_dir) / cfg.arch_id

    mesh = plc = b_plc = None
    ctx = contextlib.nullcontext()
    ckpt = CheckpointManager(root)
    if args.mesh != "none":
        mesh = _mesh_for(args.mesh)
        rules = rules_for_config(cfg)
        axes = model.param_axes()
        plc = (mesh, (tree_shardings(mesh, axes, rules),
                      tree_shardings(mesh, state_axes(axes), rules)))
        b_plc = tree_shardings(mesh, batch_axes(cfg), rules)
        ctx = axis_rules(rules, mesh=mesh)
        ckpt = _GatheredCheckpoints(root)

    def to_batch(k: str, v: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(v).to(device)
        if mesh is None:
            return t
        return distribute_tensor(t, mesh, b_plc[k], src_data_rank=None)

    losses: List[float] = []
    grad_norms: List[float] = []
    step_seconds: List[float] = []
    last: Dict[str, torch.Tensor] = {}

    def one_step(state, step):
        t0 = time.perf_counter()
        params, opt = _to(state, device, plc)
        batch = {k: to_batch(k, v) for k, v in data.batch(step).items()}
        params, opt, out = step_fn(params, opt, batch)
        losses.append(_scalar(out["loss"]))
        step_seconds.append(time.perf_counter() - t0)
        grad_norms.append(_scalar(out["grad_norm"]))
        last.clear()
        last.update(out)
        if step % args.log_every == 0 and _rank() == 0:
            print(f"step {step}: loss={losses[-1]:.4f} "
                  f"gnorm={grad_norms[-1]:.3f} "
                  f"lr={_scalar(out['lr']):.2e}")
        return (params, opt)

    with ctx:
        controller = TrainController(one_step, ckpt,
                                     ckpt_every=args.ckpt_every,
                                     monitor=StragglerMonitor())
        state = [_initial_state(model, opt_cfg, device, plc)]
        t0 = time.time()
        # popped into the call: the controller holds the initial state's
        # only reference and frees it after the first step
        (params, opt), step = controller.run(state.pop(), args.steps)
        dt = time.time() - t0
    return TrainRun(params, opt, losses, grad_norms, step_seconds, dict(last),
                    controller.events, step, dt)


def _scalar(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _rank() -> int:
    """This process's rank: the group's, or ``torchrun``'s once the group
    this launcher started is gone."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def main(argv=None) -> int:
    args = parse_args(argv)
    run = train(args)
    tokens = args.steps * args.batch * args.seq
    if _rank() == 0:
        print(f"done: {run.step} steps in {run.seconds:.1f}s "
              f"({tokens / run.seconds:.0f} tok/s); loss "
              f"{run.losses[0]:.3f} -> {run.losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
