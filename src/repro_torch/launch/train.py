"""Training launcher: config -> train loop with checkpoint / restart,
straggler monitoring and metrics logging, on one device.

Port of ``src/repro/launch/train.py``. Runs on the card unless told
otherwise; there is no CPU fallback:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --smoke --device cpu --steps 30 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 4 --batch 8 --seq 4096 --accum 4 --ckpt-every 100

The flags are the reference's plus ``--device`` (default ``cuda``). Only
``--mesh none`` is ported: the host / single / multi meshes wait for the
sharded-LM slice (ROADMAP Queue 1). Weights are random, drawn from seed 0
on the device; batches come from ``SyntheticCorpus`` (numpy) and are moved
to the device each step. A restored checkpoint (host tensors) is moved
back to the device by the step.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.models import build_model
from repro_torch.pipeline.backend import resolve_device
from repro_torch.storage import CheckpointManager
from repro_torch.training import (AdamWState, OptimizerConfig, init_state,
                                  make_train_step)
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


def _to(state, device: torch.device):
    """(params, opt) on ``device``; a restored checkpoint's leaves are host
    arrays or tensors, the others are there already (a no-op)."""
    params, opt = state

    def move(t):
        if isinstance(t, torch.Tensor):
            return t.to(device)
        return torch.from_numpy(np.array(t)).to(device)

    return (tree_map(move, params),
            AdamWState(move(opt.step), tree_map(move, opt.m),
                       tree_map(move, opt.v)))


def _initial_state(model, opt_cfg: OptimizerConfig, device: torch.device):
    """(random params from seed 0 on ``device``, fresh AdamW state)."""
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return params, init_state(params, opt_cfg.opt_dtype)


def train(args: argparse.Namespace) -> TrainRun:
    """The training loop of :func:`main`, for ``parse_args``' flags."""
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: only --mesh none is ported; "
                         "the training meshes wait for the sharded-LM slice "
                         "(ROADMAP Queue 1: models that carry logical axes "
                         "through DTensor)")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    model = build_model(cfg, attn_impl="naive" if args.smoke else "chunked")
    opt_cfg = OptimizerConfig(learning_rate=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.arch_id)

    losses: List[float] = []
    grad_norms: List[float] = []
    step_seconds: List[float] = []
    last: Dict[str, torch.Tensor] = {}

    def one_step(state, step):
        t0 = time.perf_counter()
        params, opt = _to(state, device)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        params, opt, out = step_fn(params, opt, batch)
        losses.append(float(out["loss"]))
        step_seconds.append(time.perf_counter() - t0)
        grad_norms.append(float(out["grad_norm"]))
        last.clear()
        last.update(out)
        if step % args.log_every == 0:
            print(f"step {step}: loss={float(out['loss']):.4f} "
                  f"gnorm={float(out['grad_norm']):.3f} "
                  f"lr={float(out['lr']):.2e}")
        return (params, opt)

    controller = TrainController(one_step, ckpt, ckpt_every=args.ckpt_every,
                                 monitor=StragglerMonitor())
    state = [_initial_state(model, opt_cfg, device)]
    t0 = time.time()
    # popped into the call: the controller holds the initial state's only
    # reference and frees it after the first step
    (params, opt), step = controller.run(state.pop(), args.steps)
    dt = time.time() - t0
    return TrainRun(params, opt, losses, grad_norms, step_seconds, dict(last),
                    controller.events, step, dt)


def main(argv=None) -> int:
    args = parse_args(argv)
    run = train(args)
    tokens = args.steps * args.batch * args.seq
    print(f"done: {run.step} steps in {run.seconds:.1f}s "
          f"({tokens / run.seconds:.0f} tok/s); loss {run.losses[0]:.3f} -> "
          f"{run.losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
