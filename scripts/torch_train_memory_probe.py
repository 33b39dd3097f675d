"""Device memory of one training step of the port, phase by phase (card
only).

    PYTHONPATH=src python scripts/torch_train_memory_probe.py \\
        [--arch h2o-danube-1.8b] [--batch 8] [--seq 4096] [--accum 4]

Builds the bf16 model with random weights (seed 0) and a fresh AdamW
state, then runs what ``make_train_step`` runs, one phase at a time: the
first micro-batch's forward (graph held) and backward, the float32
gradient sums, each further micro-batch, and ``apply_updates``. After each
phase it prints the allocated and peak device memory since the last
phase (``torch.cuda.max_memory_allocated`` after a reset) and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GIB = 2 ** 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--accum", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_memory_probe: needs a CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import OptimizerConfig, init_state
    from repro_torch.training.optimizer import (apply_updates, tree_leaves,
                                                tree_map)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())

    def phase(tag: str) -> None:
        torch.cuda.synchronize()
        print(f"{tag}: allocated {torch.cuda.memory_allocated() / GIB:.2f} "
              f"GiB, peak {torch.cuda.max_memory_allocated() / GIB:.2f} GiB",
              flush=True)
        torch.cuda.reset_peak_memory_stats()

    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = init_state(params)
    phase(f"{args.arch} params + AdamW state")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq))).to(dev)
    rows = args.batch // args.accum
    gsum = None
    for i in range(args.accum):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss(tracked, {"tokens": toks[i * rows:(i + 1) * rows]})
        if i == 0:
            phase(f"micro-batch 0 forward ({rows} x {args.seq}, graph held)")
        grads = torch.autograd.grad(loss, tree_leaves(tracked))
        del loss, tracked
        if gsum is None:
            phase("micro-batch 0 backward")
            gsum = [g.float() for g in grads]
            del grads
            phase("float32 gradient sums")
        else:
            for a, g in zip(gsum, grads):
                a.add_(g.float())
            del grads
            phase(f"micro-batch {i} forward + backward, summed")
    it = iter(g.div_(args.accum) for g in gsum)
    grad_tree = tree_map(lambda p: next(it), params)
    t0 = time.perf_counter()
    apply_updates(OptimizerConfig(), params, grad_tree, opt)
    torch.cuda.synchronize()
    phase(f"apply_updates ({time.perf_counter() - t0:.3f} s, new params "
          "and moments beside the old)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
