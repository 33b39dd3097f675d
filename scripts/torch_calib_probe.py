"""Fit the card's per-row embed cost at several probe sizes, to choose the
row counts that the session's fast calibration gives ``"cuda"``.

    python scripts/torch_calib_probe.py [--runs 3]

For each pair of row counts it runs the cost model's two-point fit
(``repro_torch.pipeline.cost._fit_per_row``, one timed call a size, as the
session's fast calibration calls it) through a fresh
``TorchBackend(device="cuda")`` ``--runs`` times, and prints the per-row
seconds, the per-call (launch) seconds and the ``flops_per_s`` they give.
A slope at the 1e-12 s clamp means the two sizes took the same time: the
pair does not resolve the per-row cost. The card's name and power limit
come first. Needs CUDA; exits 2 without it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

PAIRS = ((64, 512), (1 << 12, 1 << 15), (1 << 14, 1 << 17),
         (1 << 15, 1 << 18))
DIM, WIDTH = 32, 64             # calibrate()'s synthetic embedder


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_calib_probe: needs CUDA", file=sys.stderr)
        return 2
    from repro_torch.pipeline.backend import TorchBackend
    from repro_torch.pipeline.cost import _fit_per_row

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    flops_per_row = 2.0 * DIM * WIDTH + WIDTH
    for lo, hi in PAIRS:
        for run in range(args.runs):
            per_row, launch = _fit_per_row(
                TorchBackend(device="cuda"), "cuda", dim=DIM, width=WIDTH,
                rows=(lo, hi), repeats=1, seed=run)
            print(f"calib rows=({lo}, {hi}) run {run}: per_row "
                  f"{per_row:.4e} s, launch {launch:.4e} s, flops_per_s "
                  f"{flops_per_row / per_row:.4e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
