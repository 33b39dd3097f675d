"""The readings that the limits of ``perfbench/limits/<workload>.json``
are set from, on the card, in one process: the program's compared numbers
on each seed, the control's (the reference in float8) on the first
``--control`` of them, and for a train cell the number that a step over
half of the batch gives (the mean taken over the rest) on those seeds:

    python3 perfbench/calibrate.py --workload danube-score --seconds 5 \
        --seeds 11,12,13 --control 3

One JSON line a run on standard output: on a control seed ``correct`` is
the control's, held to the limits by the harness's own check, and
``readings`` hold the program's numbers and the control's. Not part of a
benchmark run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The train step's micro-batches cut from the first half of the
    batch's rows only: half of the batch left out, the mean taken over the
    rest."""
    from repro_torch.training import step
    whole = step._micro_batches

    def halved(batch, n):
        rows = next(iter(batch.values())).shape[0] // 2
        return whole({k: v[:rows] for k, v in batch.items()}, n)

    step._micro_batches = halved
    try:
        yield
    finally:
        step._micro_batches = whole


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()
    train = harness.cell(args.workload).mix["kind"] == "train"

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    def one(seed, control, fault=None):
        t = time.perf_counter()
        with (half_batch() if fault else contextlib.nullcontext()):
            res, readings = harness.run(args.workload, seed, args.seconds,
                                        False, started=t, control=control,
                                        log=log)
        print(json.dumps({"seed": seed, "fault": fault,
                          "correct": res["correct"], "readings": readings,
                          "metrics": res["metrics"],
                          "peak": res["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        one(seed, i < args.control)
        if train and i < args.control:
            one(seed, False, fault="half_batch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
