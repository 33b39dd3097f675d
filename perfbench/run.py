"""Run one cell of the benchmark once, on the card this process sees:

    python3 perfbench/run.py --workload danube-train --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``, each number the check compared beside
its limit (also the last lines of standard error). Everything else goes
to standard error. Without a CUDA card, with fewer cards than the cell
asks for, or when a module of the JAX package was loaded, it exits with a
code other than 0 and prints no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# no module of the JAX package, compared by the whole top-level name
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules(names) -> list:
    return sorted({n.split(".")[0] for n in names} & BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of anything the program might compile, at fixed paths inside
    # the checkout; the CUDA kernels build into src/repro_torch/kernels/build
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench import harness
    try:
        chips = harness.cell(args.workload).workload["chips"]
    except FileNotFoundError as e:
        log(f"perfbench: {e}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"perfbench: the cell needs {chips} CUDA card(s); this process "
            f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"perfbench: the program is not here: {e}")
        return 2
    result, _ = harness.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), started=STARTED, log=log)
    found = banned_modules(sys.modules)
    if found:
        log(f"perfbench: modules of the JAX package were loaded: {found}")
        return 3
    for k, v in result["checked"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
