"""Time the port's rmsnorm and fused_embed kernels on one NVIDIA GPU by the
card's own time a call, for a parent-against-change comparison of two
checkouts on one card.

    python scripts/torch_norm_embed_probe.py --tag new [--rounds 2]

``rmsnorm`` in bf16 at the serving path's decode (32 x 2560) and prefill
(16384 x 2560) shapes and at 4096 x 16384 (llama3-405b's width), beside
``F.rms_norm`` on the same inputs; ``fused_embed`` in f32 at the SQL
path's 256-row chunk (D 16, K 33), at 2^20 rows and at one row. Each call
is first held against its plain version (2e-5 f32; one bf16 ulp of the
value plus 2e-2 in bf16), then timed under ``torch.profiler``: the
kernels' device time over the calls, a call's share. One line a shape,
tagged ``--tag``, with the card's name and power limit first.

It imports the ``repro_torch`` under ``./src`` of the working directory,
so running it from the root of another checkout measures that checkout:
for an A/B, run it from each tree in turns (parent, new, new, parent) in
one run on one card. Needs CUDA; exits 2 without it.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd() / "src"))

BF16_RTOL = 2.0 ** -7
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def device_ms(fn, reps: int) -> float:
    """Kernel time a call under ``torch.profiler`` (kernel events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def held(got, want, dtype) -> float:
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel = BF16_RTOL * w.abs() if dtype == torch.bfloat16 else 0.0
    if not bool((diff - rel <= TOL[dtype]).all()):
        raise AssertionError(f"kernel differs from its plain version by "
                             f"{float(diff.max())}")
    return float(diff.max())


def probe(tag: str, rounds: int) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import _build, fused_embed, rmsnorm
    from repro_torch.kernels.ref import fused_embed_ref, rmsnorm_ref
    _build.build_all()
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(0)
    for n, d in ((32, 2560), (16384, 2560), (4096, 16384)):
        x = torch.randn((n, d), generator=g).to(dev, bf)
        w = (torch.randn((d,), generator=g) * 0.1).to(dev, bf)
        w1 = (1.0 + w.float()).to(bf)
        err = held(rmsnorm(x, w), rmsnorm_ref(x, w), bf)
        reps = 200 if n * d < 1 << 20 else 50
        for r in range(rounds):
            k = device_ms(lambda: rmsnorm(x, w), reps)
            lib = device_ms(lambda: F.rms_norm(x, (d,), w1, 1e-6), reps)
            print(f"{tag} round {r} rmsnorm bf16 {n}x{d}: device_ms {k:.5f}"
                  f" F.rms_norm {lib:.5f} err {err:.3e}", flush=True)
        del x
    for n, d, k_ in ((256, 16, 33), (1 << 20, 16, 33), (1, 16, 8)):
        x = torch.randn((n, d), generator=g).to(dev)
        w = (torch.randn((d, k_), generator=g) * 0.05).to(dev)
        err = held(fused_embed(x, w), fused_embed_ref(x, w), torch.float32)
        reps = 50 if n > 4096 else 400
        for r in range(rounds):
            t = device_ms(lambda: fused_embed(x, w), reps)
            print(f"{tag} round {r} fused_embed f32 {n}x{d}x{k_}: device_ms "
                  f"{t:.5f} err {err:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_embed_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{args.tag} card: {smi}", flush=True)
    probe(args.tag, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
