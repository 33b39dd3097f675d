"""Drive the multi-device tier across every visible GPU: what one card
cannot show.

    python scripts/torch_multi_gpu_probe.py [--rows 1048576] [--seed 0]

1. ``MeshTorchBackend`` over every visible GPU against a single-device
   ``TorchBackend`` on ``cuda:0``, on a ``--rows`` x 16 float32 table
   (the SQL path's) in 2^16-row chunks and in one call, in all four
   trunk modes: features within 1e-5, the linear mode's ``fused_embed``
   launches exactly GPUs x calls, wall seconds in turns (single, mesh,
   mesh, single).
2. A ``torch.distributed`` NCCL world of one spawned rank a GPU over a
   ``FileStore``: ``compressed_all_reduce`` of seeded per-rank gradients
   against the exact mean (error and residual within 1.5 max|g| / 127,
   uncompressed within 1e-6), and ``gpipe_apply`` with one stage a GPU
   (2 layers of D 256 a stage, 8 microbatches of 4) against the
   sequential run: forward within 1e-5, each stage's gradient within 1e-4
   of its max. The group is killed after 120 s.

Prints the card's name and power limit first and one JSON line last.
Needs two or more GPUs; exits 2 otherwise.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

CHUNK = 1 << 16
GROUP_TIMEOUT_S = 120.0
D, L_PER, M, MB = 256, 2, 8, 4


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _models(seed: int):
    from repro_torch.core.zoo import ZooModel
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((16, 33)) * 0.3).astype(np.float32)
    out = {m: ZooModel(name=m, source_family="gauss", W=W, mode=m)
           for m in ("linear", "relu", "proj1d")}
    out["radial"] = ZooModel(
        name="radial", source_family="ring", W=W, mode="radial",
        centers=rng.standard_normal((12, 16)).astype(np.float32), sigma=1.3)
    return out


def _run(backend, zm, X, chunk):
    """(features, wall seconds, fused_embed launches) of X in ``chunk``-row
    calls, after staging and one warm-up call."""
    from repro_torch.kernels.fused_embed import fused_embed
    from repro_torch.pipeline.backend import InferSpec
    from repro_torch.pipeline.batcher import BatcherStats
    spec = InferSpec(kind="embed", task="t", col="x", out="f", table="m",
                     version=zm.mode, model=SimpleNamespace(zoo_model=zm),
                     stats=BatcherStats())
    backend.stage(zm.mode, zm)
    backend.run_infer(spec, {"x": X[:chunk]})
    backend.synchronize()
    fused_embed.launch_count = 0
    t0 = time.perf_counter()
    out = np.concatenate([backend.run_infer(spec, {"x": X[i:i + chunk]})["f"]
                          for i in range(0, len(X), chunk)])
    backend.synchronize()
    return out, time.perf_counter() - t0, fused_embed.launch_count


def mesh_backend(rows: int, seed: int, device_type: str = "cuda"):
    from repro_torch.pipeline.backend import MeshTorchBackend, TorchBackend
    mesh = MeshTorchBackend(device=device_type)
    single = TorchBackend(device=device_type)
    n = mesh.device_count
    X = np.random.default_rng(seed).standard_normal((rows, 16)).astype(
        np.float32)
    res = {}
    for mode, zm in _models(seed).items():
        for chunk in (CHUNK, rows):
            calls = -(-rows // chunk)
            s1, ts1, _ = _run(single, zm, X, chunk)
            m1, tm1, lm = _run(mesh, zm, X, chunk)
            m2, tm2, _ = _run(mesh, zm, X, chunk)
            s2, ts2, ls = _run(single, zm, X, chunk)
            want = n * calls if mode == "linear" else 0
            _check(lm == want, f"{mode} chunk {chunk}: {lm} launches, not "
                   f"{want}")
            _check(ls == (calls if mode == "linear" else 0),
                   f"{mode}: single launched {ls}")
            err = float(np.abs(m1 - s1).max())
            _check(err <= 1e-5 and np.array_equal(m1, m2)
                   and np.array_equal(s1, s2), f"{mode}: mesh vs single {err}")
            res[f"{mode}@{chunk}"] = {
                "single_s": [ts1, ts2], "mesh_s": [tm1, tm2],
                "launches": lm, "max_abs_err": err}
            print(f"mesh {n} GPUs {mode} {rows} rows in {calls} calls: mesh "
                  f"{tm1:.4f}/{tm2:.4f} s, single {ts1:.4f}/{ts2:.4f} s, "
                  f"launches {lm}, max abs diff {err:.3e}", flush=True)
    return {"gpus": n, "devices": [str(d) for d in mesh.mesh.devices],
            "runs": res}


# -- the NCCL world ------------------------------------------------------------

def _stage(W, h):
    for w in W:
        h = torch.tanh(h @ w)
    return h


def _rank(rank, world, root, seed, device_type):
    from repro_torch.distributed import (compressed_all_reduce, gpipe_apply,
                                         init_ef_state)
    root = Path(root)
    try:
        nccl = device_type == "cuda"
        dev = torch.device(device_type, rank if nccl else 0)
        if nccl:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if nccl else "gloo",
            store=dist.FileStore(str(root / "store"), world), rank=rank,
            world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S),
            device_id=dev if nccl else None)
        try:
            rng = np.random.default_rng(seed)
            g_all = {"w": rng.standard_normal((world, 4096, 64)),
                     "b": rng.standard_normal((world, 16)) * 5}
            g = {k: torch.tensor(v[rank], dtype=torch.float32, device=dev)
                 for k, v in g_all.items()}
            t0 = time.perf_counter()
            red, ef = compressed_all_reduce(g, init_ef_state(g))
            if nccl:
                torch.cuda.synchronize(dev)
            c_secs = time.perf_counter() - t0
            plain, _ = compressed_all_reduce(g, ef, enabled=False)
            out = {"compress_s": c_secs}
            for k, v in g_all.items():
                exact = v.astype(np.float32).mean(axis=0)
                bound = float(np.abs(v.astype(np.float32)).max()) / 127.0
                err = float(np.abs(red[k].cpu().numpy() - exact).max())
                res = float(ef.residual[k].abs().max())
                p_err = float(np.abs(plain[k].cpu().numpy() - exact).max())
                _check(err <= 1.5 * bound and res <= 1.5 * bound
                       and p_err < 1e-6, f"rank {rank} {k}: err {err}, "
                       f"residual {res}, plain {p_err}, bound {bound}")
                out[k] = {"err": err, "residual": res, "plain_err": p_err,
                          "bound": bound}

            Ws = (rng.standard_normal((world, L_PER, D, D))
                  * (0.5 / D ** 0.5)).astype(np.float32)
            x = torch.tensor(rng.standard_normal((M, MB, D)),
                             dtype=torch.float32, device=dev)
            W = torch.tensor(Ws[rank], device=dev).requires_grad_()
            t0 = time.perf_counter()
            y = gpipe_apply(_stage, W, x)
            y.sum().backward()
            if nccl:
                torch.cuda.synchronize(dev)
            p_secs = time.perf_counter() - t0
            Wall = torch.tensor(Ws, device=dev).requires_grad_()
            h = x.reshape(M * MB, D)
            for s in range(world):
                h = _stage(Wall[s], h)
            h.reshape(M, MB, D).sum().backward()
            f_err = float((y.detach() - h.detach().reshape(M, MB, D))
                          .abs().max())
            g_ref = Wall.grad[rank]
            g_err = float((W.grad - g_ref).abs().max())
            g_max = float(g_ref.abs().max())
            _check(f_err <= 1e-5 and g_err <= 1e-4 * max(g_max, 1.0),
                   f"rank {rank} gpipe: forward {f_err}, grads {g_err} of "
                   f"{g_max}")
            out["gpipe"] = {"s": p_secs, "forward_err": f_err,
                            "grad_err": g_err, "grad_max": g_max}
        finally:
            dist.destroy_process_group()
        (root / f"out{rank}.json").write_text(json.dumps(out))
    except BaseException:
        (root / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def nccl_world(world: int, seed: int, device_type: str = "cuda"):
    with tempfile.TemporaryDirectory(prefix="nccl-world-") as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank,
                             args=(r, world, tmp, seed, device_type))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        root = Path(tmp)
        errs = {r: (root / f"err{r}.txt").read_text() for r in range(world)
                if (root / f"err{r}.txt").exists()}
        _check(not hung and not errs
               and all(p.exitcode == 0 for p in procs),
               f"NCCL world: hung ranks {hung}, errors {errs}")
        ranks = [json.loads((root / f"out{r}.json").read_text())
                 for r in range(world)]
    for r, o in enumerate(ranks):
        print(f"nccl rank {r} of {world}: compressed all-reduce "
              f"{o['compress_s']:.4f} s (w err {o['w']['err']:.3e}, bound "
              f"{o['w']['bound']:.3e}); gpipe {o['gpipe']['s']:.4f} s, "
              f"forward {o['gpipe']['forward_err']:.3e}, grads "
              f"{o['gpipe']['grad_err']:.3e} of {o['gpipe']['grad_max']:.3e}",
              flush=True)
    return ranks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_multi_gpu_probe: needs two or more GPUs",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    from repro_torch.kernels import _build
    _build.build_all()
    out = {"nvidia_smi": smi, "mesh": mesh_backend(args.rows, args.seed),
           "nccl": nccl_world(torch.cuda.device_count(), args.seed)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
