"""Process-group helpers for the ``repro_torch.distributed`` tests.

``run_group`` starts ``world`` spawned processes, each in a gloo group
over a ``FileStore`` in a scratch directory, runs ``fn(rank, world,
*args)`` in each and returns each rank's result. The whole group has one
deadline: a rank still running past it is killed and the call raises, so
a hang fails one test instead of the suite. This module imports only
torch and ``repro_torch``: the spawned ranks never load jax.
"""
from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _entry(fn, rank, world, root, timeout, args):
    torch.set_num_threads(1)
    root = Path(root)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(root / "store"), world),
            rank=rank, world_size=world, timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, root / f"out{rank}.pt")
    except BaseException:
        (root / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def run_group(fn, world: int, root, *args, timeout: float = 60.0):
    """[rank 0's result, ..., rank world-1's]; raises if a rank fails or
    the group outlives ``timeout`` seconds."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(root), timeout, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still running after "
                           f"{timeout} s")
    errs = {r: (root / f"err{r}.txt").read_text() for r in range(world)
            if (root / f"err{r}.txt").exists()}
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if errs or bad:
        raise RuntimeError(f"ranks {bad} failed: {errs}")
    return [torch.load(root / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# -- the ranks' work ---------------------------------------------------------

def compress_and_mesh(rank, world, grads):
    """``grads``: {name: [world, ...] float32}; this rank takes row
    ``rank``. Returns the compressed and plain reductions, the residuals
    and the host mesh's sizes."""
    from repro_torch.distributed import (compressed_all_reduce,
                                         init_ef_state, named_sharding,
                                         make_rules)
    from repro_torch.launch.mesh import (dp_size, make_host_mesh,
                                         make_production_mesh, tp_size)

    g = {k: torch.from_numpy(np.ascontiguousarray(v[rank]))
         for k, v in grads.items()}
    ef = init_ef_state(g)
    red, ef2 = compressed_all_reduce(g, ef)
    red2, ef3 = compressed_all_reduce(g, ef, enabled=False)
    mesh = make_host_mesh(world, 1)
    try:
        make_production_mesh()
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"red": {k: v.numpy() for k, v in red.items()},
            "resid": {k: v.numpy() for k, v in ef2.residual.items()},
            "plain": {k: v.numpy() for k, v in red2.items()},
            "plain_ef_kept": ef3 is ef,
            "dp": dp_size(mesh), "tp": tp_size(mesh),
            "names": tuple(mesh.mesh_dim_names),
            "mesh_shape": tuple(mesh.shape),
            "placements": named_sharding(mesh, ("batch", "embed"),
                                         make_rules()),
            "refused": refused}


def _stage_fn(W, x):
    """One stage: ``len(W)`` layers of ``tanh(h @ w)``."""
    for w in W:
        x = torch.tanh(x @ w)
    return x


def gpipe(rank, world, Ws, x):
    """Ws: [S, L, D, D] (this rank's stage is row ``rank``); x: [M, mb, D].
    Returns the pipelined outputs and d(sum of them)/d(this rank's W)."""
    from repro_torch.distributed import make_pipelined_fn

    W = torch.from_numpy(np.ascontiguousarray(Ws[rank])).requires_grad_()
    f = make_pipelined_fn(_stage_fn, None)
    out = f(W, torch.from_numpy(x))
    out.sum().backward()
    return {"out": out.detach().numpy(), "grad": W.grad.numpy()}


def one_rank_compress(rank, world, g):
    from repro_torch.distributed import compressed_all_reduce, init_ef_state

    ef = init_ef_state(g)
    red, ef2 = compressed_all_reduce(g, ef)
    plain, _ = compressed_all_reduce(g, ef, enabled=False)
    return {"red": red, "resid": ef2.residual, "plain": plain}


def hang(rank, world):
    """Rank 0 waits in a barrier that rank 1 never reaches."""
    if rank == 0:
        dist.barrier()
    else:
        time.sleep(600)
