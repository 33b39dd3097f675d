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
from torch.utils._python_dispatch import TorchDispatchMode


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


# -- the sharded LM ----------------------------------------------------------

def _counting(calls, layers, attn):
    """Route the model's rmsnorm and flash calls through their
    ``autograd.Function``s (the plain version on the CPU), counting calls
    in ``calls``; returns a function that undoes it."""
    import importlib
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    fl = importlib.import_module("repro_torch.kernels.flash_attention")
    old = layers.rmsnorm_kernel, attn.flash_attention

    def norm(x, w, eps):
        assert not hasattr(x, "device_mesh"), "a DTensor reached rmsnorm"
        calls["rmsnorm"] += 1
        return rms.RMSNormFunction.apply(x, w, eps)

    def flash(q, k, v, causal, window):
        assert not hasattr(q, "device_mesh"), "a DTensor reached flash"
        calls["flash_attention"] += 1
        return fl.FlashAttentionFunction.apply(q, k, v, causal, window)

    layers.rmsnorm_kernel, attn.flash_attention = norm, flash

    def undo():
        layers.rmsnorm_kernel, attn.flash_attention = old
    return undo


class LocalShapes(TorchDispatchMode):
    """A dispatch mode that records the shape of every tensor each op
    outputs on this rank's local tensors (a DTensor op is let through, and
    its local pieces come back to the mode)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def vocab_split(mesh, logits_np, labels_np, mask_np, table_np, tokens_np,
                ct_np):
    """The cross entropy of vocab-split logits (rows split over "data",
    vocab over "model") and the lookup of a vocab-split table, their values
    and gradients, and every local tensor shape the ranks' ops made."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.models import layers

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    out = {}
    rows, whole_model = (Shard(0), Shard(2)), (Shard(0), Replicate())
    with axis_rules(make_rules(), mesh=mesh):
        lg = distribute_tensor(torch.from_numpy(logits_np), mesh, rows,
                               src_data_rank=None).requires_grad_()
        lab = distribute_tensor(torch.from_numpy(labels_np), mesh,
                                whole_model, src_data_rank=None)
        for name, mask in (("ce", None), ("ce_masked", mask_np)):
            mk = None if mask is None else distribute_tensor(
                torch.from_numpy(mask), mesh, whole_model,
                src_data_rank=None)
            with LocalShapes() as mode:
                loss = layers.cross_entropy(lg, lab, mk)
                g, = torch.autograd.grad(loss, [lg])
            out[name] = {"loss": float(whole(loss)), "grad": whole(g),
                         "shapes": mode.shapes}
        tab = distribute_tensor(torch.from_numpy(table_np), mesh,
                                (Shard(1), Shard(0)),
                                src_data_rank=None).requires_grad_()
        with LocalShapes() as mode:
            x = layers._sharded_lookup(tab, torch.from_numpy(tokens_np))
            g, = torch.autograd.grad((x * torch.from_numpy(ct_np)).sum(),
                                     [tab])
        out["lookup"] = {"x": whole(x), "grad": whole(g),
                         "grad_placements": tuple(g.placements),
                         "shapes": mode.shapes}
    return out


def family_steps(mesh_of, cases):
    """One sharded train step of each ``cases[arch] = (cfg overrides of
    the smoke config, mesh shape, params as numpy, tokens)``: (loss, whole
    params), the gradients the step updates with (each redistributed to
    its param's placements, as the step does, then made whole) and what
    each rank's core took as input (SSD heads, RG-LRU width, attention
    rows and heads)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed.sharding import (axis_rules, shard_params,
                                                  rules_for_config,
                                                  tree_shardings)
    from repro_torch.models import attention, batch_axes, build_model
    from repro_torch.models import mamba2, rglru
    from repro_torch.training import (OptimizerConfig, init_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.step import _loss_and_grads

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    out = {}
    for arch, (ov, shape, params_np, tokens) in cases.items():
        cfg = smoke_config(arch).replace(**ov)
        m = build_model(cfg, attn_impl="naive")
        mesh = mesh_of(shape)
        rules = rules_for_config(cfg)
        seen = _CoreInputs(attention, mamba2, rglru)
        try:
            params = lm_params_from_numpy(params_np)
            step = make_train_step(m, OptimizerConfig(learning_rate=1e-3))
            with axis_rules(rules, mesh=mesh):
                sp = shard_params(params, mesh, m.param_axes(), rules)
                bp = tree_shardings(mesh, batch_axes(cfg), rules)
                sb = {"tokens": distribute_tensor(
                    torch.from_numpy(tokens), mesh, bp["tokens"],
                    src_data_rank=None)}
                p1, _, m1 = step(sp, init_state(sp), sb)
                grads = iter(_loss_and_grads(m, sp, sb)[2])
                grads = tree_map(lambda _: whole(next(grads)), sp)
        finally:
            seen.undo()
        out[arch] = {"loss": float(whole(m1["loss"])),
                     "params": tree_map(whole, p1), "grads": grads,
                     "inputs": seen.shapes}
    return out


class _CoreInputs:
    """Records the local shapes the shard-local cores take:
    ``ssd_chunked`` (x [b, S, h, P]), ``linear_scan`` (a [b, S, w]) and
    ``attend`` (q [b, S, h, D]), patched in their modules for the block."""

    def __init__(self, attention, mamba2, rglru):
        self.shapes = {"ssd": [], "scan": [], "attend": []}
        self._old = []
        for mod, name, key, pos in ((mamba2, "ssd_chunked", "ssd", 0),
                                    (rglru, "linear_scan", "scan", 0),
                                    (attention, "attend", "attend", 1)):
            fn = getattr(mod, name)
            self._old.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, key, pos))

    def _wrap(self, fn, key, pos):
        def run(*a, **k):
            if not hasattr(a[pos], "device_mesh"):
                self.shapes[key].append(tuple(a[pos].shape))
            return fn(*a, **k)
        return run

    def undo(self):
        for mod, name, fn in self._old:
            setattr(mod, name, fn)


def sharded_lm(rank, world, arch, layers_n, params_np, tokens, moe_np, x_moe,
               ct_moe, launcher_argv, vocab_np, family_cases):
    """Every sharded-LM case on one 4-rank world; rank 0's view of each
    result (whole values, as numpy)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed.sharding import (axis_rules, make_rules,
                                                  shard_params,
                                                  tree_shardings)
    from repro_torch.launch import train as launcher
    from repro_torch.models import attention as attn
    from repro_torch.models import batch_axes, build_model, layers
    from repro_torch.models import moe
    from repro_torch.training import (OptimizerConfig, init_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_map

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    out = {}

    def mesh_of(shape):
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    mesh = mesh_of((2, 2))
    rules = make_rules(shard_attn_heads=True)
    out["vocab"] = vocab_split(mesh, *vocab_np)
    out["family_steps"] = family_steps(mesh_of, family_cases)
    cfg = smoke_config(arch).replace(num_layers=layers_n)
    batch = {"tokens": torch.from_numpy(tokens)}
    for route in ("plain", "kernels", "remat"):
        c = cfg.replace(remat_policy="full") if route == "remat" else cfg
        m = build_model(c, attn_impl="naive",
                        use_kernels=route != "plain")
        calls = {"rmsnorm": 0, "flash_attention": 0}
        undo = _counting(calls, layers, attn) if route == "kernels" else None
        try:
            params = lm_params_from_numpy(params_np)
            step = make_train_step(m, OptimizerConfig(learning_rate=1e-3))
            with axis_rules(rules, mesh=mesh):
                sp = shard_params(params, mesh, m.param_axes(), rules)
                bp = tree_shardings(mesh, batch_axes(c), rules)
                sb = {k: distribute_tensor(v, mesh, bp[k], src_data_rank=None)
                      for k, v in batch.items()}
                p1, o1, m1 = step(sp, init_state(sp), sb)
            mesh_calls = dict(calls)
            for k in calls:
                calls[k] = 0
            q1, _, n1 = step(params, init_state(params), batch)
        finally:
            if undo:
                undo()
        out[route] = {
            "loss": float(whole(m1["loss"])), "gnorm": float(
                whole(m1["grad_norm"])),
            "params": tree_map(whole, p1),
            "placed": all(p.placements == s.placements for p, s in zip(
                _leaves(p1), _leaves(sp))),
            "moments_placed": all(p.placements == s.placements for p, s in
                                  zip(_leaves(o1.m), _leaves(sp))),
            "off_loss": float(n1["loss"]), "off_params": tree_map(whole, q1),
            "calls": mesh_calls, "off_calls": dict(calls)}

    # every other family: one step on the mesh against the step off it
    out["families"] = {}
    rng = np.random.default_rng(7)
    for fam in FAMILY_ARCHS:
        c = smoke_config(fam)
        m = build_model(c, attn_impl="naive")
        params = m.init(torch.Generator().manual_seed(0))
        fb = {"tokens": torch.from_numpy(rng.integers(0, c.vocab_size,
                                                      (4, 32)))}
        if c.is_encoder_decoder:
            fb["frames"] = torch.from_numpy(rng.standard_normal(
                (4, 32, c.d_model)).astype(np.float32))
        step = make_train_step(m, OptimizerConfig(learning_rate=1e-3))
        q1, _, n1 = step(params, init_state(params), fb)
        fr = make_rules(shard_attn_heads=c.shard_attn_heads)
        with axis_rules(fr, mesh=mesh):
            sp = shard_params(params, mesh, m.param_axes(), fr)
            bp = tree_shardings(mesh, batch_axes(c), fr)
            sb = {k: distribute_tensor(v, mesh, bp[k], src_data_rank=None)
                  for k, v in fb.items()}
            p1, _, m1 = step(sp, init_state(sp), sb)
        out["families"][fam] = {
            "loss": float(whole(m1["loss"])), "off_loss": float(n1["loss"]),
            "gap": max(float(np.abs(whole(a) - whole(b)).max())
                       for a, b in zip(_leaves(p1), _leaves(q1)))}

    # expert parallel MoE: forward against moe_dense, gradient against the
    # single-device gradient of the same function
    mcfg = smoke_config("olmoe-1b-7b")
    for shape in ((1, 4), (2, 2)):
        em = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        plc = {"x": (Shard(0), Replicate()), "router": (Replicate(),) * 2,
               "wi": (Shard(1), Shard(0)), "wg": (Shard(1), Shard(0)),
               "wo": (Shard(2), Shard(0))}
        p = {k: distribute_tensor(torch.from_numpy(v), em, plc[k],
                                  src_data_rank=None).requires_grad_()
             for k, v in moe_np.items()}
        x = distribute_tensor(torch.from_numpy(x_moe), em, plc["x"],
                              src_data_rank=None).requires_grad_()
        with axis_rules(rules, mesh=em):
            y, aux = moe.moe_apply(mcfg, p, x, mesh=em)
            loss = (y * torch.from_numpy(ct_moe)).sum() + 3.0 * aux
            grads = torch.autograd.grad(loss, [x] + [p[k] for k in
                                                     sorted(p)])
        out[f"ep{shape}"] = {"y": whole(y), "aux": float(whole(aux)),
                             "y_placements": tuple(y.placements),
                             "grads": [whole(g) for g in grads]}

    # the launcher on the host mesh of this world
    run = launcher.train(launcher.parse_args(launcher_argv + ["--mesh",
                                                              "host"]))
    out["launcher"] = {"losses": run.losses,
                       "mesh": tuple(run.params["final_norm"].device_mesh
                                     .shape)}
    return out


FAMILY_ARCHS = ("gemma-2b", "olmoe-1b-7b", "mamba2-370m",
                "recurrentgemma-9b", "whisper-medium")


def _leaves(tree):
    from repro_torch.training.optimizer import tree_leaves
    return tree_leaves(tree)


def lshard_cases(rank, world):
    """``lshard`` on DTensors over a (world, 1) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.sharding import (axis_rules, lshard,
                                                  make_rules)
    mesh = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.ones(2, 3, 4), mesh,
                           (Replicate(), Replicate()))
    h = DTensor.from_local(torch.ones(2, 3, 4, 5), mesh,
                           (Replicate(), Replicate()))
    part = DTensor.from_local(torch.full((2, 4), 6.0 / world), mesh,
                              (Partial(), Replicate()))
    out = {"no_rules_same": lshard(x, "batch", "seq", "act_embed") is x}
    with axis_rules(make_rules(), mesh=mesh):
        out["embed"] = tuple(lshard(x, "batch", "seq",
                                    "act_embed").placements)
        out["heads"] = tuple(lshard(h, "batch", "seq", "act_heads",
                                    None).placements)
        red = lshard(part, "batch", "act_embed")
        out["partial_reduced"] = tuple(red.placements)
        out["partial_value"] = float(red.full_tensor()[0, 0])
        try:
            lshard(x, "batch")
            out["rank_error"] = ""
        except ValueError as e:
            out["rank_error"] = str(e)
    return out


def unstack_cases(rank, world, archs):
    """For each arch and each mesh of the world's ranks, (world, 1) and
    (1, world): whether ``unstack`` gave every layer's piece of every
    stacked DTensor leaf its leaf's placements (a ``Shard`` one tensor dim
    lower) and its local slice, and the largest gap between the train
    step's gradients (remat ``"full"``) on the mesh and off it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import (axis_rules, shard_params,
                                                  rules_for_config,
                                                  tree_shardings)
    from repro_torch.models import batch_axes, build_model
    from repro_torch.models.transformer import unstack
    from repro_torch.training.step import _loss_and_grads

    def stacks(tree):
        for k in ("layers", "enc_layers", "dec_layers"):
            if k in tree:
                yield tree[k]
        yield from tree.get("cycles", {}).values()

    def lower(p):
        return Shard(p.dim - 1) if isinstance(p, Shard) else p

    out = {}
    rng = np.random.default_rng(13)
    for arch in archs:
        cfg = smoke_config(arch).replace(remat_policy="full")
        m = build_model(cfg, attn_impl="naive")
        params = m.init(torch.Generator().manual_seed(0))
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 32)))}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (4, 32, cfg.d_model)).astype(np.float32))
        want = [g.numpy() for g in _loss_and_grads(m, params, batch)[2]]
        rules = rules_for_config(cfg)
        for shape in ((world, 1), (1, world)):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            with axis_rules(rules, mesh=mesh):
                sp = shard_params(params, mesh, m.param_axes(), rules)
                placed, split = True, 0
                for tree in stacks(sp):
                    n = _leaves(tree)[0].shape[0]
                    for i, layer in enumerate(unstack(tree, n)):
                        for leaf, piece in zip(_leaves(tree),
                                               _leaves(layer)):
                            split += any(isinstance(p, Shard)
                                         for p in leaf.placements)
                            placed &= (
                                isinstance(piece, DTensor)
                                and Shard(0) not in leaf.placements
                                and piece.placements == tuple(
                                    lower(p) for p in leaf.placements)
                                and torch.equal(piece.to_local(),
                                                leaf.to_local()[i]))
                bp = tree_shardings(mesh, batch_axes(cfg), rules)
                sb = {k: distribute_tensor(v, mesh, bp[k],
                                           src_data_rank=None)
                      for k, v in batch.items()}
                got = _loss_and_grads(m, sp, sb)[2]
            out[(arch, shape)] = {
                "placed": placed, "split": split,
                "grad_gap": max(float(np.abs(g.full_tensor().numpy()
                                             - w).max())
                                for g, w in zip(got, want))}
    return out


def moe_one_rank(rank, world, cfgs, p_np, x_np):
    """``moe_apply`` for each config on a (1, 1) mesh (the EP branch), and
    with a serving mesh that has no "model" axis (the local path)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed.sharding import axis_rules, make_rules
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.models import moe

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    p, x = lm_params_from_numpy(p_np), torch.from_numpy(x_np)
    out = {}
    for name, cfg in cfgs.items():
        with axis_rules(make_rules(), mesh=mesh):
            y, aux = moe.moe_apply(cfg, p, x, mesh=mesh)
        ys, auxs = moe.moe_apply(cfg, p, x,
                                 mesh=ServingMesh((torch.device("cpu"),)))
        whole = [t.full_tensor() if hasattr(t, "full_tensor") else t
                 for t in (y, aux)]
        out[name] = {"y": whole[0].numpy(), "aux": float(whole[1]),
                     "dtensor": type(y).__name__,
                     "serving_y": ys.numpy(), "serving_aux": float(auxs)}
    return out


# -- the sharded decode step -------------------------------------------------

DECODE_ARCHS = ("h2o-danube-1.8b", "recurrentgemma-9b", "mamba2-370m",
                "whisper-medium")
DECODE_STEPS = 6


def decode_rules(cfg, mesh):
    """The reference dry-run's decode rules (``cache_seq`` over
    ``"model"``, heads replicated) on ``mesh``."""
    from repro_torch.distributed.sharding import rules_for_config
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import _rule_overrides
    return rules_for_config(cfg, overrides=_rule_overrides(
        cfg, SHAPES["decode_32k"], mesh))


def sharded_decode(rank, world, inputs, max_len, use_kernels):
    """Each family's smoke model decodes ``DECODE_STEPS`` greedy steps
    after an off-mesh prefill, on a (2, 2) mesh with the decode rules and
    off it; rank 0's view of the tokens, logits and final caches of
    both (whole values, as numpy), and each rank's slice of the caches.
    ``inputs``: arch -> (numpy params, prompt tokens [B, S], encoder
    frames or None)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed.sharding import axis_rules, shard_params
    from repro_torch.models import build_model
    from repro_torch.training import make_serve_step

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    def caches(state):
        if hasattr(state, "self_kv"):
            return [state.self_kv.k, state.self_kv.v, state.cross_k]
        out = [state.kv.k, state.kv.v] if state.kv is not None else []
        return out + [t for t in (state.conv, state.rec) if t is not None]

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in DECODE_ARCHS:
        cfg = smoke_config(arch)
        m = build_model(cfg, attn_impl="naive", use_kernels=use_kernels)
        params_np, toks, frames = inputs[arch]
        params = lm_params_from_numpy(params_np)
        inp = torch.from_numpy(toks)
        if frames is not None:
            inp = {"tokens": inp, "frames": torch.from_numpy(frames)}
        step = make_serve_step(m)
        rules = decode_rules(cfg, mesh)
        runs = {}
        for where in ("off", "mesh"):
            with torch.no_grad():
                logits, state = m.prefill(params, inp, max_len=max_len)
                nxt = logits[:, -1:].argmax(-1)
                ctx = axis_rules(rules, mesh=mesh) if where == "mesh" else None
                p = params
                if ctx is not None:
                    ctx.__enter__()
                    p = shard_params(params, mesh, m.param_axes(), rules)
                    state = shard_params(state, mesh, m.cache_axes(), rules)
                got = []
                try:
                    for _ in range(DECODE_STEPS):
                        nxt, state = step(p, state, nxt)
                        got.append(whole(nxt))
                    last, _ = m.decode_step(p, state, nxt)
                finally:
                    if ctx is not None:
                        ctx.__exit__(None, None, None)
            runs[where] = {
                "tokens": np.concatenate(got, axis=1),
                "logits": whole(last), "index": state.index,
                "caches": [whole(c) for c in caches(state)],
                "local": [c.to_local().shape if isinstance(c, DTensor)
                          else None for c in caches(state)]}
        out[arch] = runs
    return out
