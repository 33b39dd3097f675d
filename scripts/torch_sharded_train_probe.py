"""Drive the sharded LM across four cards: what a (1, 1) mesh cannot show.

    torchrun --nproc-per-node 4 scripts/torch_sharded_train_probe.py [--seed 0]

(``python -m torch.distributed.run`` where ``torchrun`` is not on the
PATH.) One NCCL rank a card, on the (2, 2) ``("data", "model")`` mesh the
training launcher's ``--mesh host`` builds over four ranks:

1. h2o-danube-1.8b at full width, 2 layers, float32, B 2 x 1024: one
   train step on the mesh (params placed by their logical axes, FSDP over
   ``data``, heads / MLP / vocab over ``model``; GQA's kv heads cut to
   each rank's q heads) against the same step on one card, run by every
   rank: loss within 1e-4 and every param within 5e-3 (the bounds of the
   reference's ``tests/test_distributed.py``), and every gradient the
   step updates with within 1e-4 of its leaf's largest; each rank's
   ``rmsnorm`` and ``flash_attention`` launches equal the single-card
   step's.
2. olmoe-1b-7b's MoE block at full width (64 experts, top 8, d 2048),
   float32, x (2, 512, 2048) x 0.5, expert parallel over ``model`` 2 and
   split over ``data`` 2: y within 1e-4 of ``moe_batched_local`` run on
   each data shard's tokens (the reference's EP capacity, taken over a
   shard's tokens), aux within 1e-5 of ``moe_dense``; the gap to
   ``moe_dense`` and the copies past capacity are logged.
3. bf16 h2o-danube-1.8b at full width and depth through
   ``launch.train --mesh host``, 8 x 4096 tokens a step in micro-batches
   of 2, 3 steps: step seconds (median of steps 2-3), tokens/s, peak
   memory of each card, launches.
4. The sharded decode step: h2o-danube-1.8b at full width, 2 layers,
   float32, B 8, a 4090-token prompt prefilled on one card, then 8 greedy
   steps across the 4096 window's wrap on the mesh with the dry-run's
   decode rules (the KV cache's length split over ``model``, its batch
   over ``data``; each rank runs ``decode_attention_partial`` on its slice
   and the slices merge) against the same steps on one card: tokens
   equal, the last logits within 1e-4, each rank's ``decode_attention``
   launches one a layer a step; step seconds.
5. Case 1 for gemma-2b (2 layers, its 8 q heads whole over ``model``, as
   its config keeps them), mamba2-370m (2 layers, the SSD heads split over
   ``model``) and recurrentgemma-9b (3 layers: two RG-LRU blocks, the
   width split over ``model``, and a local attention block; bf16 AdamW
   moments, so that its one-card step fits a card): the step
   equals one card's, the launches are equal on every rank, each rank's
   SSD / scan / attention input holds its share of the heads, width or
   rows, and each card's peak memory is logged.

``--smoke --device cpu`` runs the same on four gloo ranks at smoke sizes
(a rehearsal on a machine without cards). Rank 0 prints the card's name
and power limit and one JSON line last; any failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

ARCH, EP_ARCH = "h2o-danube-1.8b", "olmoe-1b-7b"
# case 5: the families whose cores split over "model" (or, gemma's heads,
# stay whole over it), their depth and AdamW moments' dtype:
# recurrentgemma's one pattern cycle holds two RG-LRU blocks and its local
# attention, and keeps bf16 moments (as the dry run keeps the largest
# configs') so that its one-card step fits a card
FAMILIES = {"gemma-2b": (2, "float32"), "mamba2-370m": (2, "float32"),
            "recurrentgemma-9b": (3, "bfloat16")}
LOSS_TOL, PARAM_TOL = 1e-4, 5e-3
# a first AdamW step in warm-up moves each param by about lr / 100 = 1e-5
# whatever its gradient: cases 1 and 5 also hold the gradients the step
# updates with, each leaf within GRAD_RTOL of its largest on one card
GRAD_RTOL = 1e-4
EP_Y_TOL, EP_AUX_TOL = 1e-4, 1e-5
DECODE_LOGIT_TOL = 1e-4
SIZES = {   # (step B, S), EP x (B, S), launcher (batch, seq, accum, steps),
            # decode (B, prompt, steps)
    "full": ((2, 1024), (2, 512), (8, 4096, 4, 3), (8, 4090, 8)),
    "smoke": ((2, 64), (2, 16), (8, 64, 4, 3), (4, 60, 8)),
}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _log(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _kernels():
    from repro_torch.kernels import flash_attention, rmsnorm
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts(dev) -> dict:
    _sync(dev)
    return {n: f.launch_count for n, f in _kernels().items()}


def _zero(dev) -> None:
    _sync(dev)
    for f in _kernels().values():
        f.launch_count = 0


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _config(name: str, smoke: bool):
    from repro_torch.configs import get_config, smoke_config
    return smoke_config(name) if smoke else get_config(name)


class _CoreInputs:
    """The local shapes the shard-local cores take while active:
    ``ssd_chunked`` (x [b, S, h, P]), ``linear_scan`` (a [b, S, w]) and
    ``attend`` (q [b, S, h, D]); DTensor calls are left out."""

    def __enter__(self):
        from repro_torch.models import attention, mamba2, rglru
        self.shapes = {"ssd": set(), "scan": set(), "attend": set()}
        self._old = []
        for mod, name, key, pos in ((mamba2, "ssd_chunked", "ssd", 0),
                                    (rglru, "linear_scan", "scan", 0),
                                    (attention, "attend", "attend", 1)):
            fn = getattr(mod, name)
            self._old.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, key, pos))
        return self

    def _wrap(self, fn, key, pos):
        def run(*a, **k):
            if not hasattr(a[pos], "device_mesh"):
                self.shapes[key].add(tuple(a[pos].shape))
            return fn(*a, **k)
        return run

    def __exit__(self, *exc):
        for mod, name, fn in self._old:
            setattr(mod, name, fn)


def _grad_gap(want, got) -> float:
    """The largest over the leaves of max |got - want| / max |want| (inf
    where a leaf of ``want`` is all 0 and ``got``'s is not)."""
    worst = 0.0
    for a, b in zip(want, got):
        b = _whole(b).detach()
        err = float((a.to(b.device) - b).abs().max())
        scale = float(a.abs().max())
        worst = max(worst, err / scale if scale else
                    (0.0 if err == 0 else float("inf")))
    return worst


def train_step(dev, mesh, args, sizes, arch: str = ARCH,
               layers: int = 2, opt_dtype: str = "float32") -> dict:
    """Case 1 (and each of case 5's): one float32 step of ``arch`` at
    full width, ``layers`` layers, on the mesh against one card, and the
    gradients it updates with (each in its param's placements, then made
    whole); the shapes each rank's cores took on the mesh; each card's
    peak memory."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import (axis_rules,
                                                  rules_for_config,
                                                  shard_params,
                                                  tree_shardings)
    from repro_torch.models import batch_axes, build_model
    from repro_torch.training import (OptimizerConfig, init_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.step import _loss_and_grads
    cfg = _config(arch, args.smoke).replace(
        num_layers=layers, dtype="float32", param_dtype="float32")
    model = build_model(cfg, attn_impl="naive" if args.smoke else "chunked")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    B, S = sizes[0]
    tokens = np.random.default_rng(args.seed + 11).integers(
        0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    step = make_train_step(model, OptimizerConfig(learning_rate=1e-3,
                                                  opt_dtype=opt_dtype))

    _zero(dev)
    t0 = time.perf_counter()
    p_one, _, out = step(params, init_state(params, opt_dtype), batch)
    loss_one = float(out["loss"])
    one_s, one_counts = time.perf_counter() - t0, _counts(dev)
    # the gradients once more (the step returns none), kept on the host
    g_one = [g.detach().cpu() for g in _loss_and_grads(model, params,
                                                       batch)[2]]

    rules = rules_for_config(cfg)
    with axis_rules(rules, mesh=mesh), _CoreInputs() as seen:
        sp = shard_params(params, mesh, model.param_axes(), rules)
        bp = tree_shardings(mesh, batch_axes(cfg), rules)
        sb = {k: distribute_tensor(v, mesh, bp[k], src_data_rank=None)
              for k, v in batch.items()}
        _zero(dev)
        t0 = time.perf_counter()
        p_mesh, _, out = step(sp, init_state(sp, opt_dtype), sb)
        loss_mesh = float(_whole(out["loss"]))
        mesh_s, mesh_counts = time.perf_counter() - t0, _counts(dev)
        gap = max(float((_whole(a) - b).abs().max())
                  for a, b in zip(tree_leaves(p_mesh), tree_leaves(p_one)))
        del p_mesh, p_one
        g_gap = _grad_gap(g_one, _loss_and_grads(model, sp, sb)[2])
    del sp, g_one
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    every, peaks, shapes = ([None] * dist.get_world_size() for _ in range(3))
    dist.all_gather_object(every, mesh_counts)
    dist.all_gather_object(peaks, peak)
    dist.all_gather_object(shapes, {k: sorted(v)
                                    for k, v in seen.shapes.items()})
    _check(abs(loss_mesh - loss_one) < LOSS_TOL and gap < PARAM_TOL
           and g_gap <= GRAD_RTOL,
           f"step {arch}: loss {loss_mesh} vs {loss_one}, param gap {gap}, "
           f"gradient gap {g_gap} of each leaf's largest")
    _check(all(c == one_counts for c in every),
           f"step {arch} launches a rank {every}, one card {one_counts}")
    kinds = cfg.layer_kinds()
    _check(dev.type != "cuda" or (one_counts["rmsnorm"] > 0 and (
        one_counts["flash_attention"] > 0) == ("attn" in kinds)),
           f"the single-card step of {arch} launched {one_counts}")
    _check_shares(cfg, mesh, B, S, shapes)
    _log(f"step {arch} f32 ({opt_dtype} moments) {layers} layers B={B} "
         f"S={S} on a "
         f"{tuple(mesh.shape)} mesh: loss {loss_mesh:.6f} vs one card "
         f"{loss_one:.6f} (gap {abs(loss_mesh - loss_one):.3e}, bound "
         f"{LOSS_TOL}); max param gap {gap:.3e} (bound {PARAM_TOL}); "
         f"gradients within {g_gap:.3e} of each leaf's largest (bound "
         f"{GRAD_RTOL}); "
         f"launches a rank {every}, one card {one_counts}; cores' local "
         f"inputs (rank 0) {shapes[0]}; step {mesh_s:.4f} s on the mesh "
         f"(rank 0), {one_s:.4f} s on one card; peak GiB a card "
         f"{[round(v, 2) for v in peaks]}")
    return {"loss_gap": abs(loss_mesh - loss_one), "param_gap": gap,
            "grad_gap": g_gap,
            "launches": every, "launches_one_card": one_counts,
            "mesh_s": mesh_s, "one_card_s": one_s, "peak_gib": peaks,
            "core_inputs": shapes[0]}


def _check_shares(cfg, mesh, B: int, S: int, shapes) -> None:
    """Each rank's cores took its share: its data shard's rows, and its
    "model" share of mamba2's SSD heads, of the RG-LRU width and of the
    attention's q heads (all of them where the config keeps them whole,
    ``shard_attn_heads=False``, as the reference's compiled step does)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    b, tp = B // sizes["data"], sizes["model"]
    kinds = set(cfg.layer_kinds())
    want = {"ssd": set(), "scan": set(), "attend": set()}
    if "ssm" in kinds:
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        want["ssd"] = {(b, S, heads // tp, s.head_dim)}
    if "rglru" in kinds:
        want["scan"] = {(b, S, (cfg.rglru_width or cfg.d_model) // tp)}
    if "attn" in kinds:
        hq = cfg.num_heads // (tp if cfg.shard_attn_heads else 1)
        want["attend"] = {(b, S, hq, cfg.resolved_head_dim)}
    for r, got in enumerate(shapes):
        got = {k: {tuple(x) for x in v} for k, v in got.items()}
        _check(got == want, f"rank {r}'s cores took {got}, want {want}")


def ep_block(dev, mesh, args, sizes) -> dict:
    """Case 2: the EP MoE block against each data shard's single-device
    call and against ``moe_dense``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import (PartitionSpec, axis_rules,
                                                  make_rules,
                                                  spec_placements)
    from repro_torch.models import moe
    from repro_torch.models.spec import init_params
    cfg = _config(EP_ARCH, args.smoke).replace(dtype="float32",
                                               param_dtype="float32")
    p = init_params(moe.moe_specs(cfg),
                    torch.Generator(device=dev).manual_seed(args.seed),
                    "float32", dev)
    g = torch.Generator().manual_seed(args.seed + 11)
    p["router"] = (torch.randn(tuple(p["router"].shape), generator=g)
                   * 0.02).to(dev)
    x = (torch.randn((*sizes[1], cfg.d_model), generator=g) * 0.5).to(dev)
    dp = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    shards = x.chunk(dp)
    with torch.no_grad():
        yd, auxd = moe.moe_dense(cfg, p, x)
        ys = torch.cat([moe.moe_batched_local(cfg, p, s)[0] for s in shards])
        E, k = cfg.moe.num_experts, cfg.moe.top_k
        drops = 0
        for s in shards:
            _, _, idx, _ = moe._route(cfg, p["router"],
                                      s.reshape(-1, cfg.d_model))
            cap = moe._capacity(idx.numel(), E, cfg.moe.capacity_factor)
            drops += int((torch.bincount(idx.reshape(-1), minlength=E)
                          - cap).clamp(min=0).sum())
    PS = PartitionSpec
    specs = {"router": PS(None, None), "wi": PS("model", "data", None),
             "wg": PS("model", "data", None), "wo": PS("model", None, "data")}
    with torch.no_grad(), axis_rules(make_rules(), mesh=mesh):
        xd = distribute_tensor(x, mesh, spec_placements(
            mesh, PS("data", None, None)), src_data_rank=None)
        pd = {n: distribute_tensor(p[n], mesh, spec_placements(mesh, s),
                                   src_data_rank=None)
              for n, s in specs.items()}
        _sync(dev)
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(cfg, pd, xd, mesh=mesh)
        y, aux = _whole(y), float(_whole(aux))
        ep_s = time.perf_counter() - t0
    y_err = float((y - ys).abs().max())
    dense_err = float((y - yd).abs().max())
    aux_err = abs(aux - float(auxd))
    _check(y_err < EP_Y_TOL and aux_err < EP_AUX_TOL,
           f"EP: y {y_err} against each shard's call, aux {aux_err}")
    _log(f"EP {EP_ARCH} f32 x {tuple(x.shape)} over model "
         f"{dict(zip(mesh.mesh_dim_names, mesh.shape))['model']}, data "
         f"{dp}: max |y - each shard's moe_batched_local| {y_err:.3e} "
         f"(bound {EP_Y_TOL}); |aux - moe_dense| {aux_err:.3e} (bound "
         f"{EP_AUX_TOL}); max |y - moe_dense| {dense_err:.3e} with {drops} "
         f"copies past capacity; forward {ep_s:.4f} s (rank 0)")
    return {"y_err": y_err, "aux_err": aux_err, "dense_err": dense_err,
            "drops": drops, "s": ep_s}


def launcher(dev, args, sizes) -> dict:
    """Case 3: bf16 danube through ``launch.train --mesh host``."""
    from repro_torch.launch import train as train_launcher
    batch, seq, accum, steps = sizes[2]
    argv = ["--arch", ARCH, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--accum", str(accum), "--ckpt-every", "100",
            "--log-every", "1", "--mesh", "host", "--device", dev.type]
    if args.smoke:
        argv.append("--smoke")
    with tempfile.TemporaryDirectory(prefix="probe-ckpt-") as ckpt:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _zero(dev)
        run = train_launcher.train(train_launcher.parse_args(
            argv + ["--ckpt-dir", ckpt]))
        counts = _counts(dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    kinds = [k for k, _ in run.events]
    _check("failure" not in kinds and "restart" not in kinds
           and all(np.isfinite(run.losses)),
           f"launcher: events {run.events}, losses {run.losses}")
    steady = float(np.median(run.step_seconds[1:]))
    mesh_shape = tuple(run.params["final_norm"].device_mesh.shape)
    _log(f"launcher bf16 {ARCH} --mesh host ({mesh_shape}): {batch} x {seq} "
         f"a step, accum {accum}: step seconds "
         f"{[round(s, 4) for s in run.step_seconds]} (steps 2-{steps} "
         f"median {steady:.4f} s, {batch * seq / steady:.1f} tok/s); losses "
         f"{[round(v, 4) for v in run.losses]}; launches (rank 0) {counts}; "
         f"peak GiB a card {[round(v, 2) for v in peaks]}")
    return {"step_s": run.step_seconds, "steady_s": steady,
            "tok_s": batch * seq / steady, "peak_gib": peaks,
            "losses": run.losses, "launches": counts, "mesh": mesh_shape}


def decode(dev, mesh, args, sizes) -> dict:
    """Case 4: greedy decode steps with the KV cache split over the mesh
    against the same steps on one card."""
    import contextlib

    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import (axis_rules,
                                                  rules_for_config,
                                                  shard_params)
    from repro_torch.kernels import decode_attention
    from repro_torch.launch.dryrun import _rule_overrides
    from repro_torch.models import build_model
    from repro_torch.training import make_serve_step
    cfg = _config(ARCH, args.smoke).replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    B, prompt, steps = sizes[3]
    tokens = torch.from_numpy(np.random.default_rng(args.seed + 5).integers(
        0, cfg.vocab_size, (B, prompt))).to(dev)
    step = make_serve_step(model)
    rules = rules_for_config(cfg, overrides=_rule_overrides(
        cfg, SHAPES["decode_32k"], mesh))
    runs = {}
    for where in ("one", "mesh"):
        with torch.no_grad(), (axis_rules(rules, mesh=mesh)
                               if where == "mesh"
                               else contextlib.nullcontext()):
            logits, state = model.prefill(params, tokens)
            nxt, p = logits[:, -1:].argmax(-1), params
            if where == "mesh":
                p = shard_params(params, mesh, model.param_axes(), rules)
                state = shard_params(state, mesh, model.cache_axes(), rules)
            _sync(dev)
            decode_attention.launch_count = 0
            toks, secs = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                nxt, state = step(p, state, nxt)
                _sync(dev)
                secs.append(time.perf_counter() - t0)
                toks.append(_whole(nxt))
            launches = decode_attention.launch_count
            last, _ = model.decode_step(p, state, nxt)
            local = tuple(getattr(state.kv.k, "to_local",
                                  lambda: state.kv.k)().shape)
            runs[where] = (torch.cat(toks, 1), _whole(last).float(),
                           launches, float(np.median(secs[1:])), local)
        del state
    (t1, l1, n1, s1, c1), (tm, lm, nm, sm, cm) = runs["one"], runs["mesh"]
    gap = float((lm - l1).abs().max())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, nm)
    want = steps * cfg.num_layers if dev.type == "cuda" else 0
    _check(bool((tm == t1).all()) and gap < DECODE_LOGIT_TOL,
           f"decode: tokens equal {bool((tm == t1).all())}, logit gap {gap}")
    _check(n1 == want and all(n == want for n in every),
           f"decode launches a rank {every}, one card {n1}, want {want}")
    _log(f"decode {ARCH} f32 2 layers B={B} prompt={prompt}, {steps} steps "
         f"on a {tuple(mesh.shape)} mesh: tokens equal one card's; last "
         f"logits gap {gap:.3e} (bound {DECODE_LOGIT_TOL}); decode_attention"
         f" launches a rank {every} (one card {n1}); a rank's cache slice "
         f"{cm} of {c1}; step {sm:.4f} s on the mesh (median, rank 0), "
         f"{s1:.4f} s on one card")
    return {"logit_gap": gap, "launches": every, "launches_one_card": n1,
            "mesh_step_s": sm, "one_card_step_s": s1, "cache_slice": cm}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs and sizes (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if "WORLD_SIZE" not in os.environ:
        print("run under torchrun --nproc-per-node 4", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available; pass --smoke --device cpu to rehearse",
              file=sys.stderr)
        return 2
    if args.device == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo")
    try:
        if dist.get_world_size() != 4:
            raise SystemExit(f"a (2, 2) mesh needs 4 ranks, not "
                             f"{dist.get_world_size()}")
        from torch.distributed.device_mesh import init_device_mesh
        smi = ""
        if dev.type == "cuda":
            if dist.get_rank() == 0:
                from repro_torch.kernels import _build
                t0 = time.perf_counter()
                built = _build.build_all()
                _log(f"build: {built} (wall {time.perf_counter() - t0:.2f} s)")
                smi = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60, check=True).stdout.strip()
            dist.barrier()
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        _log(f"device: {dev.type} x {dist.get_world_size()} ({name}, torch "
             f"{torch.__version__})")
        mesh = init_device_mesh(dev.type, (2, 2),
                                mesh_dim_names=("data", "model"))
        sizes = SIZES["smoke" if args.smoke else "full"]
        res = {"step": train_step(dev, mesh, args, sizes)}
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        res["ep"] = ep_block(dev, mesh, args, sizes)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        res["launcher"] = launcher(dev, args, sizes)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        res["decode"] = decode(dev, mesh, args, sizes)
        res["families"] = {}
        for arch, (layers, opt_dtype) in FAMILIES.items():
            torch.cuda.empty_cache() if dev.type == "cuda" else None
            res["families"][arch] = train_step(dev, mesh, args, sizes, arch,
                                               layers, opt_dtype)
        if dist.get_rank() == 0:
            if smi:
                print(smi)
            print(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
