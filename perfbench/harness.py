"""One run of one cell: build the program on the card, warm it, measure a
window, read the metrics, and check what the window produced against the
plain reference.

Everything a cell is made of is found by name: its entry (in
``BENCHMARK.json``, or in ``perfbench/held.json`` for a cell held out of
the benchmark), its configuration file (``configs``), its traffic mix
(``perfbench/traffic/<traffic>.json``), the limits of its comparison
(``perfbench/limits/<workload>.json``), a reader for each metric
(``perfbench/metrics/<metric>.py``), and the architecture file that the
configuration's key ``"arch"`` names, which describes its model: weight
layout, reference, FLOP counts and smoke cut (``perfbench/archs``). A
traffic mix's ``kind`` picks the loop: ``serve`` drives
``repro_torch.launch.serve.ServingEngine.generate`` in a closed loop,
``train`` the step of ``repro_torch.training.make_train_step``.

``rehearse=True`` runs the same path on the CPU at smoke width
(``perfbench.rehearsal``), with the kernels' plain versions; only the
benchmark's tests use it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
import typing
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import archs, flops, peaks, reference, traffic, weights
from perfbench.trace import Profiled, kernel_seconds

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
LAUNCH_COUNTED = ("rmsnorm", "flash_attention", "decode_attention")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def with_held(bench: dict) -> dict:
    """``bench`` with the entries of ``perfbench/held.json`` added: cells
    (with their configurations and metrics) held out of the benchmark,
    which run by name like its own."""
    held = load_json(HERE / "held.json")
    return {k: v + held.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


def cell(name: str, bench: Optional[dict] = None) -> SimpleNamespace:
    """The workload ``name`` with its configuration, mix and limits."""
    bench = bench or with_held(spec())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_json(ROOT / conf["file"])
    return SimpleNamespace(
        name=name, workload=wl, cfg=cfg, arch=load_arch(conf["file"], cfg),
        mix=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        metrics=metrics_of(bench, name))


def load_arch(conf_file: str, cfg: dict) -> ModuleType:
    """The architecture file that the configuration in ``conf_file``
    names under ``"arch"`` (a path from the repository's root), loaded;
    it has to define ``archs.INTERFACE``."""
    path = cfg.get("arch")
    if path is None:
        raise SystemExit(f"{conf_file}: no key \"arch\" naming the file "
                         "that describes its model (perfbench/archs)")
    if not (ROOT / path).is_file():
        raise SystemExit(f"{conf_file}: its arch file {path} is not there")
    sp = importlib.util.spec_from_file_location(
        "perfbench_arch_" + "".join(ch if ch.isalnum() else "_"
                                    for ch in path), ROOT / path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    missing = [n for n in archs.INTERFACE if not hasattr(mod, n)]
    if missing:
        raise SystemExit(f"{conf_file}: its arch file {path} lacks "
                         f"{', '.join(missing)}")
    return mod


def counts(arch: ModuleType) -> SimpleNamespace:
    """What the metrics read as ``ctx.flops``: the architecture file's
    names over those of ``perfbench.flops``."""
    return SimpleNamespace(**{k: v for src in (flops, arch)
                              for k, v in vars(src).items()
                              if not k.startswith("_")})


def metrics_of(bench: dict, name: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics this cell reports: those that
    list it, and those that list no cells (a per-layer one only where its
    end-to-end metric is reported)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names
                              else [])]
    return {"end_to_end": e2e, "per_layer": layer}


def reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: the fields
    the file gives (other keys ignored), each read by its type."""
    from repro_torch.configs.base import ModelConfig
    return from_json(ModelConfig, cfg)


def from_json(hint, value):
    """``value``, as JSON gives it, as the type ``hint``: a dataclass
    (``ModelConfig``, its sub-configs) from a dict of its fields, each
    read by its own type, and a tuple from a list, so that a frozen config
    still hashes; ``Optional[X]`` as ``X``."""
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    if typing.get_origin(hint) is typing.Union and len(args) == 1:
        hint = args[0]
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        hints = typing.get_type_hints(hint)
        return hint(**{f.name: from_json(hints[f.name], value[f.name])
                       for f in dataclasses.fields(hint) if f.name in value})
    if typing.get_origin(hint) is tuple and isinstance(value, list):
        return tuple(value)
    return value


def launches() -> Dict[str, int]:
    import repro_torch.kernels as K
    return {n: getattr(K, n).launch_count for n in LAUNCH_COUNTED}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Loops: set-up, one timed call, the check
# ---------------------------------------------------------------------------

class ServeLoop:
    """Closed loop over ``ServingEngine.generate``: the next call of
    ``slots`` prompts goes in when the last returns."""

    def __init__(self, c, mcfg, params, device, seed, log):
        from repro_torch.launch.serve import ServingEngine
        from repro_torch.models import build_model
        self.c, self.device, self.seed, self.log = c, device, seed, log
        self.params = params
        self.traffic = traffic.ServeTraffic(c.mix, c.cfg["vocab_size"], seed)
        self.gen = c.mix["gen_tokens"]
        self.engine = ServingEngine(build_model(mcfg, attn_impl="chunked"),
                                    params, max_len=c.mix["max_len"],
                                    batch_slots=c.mix["slots"], device=device)
        self.calls: List[dict] = []

    def warm(self) -> None:
        t = self.traffic
        for i, length in enumerate(t.lengths()):
            ids = traffic.rng(self.seed, 3, i).integers(
                0, t.vocab, (t.slots, length), dtype=np.int64)
            self.engine.generate(ids, self.gen)

    def label(self, i: int) -> str:
        return f"generate L={self.traffic.length(i)}"

    def step(self, i: int) -> dict:
        prompts = self.traffic.prompts(i)
        before = dict(self.engine.stats)
        t0 = time.perf_counter()
        out = self.engine.generate(prompts, self.gen)
        t1 = time.perf_counter()
        st = {k: v - before[k] for k, v in self.engine.stats.items()}
        rec = {"i": i, "length": prompts.shape[1], "rows": prompts.shape[0],
               "t0": t0, "t1": t1, "stats": st}
        self.calls.append(dict(rec, out=out))
        return rec

    def check(self, control: bool = False) -> dict:
        """The widest and the mean gap by which a served token's reference
        logit lies below the reference's best, over whole calls of the run
        drawn from the seed (one of each length ``check_calls`` names, the
        longest among them); with ``control``, the same for the tokens the
        fp8 reference puts first."""
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        pick = traffic.rng(self.seed, 4)
        chosen = []
        for length in self.c.mix["check_calls"]:
            same = [c for c in self.calls if c["length"] == length]
            if same:
                chosen.append(same[int(pick.integers(len(same)))])
        if not chosen:
            raise RuntimeError("no finished call of the lengths to check")
        forward = self.c.arch.Forward
        ref = forward(self.c.cfg, self.params)
        low = forward(self.c.cfg, self.params, "fp8") if control else None
        gaps, ctl = [], []
        for call in chosen:
            prompts = torch.as_tensor(self.traffic.prompts(call["i"]),
                                      device=self.device)
            served = torch.as_tensor(call["out"], dtype=torch.long,
                                     device=self.device)
            seq = torch.cat([prompts, served[:, :-1]], dim=1)
            L = prompts.shape[1]
            pos = torch.arange(L - 1, L - 1 + served.shape[1],
                               device=self.device)
            lg = ref.logits(seq, pos)
            best = lg.max(dim=-1).values
            got = lg.gather(-1, served[..., None]).squeeze(-1)
            gaps.append((best - got).flatten())
            if control:
                first = low.logits(seq, pos).argmax(dim=-1)
                mine = lg.gather(-1, first[..., None]).squeeze(-1)
                ctl.append((best - mine).flatten())
            del lg
        gaps = torch.cat(gaps)
        self.log(f"check: {len(chosen)} calls "
                 f"{[c['length'] for c in chosen]}, {gaps.numel()} served "
                 "tokens")
        out = {"served_logit_gap": float(gaps.max()),
               "served_logit_gap_mean": float(gaps.mean())}
        if control:
            ctl = torch.cat(ctl)
            out["control.served_logit_gap"] = float(ctl.max())
            out["control.served_logit_gap_mean"] = float(ctl.mean())
        return out


class TrainLoop:
    """The program's train step, one object from set-up through the window:
    set-up takes its first ``check_steps`` steps, whose readings the
    reference follows after the window."""

    def __init__(self, c, mcfg, params, device, seed, log):
        from repro_torch.models import build_model
        from repro_torch.training import (OptimizerConfig, init_state,
                                          make_train_step)
        self.c, self.device, self.seed, self.log = c, device, seed, log
        self.traffic = traffic.TrainTraffic(c.mix, c.cfg["vocab_size"], seed)
        opt = OptimizerConfig(**c.mix["optimizer"])
        self.step_fn = make_train_step(build_model(mcfg, attn_impl="chunked"),
                                       opt, accum_steps=c.mix["accum"])
        self.params, self.state = params, init_state(params, opt.opt_dtype)
        self.next = 0
        self.seen: Dict[str, object] = {"losses": []}

    def batch(self, i: int) -> dict:
        return {"tokens": torch.as_tensor(self.traffic.tokens(i),
                                          device=self.device)}

    def _step(self) -> float:
        self.params, self.state, out = self.step_fn(
            self.params, self.state, self.batch(self.next))
        self.next += 1
        return float(out["loss"])       # waits for the device

    def warm(self) -> None:
        """The first ``check_steps`` steps; the first step's clipped
        gradient by leaf (from AdamW's first moment) and the params'
        change by leaf after the last of them."""
        b1 = self.c.mix["optimizer"]["beta1"]
        p0 = weights.leaves(self.params)
        for n in range(self.c.mix["check_steps"]):
            self.seen["losses"].append(self._step())
            if n == 0:
                self.seen["grad_norms"] = {
                    k: float(m.float().norm()) / (1 - b1)
                    for k, m in weights.leaves(self.state.m).items()}
        self.seen["change"] = {
            k: float((p.float() - p0[k].float()).norm())
            for k, p in weights.leaves(self.params).items()}

    def label(self, i: int) -> str:
        return "train step"

    def step(self, i: int) -> dict:
        t0 = time.perf_counter()
        self._step()
        t1 = time.perf_counter()
        return {"i": i, "tokens": self.c.mix["global_batch"]
                * self.c.mix["seq_len"], "t0": t0, "t1": t1}

    def check(self, control: bool = False) -> dict:
        """The program's first steps against the reference's from the same
        weights and rows: the worst step's loss gap, and by the worst leaf
        the gap of the first clipped gradient's norm and of the params'
        change norm, each over the larger of the reference leaf's norm and
        the median leaf's. Leaves whose reference gradient is under a
        thousandth of the median leaf's are left out of the change."""
        del self.params, self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        c, mix = self.c, self.c.mix
        p0 = weights.make(c.cfg, c.arch.layout(c.cfg), self.seed, self.device)
        batches = [self.batch(i)["tokens"] for i in range(mix["check_steps"])]
        ref = reference.train(c.cfg, mix["optimizer"], p0, batches,
                              mix["accum"], loss=c.arch.loss)
        out = compare_train(self.seen, ref)
        if control:
            low = reference.train(c.cfg, mix["optimizer"], p0, batches,
                                  mix["accum"], precision="fp8",
                                  loss=c.arch.loss)
            out.update({f"control.{k}": v
                        for k, v in compare_train(low, ref).items()})
        return out


def compare_train(got: dict, ref: dict) -> dict:
    def worst(a: Dict[str, float], b: Dict[str, float]) -> float:
        med = float(np.median(list(b.values())))
        return max(abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in b)

    g_med = float(np.median(list(ref["grad_norms"].values())))
    moved = {k for k, g in ref["grad_norms"].items() if g >= 1e-3 * g_med}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_norm_gap": worst(got["grad_norms"], ref["grad_norms"]),
        "change_norm_gap": worst({k: got["change"][k] for k in moved},
                                 {k: ref["change"][k] for k in moved}),
    }


LOOPS = {"serve": ServeLoop, "train": TrainLoop}


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def window(loop, seconds: float, trace: bool) -> SimpleNamespace:
    """Calls or steps until ``seconds`` have passed; the window closes at
    the end of the one running then. With ``trace``, the first
    ``trace_calls`` / ``trace_steps`` run under the profiler before it,
    and the trace is reduced after it, so the window runs as without the
    profiler."""
    mix = loop.c.mix
    n_traced = mix.get("trace_calls", mix.get("trace_steps", 0)) if trace \
        else 0
    traced: List[dict] = []
    counts: List[Dict[str, int]] = []
    prof = None
    if n_traced:
        with Profiled(loop.device) as prof:
            for i in range(n_traced):
                before = launches()
                with prof.span(loop.label(i)):
                    traced.append(loop.step(i))
                after = launches()
                counts.append({k: after[k] - before[k] for k in after})
    rest: List[dict] = []
    start = time.perf_counter()
    while not rest or rest[-1]["t1"] - start < seconds:
        rest.append(loop.step(len(traced) + len(rest)))
    summary = None if prof is None else prof.summary(counts)
    return SimpleNamespace(start=start, records=traced + rest,
                           traced=traced, rest=rest, trace=summary)


def run(name: str, seed: int, seconds: float, trace: bool, *,
        started: float, rehearse: bool = False, control: bool = False,
        log: Callable[[str], None] = print):
    """One run of cell ``name``: (the result's fields, without the module
    check, which the caller makes; every number the check read, the
    control's too with ``control``). ``started`` is the host clock at the
    process's start, from which ``setup_s`` is taken. With ``control``,
    the control's numbers (the reference in float8, in the program's
    place) are the ones held to the limits: ``checked`` and ``correct``
    are the control's."""
    c = cell(name)
    if rehearse:
        from perfbench import rehearsal
        c = rehearsal.shrink(c)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
        from repro_torch.kernels import _build
        _build.build_all()
        log(f"kernel builds this run (s): {_build.build_seconds}")
    mcfg = model_config(c.cfg)
    params = weights.make(c.cfg, c.arch.layout(c.cfg), seed, device)
    loop = LOOPS[c.mix["kind"]](c, mcfg, params, device, seed, log)
    del params
    loop.warm()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        from repro_torch.kernels import _build
        log(f"kernel builds before the window (s): {_build.build_seconds}")
    log(f"launches before the window: {launches()}")
    setup_s = time.perf_counter() - started
    w = window(loop, seconds, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"launches after the window: {launches()}")
    log_window(w, log)
    ctx = SimpleNamespace(
        cfg=c.cfg, mix=c.mix, flops=counts(c.arch), peaks=peaks,
        setup_s=setup_s,
        window=w, log=log,
        trace_seconds=lambda names, per_launch, wrapper: kernel_seconds(
            w.trace, names, per_launch, wrapper, log))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in c.metrics[kind]:
        try:
            value = reader(m["name"])(ctx)
        except AttributeError as e:
            if e.obj is not ctx.flops:
                raise
            log(f"metric {m['name']}: the arch file has no {e.name}")
            value = None
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t0 = time.perf_counter()
    readings = loop.check(control=control)
    log(f"check: {time.perf_counter() - t0:.1f} s")
    judged = ({k[len("control."):]: v for k, v in readings.items()
               if k.startswith("control.")} if control else readings)
    checked = {k: {"value": v, "limit": c.limits[k]}
               for k, v in judged.items() if k in c.limits}
    correct = all(v["value"] <= v["limit"] for v in checked.values())
    attempted = sum(r.get("rows", 1) for r in w.records)
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_block(device, peak, w)}
    if w.trace is not None:
        result["breakdown"] = {"device_ops": w.trace["device_ops"],
                               "idle_gaps": w.trace["idle_gaps"]}
    result["checked"] = checked
    return result, readings


def log_window(w, log) -> None:
    """The window's calls or steps by size: count and mean seconds."""
    by: Dict[int, List[float]] = {}
    for r in w.rest:
        by.setdefault(r.get("length", 0), []).append(r["t1"] - r["t0"])
    log(f"window: {len(w.rest)} calls in "
        f"{w.rest[-1]['t1'] - w.start:.3f} s ({len(w.traced)} traced "
        "before it); "
        + ", ".join(f"{k}: {len(v)} x {np.mean(v):.4f} s"
                    for k, v in sorted(by.items())))


def device_block(device, peak: int, w) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1,
               "memory_peak_bytes": 0}
    if w.trace is not None:
        out["busy_s"] = w.trace["busy_s"]
        out["window_s"] = w.trace["window_s"]
    return out
