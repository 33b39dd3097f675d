"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 1048576]

Phases, each raising on failure (the script then exits non-zero):

1. require CUDA; print the card's name and ``nvidia-smi`` name/power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together) and print the build seconds;
3. hold ``fused_embed`` against its plain PyTorch version on the card at
   the main path's shapes, the calibration probe's, one wide shape and
   N = 0, in float32 (atol 2e-5) and bfloat16 (atol 2e-2);
4. main path: ``MorphingSession(backend="torch")`` over a ``--rows`` table
   (gender, len, 16-wide float32 emb from ``--seed``) with a linear-mode
   zoo, so the resolved trunk runs ``fused_embed``: CREATE TASK, a
   grouped AVG cold and warm, a PREDICT over a slice. Launch counts are
   zeroed just before each query and read just after; rows are held to a
   ``backend="numpy"`` session at atol 1e-5;
5. the quickstart query (full 16-model zoo, 600 rows) through the
   selector, on the card;
6. time ``fused_embed`` and its plain version with CUDA events, beside the
   least time the card could take (H100 SXM data sheet: 3.35 TB/s HBM,
   67 TFLOP/s float32).

The last three lines are the ``nvidia-smi`` name/power-limit line, one
JSON object with the kernel table, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM data sheet, float32 non-tensor
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ROW_ATOL = 1e-5
SQL_AVG = ("SELECT gender, AVG(t(emb)) FROM reviews WHERE len > 20 "
           "GROUP BY gender")
SQL_PREDICT = "PREDICT emb USING TASK t FROM reviews WHERE len > 190"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 3: kernel against its plain version ------------------------------

def compare_kernel(fused_embed, fused_embed_ref, dev):
    shapes = ([(n, 16, k) for n in (1, 32, 100, 256, 511)
               for k in (8, 28, 33, 40)]
              + [(64, 32, 64), (512, 32, 64), (4096, 1024, 512),
                 (0, 16, 33)])
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n, d, k in shapes:
        x32 = torch.randn((n, d), generator=g).to(dev)
        w = (torch.randn((d, k), generator=g) * 0.05).to(dev)
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for mean, scale in ((0.0, 1.0), (0.5, 2.0)):
                got = fused_embed(x, w, mean=mean, scale=scale)
                torch.cuda.synchronize()
                want = fused_embed_ref(x, w, mean, scale)
                torch.cuda.synchronize()
                check(got.shape == (n, k) and got.dtype == dtype,
                      f"fused_embed shape/dtype {got.shape} {got.dtype}")
                err = (float((got.float() - want.float()).abs().max())
                       if n else 0.0)
                check(err < TOL[dtype], f"fused_embed {n}x{d}x{k} {dtype} "
                      f"mean={mean} scale={scale}: err {err}")
                worst[dtype] = max(worst[dtype], err)
                errs.append(f"{str(dtype)[6:]}/{mean}/{scale}={err:.2e}")
        log(f"compare fused_embed N={n} D={d} K={k}: " + " ".join(errs))
    return worst


# -- phase 4: the main path -------------------------------------------------

def make_table(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"gender": rng.integers(0, 2, rows),
            "len": rng.integers(1, 200, rows),
            "emb": rng.standard_normal((rows, 16)).astype(np.float32)}


def main_path(args, fused_embed):
    from repro_torch.core import (ModelSelector, TaskFeaturizer, build_tasks,
                                  build_zoo, make_task, transfer_matrix)
    from repro_torch.engine import EngineConfig, MorphingSession

    zoo = [m for m in build_zoo(16, seed=0) if m.mode == "linear"]
    hist = build_tasks(24, seed=1)
    fz = TaskFeaturizer()
    feats = np.stack([fz.features(t.X, t.y) for t in hist])
    sel = ModelSelector(k=2).fit_offline(transfer_matrix(zoo, hist), feats,
                                         zoo=zoo)
    log(f"main path zoo: {[(m.name, tuple(m.W.shape)) for m in zoo]}")
    table = make_table(args.rows, args.seed)
    sample = make_task(np.random.default_rng(args.seed + 7), "gauss",
                       n=128, dim=16, classes=3)

    sessions = {}
    for backend in ("torch", "numpy"):
        sess = MorphingSession(selector=sel, zoo=zoo,
                               config=EngineConfig(backend=backend))
        sess.register_table("reviews", table)
        sess.sql("CREATE TASK t (INPUT=Series, OUTPUT IN ('POS','NEG',"
                 "'NEU'), TYPE='Classification');")
        sessions[backend] = sess

    sess = sessions["torch"]
    check(sess.hw is not None and sess.hw["cuda"].measured,
          "auto-calibration did not measure the torch backend")
    tb = sess.backends["cuda"]
    check(tb.device.type == "cuda", f"torch backend on {tb.device}")
    rm = sess.resolve_task("t", sample.X, sample.y)
    check(rm.zoo_model.mode == "linear",
          f"resolved {rm.model_id} in mode {rm.zoo_model.mode}")
    log(f"resolved t -> {rm.model_id} mode={rm.zoo_model.mode} "
        f"W={tuple(rm.zoo_model.W.shape)}")

    out = {}
    for label, sql in (("cold", SQL_AVG), ("warm", SQL_AVG),
                       ("predict", SQL_PREDICT)):
        fused_embed.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.sql(sql)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[label] = (res, fused_embed.launch_count, secs)
        log(f"query {label}: {secs:.4f} s, launches={out[label][1]}, "
            f"rows_in={res.report.rows_in} rows_out={res.report.rows_out} "
            f"share_hit_rate={res.report.share_hit_rate} "
            f"compile_count={res.report.compile_count} "
            f"backend_of={sorted(set(res.report.backend_of.values()))} "
            f"op_seconds={res.report.op_seconds} "
            f"infer_seconds={res.report.batch_infer_seconds:.4f}")
    cold, warm, pred = out["cold"], out["warm"], out["predict"]
    check(cold[1] > 0, "fused_embed was not launched by the cold query")
    check(warm[1] == 0, f"warm query launched fused_embed {warm[1]} times")
    check(warm[0].report.share_hit_rate == 1.0,
          f"warm share hit rate {warm[0].report.share_hit_rate}")
    check(warm[0].report.compile_count == 0, "warm query saw new shapes")
    check(tb.stage_count == 1, f"stage_count {tb.stage_count}")
    check(set(cold[0].report.backend_of.values()) == {"torch"},
          f"backends {cold[0].report.backend_of}")

    ref = sessions["numpy"]
    ref.resolve_task("t", sample.X, sample.y)
    check(ref.models["t"].model_id == rm.model_id,
          "numpy session resolved another model")
    for label, sql in (("cold", SQL_AVG), ("warm", SQL_AVG),
                       ("predict", SQL_PREDICT)):
        t0 = time.perf_counter()
        want = ref.sql(sql).rows
        log(f"numpy session query {label}: "
            f"{time.perf_counter() - t0:.4f} s")
        got = out[label][0].rows
        check(list(got) == list(want), f"{label} columns differ")
        worst = 0.0
        for col in want:
            a = np.asarray(got[col], np.float64)
            b = np.asarray(want[col], np.float64)
            check(a.shape == b.shape, f"{label}.{col} shape differs")
            check(bool(np.all(np.isfinite(a))), f"{label}.{col} not finite")
            worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
        check(worst <= ROW_ATOL, f"{label} rows differ from numpy by {worst}")
        log(f"rows {label}: torch vs numpy max abs diff {worst:.3e} "
            f"({len(next(iter(got.values())))} rows)")
    log(f"cold AVG rows: {dict((k, np.asarray(v).tolist()) for k, v in cold[0].rows.items())}")
    return {"launches": cold[1], "cold_s": cold[2], "warm_s": warm[2],
            "predict_s": pred[2], "predict_launches": pred[1],
            "model": rm.model_id, "K": int(rm.zoo_model.W.shape[1]),
            "stage_count": tb.stage_count}


# -- phase 5: the quickstart query ------------------------------------------

def quickstart():
    from repro_torch.core import (ModelSelector, TaskFeaturizer, build_tasks,
                                  build_zoo, make_task, transfer_matrix)
    from repro_torch.engine import EngineConfig, MorphingSession

    zoo = build_zoo(16, seed=0)
    hist = build_tasks(32, seed=1)
    fz = TaskFeaturizer()
    feats = np.stack([fz.features(t.X, t.y) for t in hist])
    sel = ModelSelector(k=6, n_anchors=3).fit_offline(
        transfer_matrix(zoo, hist), feats, zoo=zoo)
    db = MorphingSession(selector=sel, zoo=zoo,
                         config=EngineConfig(backend="torch"))
    rng = np.random.default_rng(0)
    n = 600
    db.register_table("reviews", {
        "gender": rng.integers(0, 2, n), "len": rng.integers(1, 200, n),
        "emb": rng.standard_normal((n, 16)).astype(np.float32)})
    db.sql("CREATE TASK sentiment_classifier (INPUT=Series, "
           "OUTPUT IN ('POS','NEG','NEU'), TYPE='Classification');")
    sample = make_task(rng, "gauss", n=128, dim=16, classes=3)
    res = db.sql("SELECT gender, AVG(sentiment_classifier(emb)) FROM "
                 "reviews WHERE len > 20 GROUP BY gender;",
                 sample=(sample.X, sample.y))
    rm = db.models["sentiment_classifier"]
    scores = np.asarray(res.rows["mean__score"])
    check(scores.shape == (2,) and bool(np.all(np.isfinite(scores))),
          f"quickstart rows {res.rows}")
    log(f"quickstart: resolved {rm.model_id} mode={rm.zoo_model.mode}, "
        f"rows={dict((k, np.asarray(v).tolist()) for k, v in res.rows.items())}")


# -- phase 6: timing --------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n: int, d: int, k: int):
    """Least time for the work: each input read once, the output written
    once (float32), against 2DK FMA flops + one tanh per output."""
    nbytes = 4.0 * (n * d + d * k + n * k)
    ops = 2.0 * n * d * k + n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timings(fused_embed, fused_embed_ref, dev, K):
    g = torch.Generator(device="cpu").manual_seed(2)
    res = {}
    for n, d, k, reps in ((256, 16, K, 400), (1 << 20, 16, K, 50),
                          (1, 16, 8, 400)):
        x = torch.randn((n, d), generator=g).to(dev)
        w = (torch.randn((d, k), generator=g) * 0.05).to(dev)
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = time_ms(lambda: fused_embed_ref(x, w), reps)
        k1 = time_ms(lambda: fused_embed(x, w), reps)
        k2 = time_ms(lambda: fused_embed(x, w), reps)
        p2 = time_ms(lambda: fused_embed_ref(x, w), reps)
        b, by = bound_ms(n, d, k)
        res[(n, d, k)] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                          "bound_ms": b, "bound_by": by}
        log(f"time fused_embed N={n} D={d} K={k}: kernel {k1:.5f}/{k2:.5f} "
            f"ms, plain {p1:.5f}/{p2:.5f} ms, bound {b:.6f} ms ({by}); "
            f"library: none (no single PyTorch call computes "
            f"tanh(((x-mean)*scale)@w))")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_embed import fused_embed
    from repro_torch.kernels.ref import fused_embed_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {built} (wall {time.perf_counter() - t0:.2f} s)")

    worst = compare_kernel(fused_embed, fused_embed_ref, dev)
    mp = main_path(args, fused_embed)
    quickstart()
    tm = timings(fused_embed, fused_embed_ref, dev, mp["K"])

    main_shape = tm[(256, 16, mp["K"])]
    big = tm[(1 << 20, 16, mp["K"])]
    floor = tm[(1, 16, 8)]
    kernels = [{
        "name": "fused_embed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_embed.cu",
        "replaces": "src/repro/kernels/fused_embed.py:44",
        "launches": mp["launches"],
        "max_abs_err": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        "shape": [256, 16, mp["K"]],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "launch_floor_ms": floor["ms"],
        "at_2p20_rows": {"shape": [1 << 20, 16, mp["K"]], **big},
    }]
    log(f"main path: model={mp['model']} stage_count={mp['stage_count']} "
        f"cold={mp['cold_s']:.4f} s warm={mp['warm_s']:.4f} s "
        f"predict={mp['predict_s']:.4f} s "
        f"(launches cold={mp['launches']} predict={mp['predict_launches']})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
