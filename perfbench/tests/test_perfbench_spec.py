"""BENCHMARK.json keeps to its contract's characters and keys (and so do
the held entries of ``perfbench/held.json``), every cell finds its files
by name (its architecture file too), and no module the harness loads is
of the JAX package (top-level names compared whole)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest


ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def _spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _held():
    from perfbench import harness
    return harness.with_held(_spec())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@pytest.mark.parametrize("spec", [_spec, _held])
def test_names_units_and_keys(spec):
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(_line(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config",
                                                  "traffic"))
        assert _line(w["why"]) and w["chips"] in (1, 4)
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("spec", [_spec, _held])
def test_every_cell_finds_its_files(spec):
    from perfbench import archs, harness
    b = spec()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        c = harness.cell(w["name"], b)
        got = c.metrics
        assert "setup_s" in {m["name"] for m in got["end_to_end"]}
        assert len(got["end_to_end"]) >= 2 and got["per_layer"]
        for m in got["end_to_end"] + got["per_layer"]:
            assert callable(harness.reader(m["name"]))
        for m in got["per_layer"]:
            assert m["moves"] in e2e
            assert m["moves"] in {x["name"] for x in got["end_to_end"]}
        assert c.limits and c.mix["kind"] in harness.LOOPS
        assert c.cfg["vocab_size"] > 0
        assert (ROOT / c.cfg["arch"]).is_file()
        assert all(callable(getattr(c.arch, n)) for n in archs.INTERFACE)


def test_banned_modules_compares_whole_names():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "perfbench_run", ROOT / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.banned_modules(["repro_torch", "repro_torch.models",
                               "jaxtyping", "reproducer"]) == []
    assert run.banned_modules(["repro.models", "jax", "jaxlib.xla",
                               "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def test_a_rehearsal_loads_no_module_of_the_jax_package():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import harness\n"
        "for wl in ('danube-score', 'danube-train'):\n"
        "    harness.run(wl, 1, 0.2, True, started=time.perf_counter(),\n"
        "                rehearse=True, log=lambda m: None)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_run_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                          "--workload", "danube-train", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout == ""
