"""``perfbench.spans``: the program's spans of the traced steps, per step,
by device time or else host time; and the four span metrics of the
danube-train rehearsal."""
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, spans  # noqa: E402
from repro_torch import tracing  # noqa: E402

SPAN_METRICS = ("forward_ms.train", "backward_ms.train",
                "attention_backward_ms.train", "optimizer_ms.train")


def _span(name, t0, t1, device_ms=None, parent=None):
    return tracing.Span(name, 0, 0, parent, t0, t1, None, device_ms)


def _ctx(kind="train"):
    return SimpleNamespace(mix={"kind": kind}, window=SimpleNamespace(
        traced=[{"t0": 10.0, "t1": 20.0}, {"t0": 20.0, "t1": 30.0}]))


def test_ms_per_step_reads_the_traced_steps(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [
        _span("train.forward", 5.0, 6.0, 100.0),       # before the steps
        _span("train.forward", 11.0, 12.0, 4.0),
        _span("train.forward", 21.0, 21.5),             # host: 500 ms
        _span("train.update", 22.0, 23.0, 7.0),
        _span("train.forward", 29.0, 31.0, 100.0),     # past the last
        _span("flash_attention.backward", 12.0, 13.0, 3.0, "train.backward"),
        _span("flash_attention.backward", 14.0, 15.0, 9.0, None),
    ])
    ctx = _ctx()
    assert spans.ms_per_step(ctx, ("train.forward",)) == \
        pytest.approx((4.0 + 500.0) / 2)
    assert spans.ms_per_step(ctx, ("train.forward", "train.update")) == \
        pytest.approx((4.0 + 500.0 + 7.0) / 2)
    assert spans.ms_per_step(ctx, ("flash_attention.backward",),
                             parent="train.backward") == pytest.approx(1.5)
    assert spans.ms_per_step(ctx, ("train.accumulate",)) is None
    assert spans.ms_per_step(_ctx("serve"), ("train.forward",)) is None


def test_ms_per_step_reads_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.ms_per_step(_ctx(), ("train.forward",)) is None


def test_the_rehearsal_reads_every_span_metric():
    res, _ = harness.run("danube-train", 2 ** 31 + 31, 0.3, True,
                         started=time.perf_counter(), rehearse=True,
                         log=lambda m: None)
    got = {k: res["metrics"][k]["value"] for k in SPAN_METRICS}
    assert all(v > 0 for v in got.values()), got
    assert got["attention_backward_ms.train"] < got["backward_ms.train"]
    phases = (got["forward_ms.train"] + got["backward_ms.train"]
              + got["optimizer_ms.train"])
    assert phases <= res["device"]["window_s"] * 1e3
