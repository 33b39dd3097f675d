"""The reduction of a trace: the device's busy union, the idle gaps by
what the host was doing, and the event-loss check of a kernel's time."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import trace  # noqa: E402


def test_reduce_union_and_gaps():
    spans = [(0.0, 100.0, "generate L=8"), (110.0, 200.0, "generate L=16")]
    tops = [(0.0, 20.0, "aten::embedding"), (60.0, 100.0, "aten::argmax"),
            (110.0, 150.0, "aten::mm")]
    dev = [(10.0, 30.0, "k_a"), (20.0, 50.0, "k_b"), (150.0, 190.0, "k_a")]
    t = trace.reduce(dev, spans, tops, [{"flash_attention": 1},
                                        {"flash_attention": 1}])
    assert t["window_s"] == pytest.approx(200e-6)
    assert t["busy_s"] == pytest.approx(80e-6)
    assert t["kernels"]["k_a"] == [pytest.approx(60e-6), 2]
    assert [sorted(s["kernels"]) for s in t["spans"]] == [["k_a", "k_b"],
                                                          ["k_a"]]
    assert t["spans"][1]["kernels"]["k_a"] == [pytest.approx(40e-6), 1]
    # each gap goes whole to what the host was doing at its start
    assert dict(t["idle_gaps"]) == {
        "generate L=8: aten::embedding": pytest.approx(10e-6),
        "generate L=8: no op of the span": pytest.approx(100e-6),
        "generate L=16: no op of the span": pytest.approx(10e-6)}
    assert t["device_ops"][0] == ["k_a", pytest.approx(60e-6)]


def _spans(*calls):
    """A reduced trace of calls, each (seconds a flash event, events,
    launches)."""
    return {"spans": [{"kernels": {"flash_mma_kernel<5>": [s * n, n],
                                   "other": [5.0, 3]},
                       "launches": {"flash_attention": want}}
                      for s, n, want in calls]}


def test_kernel_seconds_checks_lost_events():
    log = []
    whole = _spans((0.01, 24, 24), (0.5, 24, 24))
    assert trace.kernel_seconds(whole, ["flash_mma"], ["flash_mma"],
                                "flash_attention", log.append) == \
        pytest.approx(24 * 0.51)
    assert not log
    # a long call's lost events are made up from its own, not the mean
    lost = _spans((0.01, 24, 24), (0.5, 22, 24))
    assert trace.kernel_seconds(lost, ["flash_mma"], ["flash_mma"],
                                "flash_attention", log.append) == \
        pytest.approx(24 * 0.51)
    assert log
    # more than a tenth lost, a span with none, or more events than
    # launches: nothing to read
    for t in (_spans((0.01, 24, 24), (0.5, 18, 24)),
              _spans((0.01, 24, 24), (0.5, 0, 2)),
              _spans((0.01, 25, 24))):
        assert trace.kernel_seconds(t, ["flash_mma"], ["flash_mma"],
                                    "flash_attention", log.append) is None
    assert trace.kernel_seconds(whole, ["decode"], ["decode_mma"],
                                "decode_attention", log.append) is None
