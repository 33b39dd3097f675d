"""The port's spans (``repro_torch.tracing``) on the CPU: off, a span is a
shared no-op that records nothing and touches no CUDA; under
``torch.profiler`` it is a plain function-scope op in the trace and a
record in the store, with its parent taken across threads; the train
step's phases and the attention backward nest as the benchmark reads
them."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (OptimizerConfig, init_state,  # noqa: E402
                                  make_train_step)


@pytest.fixture
def store(monkeypatch):
    fresh = tracing.Store()
    monkeypatch.setattr(tracing, "STORE", fresh)
    return fresh


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_off_records_nothing_and_touches_no_cuda(store, monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a span off touched CUDA")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    assert tracing.span("a") is tracing.span("b", 1, 2)
    with tracing.span("train.forward", 0, 0):
        torch.ones(2) + 1
    assert tracing.spans() == []


def test_a_span_on_records_its_fields(store):
    with _profiled():
        before = time.perf_counter()
        with tracing.span("train.backward", 7, 3):
            with tracing.span("inner"):
                torch.ones(4).sum()
        after = time.perf_counter()
    inner, outer = tracing.spans()
    assert (outer.name, outer.step, outer.micro, outer.parent) == \
        ("train.backward", 7, 3, None)
    # a child takes its parent's step and micro-batch
    assert (inner.name, inner.step, inner.micro, inner.parent) == \
        ("inner", 7, 3, "train.backward")
    assert before <= outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= after
    assert outer.device_ms is None and inner.device_ms is None


def test_a_span_in_the_profile_is_no_user_annotation(store):
    with _profiled() as prof:
        with record_function("perfbench/train step"):
            with tracing.span("train.forward", 0, 0):
                torch.ones(4).sum()
    ev = [e for e in prof.events() if e.name == "repro_torch/train.forward"]
    assert len(ev) == 1
    assert ev[0].scope == 0 and not ev[0].is_user_annotation
    assert ev[0].cpu_parent.name == "perfbench/train step"


def test_a_span_on_another_thread_takes_the_open_phase(store):
    got = {}

    def other(key):
        with tracing.span("flash_attention.backward"):
            got[key] = True

    with _profiled():
        with tracing.span("train.backward", 4, 1):
            t = threading.Thread(target=other, args=("in",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        t = threading.Thread(target=other, args=("after",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    first, _, last = tracing.spans()
    assert got == {"in": True, "after": True}
    assert (first.parent, first.step, first.micro) == ("train.backward", 4, 1)
    assert (last.parent, last.step, last.micro) == (None, None, None)


def test_the_store_drops_its_oldest_records(monkeypatch):
    monkeypatch.setattr(tracing, "STORE", tracing.Store(keep=3))
    with _profiled():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]


def test_a_train_step_nests_its_spans(store):
    """One step of 2 micro-batches (remat "full", as the benchmark's cell
    trains): forward, backward and accumulate once a micro-batch, the
    update once, and one attention backward a layer a micro-batch inside
    that micro-batch's backward."""
    cfg = smoke_config("h2o-danube-1.8b").replace(remat_policy="full")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    step = make_train_step(model, OptimizerConfig(), accum_steps=2)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))}
    state = init_state(params)
    params, state, _ = step(params, state, batch)       # untraced: step 0
    assert tracing.spans() == []
    with _profiled():
        step(params, state, batch)
    got = tracing.spans()
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    assert {k: len(v) for k, v in by.items()} == {
        "train.forward": 2, "train.backward": 2, "train.accumulate": 2,
        "train.update": 1, "flash_attention.backward": 2 * cfg.num_layers}
    assert {s.step for s in got} == {1}
    for name in ("train.forward", "train.backward", "train.accumulate"):
        assert [s.micro for s in by[name]] == [0, 1]
    for s in by["flash_attention.backward"]:
        back = by["train.backward"][s.micro]
        assert s.parent == "train.backward"
        assert back.t0 <= s.t0 <= s.t1 <= back.t1
    # the phases follow one another
    order = sorted((s for s in got if s.parent is None), key=lambda s: s.t0)
    assert [s.name for s in order] == [
        "train.forward", "train.backward", "train.accumulate"] * 2 + [
        "train.update"]
    assert all(a.t1 <= b.t0 for a, b in zip(order, order[1:]))


def test_counts_are_kept_only_while_a_profiler_records(store):
    """Off, a count keeps nothing; on, it keeps the name, the time and the
    value, read when asked. The batched MoE counts the copies routed
    to its held experts and those its capacity dropped."""
    import dataclasses
    from repro_torch.models import moe
    assert not tracing.recording()
    tracing.count("a", torch.tensor(3))
    assert tracing.counts() == []
    cfg = smoke_config("olmoe-1b-7b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="batched",
                                              capacity_factor=0.5))
    p = moe.moe_specs(cfg)
    from repro_torch.models.spec import init_params
    p = init_params(p, torch.Generator().manual_seed(0))
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with _profiled():
        assert tracing.recording()
        before = time.perf_counter()
        tracing.count("a", torch.tensor(3))
        moe.moe_apply(cfg, p, x)
    a, routed, dropped = tracing.counts()
    assert (a.name, a.value) == ("a", 3.0) and before <= a.t <= routed.t
    assert routed.name == "moe.routed"
    # 32 tokens x top-2 copies, all held; capacity 0.5 drops some
    assert routed.value == 32 * cfg.moe.top_k
    assert dropped.name == "moe.dropped" and 0 < dropped.value < routed.value
    names = {s.name for s in tracing.spans()}
    assert {"moe.route", "moe.experts"} <= names
