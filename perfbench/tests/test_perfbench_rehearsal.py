"""The whole harness rehearsed on the CPU at smoke width, cell by cell
(the benchmark's and the held ones of ``perfbench/held.json``): the
result's fields, the check passing a sound run and failing each fault a
cell can have and the control (the reference in float8)."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import calibrate, harness  # noqa: E402

BENCH = harness.with_held(json.loads((ROOT / "BENCHMARK.json").read_text()))
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [c for c in CELLS if harness.cell(c, BENCH).mix["kind"] == "serve"]
TRAIN = [c for c in CELLS if harness.cell(c, BENCH).mix["kind"] == "train"]
SEED = 2 ** 31 + 29


def rehearse(name, trace=False, control=False, seed=SEED):
    return harness.run(name, seed, 0.3, trace, started=time.perf_counter(),
                       rehearse=True, control=control, log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_result(name, trace):
    res, readings = rehearse(name, trace)
    c = harness.cell(name, BENCH)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checked"
    assert res["correct"] is True, res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    # on the CPU only the readers of the device's trace find nothing
    want = {m["name"] for m in c.metrics[kind]
            if m["source"] != "device_trace"}
    assert set(res["metrics"]) == want
    assert set(res["checked"]) == set(c.limits) <= set(readings)
    assert ("breakdown" in res) == trace
    if trace:
        assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_token_fails_the_check(name, monkeypatch):
    from repro_torch.launch.serve import ServingEngine
    generate = ServingEngine.generate

    def altered(self, prompts, gen_tokens):
        out = generate(self, prompts, gen_tokens)
        out[0, -1] = (out[0, -1] + 1) % self.model.cfg.vocab_size
        return out

    monkeypatch.setattr(ServingEngine, "generate", altered)
    res, _ = rehearse(name)
    assert res["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_keeps_its_state_fails_the_check(name, monkeypatch):
    import repro_torch.training as training
    make = training.make_train_step

    def unchanged(*args, **kw):
        step = make(*args, **kw)

        def keep(params, state, batch):
            _, _, out = step(params, state, batch)
            return params, state, out

        return keep

    monkeypatch.setattr(training, "make_train_step", unchanged)
    res, _ = rehearse(name)
    assert res["correct"] is False
    assert res["checked"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_fails_the_check(name):
    with calibrate.half_batch():
        res, _ = rehearse(name)
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name):
    res, readings = rehearse(name, control=True)
    # the harness's own check holds the control's numbers to the limits
    assert set(res["checked"]) == set(harness.cell(name, BENCH).limits)
    assert all(v["value"] == readings[f"control.{k}"]
               for k, v in res["checked"].items())
    assert res["correct"] is False, res["checked"]
