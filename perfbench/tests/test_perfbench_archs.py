"""A configuration brings its model by the file its key ``"arch"`` names:
a cell without one fails by name, the harness dispatches on the file (a
test-only variant with one fault in its reference fails a sound run's
check), and the program's ``ModelConfig`` reads every field by its type
from JSON."""
import dataclasses
import json
import sys
import time
import typing
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402

DANUBE = "perfbench/configs/h2o-danube-1.8b.json"
FAULTY = "perfbench/tests/arch_unscaled_final_norm.py"


def _bench_with(tmp_path, **changes):
    """The benchmark (and its held cells) with danube's configuration
    file replaced by a copy with ``changes`` (a value of None drops the
    key)."""
    cfg = json.loads((ROOT / DANUBE).read_text())
    cfg.update(changes)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    path = tmp_path / "danube.json"
    path.write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        if c["file"] == DANUBE:
            c["file"] = str(path)
    return bench, path


@pytest.mark.parametrize("arch, says", [
    (None, "no key \"arch\""),
    ("perfbench/archs/no_such_model.py", "perfbench/archs/no_such_model.py"),
])
def test_a_cell_without_its_arch_file_fails_by_name(tmp_path, arch, says):
    bench, path = _bench_with(tmp_path, arch=arch)
    with pytest.raises(SystemExit) as e:
        harness.cell("danube-train", bench)
    assert str(path) in str(e.value) and says in str(e.value)


@pytest.mark.parametrize("arch, correct", [
    ("perfbench/archs/transformer.py", True), (FAULTY, False)])
def test_the_check_follows_the_arch_file(tmp_path, monkeypatch, arch,
                                         correct):
    bench, _ = _bench_with(tmp_path, arch=arch)
    monkeypatch.setattr(harness, "spec", lambda: bench)
    c = harness.cell("danube-train")
    assert c.arch.__file__ == str(ROOT / arch)
    res, readings = harness.run("danube-train", 2 ** 31 + 3, 0.3, False,
                                started=time.perf_counter(), rehearse=True,
                                log=lambda m: None)
    assert res["correct"] is correct, readings


def _other(hint, default):
    """A value of type ``hint`` other than ``default``."""
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    if args and typing.get_origin(hint) is typing.Union:
        hint = args[0]
    if dataclasses.is_dataclass(hint):
        return hint(**{f.name: _other(typing.get_type_hints(hint)[f.name],
                                      f.default)
                       for f in dataclasses.fields(hint)})
    if typing.get_origin(hint) is tuple:
        return ("attn", "rglru", "attn")
    if hint is bool:
        return not default
    if hint in (int, float):
        return (default or 0) + 3
    return f"{default}x"


REQUIRED = {"arch_id": "a", "family": "moe", "num_layers": 2, "d_model": 8,
            "num_heads": 2, "num_kv_heads": 1, "d_ff": 16, "vocab_size": 64}


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(ModelConfig)])
def test_model_config_round_trips_through_json(field):
    hints = typing.get_type_hints(ModelConfig)
    f = next(f for f in dataclasses.fields(ModelConfig) if f.name == field)
    value = _other(hints[field], REQUIRED.get(field, f.default))
    want = ModelConfig(**dict(REQUIRED, **{field: value}))
    text = json.dumps(dict(dataclasses.asdict(want), arch="x.py"))
    got = harness.model_config(json.loads(text))
    assert got == want and hash(got) == hash(want)
    assert type(getattr(got, field)) is type(value)
