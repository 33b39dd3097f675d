"""Port parity for the serving launcher: ``repro_torch.launch.serve``
against ``repro.launch.serve`` on the CPU (smoke h2o-danube, float32).

The same converted params and prompts go into both ``ServingEngine``s;
greedy decoding must give identical tokens. The port's entry points run on
``cuda`` unless asked for the CPU, and raise where there is no CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.launch.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "h2o-danube-1.8b"


def _engines(slots=2, prompt=32, gen=8, arch=ARCH):
    jm = jbuild(jsmoke(arch), attn_impl="naive")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    m = build_model(smoke_config(arch), attn_impl="naive")
    return (JServingEngine(jm, jparams, max_len=prompt + gen,
                           batch_slots=slots),
            serve.ServingEngine(m, params, max_len=prompt + gen,
                                batch_slots=slots, device="cpu"))


def test_generate_gives_the_reference_greedy_tokens():
    want_engine, engine = _engines()
    prompts = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(
        np.int32)
    want = want_engine.generate(prompts, 8)
    got = engine.generate(prompts, 8)
    assert got.shape == (4, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    st = engine.stats
    assert st["prefill_tokens"] == 4 * 32 and st["decode_tokens"] == 4 * 7


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_families_generate_the_reference_greedy_tokens(arch):
    """The MoE, SSM and hybrid families through both engines: 70-token
    prompts (past recurrentgemma's 64-slot window) in two slot chunks."""
    want_engine, engine = _engines(prompt=70, gen=6, arch=arch)
    prompts = np.random.default_rng(1).integers(0, 512, (4, 70)).astype(
        np.int32)
    want = want_engine.generate(prompts, 6)
    got = engine.generate(prompts, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_main_serves_the_families_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--gen", "4"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out


def test_enc_dec_is_refused_by_the_launcher():
    with pytest.raises(SystemExit, match="make_prefill_step / make_serve_step"):
        serve.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu"])


def test_main_runs_on_the_cpu_when_asked(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated (8, 16)" in out and "on cpu" in out


def test_slots_come_from_the_cuda_cost_profile():
    """h2o-danube-1.8b's 3.7 GB of weights dominate each batch's cost, so
    throughput rises with the batch up to the largest candidate that fits
    the 8 GB cap."""
    from repro_torch.configs import get_config
    assert serve.serving_slots(get_config(ARCH)) == 32


@pytest.mark.parametrize("arch,slots", [("mamba2-370m", 32),
                                        ("olmoe-1b-7b", 1),
                                        ("recurrentgemma-9b", 1)])
def test_family_slots_come_from_eq_11(arch, slots):
    """Eq. 11 with its 8 GB cap: mamba2's 0.84 GB of bf16 weights leave
    room for 32 slots; olmoe's 13.8 GB and recurrentgemma's 17 GB exceed
    the cap at any batch, and the cost model falls back to 1."""
    from repro_torch.configs import get_config
    assert serve.serving_slots(get_config(arch)) == slots


def test_cuda_is_the_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = build_model(smoke_config(ARCH))
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.ServingEngine(m, params, max_len=8, batch_slots=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_params_off_the_engine_device_are_refused():
    m = build_model(smoke_config(ARCH))
    params = m.init(torch.Generator().manual_seed(0))
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="params lie elsewhere"):
        serve.ServingEngine(m, params, max_len=8, batch_slots=1,
                            device="cpu")
