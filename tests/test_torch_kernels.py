"""Port parity: ``repro_torch.kernels.fused_embed`` against the reference
Pallas kernel (``repro.kernels.ops.fused_embed``, interpret mode on CPU).

Inputs come from numpy seeds and go into both packages. Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in float32 (summation
order differs between XLA and torch) and 2e-2 in bfloat16 (one bf16 ulp
of a tanh output below 1 is 2^-8 ~ 3.9e-3; two roundings may differ).
On the CPU the wrapper takes its plain PyTorch version; the CUDA kernel
itself is held to it on the card by ``tests/test_torch_kernels_cuda.py``
and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import fused_embed  # noqa: E402
from repro_torch.kernels.ref import fused_embed_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(N, D, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, K)) * 0.05).astype(np.float32)
    return x, w


def _both(x, w, dtype, mean=0.0, scale=1.0, block_rows=256):
    want = ref_ops.fused_embed(jnp.asarray(x).astype(JAX_DT[dtype]),
                               jnp.asarray(w), mean=mean, scale=scale,
                               block_rows=block_rows, interpret=True)
    got = fused_embed(torch.from_numpy(x).to(TORCH_DT[dtype]),
                      torch.from_numpy(w), mean=mean, scale=scale)
    return (got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,K,br", [(256, 128, 64, 64), (512, 64, 32, 128),
                                      (256, 16, 33, 256)])
@pytest.mark.parametrize("mean,scale", [(0.0, 1.0), (0.5, 2.0)])
def test_fused_embed_matches_reference(dtype, N, D, K, br, mean, scale):
    x, w = _inputs(N, D, K)
    got, want = _both(x, w, dtype, mean, scale, block_rows=br)
    assert got.shape == want.shape == (N, K)
    err = float(np.abs(got - want).max())
    assert err < TOL[dtype], err


@pytest.mark.parametrize("N", [0, 1, 100, 300, 511])
def test_fused_embed_ragged_rows_match_reference(N):
    x, w = _inputs(N, 64, 32, seed=2)
    got, want = _both(x, w, "float32")
    assert got.shape == want.shape == (N, 32)
    if N:
        assert float(np.abs(got - want).max()) < TOL["float32"]


def test_cpu_tensor_takes_plain_version_without_launch():
    x, w = _inputs(100, 16, 33, seed=3)
    before = fused_embed.launch_count
    got = fused_embed(torch.from_numpy(x), torch.from_numpy(w))
    assert fused_embed.launch_count == before
    np.testing.assert_array_equal(
        got.numpy(), fused_embed_ref(torch.from_numpy(x),
                                     torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("xdt,wdt", [(torch.float16, torch.float32),
                                     (torch.int32, torch.float32),
                                     (torch.float32, torch.float64)])
def test_unsupported_dtype_raises(xdt, wdt):
    x = torch.zeros((4, 16), dtype=xdt)
    w = torch.zeros((16, 8), dtype=wdt)
    with pytest.raises(TypeError):
        fused_embed(x, w)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        fused_embed(torch.zeros((4, 16)), torch.zeros((15, 8)))
