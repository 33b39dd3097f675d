"""The hand-written CUDA ``fused_embed`` against its plain PyTorch version,
on the card. Skips where there is no CUDA device; imports no jax, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: 2e-5 in float32 (the kernel sums in another order than the
plain version's matmul), 2e-2 in bfloat16 (the output's own rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_embed  # noqa: E402
from repro_torch.kernels.ref import fused_embed_ref  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _inputs(N, D, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, K)) * 0.05).astype(np.float32)
    return x, w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and run the "
                    "kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,K", [(0, 16, 8), (1, 16, 33), (256, 16, 40),
                                   (511, 32, 64), (300, 1024, 512)])
@pytest.mark.parametrize("mean,scale", [(0.0, 1.0), (0.5, 2.0)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, N, D, K, mean,
                                   scale):
    x, w = _inputs(N, D, K, seed=4)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    wt = torch.from_numpy(w).to(cuda_device)
    before = fused_embed.launch_count
    got = fused_embed(xt, wt, mean=mean, scale=scale)
    torch.cuda.synchronize()
    assert fused_embed.launch_count == before + (1 if N else 0)
    want = fused_embed_ref(xt, wt, mean, scale)
    assert got.shape == (N, K) and got.dtype == xt.dtype
    if N:
        err = float((got.float() - want.float()).abs().max())
        assert err < TOL[dtype], err


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((8, 16), device=cuda_device)
    w = torch.zeros((16, 4), device=cuda_device)
    with pytest.raises(ValueError):
        fused_embed(x, w.cpu())                  # devices differ
    with pytest.raises(ValueError):
        fused_embed(x.t(), torch.zeros((8, 4), device=cuda_device))
    with pytest.raises(TypeError):
        fused_embed(x.half(), w)
