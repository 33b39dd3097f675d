"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Skips where there is no CUDA device; imports no jax, so it runs
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: 2e-5 in float32 for ``fused_embed`` and ``rmsnorm`` (the
kernel sums in another order than the plain version), 5e-5 in float32 for
the attention kernels (softmax sums over up to 4096 keys in another
order). In bfloat16, one bf16 ulp of the value (2^-7 relative), since the
output's own rounding may land on either side of a rounding boundary,
plus 2e-2 for ``fused_embed`` and ``rmsnorm`` and 2e-4 for the attention
kernels: both sides of those compute in float32 and round once, and their
outputs (about 0.02 to 0.07 over thousands of keys) are too small for a
looser bound to catch a kernel that drops a share of the keys.
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


# -- rmsnorm, flash_attention, decode_attention ------------------------------

from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 rmsnorm)
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     flash_attention_ref, rmsnorm_ref)

ATTN_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-4}
BF16_RTOL = 2.0 ** -7


def _assert_close(got, want, dtype, atol=None):
    """|got - want| <= atol (+ one bf16 ulp of want in bfloat16)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    if atol is None:
        atol = TOL[dtype]
    bound = atol + (BF16_RTOL * w.abs() if dtype == torch.bfloat16 else 0.0)
    excess = float(((g - w).abs() - bound).max())
    assert excess <= 0.0, (float((g - w).abs().max()), dtype)


def _randn(shape, seed, dev, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D", [(1, 2560), (4, 2560), (37, 2560),
                                 (4096, 2560), (256, 512), (128, 384),
                                 (33, 80), (5, 7)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_matches_plain(cuda_device, dtype, N, D, wdtype):
    x = _randn((N, D), N + D, cuda_device, dtype)
    w = (_randn((D,), 3, cuda_device, torch.float32) * 0.1).to(wdtype)
    before = rmsnorm.launch_count
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launch_count == before + 1
    _assert_close(got, rmsnorm_ref(x, w), dtype)


def _flash_check(q, k, v, causal, window, dtype):
    """Kernel against its plain version, one kv head's query group at a time
    so the plain version's [G, S, S] scores stay small at S = 8192."""
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    G = q.shape[1] // k.shape[1]
    for h in range(k.shape[1]):
        want = flash_attention_ref(q[:, h * G:(h + 1) * G], k[:, h:h + 1],
                                   v[:, h:h + 1], causal=causal,
                                   window=window)
        _assert_close(got[:, h * G:(h + 1) * G], want, dtype,
                      ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", [
    (1, 2, 1, 128, 32, True, None), (2, 4, 2, 256, 64, False, None),
    (1, 8, 8, 256, 16, True, 96), (2, 8, 1, 128, 64, True, None),
    (1, 4, 2, 100, 80, True, 7), (2, 4, 4, 37, 128, False, 16),
    (32, 32, 8, 512, 80, True, 4096), (1, 32, 8, 1024, 80, True, 4096),
    (1, 32, 8, 8192, 80, True, 4096)])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, B, Hq, Hkv,
                                            S, D, causal, window):
    q = _randn((B, Hq, S, D), 1, cuda_device, dtype)
    k = _randn((B, Hkv, S, D), 2, cuda_device, dtype)
    v = _randn((B, Hkv, S, D), 3, cuda_device, dtype)
    before = flash_attention.launch_count
    _flash_check(q, k, v, causal, window, dtype)
    assert flash_attention.launch_count == before + 1


@pytest.mark.cuda
def test_cuda_flash_attention_reads_the_models_layout(cuda_device):
    """[B, S, H, D] activations as transpose(1, 2) views: no copy in, the
    output comes back in the same layout."""
    q = _randn((2, 300, 32, 80), 4, cuda_device, torch.bfloat16)
    k = _randn((2, 300, 8, 80), 5, cuda_device, torch.bfloat16)
    v = _randn((2, 300, 8, 80), 6, cuda_device, torch.bfloat16)
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=128)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True, window=128)
    _assert_close(got, want, torch.bfloat16, ATTN_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 8, 2, 512, 64),
                                          (3, 16, 2, 384, 16),
                                          (4, 32, 8, 4096, 80)])
@pytest.mark.parametrize("length", [1, 600, 4096, "rows"])
def test_cuda_decode_attention_matches_plain(cuda_device, dtype, B, Hq, Hkv,
                                             S, D, length):
    q = _randn((B, Hq, D), 7, cuda_device, dtype)
    # the model's [B, W, Hkv, D] cache, read through transpose(1, 2) views
    kc = _randn((B, S, Hkv, D), 8, cuda_device, dtype).transpose(1, 2)
    vc = _randn((B, S, Hkv, D), 9, cuda_device, dtype).transpose(1, 2)
    if length == "rows":
        length = torch.randint(1, S + 1, (B,), device=cuda_device)
    before = decode_attention.launch_count
    got = decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    assert decode_attention.launch_count == before + 1
    want = decode_attention_ref(q, kc, vc, length)
    _assert_close(got, want, dtype, ATTN_TOL[dtype])


# -- the tile and split edges of the redesigned attention kernels -----------
# flash: 64-row q tiles and 64-key kv tiles, D padded to 16 in shared memory
# (bf16 on mma.sync) or cut in 16-column groups (f32 on FMA); decode: the
# chunks of _split_plan and the combine pass.

from repro_torch.kernels.decode_attention import _split_plan  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 300])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_cuda_flash_attention_tile_edges(cuda_device, dtype, S, D):
    G = (1, 4, 8)[(S + D) % 3]
    q = _randn((2, 2 * G, S, D), S, cuda_device, dtype)
    k = _randn((2, 2, S, D), D, cuda_device, dtype)
    v = _randn((2, 2, S, D), S + D, cuda_device, dtype)
    for causal in (True, False):
        _flash_check(q, k, v, causal, None, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [63, 64, 65, 129, 300])
@pytest.mark.parametrize("window", [1, 7, 64])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_cuda_flash_attention_window_edges(cuda_device, dtype, S, window,
                                           G):
    q = _randn((1, 2 * G, S, 80), S + window, cuda_device, dtype)
    k = _randn((1, 2, S, 80), G, cuda_device, dtype)
    v = _randn((1, 2, S, 80), S, cuda_device, dtype)
    _flash_check(q, k, v, True, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,W,D", [(32, 32, 8, 4096, 80),
                                          (1, 32, 8, 4096, 80),
                                          (64, 32, 8, 4096, 80),
                                          (3, 16, 2, 384, 16)])
@pytest.mark.parametrize("where", ["1", "chunk-1", "chunk", "chunk+1", "W",
                                   "rows"])
def test_cuda_decode_attention_split_edges(cuda_device, dtype, B, Hq, Hkv, W,
                                           D, where):
    q = _randn((B, Hq, D), B + W, cuda_device, dtype)
    kc = _randn((B, W, Hkv, D), 10, cuda_device, dtype).transpose(1, 2)
    vc = _randn((B, W, Hkv, D), 11, cuda_device, dtype).transpose(1, 2)
    chunk = _split_plan(B, Hkv, W)[0]
    if where == "rows":             # per-row lengths: 1, W and a boundary
        length = torch.tensor([(1, W, chunk + 1, chunk)[b % 4]
                               for b in range(B)], device=cuda_device)
    else:
        length = {"1": 1, "chunk-1": chunk - 1, "chunk": chunk,
                  "chunk+1": chunk + 1, "W": W}[where]
    before = decode_attention.launch_count
    got = decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    assert decode_attention.launch_count == before + 1
    _assert_close(got, decode_attention_ref(q, kc, vc, length), dtype,
                  ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [136, 160, 192, 232, 256])
@pytest.mark.parametrize("B,length", [(2, 1), (2, 300), (1, 1024),
                                      (3, "rows")])
def test_cuda_decode_attention_wide_heads(cuda_device, dtype, D, B, length):
    # head dims past 128: the bf16 kernel pads D to ceil(D / 16) k16 steps
    q = _randn((B, 8, D), D, cuda_device, dtype)
    kc = _randn((B, 1024, 2, D), D + 1, cuda_device, dtype).transpose(1, 2)
    vc = _randn((B, 1024, 2, D), D + 2, cuda_device, dtype).transpose(1, 2)
    if length == "rows":
        length = torch.tensor([1, 1024, 65][:B], device=cuda_device)
    got = decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    _assert_close(got, decode_attention_ref(q, kc, vc, length), dtype,
                  ATTN_TOL[dtype])


# -- head dim 256 (gemma-2b, recurrentgemma-9b) and G * D 4096 -------------
# flash: D past 128 runs the KS / JD 16 instances, Q's fragments read from
# shared memory each k step; decode: recurrentgemma's G 16 x D 256 group,
# 16 column pairs a thread on the f32 path.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 65, 300, 1024])
@pytest.mark.parametrize("Hkv,G", [(1, 8), (1, 16), (2, 4)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (True, 257), (False, None)])
def test_cuda_flash_attention_head_dim_256(cuda_device, dtype, S, Hkv, G,
                                           causal, window):
    q = _randn((1, Hkv * G, S, 256), S + G, cuda_device, dtype)
    k = _randn((1, Hkv, S, 256), S + 1, cuda_device, dtype)
    v = _randn((1, Hkv, S, 256), S + 2, cuda_device, dtype)
    before = flash_attention.launch_count
    _flash_check(q, k, v, causal, window, dtype)
    assert flash_attention.launch_count == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [136, 200, 248])
def test_cuda_flash_attention_padded_wide_heads(cuda_device, dtype, D):
    # D in (128, 256) runs the 256 instance with zero columns past D
    q = _randn((2, 4, 130, D), D, cuda_device, dtype)
    k = _randn((2, 2, 130, D), D + 1, cuda_device, dtype)
    v = _randn((2, 2, 130, D), D + 2, cuda_device, dtype)
    for causal, window in ((True, None), (True, 33), (False, None)):
        _flash_check(q, k, v, causal, window, dtype)


@pytest.mark.cuda
def test_cuda_flash_attention_recurrentgemma_prefill(cuda_device):
    # the served prefill's shape: B 32, Hq 16, Hkv 1, S 512, D 256, window
    # 2048, bf16, in the model's [B, S, H, D] layout
    bf = torch.bfloat16
    q = _randn((32, 512, 16, 256), 20, cuda_device, bf).transpose(1, 2)
    k = _randn((32, 512, 1, 256), 21, cuda_device, bf).transpose(1, 2)
    v = _randn((32, 512, 1, 256), 22, cuda_device, bf).transpose(1, 2)
    _flash_check(q, k, v, True, 2048, bf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W", [(32, 2048), (1, 2048), (2, 4096)])
@pytest.mark.parametrize("where", ["1", "chunk-1", "chunk", "chunk+1", "W",
                                   "rows"])
def test_cuda_decode_attention_group_width_4096(cuda_device, dtype, B, W,
                                                where):
    # recurrentgemma's group: G 16 query heads on one kv head of D 256
    Hq, Hkv, D = 16, 1, 256
    q = _randn((B, Hq, D), B + W, cuda_device, dtype)
    kc = _randn((B, W, Hkv, D), 12, cuda_device, dtype).transpose(1, 2)
    vc = _randn((B, W, Hkv, D), 13, cuda_device, dtype).transpose(1, 2)
    chunk = _split_plan(B, Hkv, W)[0]
    if where == "rows":
        length = torch.tensor([(1, W, chunk + 1, chunk)[b % 4]
                               for b in range(B)], device=cuda_device)
    else:
        length = {"1": 1, "chunk-1": chunk - 1, "chunk": chunk,
                  "chunk+1": chunk + 1, "W": W}[where]
    before = decode_attention.launch_count
    got = decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    assert decode_attention.launch_count == before + 1
    _assert_close(got, decode_attention_ref(q, kc, vc, length), dtype,
                  ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(32, 128), (16, 240), (12, 256)])
def test_cuda_decode_attention_wide_groups(cuda_device, dtype, G, D):
    # G * D between 2048 and 4096: 16 column pairs a thread in f32; G past
    # 16 takes two m16 row groups in bf16
    q = _randn((3, 2 * G, D), G + D, cuda_device, dtype)
    kc = _randn((3, 700, 2, D), 14, cuda_device, dtype).transpose(1, 2)
    vc = _randn((3, 700, 2, D), 15, cuda_device, dtype).transpose(1, 2)
    for length in (1, 129, 700):
        got = decode_attention(q, kc, vc, length)
        torch.cuda.synchronize()
        _assert_close(got, decode_attention_ref(q, kc, vc, length), dtype,
                      ATTN_TOL[dtype])


@pytest.mark.cuda
def test_cuda_attention_kernels_reject_unaligned_inputs(cuda_device):
    bf = torch.bfloat16

    def z(*shape, dtype=bf):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    q, kv = z(1, 4, 16, 80), z(1, 2, 16, 80)
    with pytest.raises(ValueError):          # bf16 D not a multiple of 8
        flash_attention(z(1, 4, 16, 20), z(1, 2, 16, 20), z(1, 2, 16, 20))
    with pytest.raises(ValueError):          # q pointer 2 bytes off
        flash_attention(z(1, 4, 16, 81)[..., 1:], kv, kv)
    with pytest.raises(ValueError):          # position stride 84 elements
        flash_attention(q, z(1, 2, 16, 84)[..., :80], kv)
    flash_attention(z(1, 4, 16, 20, dtype=torch.float32),   # f32: FMA, any D
                    z(1, 2, 16, 20, dtype=torch.float32),
                    z(1, 2, 16, 20, dtype=torch.float32))
    qd = z(2, 8, 80)
    cache = z(2, 2, 64, 80)
    with pytest.raises(ValueError):          # D not a multiple of 8
        decode_attention(z(2, 8, 12), z(2, 2, 64, 12), z(2, 2, 64, 12), 4)
    with pytest.raises(ValueError):          # cache pointer 2 bytes off
        decode_attention(qd, z(2, 2, 64, 81)[..., 1:], cache, 4)
    with pytest.raises(ValueError):          # f32 position stride 81
        decode_attention(qd.float(), cache.float(),
                         z(2, 2, 64, 81, dtype=torch.float32)[..., :80], 4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_attention_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 4, 16, 264), device=cuda_device)
    with pytest.raises(ValueError):          # head dim above 256
        flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 16, 32), device=cuda_device)
    with pytest.raises(ValueError):          # devices differ
        flash_attention(q, q[:, :2].cpu(), q[:, :2].cpu())
    with pytest.raises(ValueError):          # last dim not contiguous
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                        q[:, :2], q[:, :2])
    qd = torch.zeros((2, 128, 64), device=cuda_device)
    kc = torch.zeros((2, 1, 32, 64), device=cuda_device)
    with pytest.raises(ValueError):          # G * D above 4096
        decode_attention(qd, kc, kc, 4)
    with pytest.raises(ValueError):          # length on another device
        decode_attention(qd[:, :8], kc, kc, torch.tensor([1, 2]))
    with pytest.raises(ValueError):          # w on another device
        rmsnorm(torch.zeros((4, 8), device=cuda_device), torch.zeros(8))


@pytest.mark.cuda
def test_softcap_config_raises_on_the_card(cuda_device):
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    cfg = smoke_config("h2o-danube-1.8b").replace(attn_logit_softcap=30.0)
    m = build_model(cfg)
    params = m.init(torch.Generator(device=cuda_device).manual_seed(0))
    with pytest.raises(NotImplementedError):
        m.apply(params, torch.zeros((1, 8), dtype=torch.long,
                                    device=cuda_device))


# -- the register / staged paths of the redesigned rmsnorm and fused_embed ---
# rmsnorm: a register instance for each registered config's d_model (one to
# 16 warps a row), the general path for any other D, a D off the vector
# width and unaligned x. fused_embed: the staged path at its tile edges and
# K from 1 to 512, the general path for w above the shared-memory cap and
# unaligned x.

import sys  # noqa: E402

from repro_torch.kernels.fused_embed import _plan  # noqa: E402
from repro_torch.kernels.rmsnorm import _norm_instance  # noqa: E402

REGISTER_WIDTHS = (1024, 2048, 2560, 4096, 7168, 8192, 16384)
_EMBED = sys.modules["repro_torch.kernels.fused_embed"]
_NORM = sys.modules["repro_torch.kernels.rmsnorm"]


def _unaligned(shape, seed, dev, dtype):
    """A contiguous [N, D] view that starts one element past a 16-byte
    boundary."""
    n = 1
    for s in shape:
        n *= s
    buf = _randn((n + 1,), seed, dev, dtype)
    view = buf[1:].view(shape)
    assert view.data_ptr() % 16
    return view


def _rms_check(x, w, dtype):
    before = rmsnorm.launch_count
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launch_count == before + 1
    _assert_close(got, rmsnorm_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", REGISTER_WIDTHS)
@pytest.mark.parametrize("N", [1, 32, 3000])
def test_cuda_rmsnorm_register_widths(cuda_device, dtype, wdtype, D, N):
    assert _norm_instance(D, torch.tensor([], dtype=dtype).element_size())
    x = _randn((N, D), N + D, cuda_device, dtype)
    w = (_randn((D,), D, cuda_device, torch.float32) * 0.1).to(wdtype)
    _rms_check(x, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["outside", "odd", "unaligned",
                                  "many_rows"])
def test_cuda_rmsnorm_general_path(cuda_device, dtype, wdtype, case):
    N, D = {"outside": (300, 3072), "odd": (300, 2561),
            "unaligned": (300, 2560), "many_rows": (200000, 80)}[case]
    if case == "unaligned":
        x = _unaligned((N, D), 5, cuda_device, dtype)
    else:
        x = _randn((N, D), 5, cuda_device, dtype)
        assert _norm_instance(D, x.element_size()) is None
    w = (_randn((D,), 6, cuda_device, torch.float32) * 0.1).to(wdtype)
    _rms_check(x, w, dtype)
    key = (N, D, int(dtype == torch.bfloat16), case != "unaligned",
           x.device)
    assert _NORM._PLANS[key].nv == 0            # the general path ran


def _embed_check(x, w, dtype, staged, mean=0.5, scale=2.0):
    n, d = x.shape
    before = fused_embed.launch_count
    got = fused_embed(x, w, mean=mean, scale=scale)
    torch.cuda.synchronize()
    assert fused_embed.launch_count == before + 1
    key = (n, d, w.shape[1], dtype, x.data_ptr() % 16 == 0, x.device)
    assert (_EMBED._PLANS[key].rows > 0) == staged
    want = fused_embed_ref(x, w, mean, scale)
    assert got.shape == want.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    assert err < TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 8, 28, 33, 40, 64, 65, 512])
@pytest.mark.parametrize("tile,offset", [("small", -1), ("small", 0),
                                         ("small", 1), ("big", -1),
                                         ("big", 0), ("big", 1),
                                         ("2^20", 3)])
def test_cuda_fused_embed_staged_tile_edges(cuda_device, dtype, K, tile,
                                            offset):
    size = torch.tensor([], dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    # three tiles of the plan of a short call (the SQL path's 256-row
    # chunk) or of a long one, and one past 2^20 rows
    rows = {"small": 3 * _plan(256, 16, K, size, sms, lambda *_: 1).rows,
            "big": 3 * _plan(1 << 20, 16, K, size, sms, lambda *_: 1).rows,
            "2^20": 1 << 20}[tile]
    assert rows
    N = rows + offset
    x, w = _inputs(N, 16, K, seed=K)
    _embed_check(torch.from_numpy(x).to(cuda_device, dtype),
                 torch.from_numpy(w).to(cuda_device), dtype, staged=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("N", [1, 255, 256, 4099])
def test_cuda_fused_embed_staged_widths(cuda_device, dtype, D, N):
    x, w = _inputs(N, D, 33, seed=D + N)
    _embed_check(torch.from_numpy(x).to(cuda_device, dtype),
                 torch.from_numpy(w).to(cuda_device), dtype, staged=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["w_above_cap", "unaligned", "wide_d"])
def test_cuda_fused_embed_general_path(cuda_device, dtype, case):
    N, D, K = {"w_above_cap": (1000, 64, 512), "unaligned": (1000, 16, 33),
               "wide_d": (300, 1024, 512)}[case]
    _, w = _inputs(N, D, K, seed=9)
    if case == "unaligned":
        x = _unaligned((N, D), 9, cuda_device, dtype)
    else:
        x = _randn((N, D), 9, cuda_device, dtype)
    _embed_check(x, torch.from_numpy(w).to(cuda_device), dtype,
                 staged=False)


# -- the encoder-decoder shapes and the kernels' gradients ------------------
# whisper-medium: 16 heads of 64, no GQA; cross-attention is non-causal
# flash with Sq != Sk (the kernel masks from position 0 for q and kv
# alike), cross decode reads the whole 1500-position encoder cache.
# Gradients: rmsnorm and flash_attention go through their autograd
# Functions where autograd records (kernel forward; rmsnorm's backward
# plain, flash's the backward kernel in bfloat16 and plain in float32); f32
# grads within atol 1e-5 of plain autograd's (the same float32 math, k and
# v summed over query chunks in another order), bf16 at TOL; decode and
# fused_embed refuse an input that requires grad.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(64, 1500), (1500, 64), (448, 1500),
                                   (1500, 1500)])
def test_cuda_flash_attention_cross_shapes(cuda_device, dtype, Sq, Sk):
    q = _randn((2, Sq, 16, 64), Sq, cuda_device, dtype).transpose(1, 2)
    k = _randn((2, Sk, 16, 64), Sk + 1, cuda_device, dtype).transpose(1, 2)
    v = _randn((2, Sk, 16, 64), Sk + 2, cuda_device, dtype).transpose(1, 2)
    before = flash_attention.launch_count
    _flash_check(q, k, v, False, None, dtype)
    assert flash_attention.launch_count == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [2, 32])
@pytest.mark.parametrize("length", [1, 64, 1499, 1500])
def test_cuda_decode_attention_cross_cache(cuda_device, dtype, B, length):
    """G 1, D 64 against a 1500-position cache (whisper's cross decode
    reads all 1500; its self decode any prefix)."""
    q = _randn((B, 16, 64), 10, cuda_device, dtype)
    kc = _randn((B, 1500, 16, 64), 11, cuda_device, dtype).transpose(1, 2)
    vc = _randn((B, 1500, 16, 64), 12, cuda_device, dtype).transpose(1, 2)
    got = decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    _assert_close(got, decode_attention_ref(q, kc, vc, length), dtype,
                  ATTN_TOL[dtype])


GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: TOL[torch.bfloat16]}


def _plain_grads(fn, inputs, dy):
    leaves = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D", [(64, 2560), (4096, 1024), (33, 80)])
def test_cuda_rmsnorm_grads_match_plain_autograd(cuda_device, dtype, N, D):
    x = _randn((N, D), N, cuda_device, dtype)
    w = (_randn((D,), 3, cuda_device, torch.float32) * 0.1).to(dtype)
    dy = _randn((N, D), 4, cuda_device, dtype)
    want = _plain_grads(rmsnorm_ref, (x, w), dy)
    before = rmsnorm.launch_count
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = rmsnorm(xs, ws)
    assert y.grad_fn is not None and rmsnorm.launch_count == before + 1
    got = torch.autograd.grad(y, (xs, ws), dy)
    torch.cuda.synchronize()
    assert rmsnorm.launch_count == before + 1       # a plain backward
    for a, b in zip(got, want):
        # the w gradient sums N rows: bound it relative to its size
        _assert_close(a, b, dtype, GRAD_TOL[dtype] * max(
            1.0, float(b.float().abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", [
    (1, 32, 8, 1024, 1024, 80, True, 4096),
    (1, 16, 16, 448, 1500, 64, False, None),
    (1, 16, 16, 1500, 1500, 64, False, None),
    (1, 8, 2, 300, 300, 128, True, 64),
    (1, 32, 8, 2048, 2048, 80, True, 4096),     # danube-train, cut
    (1, 8, 1, 700, 700, 256, True, 256)])       # gemma-like: MQA, D 256
def test_cuda_flash_attention_grads_match_plain_autograd(
        cuda_device, dtype, B, Hq, Hkv, Sq, Sk, D, causal, window):
    q = _randn((B, Sq, Hq, D), 1, cuda_device, dtype)
    k = _randn((B, Sk, Hkv, D), 2, cuda_device, dtype)
    v = _randn((B, Sk, Hkv, D), 3, cuda_device, dtype)
    do = _randn((B, Hq, Sq, D), 4, cuda_device, dtype)

    def ref(q, k, v):
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window)

    want = _plain_grads(ref, (q, k, v), do)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launch_count,
              flash_attention.backward_launch_count)
    o = flash_attention(*(t.transpose(1, 2) for t in leaves), causal=causal,
                        window=window)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    # bf16: the backward kernel, one launch; f32: the plain backward
    assert (flash_attention.launch_count - before[0],
            flash_attention.backward_launch_count - before[1]) == (
        1, int(dtype == torch.bfloat16))
    for a, b in zip(got, want):
        _assert_close(a, b, dtype, GRAD_TOL[dtype] * max(
            1.0, float(b.float().abs().max())))


def _latent_qkv(B, H, S, seed, dev, dtype):
    """Latent attention's q, k [B, H, S, 192] and v [B, H, S, 128] in the
    model's layout: q and k [B, S, H, 192] tensors, v the last 128 columns
    of each head of the [B, S, H, 256] up-projection, all seen through
    transpose(1, 2)."""
    q = _randn((B, S, H, 192), seed, dev, dtype)
    k = _randn((B, S, H, 192), seed + 1, dev, dtype)
    kv = _randn((B, S, H, 256), seed + 2, dev, dtype)
    return (q.transpose(1, 2), k.transpose(1, 2),
            kv[..., 128:].transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,Dv,causal,window", [
    (1, 2, 1, 128, 128, 16, 16, True, None),
    (2, 4, 2, 256, 256, 32, 32, False, None),
    (1, 4, 2, 100, 100, 48, 48, True, 7),
    (2, 8, 1, 128, 128, 64, 64, True, None),
    (1, 4, 2, 37, 37, 80, 80, True, 16),
    (1, 32, 8, 1024, 1024, 80, 80, True, 4096),
    (2, 4, 2, 200, 200, 96, 96, False, 33),
    (1, 8, 2, 300, 300, 128, 128, True, 64),
    (1, 16, 16, 448, 1500, 64, 64, False, None),
    (1, 4, 4, 150, 64, 64, 64, False, None),
    (1, 2, 2, 1, 1, 80, 80, True, None),
    (1, 8, 1, 320, 320, 256, 256, True, 96),
    (1, 4, 2, 130, 130, 200, 200, False, None),
    (2, 16, 16, 500, 500, 80, 80, False, None),
    (1, 2, 2, 37, 37, 192, 128, True, None),
    (2, 4, 4, 300, 300, 192, 128, False, None),
    (1, 4, 4, 200, 200, 192, 128, True, 33),
    (1, 16, 16, 1024, 1024, 192, 128, True, None),
    (1, 4, 4, 2048, 2048, 192, 128, True, None),
    # one short of, one past and two past the 128-key tile
    (1, 4, 2, 127, 127, 80, 80, True, None),
    (1, 4, 2, 129, 129, 80, 80, False, None),
    (2, 4, 1, 257, 257, 80, 80, True, 100),
    (1, 2, 2, 127, 127, 192, 128, True, None),
    (1, 2, 2, 129, 129, 192, 128, False, None),
    (1, 2, 2, 257, 257, 192, 128, True, None),
    (1, 8, 2, 129, 257, 64, 64, False, None),
    # G 8 heads x 10 q tiles: up to 80 turns of the 2-stage ring a block
    (1, 16, 2, 640, 640, 80, 80, True, None)])
def test_cuda_flash_backward_kernel_matches_twin(cuda_device, B, Hq, Hkv, Sq,
                                                 Sk, D, Dv, causal, window):
    """The backward kernel against its plain twin on the same bf16 inputs,
    o and lse (the kernel's forward), at every instance: values as wide as
    q.k, and latent attention's (192, 128) in the model's layout (v a slice
    of the up-projection, dv in v's shape). Both compute in float32 and
    round once, so within one bf16 ulp plus 1e-3 of the largest gradient
    (the kernel's P and dS carried as bf16 hi + lo, ~2^-17 relative). The
    lse within 1e-4 of the plain version's; the forward's output the same
    with and without it."""
    from repro_torch.kernels.flash_attention import _launch, _launch_backward
    from repro_torch.kernels.ref import flash_attention_backward_ref
    bf = torch.bfloat16
    if Dv == D:
        q = _randn((B, Sq, Hq, D), 1, cuda_device, bf).transpose(1, 2)
        k = _randn((B, Sk, Hkv, D), 2, cuda_device, bf).transpose(1, 2)
        v = _randn((B, Sk, Hkv, D), 3, cuda_device, bf).transpose(1, 2)
        do = _randn((B, Hq, Sq, D), 4, cuda_device, bf)
    else:
        assert (Hq, Sq, D, Dv) == (Hkv, Sk, 192, 128)
        q, k, v = _latent_qkv(B, Hq, Sq, 11, cuda_device, bf)
        do = _randn((B, Hq, Sq, Dv), 14, cuda_device, bf)
    o, lse = _launch(q, k, v, causal, window, with_lse=True)
    assert torch.equal(o, _launch(q, k, v, causal, window))
    _, want_lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert lse.shape == (B, Hq, -(-Sq // 64) * 64)
    torch.testing.assert_close(lse[..., :Sq], want_lse, rtol=0, atol=1e-4)
    before = flash_attention.backward_launch_count
    got = _launch_backward(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.backward_launch_count == before + 1
    want = flash_attention_backward_ref(q, k, v, o, lse[..., :Sq], do,
                                        causal=causal, window=window)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.shape == t.shape
        if Dv == D:
            assert a.stride() == t.stride()
        _assert_close(a, b, bf, 1e-3 * max(1.0, float(b.float().abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv,fallback", [(80, 80, 0), (192, 128, 0),
                                           (64, 64, 0), (256, 256, 1)])
def test_cuda_flash_backward_counts_the_fallback(cuda_device, D, Dv,
                                                  fallback):
    """danube's and moonlight's widths run the Hopper kernel
    (``backward_fallback_count`` unchanged); D 256 runs the mma.sync one
    and is counted."""
    from repro_torch.kernels.flash_attention import _launch, _launch_backward
    bf = torch.bfloat16
    q = _randn((1, 2, 200, D), 1, cuda_device, bf)
    k = _randn((1, 2, 200, D), 2, cuda_device, bf)
    v = _randn((1, 2, 200, Dv), 3, cuda_device, bf)
    do = _randn((1, 2, 200, Dv), 4, cuda_device, bf)
    o, lse = _launch(q, k, v, True, None, with_lse=True)
    before = (flash_attention.backward_launch_count,
              flash_attention.backward_fallback_count)
    _launch_backward(q, k, v, o, lse, do, True, None)
    torch.cuda.synchronize()
    assert (flash_attention.backward_launch_count - before[0],
            flash_attention.backward_fallback_count - before[1]) == (
        1, fallback)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,causal,window", [
    (1, 2, 37, True, None), (2, 4, 300, False, None), (1, 4, 200, True, 33),
    (1, 16, 1024, True, None), (2, 16, 8192, True, None)])
def test_cuda_flash_attention_latent_widths(cuda_device, dtype, B, H, S,
                                            causal, window):
    """q.k over 192 columns, values 128 wide (Moonlight's latent
    attention), against the plain version, in the model's layout; the
    output is 128 wide, in q's layout."""
    q, k, v = _latent_qkv(B, H, S, 7, cuda_device, dtype)
    before = flash_attention.launch_count
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launch_count == before + 1
    assert got.shape == (B, H, S, 128) and got.transpose(1, 2).is_contiguous()
    for h in range(H):
        want = flash_attention_ref(q[:, h:h + 1], k[:, h:h + 1],
                                   v[:, h:h + 1], causal=causal,
                                   window=window)
        _assert_close(got[:, h:h + 1], want, dtype, ATTN_TOL[dtype])


@pytest.mark.cuda
def test_cuda_flash_attention_latent_grads_through_the_function(cuda_device):
    """The (192, 128) pair through ``FlashAttentionFunction``: one forward
    and one backward launch, gradients within the plain autograd's at the
    bf16 bound of the grads test."""
    bf = torch.bfloat16
    q, k, v = _latent_qkv(1, 4, 500, 21, cuda_device, bf)
    do = _randn((1, 4, 500, 128), 24, cuda_device, bf)
    want = _plain_grads(lambda q, k, v: flash_attention_ref(q, k, v),
                        (q, k, v), do)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launch_count,
              flash_attention.backward_launch_count)
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention.launch_count - before[0],
            flash_attention.backward_launch_count - before[1]) == (1, 1)
    for a, b in zip(got, want):
        _assert_close(a, b, bf, GRAD_TOL[bf] * max(
            1.0, float(b.float().abs().max())))


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_other_value_widths(cuda_device):
    q = _randn((1, 2, 64, 128), 1, cuda_device, torch.bfloat16)
    v = _randn((1, 2, 64, 64), 2, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="values 64 wide"):
        flash_attention(q, q, v)
    with pytest.raises(ValueError):
        flash_attention(q, q, _randn((1, 2, 64, 136), 3, cuda_device,
                                     torch.bfloat16))


@pytest.mark.cuda
def test_cuda_serving_kernels_refuse_an_input_that_requires_grad(
        cuda_device):
    q = _randn((2, 8, 64), 1, cuda_device, torch.float32)
    kc = _randn((2, 128, 2, 64), 2, cuda_device, torch.float32).transpose(1, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q.requires_grad_(), kc, kc, 5)
    x, w = _inputs(8, 16, 4)
    xt = torch.from_numpy(x).to(cuda_device).requires_grad_()
    wt = torch.from_numpy(w).to(cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_embed(xt, wt)
    with torch.no_grad():           # not recording: each launches
        decode_attention(q, kc, kc, 5)
        fused_embed(xt, wt)
    decode_attention(q.detach(), kc, kc, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-medium"])
def test_cuda_model_grads_kernel_route_match_plain_route(cuda_device, arch):
    """Smoke-size f32 model under full remat: every leaf's gradient within
    1e-3 of the largest of its plain-route gradient, the launches those of
    a forward and its recompute."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model, make_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.optimizer import tree_leaves, tree_map
    cfg = smoke_config(arch).replace(remat_policy="full")
    params = build_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    batch = make_batch(cfg, ShapeConfig("s", 256, 2, "train"), seed=1,
                       device=cuda_device)
    grads = {}
    for use in (True, False):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        before = (flash_attention.launch_count, rmsnorm.launch_count)
        loss, _ = build_model(cfg, use_kernels=use).loss(tracked, batch)
        grads[use] = torch.autograd.grad(loss, tree_leaves(tracked))
        torch.cuda.synchronize()
        if use:
            n_attn = (cfg.num_layers if arch != "whisper-medium"
                      else cfg.num_encoder_layers + 2 * cfg.num_layers)
            n_norm = 0 if cfg.norm == "layernorm" else 4 * cfg.num_layers + 1
            assert (flash_attention.launch_count - before[0],
                    rmsnorm.launch_count - before[1]) == (2 * n_attn, n_norm)
    for a, b in zip(grads[True], grads[False]):
        assert a is not None
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


# -- the data-parallel mesh backend: one fused_embed launch a shard ----------

def _mesh_run(backend, zm, X, version):
    from types import SimpleNamespace

    from repro_torch.pipeline.backend import InferSpec
    from repro_torch.pipeline.batcher import BatcherStats
    spec = InferSpec(kind="embed", task="t", col="x", out="f", table="m",
                     version=version, model=SimpleNamespace(zoo_model=zm),
                     stats=BatcherStats())
    before = fused_embed.launch_count
    out = backend.run_infer(spec, {"x": X})["f"]
    torch.cuda.synchronize()
    return out, fused_embed.launch_count - before


def _mesh_models():
    from repro_torch.core.zoo import ZooModel
    rng = np.random.default_rng(7)
    W = rng.standard_normal((16, 33)).astype(np.float32) * 0.3
    out = {m: ZooModel(name=m, source_family="gauss", W=W, mode=m)
           for m in ("linear", "relu", "proj1d")}
    out["radial"] = ZooModel(
        name="radial", source_family="ring", W=W, mode="radial",
        centers=rng.standard_normal((12, 16)).astype(np.float32), sigma=1.3)
    return out


def _check_mesh(backend, n_rows):
    from repro_torch.pipeline.backend import TorchBackend
    X = np.random.default_rng(8).standard_normal((n_rows, 16)).astype(
        np.float32)
    single = TorchBackend(device="cuda")
    for mode, zm in _mesh_models().items():
        got, launches = _mesh_run(backend, zm, X, mode)
        want, single_launches = _mesh_run(single, zm, X, mode)
        assert launches == (backend.device_count if mode == "linear" else 0)
        assert single_launches == (1 if mode == "linear" else 0)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, zm.features(X), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 37, 4096, 70000])
def test_cuda_mesh_backend_one_card_named_twice(cuda_device, n_rows):
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.pipeline.backend import MeshTorchBackend
    dev0 = torch.device("cuda", 0)
    backend = MeshTorchBackend(ServingMesh((dev0, dev0)))
    assert backend.device_count == 2
    _check_mesh(backend, n_rows)


@pytest.mark.cuda
def test_cuda_mesh_backend_every_visible_gpu(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more visible GPUs")
    from repro_torch.pipeline.backend import MeshTorchBackend
    backend = MeshTorchBackend(device="cuda")
    assert backend.device_count == torch.cuda.device_count()
    assert len(backend.mesh.distinct_devices()) == backend.device_count
    _check_mesh(backend, 70000)


# -- decode_attention over slices of a cache (a cache split over ranks) -----

from repro_torch.kernels.decode_attention import (  # noqa: E402
    combine_partials, decode_attention_partial)
from repro_torch.kernels.ref import decode_attention_partial_ref  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,W,D", [(128, 32, 8, 4096, 80),
                                          (32, 32, 8, 4096, 80),
                                          (8, 16, 1, 2048, 256),
                                          (3, 16, 2, 384, 16)])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("where", ["W", "W-7", "quarter+3", "rows"])
def test_cuda_decode_attention_partial_combines_to_the_whole(
        cuda_device, dtype, B, Hq, Hkv, W, D, n, where):
    """Each slice's (o, lse) from one launch, against the plain twin
    (o at the kernel's attention bound, lse within 1e-3); merged by
    ``combine_partials`` they equal the whole kernel within one bf16 ulp
    plus 2e-4, or 1e-5 in float32. A slice wholly past length gives o = 0
    and lse = -inf."""
    q = _randn((B, Hq, D), B + W + n, cuda_device, dtype)
    kc = _randn((B, W, Hkv, D), 20, cuda_device, dtype).transpose(1, 2)
    vc = _randn((B, W, Hkv, D), 21, cuda_device, dtype).transpose(1, 2)
    if where == "rows":
        length = torch.tensor([(1, W, W // 4 + 3, W - 7)[b % 4]
                               for b in range(B)], device=cuda_device)
    else:
        length = {"W": W, "W-7": W - 7, "quarter+3": W // 4 + 3}[where]
    ws, os_, ls_ = W // n, [], []
    for i in range(n):
        ks, vs = (c[:, :, i * ws:(i + 1) * ws] for c in (kc, vc))
        ln = (length - i * ws).clamp(0, ws) if isinstance(
            length, torch.Tensor) else max(0, min(length - i * ws, ws))
        before = decode_attention.launch_count
        o, lse = decode_attention_partial(q, ks, vs, ln)
        torch.cuda.synchronize()
        assert decode_attention.launch_count == before + 1
        assert o.dtype == lse.dtype == torch.float32
        ro, rl = decode_attention_partial_ref(q, ks, vs, ln)
        live = torch.as_tensor(ln, device=cuda_device).expand(B) > 0
        assert torch.isneginf(lse[~live]).all()
        assert not o[~live].abs().sum() > 0
        if live.any():
            assert (lse[live] - rl[live]).abs().max() <= 1e-3
        _assert_close(o, ro, torch.float32, ATTN_TOL[dtype])
        os_.append(o)
        ls_.append(lse)
    got = combine_partials(os_, ls_, dtype)
    _assert_close(got, decode_attention(q, kc, vc, length), dtype,
                  1e-5 if dtype == torch.float32 else ATTN_TOL[dtype])
