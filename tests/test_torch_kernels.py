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


# -- rmsnorm, flash_attention, decode_attention ------------------------------
# Plain versions against ``repro.kernels.ref`` at ``tests/test_kernels.py``'s
# shapes, one interpret-mode case of each Pallas kernel, and ragged shapes
# (N, S not a multiple of any block) against ``repro.kernels.ref`` only.
# Float32 throughout, tolerance 2e-5 (summation order differs).

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 rmsnorm)
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     flash_attention_ref, rmsnorm_ref)

F32_TOL = 2e-5


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("N,D", [(256, 512), (512, 1024), (128, 384),
                                 (1, 2560), (37, 80), (300, 2560)])
def test_rmsnorm_plain_matches_reference(N, D):
    x, w = _normal((N, D), 0), _normal((D,), 1, 0.1)
    want = jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))
    got = rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (N, D)
    assert _err(got.numpy(), want) < F32_TOL
    # the wrapper takes the plain version for a CPU tensor, without a launch
    before = rmsnorm.launch_count
    np.testing.assert_array_equal(
        rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        got.numpy())
    assert rmsnorm.launch_count == before


def test_rmsnorm_pallas_interpret_matches_port():
    x, w = _normal((256, 512), 2), _normal((512,), 3, 0.1)
    want = ref_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w), block_rows=64,
                           interpret=True)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert _err(got.numpy(), want) < F32_TOL


FLASH_SHAPES = [(1, 2, 1, 128, 32), (2, 4, 2, 256, 64), (1, 8, 8, 256, 16),
                (2, 8, 1, 128, 64)]
RAGGED_FLASH = [(1, 4, 2, 100, 80), (2, 4, 1, 37, 32), (1, 2, 2, 1, 16)]


def _qkv(B, Hq, Hkv, S, D, seed):
    return (_normal((B, Hq, S, D), seed), _normal((B, Hkv, S, D), seed + 1),
            _normal((B, Hkv, S, D), seed + 2))


@pytest.mark.parametrize("B,Hq,Hkv,S,D", FLASH_SHAPES + RAGGED_FLASH)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 96), (True, 7)])
def test_flash_attention_plain_matches_reference(B, Hq, Hkv, S, D, causal,
                                                 window):
    q, k, v = _qkv(B, Hq, Hkv, S, D, seed=S)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert got.shape == (B, Hq, S, D)
    assert _err(got.numpy(), want) < F32_TOL


def test_flash_attention_pallas_interpret_matches_port():
    q, k, v = _qkv(2, 4, 2, 256, 64, seed=5)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=96,
                                   block_q=64, block_k=128, interpret=True)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=96)
    assert _err(got.numpy(), want) < F32_TOL


def test_flash_attention_strided_views_match_contiguous():
    """The model hands in [B, S, H, D] activations as transpose(1, 2)
    views; the result must not depend on the layout."""
    q, k, v = _qkv(2, 4, 2, 40, 16, seed=9)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = flash_attention(tq, tk, tv, causal=True, window=16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (tq, tk, tv)]
    got = flash_attention(*views, causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# The backward kernel's plain twin (lse / delta form) against autograd
# through the plain version, float32, atol 1e-5 (sums in another order).
# Square shapes under every mask; Sq != Sk under masks that leave every
# query a key (a query with none has no softmax to differentiate).
FLASH_GRAD_CASES = (
    [(B, Hq, Hkv, S, S, D, causal, window)
     for B, Hq, Hkv, S, D in FLASH_SHAPES + RAGGED_FLASH
     for causal, window in ((True, None), (False, None), (True, 96),
                            (True, 7))]
    + [(1, 4, 2, 64, 150, 16, False, None), (2, 4, 4, 150, 64, 32, False,
                                              None),
       (1, 4, 1, 100, 70, 16, True, None), (1, 2, 2, 40, 130, 16, False, 9)])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", FLASH_GRAD_CASES)
def test_flash_backward_twin_matches_autograd(B, Hq, Hkv, Sq, Sk, D, causal,
                                              window):
    from repro_torch.kernels.ref import flash_attention_backward_ref
    q = torch.from_numpy(_normal((B, Hq, Sq, D), Sq))
    k = torch.from_numpy(_normal((B, Hkv, Sk, D), Sk + 1))
    v = torch.from_numpy(_normal((B, Hkv, Sk, D), Sk + 2))
    do = torch.from_numpy(_normal((B, Hq, Sq, D), 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = flash_attention_ref(*leaves, causal=causal, window=window,
                                 return_lse=True)
    want = torch.autograd.grad(o, leaves, do)
    got = flash_attention_backward_ref(q, k, v, o.detach(), lse.detach(), do,
                                       causal=causal, window=window)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", [
    (2, 4, 2, 100, 100, 16, True, 7), (1, 4, 1, 64, 150, 32, False, None)])
def test_flash_attention_ref_lse_is_logsumexp(B, Hq, Hkv, Sq, Sk, D, causal,
                                              window):
    q = torch.from_numpy(_normal((B, Hq, Sq, D), 1))
    k = torch.from_numpy(_normal((B, Hkv, Sk, D), 2))
    v = torch.from_numpy(_normal((B, Hkv, Sk, D), 3))
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    torch.testing.assert_close(o, flash_attention_ref(q, k, v, causal=causal,
                                                      window=window))
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(Hq // Hkv, dim=1)) * D ** -0.5
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    band = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        band &= kpos <= qpos
    if window is not None:
        band &= kpos > qpos - window
    want = torch.logsumexp(s.masked_fill(~band, float("-inf")), dim=-1)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def _einsum_attention(q, k, v, causal, window):
    """Softmax attention in float32 by einsum: q, k [B, H, S, D], v
    [B, H, S, Dv], the scale D^-0.5."""
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    qpos, kpos = torch.arange(S)[:, None], torch.arange(S)[None, :]
    band = torch.ones((S, S), dtype=torch.bool)
    if causal:
        band &= kpos <= qpos
    if window is not None:
        band &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~band, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("B,H,S,causal,window", [
    (2, 4, 70, True, None), (1, 2, 130, False, None), (1, 4, 100, True, 9)])
def test_flash_attention_latent_widths_plain(B, H, S, causal, window):
    """q.k 192 wide, values 128 (latent attention): the plain forward and
    its backward (through ``FlashAttentionFunction``, and the backward
    kernel's twin) against an f32 einsum and its autograd."""
    from repro_torch.kernels.ref import flash_attention_backward_ref
    q = torch.from_numpy(_normal((B, H, S, 192), 1))
    k = torch.from_numpy(_normal((B, H, S, 192), 2))
    v = torch.from_numpy(_normal((B, H, S, 128), 3))
    do = torch.from_numpy(_normal((B, H, S, 128), 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = _einsum_attention(*leaves, causal, window)
    want_g = torch.autograd.grad(want, leaves, do)
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    got = flash_attention(*mine, causal=causal, window=window)
    assert got.shape == (B, H, S, 128)
    assert _err(got.detach().numpy(), want.detach().numpy()) < F32_TOL
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    twin = flash_attention_backward_ref(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    for a, b, w in zip(torch.autograd.grad(got, mine, do), twin, want_g):
        assert a.shape == w.shape and b.shape == w.shape
        assert _err(a.numpy(), w.numpy()) < 1e-5
        assert _err(b.numpy(), w.numpy()) < 1e-5


DECODE_SHAPES = [(2, 8, 2, 512, 64), (1, 4, 4, 256, 32), (3, 16, 2, 384, 16),
                 (2, 4, 1, 100, 80)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODE_SHAPES)
@pytest.mark.parametrize("length_frac", [1.0, 0.6, 0.1])
def test_decode_attention_plain_matches_reference(B, Hq, Hkv, S, D,
                                                  length_frac):
    q = _normal((B, Hq, D), S)
    kc, vc = _normal((B, Hkv, S, D), 1), _normal((B, Hkv, S, D), 2)
    L = max(1, int(S * length_frac))
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), L)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), L)
    assert got.shape == (B, Hq, D)
    assert _err(got.numpy(), want) < F32_TOL


def test_decode_attention_per_row_lengths():
    q = _normal((3, 8, 32), 4)
    kc, vc = _normal((3, 2, 70, 32), 5), _normal((3, 2, 70, 32), 6)
    lengths = [1, 33, 70]
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.tensor(lengths))
    for b, L in enumerate(lengths):
        want = jref.decode_attention_ref(jnp.asarray(q[b:b + 1]),
                                         jnp.asarray(kc[b:b + 1]),
                                         jnp.asarray(vc[b:b + 1]), L)
        assert _err(got[b:b + 1].numpy(), want) < F32_TOL


def test_decode_attention_pallas_interpret_matches_port():
    q = _normal((2, 8, 64), 7)
    kc, vc = _normal((2, 2, 512, 64), 8), _normal((2, 2, 512, 64), 9)
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), 300, block_k=128,
                                    interpret=True)
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), 300)
    assert _err(got.numpy(), want) < F32_TOL


@pytest.mark.parametrize("call,exc", [
    (lambda: rmsnorm(torch.zeros(4, 8), torch.zeros(7)), ValueError),
    (lambda: rmsnorm(torch.zeros(4, 8, dtype=torch.float16),
                     torch.zeros(8)), TypeError),
    (lambda: flash_attention(torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16),
                             torch.zeros(1, 2, 8, 16)), ValueError),
    (lambda: flash_attention(torch.zeros(1, 2, 8, 16), torch.zeros(1, 1, 8, 16),
                             torch.zeros(1, 1, 8, 16), window=0), ValueError),
    (lambda: flash_attention(torch.zeros(1, 2, 8, 16),
                             torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16),
                             torch.zeros(1, 1, 8, 16)), TypeError),
    (lambda: decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 2, 8, 16),
                              torch.zeros(2, 2, 8, 16), 2.5), TypeError),
    (lambda: decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 2, 8, 16),
                              torch.zeros(2, 2, 8, 16),
                              torch.tensor([1, 2, 3])), ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc):
    with pytest.raises(exc):
        call()


# -- decode_attention's split plan and combine rule --------------------------
# The CUDA kernel cuts the cache below ``length`` into the chunks of
# ``_split_plan`` and merges their partial softmax sums. The same rule,
# written here in torch over the plan's splits, must equal the plain version
# and the Pallas kernel: it is what the kernel computes, in f32 (2e-5).

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (SPLIT_QUANTUM,  # noqa: E402
                                                  _split_plan)

PLAN_SHAPES = [(32, 8, 528), (32, 8, 1), (32, 8, 4096), (1, 8, 4096),
               (1, 8, 64), (1, 8, 65), (64, 8, 4096), (4, 8, 4096),
               (3, 2, 384), (2, 2, 512), (1, 1, 1), (1, 1, 100000)]


@pytest.mark.parametrize("B,Hkv,n", PLAN_SHAPES)
def test_split_plan_covers_each_position_once(B, Hkv, n):
    chunk, splits = _split_plan(B, Hkv, n)
    assert chunk % SPLIT_QUANTUM == 0 and splits >= 1
    covered = np.zeros(n, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, n)
        assert lo < hi, "a split of the plan covers nothing"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the grid fills the card's 132 SMs, or has a block per quantum; the
    # combine pass takes at most 1024 splits
    blocks = B * Hkv * splits
    assert blocks >= min(132, B * Hkv * -(-n // SPLIT_QUANTUM))
    assert splits <= 1024


def _split_combine(q, kc, vc, lengths, chunk, splits):
    """The kernel's rule in torch: per split, (acc, m, l) over its
    positions below the row's length; then o = sum w acc / sum w l with
    w = exp(m - max m)."""
    B, Hq, D = q.shape
    Hkv, S = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, D).float() * D ** -0.5
    pos = torch.arange(S)
    accs, ms, ls = [], [], []
    for s in range(splits):
        inside = ((pos >= s * chunk) & (pos < (s + 1) * chunk)
                  & (pos[None, :] < lengths[:, None]))           # [B, S]
        sc = torch.einsum("bkgd,bksd->bkgs", qf, kc.float())
        sc = torch.where(inside[:, None, None, :], sc, -1e30)
        m = sc.max(dim=-1).values                                 # [B,k,g]
        p = torch.exp(sc - m[..., None]) * inside[:, None, None, :]
        accs.append(torch.einsum("bkgs,bksd->bkgd", p, vc.float()))
        ms.append(m)
        ls.append(p.sum(-1))
    m = torch.stack(ms)
    w = torch.exp(m - m.max(dim=0).values)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    den = (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    return (acc / den[..., None]).reshape(B, Hq, D)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 8, 2, 512, 64),
                                          (1, 32, 8, 4096, 80),
                                          (3, 16, 2, 384, 16)])
@pytest.mark.parametrize("where", ["1", "chunk-1", "chunk", "chunk+1",
                                   "full", "rows"])
def test_split_combine_rule_matches_plain(B, Hq, Hkv, S, D, where):
    q = torch.from_numpy(_normal((B, Hq, D), 11))
    kc = torch.from_numpy(_normal((B, Hkv, S, D), 12))
    vc = torch.from_numpy(_normal((B, Hkv, S, D), 13))
    chunk = _split_plan(B, Hkv, S)[0]
    if where == "rows":                 # one length per row: 1 and S mixed
        lengths = torch.tensor([(1, S, chunk + 1)[b % 3] for b in range(B)])
        plan = _split_plan(B, Hkv, S)
        length = lengths
    else:
        n = {"1": 1, "chunk-1": chunk - 1, "chunk": chunk,
             "chunk+1": chunk + 1, "full": S}[where]
        lengths = torch.full((B,), n)
        plan = _split_plan(B, Hkv, n)
        length = n
    got = _split_combine(q, kc, vc, lengths, *plan)
    want = decode_attention_ref(q, kc, vc, length)
    assert _err(got.numpy(), want.numpy()) < F32_TOL


@pytest.mark.parametrize("length", [1, 64, 65, 300, 512])
def test_split_combine_rule_matches_pallas(length):
    q = _normal((2, 8, 64), 14)
    kc, vc = _normal((2, 2, 512, 64), 15), _normal((2, 2, 512, 64), 16)
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), length, block_k=128,
                                    interpret=True)
    got = _split_combine(torch.from_numpy(q), torch.from_numpy(kc),
                         torch.from_numpy(vc), torch.full((2,), length),
                         *_split_plan(2, 2, length))
    assert _err(got.numpy(), want) < F32_TOL


def test_library_path_covers_the_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    first = _build._library_path("k")
    assert _build._library_path("k") == first          # unchanged: reused
    header.write_text("// v2\n")
    edited = _build._library_path("k")
    assert edited != first                             # edited: rebuilt
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build._library_path("k") not in (first, edited)
    assert first.parent == tmp_path / "build"


def test_ptxas_report_reads_each_kernel(tmp_path, monkeypatch):
    """The build keeps ptxas's report beside the library; ptxas_report
    reads each entry's registers, stack and spills from it (a library on
    disk is not built again)."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// k\n")
    lib = _build._library_path("k")
    lib.parent.mkdir()
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 2 barriers, 384 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bPf\n"
        "    64 bytes stack frame, 68 bytes spill stores, 96 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 456 bytes "
        "cmem[0]\n")
    assert _build.ptxas_report("k") == {
        "_Z1aPf": {"registers": 168, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0},
        "_Z1bPf": {"registers": 255, "stack": 64, "spill_stores": 68,
                   "spill_loads": 96}}


# -- the launch plans of rmsnorm and fused_embed ----------------------------
# The CUDA kernels walk rows (rmsnorm) or row tiles (fused_embed) over a
# persistent grid the wrappers plan in Python; every row must be taken
# exactly once, and the register / staged path taken exactly where the
# width, size and alignment rules allow it.

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.fused_embed import (BLOCK_SMEM,  # noqa: E402
                                             MAX_WARPS, SLICE_SMEM,
                                             STAGED_D, W_CAP, WARP_ROWS,
                                             _plan, _slice_smem,
                                             _staged_smem)
from repro_torch.kernels.rmsnorm import (INSTANCES, MAX_GROUPS,  # noqa: E402
                                         MAX_VECTORS, _norm_instance,
                                         _norm_plan)

_SMS = 132


def _resident(blocks):
    return lambda *_: blocks


@pytest.mark.parametrize("n", [1, 7, 32, 131, 132, 1000, 16384, 200001])
@pytest.mark.parametrize("d,itemsize", [(2560, 2), (2560, 4), (16384, 2),
                                        (16384, 4), (1024, 2), (80, 2)])
@pytest.mark.parametrize("resident", [1, 2, 3])
def test_norm_plan_covers_each_row_once(n, d, itemsize, resident):
    plan = _norm_plan(n, d, itemsize, _SMS, _resident(resident))
    seen = np.zeros(n, np.int64)
    if plan.nv == 0:                 # the general path: a block a row
        assert 1 <= plan.grid <= n
        for b in range(plan.grid):
            seen[b::plan.grid] += 1
    else:
        assert 1 <= plan.groups * plan.wpr <= max(MAX_GROUPS, plan.wpr)
        assert plan.grid <= _SMS * resident
        stride = plan.grid * plan.groups
        for b in range(plan.grid):
            for g in range(plan.groups):
                seen[b * plan.groups + g::stride] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("itemsize", [2, 4])
def test_norm_plan_takes_registers_at_every_config_width(arch, itemsize):
    d = get_config(arch).d_model
    nv, wpr = _norm_instance(d, itemsize)
    assert (nv, wpr) in INSTANCES and nv <= MAX_VECTORS
    assert nv * 32 * wpr * (16 // itemsize) == d
    # the fewest warps a row that keep a lane within MAX_VECTORS
    assert wpr == 1 or d // (16 // itemsize) > MAX_VECTORS * 32 * (wpr // 2)
    plan = _norm_plan(16384, d, itemsize, _SMS, _resident(2))
    assert (plan.nv, plan.wpr) == (nv, wpr)
    assert _norm_plan(16384, d, itemsize, _SMS, _resident(2),
                      aligned=False).nv == 0


@pytest.mark.parametrize("d,itemsize", [(80, 2), (7, 4), (2561, 2),
                                        (3072, 2), (2564, 4), (0, 2),
                                        (40960, 2)])
def test_norm_plan_takes_the_general_path_off_the_instances(d, itemsize):
    assert _norm_instance(d, itemsize) is None
    assert _norm_plan(100, max(d, 1), itemsize, _SMS, _resident(2)).nv == 0


def test_norm_plan_spreads_few_rows_over_the_sms():
    decode = _norm_plan(32, 2560, 2, _SMS, _resident(2))
    assert (decode.groups, decode.grid) == (1, 32)     # a warp a row
    prefill = _norm_plan(16384, 2560, 2, _SMS, _resident(2))
    # 2048 row groups in 8 rounds of at most 264 blocks: 256 blocks of 8
    assert (prefill.groups, prefill.grid) == (MAX_GROUPS, 256)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 255, 256, 257, 4099,
                               (1 << 20) + 3])
@pytest.mark.parametrize("k", [1, 8, 33, 64, 65, 512])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_embed_plan_covers_each_row_once(n, k, itemsize):
    plan = _plan(n, 16, k, itemsize, _SMS, _resident(3))
    assert plan.rows > 0
    tiles = -(-n // plan.rows)
    assert 1 <= plan.warps <= MAX_WARPS
    assert 1 <= plan.grid <= _SMS * 3
    assert (plan.grid - 1) * plan.warps < tiles             # no idle block
    seen = np.zeros(n, np.int64)
    stride = plan.grid * plan.warps
    for b in range(plan.grid):
        for v in range(plan.warps):
            for t in range(b * plan.warps + v, tiles, stride):
                seen[t * plan.rows:(t + 1) * plan.rows] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [8, 16, 24, 32, 64, 128, 1024])
@pytest.mark.parametrize("k", [1, 8, 28, 33, 40, 64, 65, 512, 1024, 1025])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_embed_plan_stages_exactly_where_the_rules_allow(d, k, itemsize):
    plan = _plan(4096, d, k, itemsize, _SMS, _resident(2))
    staged = d in STAGED_D and 4 * d * k <= W_CAP and any(
        r * k * itemsize % 16 == 0
        and _slice_smem(d, k, r, itemsize) <= SLICE_SMEM for r in WARP_ROWS)
    assert (plan.rows > 0) == staged
    assert _plan(4096, d, k, itemsize, _SMS, _resident(2),
                 aligned=False).rows == 0
    if staged:
        assert plan.rows in WARP_ROWS
        # a tile's outputs and inputs are whole 16-byte chunks
        assert plan.rows * k * itemsize % 16 == 0
        assert plan.rows * d * itemsize % 16 == 0
        assert _slice_smem(d, k, plan.rows, itemsize) <= SLICE_SMEM
        assert _staged_smem(d, k, plan.rows, itemsize,
                            plan.warps) <= BLOCK_SMEM


def test_embed_plan_spreads_the_main_path_chunk():
    # a 256-row chunk of the SQL path spreads over at least 16 blocks; 2^20
    # rows take the largest tile and full blocks, within one round of
    # resident blocks
    chunk = _plan(256, 16, 33, 4, _SMS, _resident(3))
    assert chunk.grid >= 16 and chunk.warps > 1
    big = _plan(1 << 20, 16, 33, 4, _SMS, _resident(2))
    assert (big.rows, big.warps) == (max(WARP_ROWS), MAX_WARPS)
    blocks = -(-(1 << 20) // (big.rows * big.warps))
    assert -(-blocks // big.grid) == -(-blocks // (_SMS * 2))


@pytest.mark.parametrize("units", [1, 7, 131, 132, 133, 264, 2048, 4096,
                                   100003])
@pytest.mark.parametrize("cap", [1, 32, 132, 264, 396])
def test_even_grid_keeps_the_rounds_and_evens_the_blocks(units, cap):
    grid = _build.even_grid(units, cap)
    assert 1 <= grid <= min(units, cap)
    assert -(-units // grid) == -(-units // cap)      # no extra round
    base = units // grid                              # counts differ by 1
    assert all(base <= len(range(b, units, grid)) <= base + 1
               for b in range(min(grid, 50)))

