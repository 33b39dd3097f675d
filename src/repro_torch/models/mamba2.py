"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Port of ``src/repro/models/mamba2.py``. Prefill runs the chunked SSD
algorithm: quadratic attention-like products inside a chunk and a linear
recurrence over the chunk states, which the reference runs as a
``lax.scan`` and the port as a Python loop over chunks. Decode is the O(1)
recurrent update ``h = h * exp(dt * A) + dt * B ⊗ x``. Both share the
parameters. The gated norm stays plain torch, as it is plain jnp in the
reference; the block has no Pallas kernel, so it runs no port kernel.

On a device mesh the projections are DTensor products, and the rest runs
shard-local (:func:`_split_heads`) as the reference places it: the input
projection's product and the conv stay whole over ``"model"``
(``in_proj`` is ``("embed", None)``), each rank runs the chunked scan on
its own heads (``xh``, ``dt``, ``A`` and ``D`` split by ``act_ssm_heads``
/ ``ssm_heads``), the gated norm's mean over ``d_in`` sums its squares
over those ranks, and ``out_proj``'s rows (``"rnn"``) make the block's
output a partial sum, constrained as the reference's is. Decode updates
each rank's heads of the SSM state the same way; the one-token conv runs
before that body, as DTensor ops of the global program (the window
[B, K-1, C] read in the cache's placements), so no rank repeats it in a
body that splits the heads.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import lshard, shard_map
from repro_torch.models.layers import (all_reduce_sum, batch_rows, dense,
                                       dtype_of, gather_fsdp, split_index)
from repro_torch.models.spec import P


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.state_dim
    return s, d_in, nheads, conv_ch


def mamba_specs(cfg) -> dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": P((d, 2 * d_in + 2 * s.n_groups * s.state_dim + nheads),
                     ("embed", None)),
        "conv_w": P((s.conv_dim, conv_ch), ("conv", None), init="small"),
        "conv_b": P((conv_ch,), (None,), init="zeros"),
        "a_log": P((nheads,), ("ssm_heads",), init="mamba_alog",
                   dtype="float32"),
        "dt_bias": P((nheads,), ("ssm_heads",), init="mamba_dt",
                     dtype="float32"),
        "d_skip": P((nheads,), ("ssm_heads",), init="ones", dtype="float32"),
        "norm_w": P((d_in,), ("act_rnn",), init="zeros"),
        "out_proj": P((d_in, d), ("rnn", "embed")),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    s, d_in, nheads, _ = _dims(cfg)
    gn = s.n_groups * s.state_dim
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nheads], dim=-1)


def _gated_norm(y, z, w, eps, groups=(), width=None):
    """RMS norm of ``y * silu(z)`` over the last dim, scale ``(1 + w)``.
    On a rank's slice of ``width`` channels the sum of squares is summed
    over ``groups`` (the ranks holding the other slices) first."""
    dt = y.dtype
    y = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if groups:
        var = all_reduce_sum((y * y).sum(dim=-1, keepdim=True),
                             groups) / width
    else:
        var = torch.mean(y * y, dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps)
            * (1.0 + w.to(torch.float32))).to(dt)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: [B,S,C]; w: [K,C]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    out = xp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.

    x: [b,S,H,P]; dt: [b,S,H] (>0); A: [H] (<0); B,C: [b,S,G,N].
    Returns y: [b,S,H,P] in x's dtype and the final state [b,H,P,N] (f32).
    """
    b, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    nc = S // chunk
    L = chunk
    f32 = torch.float32

    xc = x.reshape(b, nc, L, H, Pd).to(f32)
    dtc = dt.reshape(b, nc, L, H).to(f32)
    Bc = torch.repeat_interleave(B.reshape(b, nc, L, G, N), rep,
                                 dim=3).to(f32)
    Cc = torch.repeat_interleave(C.reshape(b, nc, L, G, N), rep,
                                 dim=3).to(f32)

    lam = dtc * A[None, None, None, :].to(f32)     # log-decay, <=0 [b,nc,L,H]
    cum = torch.cumsum(lam, dim=2)                 # within-chunk cumulative
    total = cum[:, :, -1, :]                       # [b,nc,H]

    # ---- intra-chunk (quadratic within chunk, causal) --------------------
    # scores[i,j] = C_i·B_j * exp(cum_i - cum_j) * dt_j  for j <= i. Above
    # the diagonal exp(diff) may overflow to inf: torch.where selects 0
    # there (as jnp.where does), but the gradient through the exp would be
    # 0 * inf = nan (the reference's jax.grad gives nan for dt then, at a
    # full-width chunk of 256), so diff is masked to -inf before the exp.
    # The forward is the same.
    cb = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc)          # [b,nc,H,L,L]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,l,m,H]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask, diff.permute(0, 1, 4, 2, 3),
                                  float("-inf")))            # [b,nc,H,l,m]
    scores = torch.where(mask, cb * decay, torch.zeros((), dtype=f32,
                                                       device=x.device))
    xdt = xc * dtc[..., None]                      # [b,nc,L,H,P]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", scores, xdt)

    # ---- chunk states + inter-chunk recurrence ---------------------------
    # state_c = sum_j B_j ⊗ xdt_j * exp(total - cum_j)
    dec_end = torch.exp(total[:, :, None, :] - cum)          # [b,nc,L,H]
    st = torch.einsum("bclhn,bclhp->bchpn", Bc, xdt * dec_end[..., None])

    h = torch.zeros((b, H, Pd, N), dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):                 # the reference's lax.scan
        h_in.append(h)                  # state *entering* chunk c
        h = h * torch.exp(total[:, c])[..., None, None] + st[:, c]
    h_in = torch.stack(h_in, dim=1)                          # [b,nc,H,P,N]

    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cc * torch.exp(cum)[..., None],
                           h_in)
    y = (y_intra + y_inter).reshape(b, S, H, Pd)
    return y.to(x.dtype), h


_CORE = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm_w")


def _mamba_core(cfg, zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip,
                norm_w, heads=None, groups=()):
    """From the input projection [B,S,E] to the gated-normed y [B,S,d_in],
    with the conv window [B,K-1,C] and the final SSM state [B,H,P,N].
    With ``heads`` (a range of the heads, whose ``dt_bias`` .. ``norm_w``
    slices are given) the scan and the norm run on those heads only: y
    [B,S,h·P] and the state [B,h,P,N]; ``groups`` hold the other heads."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    dt_ = dtype_of(cfg)
    z, xin, B, C, dtr = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, conv_w.to(dt_),
                                   conv_b.to(dt_)).to(torch.float32)
                      ).to(dt_)
    gn = s.n_groups * s.state_dim
    xin, B, C = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    bsz, S = zxbcdt.shape[0], zxbcdt.shape[1]
    if heads is not None:
        cols = slice(heads.start * s.head_dim, heads.stop * s.head_dim)
        xin, z, dtr = xin[..., cols], z[..., cols], dtr[..., heads]
    h = dtr.shape[-1]
    xh = xin.reshape(bsz, S, h, s.head_dim)
    Bg = B.reshape(bsz, S, s.n_groups, s.state_dim)
    Cg = C.reshape(bsz, S, s.n_groups, s.state_dim)
    if heads is not None and s.n_groups > 1:
        # each head reads its group's B and C
        g = torch.arange(heads.start, heads.stop,
                         device=Bg.device) // (nheads // s.n_groups)
        Bg, Cg = Bg[:, :, g], Cg[:, :, g]
    dt_pos = F.softplus(dtr.to(torch.float32) + dt_bias[None, None, :])
    A = -torch.exp(a_log)
    chunk = s.chunk if S % s.chunk == 0 and S >= s.chunk else S
    y, h_final = ssd_chunked(xh, dt_pos, A, Bg, Cg, chunk)
    y = y + xh.to(y.dtype) * d_skip[None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, S, h * s.head_dim)
    y = _gated_norm(y, z, norm_w, cfg.norm_eps, groups, d_in)
    # a copy: a view would keep each layer's whole [B,S,C] conv input
    # alive for as long as a prefill holds its cache
    return y, conv_in[:, -(s.conv_dim - 1):, :].to(dt_).clone(), h_final


def _in_proj(p: dict, dt_) -> torch.Tensor:
    """``in_proj`` in ``dt_``; on a mesh its FSDP rows gathered and its
    columns split over the mesh dims that split the heads, so no rank
    repeats another's product (each gathers the whole output for the conv
    after, as the reference's compiled step does)."""
    w = gather_fsdp(p["in_proj"].to(dt_))
    if not isinstance(w, DTensor):
        return w
    dims = split_index(p["a_log"], 0)[0]
    return w.redistribute(w.device_mesh, tuple(
        Shard(1) if i in dims else q for i, q in enumerate(w.placements)))


def _split_heads(cfg, p: dict, core, rows, xs, states=(), names=_CORE):
    """``core(cfg, *xs, *states, *ws, heads=, groups=)`` on each rank's
    heads and batch rows (``rows``: the block input's placements), ``ws``
    the params ``names``: the mesh dims that split ``a_log``
    (``"ssm_heads"``) split the heads, the SSM ``states`` (heads at dim 1)
    and the head params; the inputs ``xs`` (and the conv's params) are
    whole along them. Returns (y [B,S,d_in] split by heads, the conv
    window whole where ``names`` hold the conv's, SSM state split)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    mesh = xs[0].device_mesh
    dims, n, index = split_index(p["a_log"], 0)
    if nheads % n:
        raise ValueError(f"{nheads} SSM heads do not split into {n}")
    hl = nheads // n
    heads = slice(index * hl, (index + 1) * hl)
    groups = [(mesh, i) for i in dims]

    def on(d, pl):      # rows' placements, dim d split by heads
        return tuple(Shard(d) if i in dims else r for i, r in enumerate(pl))

    whole = (Replicate(),) * mesh.ndim
    sums = tuple(Partial() if isinstance(r, Shard) or i in dims
                 else Replicate() for i, r in enumerate(rows))
    per_head = on(0, tuple(Partial() if isinstance(r, Shard) else Replicate()
                           for r in rows))
    conv = ("conv_w", "conv_b")
    w_in = tuple(whole if k in conv else on(0, whole) for k in names)
    w_grad = tuple(sums if k in conv else per_head for k in names)
    # each rank reads all of x's channels and uses its heads' and B / C
    x_grad = tuple(Partial() if i in dims else r for i, r in enumerate(rows))
    window = (rows,) if conv[0] in names else ()
    return shard_map(
        functools.partial(core, cfg, heads=heads, groups=groups), mesh=mesh,
        in_specs=(rows,) * len(xs) + (on(1, rows),) * len(states) + w_in,
        out_specs=(on(2, rows), *window, on(1, rows)),
        in_grad_specs=(x_grad,) * len(xs) + (None,) * len(states) + w_grad)(
            *xs, *states, *(p[k] for k in names))


def mamba_apply(cfg, p: dict, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence mamba block. x: [B,S,D] -> ([B,S,D], state or None);
    the state is (conv window [B,K-1,C], SSM state [B,H,P,N] f32). On a
    DTensor each rank scans its own heads (:func:`_split_heads`)."""
    dt_ = dtype_of(cfg)
    zxbcdt = torch.matmul(x, _in_proj(p, dt_))
    if isinstance(zxbcdt, DTensor):
        y, conv_state, h_final = _split_heads(cfg, p, _mamba_core,
                                              batch_rows(x), (zxbcdt,))
    else:
        y, conv_state, h_final = _mamba_core(cfg, zxbcdt,
                                             *(p[n] for n in _CORE))
    out = torch.matmul(y, p["out_proj"].to(dt_))
    out = lshard(out, "batch", "seq", "act_embed")
    if return_state:
        return out, (conv_state, h_final)
    return out, None


def mamba_cache_axes():
    """(conv window, SSM state) logical axes: the reference's
    ``mamba_cache_axes``."""
    return (("layers", "batch", None, "act_rnn"),
            ("layers", "batch", "act_ssm_heads", None, None))


def mamba_decode_step(cfg, p: dict, x: torch.Tensor, conv_state, state):
    """One-token step. x: [B,1,D]; conv_state: [B,K-1,C]; state:
    [B,H,P,N] -> (out [B,1,D], (new conv_state, new state)). Returns new
    tensors: the caller decides where they go. On a DTensor the conv is
    one op of the global program (:func:`_conv_step`) and each rank
    updates its own heads of the state (:func:`_split_heads`)."""
    dt_ = dtype_of(cfg)
    zxbcdt = dense(x, _in_proj(p, dt_))
    window, conv_out = _conv_step(cfg, zxbcdt, conv_state, p["conv_w"],
                                  p["conv_b"])
    if isinstance(zxbcdt, DTensor):
        y, state = _split_heads(cfg, p, _mamba_decode_core, batch_rows(x),
                                (zxbcdt, conv_out), (state,), _DECODE_CORE)
    else:
        y, state = _mamba_decode_core(cfg, zxbcdt, conv_out, state,
                                      *(p[n] for n in _DECODE_CORE))
    out = dense(y, p["out_proj"].to(dt_))
    return out, (window[:, 1:, :], state)


def _conv_step(cfg, zxbcdt, conv_state, conv_w, conv_b):
    """The decode step's conv: (window [B,K,C], silu(conv) [B,1,C])."""
    dt_ = dtype_of(cfg)
    _, xin, B, C, _ = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, B, C], dim=-1)                 # [B,1,C]
    window = torch.cat([conv_state, conv_in], dim=1)         # [B,K,C]
    conv_out = (torch.einsum("bkc,kc->bc", window, conv_w.to(dt_))
                + conv_b.to(dt_))
    return window, F.silu(conv_out.to(torch.float32)).to(dt_)[:, None, :]


_DECODE_CORE = ("dt_bias", "a_log", "d_skip", "norm_w")


def _mamba_decode_core(cfg, zxbcdt, conv_out, state, dt_bias, a_log,
                       d_skip, norm_w, heads=None, groups=()):
    """From the input projection [B,1,E] and the conv's output [B,1,C] to
    the gated-normed y [B,1,d_in] and the new SSM state [B,H,P,N]; with
    ``heads`` the state and y are those heads' (see :func:`_mamba_core`)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    dt_ = dtype_of(cfg)
    z, _, _, _, dtr = _split_proj(cfg, zxbcdt)
    gn = s.n_groups * s.state_dim
    xin, B, C = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    hs = range(nheads) if heads is None else range(heads.start, heads.stop)
    if heads is not None:
        cols = slice(heads.start * s.head_dim, heads.stop * s.head_dim)
        xin, z, dtr = xin[..., cols], z[..., cols], dtr[..., heads]
    bsz = zxbcdt.shape[0]
    xh = xin.reshape(bsz, len(hs), s.head_dim).to(torch.float32)
    rep = nheads // s.n_groups
    g = torch.arange(hs.start, hs.stop, device=xh.device) // rep
    Bg = B.reshape(bsz, s.n_groups, s.state_dim)[:, g]
    Cg = C.reshape(bsz, s.n_groups, s.state_dim)[:, g]
    dt_pos = F.softplus(dtr[:, 0].to(torch.float32) + dt_bias[None, :])
    A = -torch.exp(a_log)
    decay = torch.exp(dt_pos * A[None, :])                   # [B,h]
    upd = torch.einsum("bhn,bhp->bhpn", Bg.to(torch.float32),
                       xh * dt_pos[..., None])
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Cg.to(torch.float32), state)
    y = y + xh * d_skip[None, :, None]
    y = y.reshape(bsz, 1, len(hs) * s.head_dim).to(dt_)
    return _gated_norm(y, z, norm_w, cfg.norm_eps, groups, d_in), state
