"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Port of ``src/repro/models/mamba2.py``. Prefill runs the chunked SSD
algorithm: quadratic attention-like products inside a chunk and a linear
recurrence over the chunk states, which the reference runs as a
``lax.scan`` and the port as a Python loop over chunks. Decode is the O(1)
recurrent update ``h = h * exp(dt * A) + dt * B ⊗ x``. Both share the
parameters. The gated norm stays plain torch, as it is plain jnp in the
reference; the block has no Pallas kernel, so it runs no port kernel.

On a device mesh the projections are DTensor products and the conv, the
scan and the gated norm run on each rank's batch rows with every head
(the reference splits the heads over "model", ``act_ssm_heads``): the
block's output is then constrained as the reference's is.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import lshard
from repro_torch.models.layers import batchwise, dense, dtype_of
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


def _gated_norm(y, z, w, eps):
    dt = y.dtype
    y = y.to(torch.float32) * F.silu(z.to(torch.float32))
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
    # there (as jnp.where does); a multiply by the mask would give nan.
    cb = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc)          # [b,nc,H,L,L]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,l,m,H]
    decay = torch.exp(diff.permute(0, 1, 4, 2, 3))           # [b,nc,H,l,m]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
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
                norm_w):
    """From the input projection [B,S,E] to the gated-normed y [B,S,d_in],
    with the conv window [B,K-1,C] and the final SSM state [B,H,P,N]."""
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
    xh = xin.reshape(bsz, S, nheads, s.head_dim)
    Bg = B.reshape(bsz, S, s.n_groups, s.state_dim)
    Cg = C.reshape(bsz, S, s.n_groups, s.state_dim)
    dt_pos = F.softplus(dtr.to(torch.float32) + dt_bias[None, None, :])
    A = -torch.exp(a_log)
    chunk = s.chunk if S % s.chunk == 0 and S >= s.chunk else S
    y, h_final = ssd_chunked(xh, dt_pos, A, Bg, Cg, chunk)
    y = y + xh.to(y.dtype) * d_skip[None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, S, d_in)
    y = _gated_norm(y, z, norm_w, cfg.norm_eps)
    return y, conv_in[:, -(s.conv_dim - 1):, :].to(dt_), h_final


def mamba_apply(cfg, p: dict, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence mamba block. x: [B,S,D] -> ([B,S,D], state or None);
    the state is (conv window [B,K-1,C], SSM state [B,H,P,N] f32). On a
    DTensor the conv and the scan run on each rank's batch rows
    (``batchwise``), the heads whole."""
    dt_ = dtype_of(cfg)
    zxbcdt = torch.matmul(x, p["in_proj"].to(dt_))
    ws = tuple(p[n] for n in _CORE)
    if isinstance(zxbcdt, DTensor):
        y, conv_state, h_final = batchwise(
            functools.partial(_mamba_core, cfg), (zxbcdt,), ws, n_out=3)
    else:
        y, conv_state, h_final = _mamba_core(cfg, zxbcdt, *ws)
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
    tensors: the caller decides where they go. On a DTensor the conv and
    the state update run on each rank's batch rows (``batchwise``)."""
    dt_ = dtype_of(cfg)
    zxbcdt = dense(x, p["in_proj"].to(dt_))
    ws = tuple(p[n] for n in _CORE)
    if isinstance(zxbcdt, DTensor):
        y, window, state = batchwise(
            functools.partial(_mamba_decode_core, cfg),
            (zxbcdt, conv_state, state), ws, n_out=3)
    else:
        y, window, state = _mamba_decode_core(cfg, zxbcdt, conv_state,
                                              state, *ws)
    out = dense(y, p["out_proj"].to(dt_))
    return out, (window, state)


def _mamba_decode_core(cfg, zxbcdt, conv_state, state, conv_w, conv_b,
                       dt_bias, a_log, d_skip, norm_w):
    """From the input projection [B,1,E] to the gated-normed y [B,1,d_in],
    the new conv window [B,K-1,C] and SSM state [B,H,P,N]."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    dt_ = dtype_of(cfg)
    z, xin, B, C, dtr = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, B, C], dim=-1)                 # [B,1,C]
    window = torch.cat([conv_state, conv_in], dim=1)         # [B,K,C]
    w = conv_w.to(dt_)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + conv_b.to(dt_)
    conv_out = F.silu(conv_out.to(torch.float32)).to(dt_)[:, None, :]
    gn = s.n_groups * s.state_dim
    xin, B, C = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    bsz = zxbcdt.shape[0]
    xh = xin.reshape(bsz, nheads, s.head_dim).to(torch.float32)
    rep = nheads // s.n_groups
    Bg = torch.repeat_interleave(B.reshape(bsz, s.n_groups, s.state_dim),
                                 rep, dim=1)
    Cg = torch.repeat_interleave(C.reshape(bsz, s.n_groups, s.state_dim),
                                 rep, dim=1)
    dt_pos = F.softplus(dtr[:, 0].to(torch.float32) + dt_bias[None, :])
    A = -torch.exp(a_log)
    decay = torch.exp(dt_pos * A[None, :])                   # [B,H]
    upd = torch.einsum("bhn,bhp->bhpn", Bg.to(torch.float32),
                       xh * dt_pos[..., None])
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Cg.to(torch.float32), state)
    y = y + xh * d_skip[None, :, None]
    y = y.reshape(bsz, 1, d_in).to(dt_)
    return _gated_norm(y, z, norm_w, cfg.norm_eps), window[:, 1:, :], state
