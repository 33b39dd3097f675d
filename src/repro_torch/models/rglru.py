"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

Port of ``src/repro/models/rglru.py``. Recurrence:

    a_t = exp(-c * softplus(Λ) * r_t),
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

with per-channel recurrence / input gates (r_t, i_t). The reference runs
prefill as ``jax.lax.associative_scan``; torch has none, and a loop over
the S positions would cost S small launches a layer. The port scans in
log2(S) doubling steps (Hillis-Steele over the same combine,
``(a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, b_l a_r + b_r)``): every factor is a
product of decays in [0, 1], so nothing overflows, and a 512-token prefill
takes 9 steps a layer. Decode is the O(1) update. The block wraps the
recurrence with in / out projections, a short causal conv and a
GeGLU-gated output branch, as the reference does. It has no Pallas
kernel, so it runs no port kernel. On a device mesh the projections are
DTensor products; ``in_x`` / ``in_gate`` split their columns (``"rnn"``)
and everything after them is elementwise over the width, so the conv,
the gates, the scan (and a decode step's state update) run on each
rank's width slice with no collective (:func:`_split_width`), as the
reference places ``xb`` (``act_rnn``). ``out``'s rows make the block's
output a partial sum, constrained as the reference's is.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import lshard, shard_map
from repro_torch.models.layers import (batch_rows, dense, dtype_of,
                                       gather_fsdp, split_index)
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.models.spec import P

_C = 8.0  # Griffin's recurrence sharpness constant


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    k = 4  # temporal conv width
    return {
        "in_x": P((d, w), ("embed", "rnn")),
        "in_gate": P((d, w), ("embed", "rnn")),
        "conv_w": P((k, w), ("conv", "rnn"), init="small"),
        "conv_b": P((w,), ("rnn",), init="zeros"),
        "a_param": P((w,), ("rnn",), init="rglru_a", dtype="float32"),
        "w_rgate": P((w,), ("rnn",), init="zeros", dtype="float32"),
        "b_rgate": P((w,), ("rnn",), init="zeros", dtype="float32"),
        "w_igate": P((w,), ("rnn",), init="zeros", dtype="float32"),
        "b_igate": P((w,), ("rnn",), init="zeros", dtype="float32"),
        "out": P((w, d), ("rnn", "embed")),
    }


def _gates(p, xb):
    """Per-channel gates -> (log_a [B,S,W] (<=0), beta·i·x input term)."""
    xf = xb.to(torch.float32)
    r = torch.sigmoid(xf * p["w_rgate"] + p["b_rgate"])
    i = torch.sigmoid(xf * p["w_igate"] + p["b_igate"])
    log_a = -_C * F.softplus(p["a_param"]) * r          # <= 0
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9))
    return log_a, beta * i * xf


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in log2(S)
    doubling steps; a, b: [B, S, W] -> h [B, S, W]."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


_CORE = ("conv_w", "conv_b", "a_param", "w_rgate", "b_rgate", "w_igate",
         "b_igate")


def _rglru_core(cfg, xb, gb, *ws):
    """The conv, gates, scan and output gate over the input branches
    [B,S,W]: (y [B,S,W] f32, the conv window [B,k-1,W], the last h [B,W])."""
    dt = dtype_of(cfg)
    p = dict(zip(_CORE, ws))
    k = p["conv_w"].shape[0]
    conv_in = xb
    xb = _causal_conv(xb, p["conv_w"].to(dt), p["conv_b"].to(dt))
    log_a, bix = _gates(p, xb)
    h = linear_scan(torch.exp(log_a), bix)
    y = h * F.gelu(gb.to(torch.float32), approximate="tanh")
    # copies: a view would keep each layer's whole [B,S,W] input and
    # scan alive for as long as a prefill holds its cache
    return y, conv_in[:, -(k - 1):, :].to(dt).clone(), h[:, -1, :].clone()


def _split_width(cfg, p: dict, core, rows, xs, out_dims):
    """``core(cfg, *xs, *ws)`` on each rank's slice of the width and its
    batch rows (``rows``: the block input's placements): the mesh dims
    that split ``a_param`` (``"rnn"``) split the last dim of every x (the
    branches, the conv window, the state) and the params', and dim
    ``out_dims[i]`` of output i. The params' gradients are partial sums
    over the batch-split dims."""
    mesh = xs[0].device_mesh
    dims, _, _ = split_index(p["a_param"], 0)

    def on(d, pl):
        return tuple(Shard(d) if i in dims else r for i, r in enumerate(pl))

    whole = (Replicate(),) * mesh.ndim
    sums = tuple(Partial() if isinstance(r, Shard) else r for r in rows)
    ws = tuple(p[n] for n in _CORE)
    return shard_map(
        functools.partial(core, cfg), mesh=mesh,
        in_specs=tuple(on(x.ndim - 1, rows) for x in xs)
        + tuple(on(w.ndim - 1, whole) for w in ws),
        out_specs=tuple(on(d, rows) for d in out_dims),
        in_grad_specs=(None,) * len(xs) + tuple(on(w.ndim - 1, sums)
                                                for w in ws))(*xs, *ws)


def rglru_apply(cfg, p: dict, x: torch.Tensor, *, return_state: bool = False):
    """Full-sequence Griffin recurrent block. x: [B,S,D] -> ([B,S,D],
    (conv window [B,k-1,W], h [B,W] f32) or None). On a DTensor each rank
    runs its slice of the width (:func:`_split_width`)."""
    dt = dtype_of(cfg)
    xb = torch.matmul(x, gather_fsdp(p["in_x"].to(dt)))
    gb = torch.matmul(x, gather_fsdp(p["in_gate"].to(dt)))
    if isinstance(xb, DTensor):
        y, conv_state, h_last = _split_width(cfg, p, _rglru_core,
                                             batch_rows(x), (xb, gb),
                                             (2, 2, 1))
    else:
        y, conv_state, h_last = _rglru_core(cfg, xb, gb,
                                            *(p[n] for n in _CORE))
    out = torch.matmul(y.to(dt), p["out"].to(dt))
    out = lshard(out, "batch", "seq", "act_embed")
    if return_state:
        return out, (conv_state, h_last)
    return out, None


def rglru_cache_axes():
    """(conv window, hidden) logical axes: the reference's
    ``rglru_cache_axes``."""
    return (("layers", "batch", None, "act_rnn"),
            ("layers", "batch", "act_rnn"))


def _rglru_decode_core(cfg, xb, gb, conv_state, h, *ws):
    """The conv, gates, state update and output gate of one token:
    (y [B,W] f32, the new conv window [B,k-1,W], the new h [B,W])."""
    dt = dtype_of(cfg)
    p = dict(zip(_CORE, ws))
    window = torch.cat([conv_state, xb], dim=1)              # [B,k,W]
    w = p["conv_w"].to(dt)
    xc = (torch.einsum("bkw,kw->bw", window, w)
          + p["conv_b"].to(dt))[:, None, :]
    log_a, bix = _gates(p, xc)
    h_new = torch.exp(log_a[:, 0]) * h + bix[:, 0]
    y = h_new * F.gelu(gb[:, 0].to(torch.float32), approximate="tanh")
    return y, window[:, 1:, :], h_new


def rglru_decode_step(cfg, p: dict, x: torch.Tensor, conv_state, h):
    """One-token step. x: [B,1,D]; conv_state [B,k-1,W]; h [B,W] f32 ->
    (out [B,1,D], (new conv_state, new h)). Returns new tensors. On a
    DTensor each rank updates its slice of the width
    (:func:`_split_width`)."""
    dt = dtype_of(cfg)
    xb = dense(x, gather_fsdp(p["in_x"].to(dt)))
    gb = dense(x, gather_fsdp(p["in_gate"].to(dt)))
    if isinstance(xb, DTensor):
        y, window, h_new = _split_width(cfg, p, _rglru_decode_core,
                                        batch_rows(x), (xb, gb, conv_state,
                                                        h), (1, 2, 1))
    else:
        y, window, h_new = _rglru_decode_core(cfg, xb, gb, conv_state, h,
                                              *(p[n] for n in _CORE))
    out = torch.matmul(y.to(dt), p["out"].to(dt))[:, None, :]
    return out, (window, h_new)
