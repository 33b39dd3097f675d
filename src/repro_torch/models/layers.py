"""Common building blocks: norms, RoPE, gated MLPs, embeddings.

Port of ``src/repro/models/layers.py``. Functional style as in the
reference: params are plain nested dicts of tensors with the reference's
keys, or DTensors on a device mesh. Activations carry the reference's
``lshard`` annotations, no-ops without rules. RMSNorm runs through the
port's ``rmsnorm`` kernel (:mod:`repro_torch.kernels.rmsnorm`) unless
``use_kernels=False``, which routes it to the kernel's plain version on
any device (the plain route, used to hold the kernel route against on the
card); on a DTensor it runs on each rank's batch rows (``shard_map``),
the norm weight gathered whole, as ``layernorm`` does. The projections stay
``torch.matmul``, as the reference leaves them to XLA. ``cross_entropy``
takes the gold logit with a ``gather`` where the reference contracts a
one-hot (on one card the one-hot would be a [B, S, V] tensor);
vocab-sharded logits are gathered along the vocab first.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import lshard, shard_map
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models.spec import DTYPES, P


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., d] @ w [d, n]``. A DTensor x of one position a row
    (decode's [B, 1, d]) is folded to one 2-D product first: DTensor's
    matmul does not always fold it, and then runs a batched product with
    ``w`` expanded over the batch."""
    if (isinstance(x, DTensor) and x.ndim > 2
            and math.prod(x.shape[1:-1]) == 1):
        return torch.matmul(x.reshape(x.shape[0], x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# Shard-local calls on DTensors
# ---------------------------------------------------------------------------

def batch_rows(t: DTensor) -> Tuple:
    """``t``'s placements with only the split of its dim 0 (the batch)
    kept; every other split and any partial sum are made whole."""
    return tuple(p if p == Shard(0) else Replicate() for p in t.placements)


def _partial_where_split(pl: Tuple) -> Tuple:
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)


def _replicated(t, mesh):
    """A plain tensor (the same on every rank) as a replicated DTensor."""
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim)


def batchwise(fn, xs: Tuple, ws: Tuple):
    """``fn(*xs, *ws)`` on each rank's own batch rows: a norm. Every x
    (dim 0 the batch) keeps the split of dim 0 that the first one has and
    is made whole along every other dim (a partial sum reduced); each w is
    gathered whole, its local gradient a partial sum over the batch-split
    mesh dims. ``fn`` returns one tensor, the batch at dim 0."""
    mesh = xs[0].device_mesh
    rows = batch_rows(xs[0])
    wp = (Replicate(),) * mesh.ndim
    return shard_map(fn, mesh=mesh,
                     in_specs=(rows,) * len(xs) + (wp,) * len(ws),
                     out_specs=rows,
                     in_grad_specs=(None,) * len(xs)
                     + (_partial_where_split(rows),) * len(ws))(
                         *(_replicated(x, mesh) for x in xs), *ws)


def gather_fsdp(w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A DTensor weight with its FSDP split (its ``dim``, the embed dim)
    gathered and every other split kept, as the reference's FSDP gathers
    a weight before its product; left to itself DTensor may instead split
    the product's contraction and sum the activations over the data axes,
    or split its columns at a point that cuts a head."""
    if not isinstance(w, DTensor):
        return w
    return w.redistribute(w.device_mesh, tuple(
        Replicate() if p == Shard(dim) else p for p in w.placements))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> P:
    return P((d,), ("act_embed",), init="zeros")  # stored as delta from 1


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            one_plus: bool = True, *, use_kernels: bool = True
            ) -> torch.Tensor:
    """x: [..., D] -> [..., D] in x's dtype, math in float32, scale
    ``(1 + w)``. The kernel computes only the ``(1 + w)`` scale, which is
    the one every config reaches (see :func:`norm_apply`)."""
    if not one_plus:
        raise NotImplementedError("rmsnorm with a plain w scale: the port's "
                                  "kernel computes (1 + w) only, as every "
                                  "config's norm does")

    def local(x, w):
        x2 = x.reshape(-1, x.shape[-1])
        y = (rmsnorm_kernel(x2.contiguous(), w, eps=eps) if use_kernels
             else rmsnorm_ref(x2, w, eps))
        return y.reshape(x.shape)

    if isinstance(x, DTensor):
        return batchwise(local, (x,), (w,))
    return local(x, w)


def layernorm_spec(d: int) -> dict:
    return {"w": P((d,), ("act_embed",), init="zeros"),
            "b": P((d,), ("act_embed",), init="zeros")}


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    """On a DTensor, each rank's batch rows (see :func:`batchwise`)."""
    def local(x, w, b):
        dt = x.dtype
        x = x.to(torch.float32)
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mu).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps)
        return (y * (1.0 + w.to(torch.float32)) + b.to(torch.float32)).to(dt)

    if isinstance(x, DTensor):
        return batchwise(local, (x,), (p["w"], p["b"]))
    return local(x, p["w"], p["b"])


def norm_apply(cfg, x: torch.Tensor, p, *,
               use_kernels: bool = True) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p, cfg.norm_eps)
    # ``or True`` as in the reference (layers.py: norm_apply): every rmsnorm
    # config takes the (1 + w) scale whatever ``rmsnorm_one_plus`` says;
    # kept for parity.
    return rmsnorm(x, p, cfg.norm_eps, one_plus=cfg.rmsnorm_one_plus or True,
                   use_kernels=use_kernels)


def norm_spec(cfg, d: int):
    return layernorm_spec(d) if cfg.norm == "layernorm" else rmsnorm_spec(d)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    angles = angles[..., None, :]  # broadcast over heads: [..., S, 1, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_specs(d: int, ff: int) -> dict:
    return {
        "wi": P((d, ff), ("embed", "mlp")),
        "wg": P((d, ff), ("embed", "mlp")),
        "wo": P((ff, d), ("mlp", "embed")),
    }


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg)
    h = dense(x, p["wi"].to(dt))
    g = dense(x, p["wg"].to(dt))
    g = g.to(torch.float32)
    # jax.nn.gelu defaults to the tanh approximation
    a = (F.gelu(g, approximate="tanh") if cfg.activation == "geglu"
         else F.silu(g))
    h = a.to(dt) * h
    h = lshard(h, *(("batch",) + ("seq",) * (h.ndim - 2) + ("act_mlp",)))
    return dense(h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> dict:
    V = cfg.padded_vocab
    d = {"embedding": P((V, cfg.d_model), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        d["unembed"] = P((cfg.d_model, V), ("embed", "vocab"), init="small")
    return d


def embed_tokens(cfg, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens`` in cfg.dtype. A DTensor table is
    gathered whole and each rank looks up its own tokens' rows."""
    dt = dtype_of(cfg)
    table = p["embedding"]
    if isinstance(table, DTensor):
        x = _sharded_lookup(table, tokens).to(dt)
    else:
        x = table[tokens].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.embedding_multiplier != 1.0:  # x * 1 is x: one launch saved
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=dt)
    return lshard(x, "batch", "seq", "act_embed")


def split_index(t: DTensor, dim: int) -> Tuple[Tuple[int, ...], int, int]:
    """(the mesh dims that split ``t``'s ``dim``, major first; how many
    pieces they cut it into; this rank's piece among them)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    dims = tuple(i for i, p in enumerate(t.placements) if p == Shard(dim))
    n, index = 1, 0
    for i in dims:
        n, index = n * mesh.size(i), index * mesh.size(i) + coord[i]
    return dims, n, index


def _sharded_lookup(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """The rows of ``tokens`` from a table split over its vocab (and its
    FSDP embed dim): each rank reads the rows of its own vocab slice, the
    tokens outside it as zeros, and the pieces are summed over the mesh
    dims that split the vocab, as the reference's vocab-split ``take``
    lowers. The rank gathers its slice's FSDP shards itself (DTensor's
    redistribute would gather the whole vocab on the way); the backward
    reduce-scatters them, so the gradient goes into the rank's own slice
    only."""
    mesh = table.device_mesh
    tokens = _replicated(tokens, mesh)
    tp = batch_rows(tokens)
    dims, n, index = split_index(table, 0)
    fsdp = [i for i, p in enumerate(table.placements) if p == Shard(1)]
    groups = [(mesh, i) for i in fsdp]
    partial = [isinstance(tp[i], Shard) for i in fsdp]
    vl = table.shape[0] // n
    lo = index * vl

    def local(t, i):
        t = gather_dim(t, 1, groups, partial)
        if n == 1:
            return t[i]
        j = i - lo
        inside = (j >= 0) & (j < vl)
        rows = t[torch.where(inside, j, 0)]
        return torch.where(inside[..., None], rows, 0)

    tab = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
                for p in table.placements)
    # a rank's gradient of its slice: a partial sum over the batch-split
    # dims that do not split the table (those that do reduce-scatter it)
    tab_grad = tuple(Partial() if p == Replicate() and isinstance(r, Shard)
                     else p for p, r in zip(tab, tp))
    out = tuple(Partial() if i in dims else p for i, p in enumerate(tp))
    x = shard_map(local, mesh=mesh, in_specs=(tab, tp), out_specs=out,
                  in_grad_specs=(tab_grad, None))(table, tokens)
    return x.redistribute(mesh, tp)


def logits_from_hidden(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg)
    if cfg.tie_embeddings:
        logits = dense(x, p["embedding"].to(dt).t())
    else:
        logits = dense(x, p["unembed"].to(dt))
    if cfg.logits_scaling != 1.0:  # x / 1 is x: one launch saved
        logits = logits / torch.tensor(cfg.logits_scaling,
                                       dtype=logits.dtype)
    if cfg.attn_logit_softcap:  # (reused as final softcap when configured)
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab-padding slots
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    axes = ("batch",) + ("seq",) * (logits.ndim - 2) + ("act_vocab",)
    return lshard(logits, *axes)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32: logits [..., V], integer labels [...];
    with ``mask`` (same shape as labels) the masked sum over
    ``max(mask.sum(), 1)``, as the reference. On a DTensor the logits stay
    split over the vocab: see :func:`_sharded_cross_entropy`."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels, mask)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced by ``op`` over each of ``groups`` (``(mesh, dim)``
    pairs) in turn, through the functional collectives (which the counting
    modes see)."""
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, op, g)
    return t


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``groups`` inside a shard-local body whose later work
    differs from rank to rank: each rank's cotangent is then a partial
    one, so the backward is the same sum (written out here, as not every
    torch registers one for the functional all-reduce)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), "sum", ctx.groups), None


class _GatherDim(torch.autograd.Function):
    """A body's local shard gathered along ``dim`` over ``group`` (a
    ``(mesh, mesh dim)`` pair). The backward reduce-scatters the gradient
    where each rank's is a partial sum (its own batch rows: FSDP), and
    takes the rank's own slice where every rank's is the same. The
    gathered dim is moved to the front first: a collective along another
    dim stages through a buffer of the group's shards stacked on dim 0."""

    @staticmethod
    def forward(ctx, t, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        ctx.piece = t.shape[dim]
        t = t.movedim(dim, 0).contiguous()
        return _funcol("all_gather")(t, 0, group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.partial:
            mesh, i = ctx.group
            lo = mesh.get_local_rank(i) * ctx.piece
            return g.narrow(ctx.dim, lo, ctx.piece), None, None, None
        g = g.movedim(ctx.dim, 0).contiguous()
        return _funcol("reduce_scatter")(g, "sum", 0, ctx.group).movedim(
            0, ctx.dim), None, None, None


def _funcol(name: str):
    """The functional collective ``name`` (``all_gather`` /
    ``reduce_scatter``): ``*_single`` on a torch that has it, else the
    older ``*_tensor``."""
    from torch.distributed import _functional_collectives as funcol
    return getattr(funcol, name + "_single", None) or getattr(
        funcol, name + "_tensor")


def gather_dim(t: torch.Tensor, dim: int, groups, partial) -> torch.Tensor:
    """A body's local ``t`` gathered along ``dim`` over each of ``groups``
    (``(mesh, mesh dim)`` pairs, major first), differentiably; ``partial``
    says, for each group, whether the ranks' gradients are partial sums
    (see ``_GatherDim``)."""
    for g, part in reversed(list(zip(groups, partial))):
        t = _GatherDim.apply(t, dim, g, part)
    return t


def all_reduce_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """Differentiable sum of a body's local ``t`` over ``groups``; ``t``
    itself where there are none."""
    return _AllReduceSum.apply(t, groups) if groups else t


class _VocabSplitNLL(torch.autograd.Function):
    """The NLL of each row from one rank's slice ``[lo, lo + V_local)`` of
    the vocab: the slice's max, then a max over ``groups`` (the mesh dims
    that split the vocab); the slice's sum of ``exp(l - max)`` and its gold
    logit (0 where the label is in another slice), then a sum over them.
    The gradient of the slice is ``softmax - onehot`` on the slice, which
    needs no collective. No rank holds a row of the whole vocab."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, groups):
        x = logits.to(torch.float32)
        m = _all_reduce(x.amax(dim=-1), "max", groups)
        j = labels.long() - lo
        inside = (j >= 0) & (j < x.shape[-1])
        j = torch.where(inside, j, 0)
        gold = torch.where(inside, torch.gather(x, -1, j[..., None])
                           .squeeze(-1), 0.0)
        se = torch.exp(x - m[..., None]).sum(dim=-1)
        se, gold = _all_reduce(torch.stack([se, gold]), "sum", groups)
        ctx.save_for_backward(logits, m, se, j, inside)
        return torch.log(se) + m - gold

    @staticmethod
    def backward(ctx, g):
        logits, m, se, j, inside = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - m[..., None]) / se[..., None]
        p = p.scatter_add(-1, j[..., None], -inside.to(p.dtype)[..., None])
        return (p * g[..., None]).to(logits.dtype), None, None, None


def _sharded_cross_entropy(logits: DTensor, labels, mask) -> DTensor:
    """Each rank's rows' NLL summed (``_VocabSplitNLL`` over its vocab
    slice), the sums reduced over the ranks that split the rows."""
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    rows = batch_rows(logits)          # labels and mask split as these
    dims, _, index = split_index(logits, vdim)
    vl = logits.to_local().shape[-1]
    groups = [(mesh, i) for i in dims]
    lp = tuple(Shard(vdim) if i in dims else p for i, p in enumerate(rows))
    sums = _partial_where_split(rows)

    def local(logits, labels, mask):
        nll = _VocabSplitNLL.apply(logits, labels, index * vl, groups)
        if mask is None:
            return nll.sum(), torch.tensor(float(nll.numel()),
                                           device=nll.device)
        mask = mask.to(torch.float32)
        return (nll * mask).sum(), mask.sum()

    num, den = shard_map(local, mesh=mesh,
                         in_specs=(lp, rows, None if mask is None else rows),
                         out_specs=(sums, sums))(
                             logits, _replicated(labels, mesh),
                             _replicated(mask, mesh))
    whole = (Replicate(),) * mesh.ndim
    num, den = num.redistribute(mesh, whole), den.redistribute(mesh, whole)
    if mask is not None:
        den = torch.clamp(den, min=1.0)
    return num / den
