"""Config system for the repro framework.

Port of ``src/repro/configs/base.py``, copied as it is (pure data, no
jax).

Every assigned architecture is a ``ModelConfig``; input shapes are
``ShapeConfig``s. Configs are plain frozen dataclasses so they hash, print,
and override cleanly (``cfg.replace(...)``). The registry maps ``--arch``
ids to constructor functions (one module per arch under ``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # 'dense'  -> all-experts compute + gated combine (oracle; smoke scale)
    # 'ragged' -> sort + jax.lax.ragged_dot, EP under shard_map (production)
    impl: str = "ragged"
    router_aux_coef: float = 0.01
    # router scores: 'softmax' over the experts, or 'sigmoid' of each
    # (DeepSeek-V3's noaux_tc, with n_group = topk_group = 1)
    scoring: str = "softmax"
    # a fixed bias added to the scores for the choice of the top-k only
    # (the gates stay the unbiased scores); empty for none, else one a
    # routed expert, the same in every layer
    selection_bias: Tuple[float, ...] = ()
    # the renormalised gates times this (routed_scaling_factor)
    routed_scaling: float = 1.0
    # chips a layer's experts are divided over: this one holds the first
    # num_experts of num_experts * expert_shards, which the router scores
    expert_shards: int = 1

    @property
    def routed_experts(self) -> int:
        """Experts the router scores: those of every chip."""
        return self.num_experts * self.expert_shards


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention without a q LoRA (DeepSeek-V2/V3,
    Moonlight): keys and values come up from one RMS-normed latent of
    ``kv_lora_rank`` per position; q and k carry ``qk_nope_head_dim``
    plain columns and ``qk_rope_head_dim`` rotated ones, the rotated key
    shared by every head; values are ``v_head_dim`` wide."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N: SSM state size per head
    head_dim: int = 64            # P: channels per head
    expand: int = 2               # d_inner = expand * d_model
    conv_dim: int = 4             # depthwise temporal conv width
    chunk: int = 256              # SSD chunk length (train/prefill)
    n_groups: int = 1             # B/C groups


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The four assigned LM shapes.
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | ssm | hybrid | vlm | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    activation: str = "swiglu"      # swiglu | geglu
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    rmsnorm_one_plus: bool = False  # gemma-style (1 + w)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    qk_norm: bool = False           # chameleon
    sliding_window: Optional[int] = None   # SWA (h2o-danube)
    attn_logit_softcap: Optional[float] = None
    embed_scale: bool = False       # gemma: scale embeddings by sqrt(d_model)
    # granite μP-style scalars
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # MoE / SSM / hybrid
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # latent attention in place of GQA (every attention layer)
    mla: Optional[MLAConfig] = None
    # leading layers with a dense MLP of d_ff before an MoE stack
    first_dense_layers: int = 0
    # hybrid (Griffin) layer pattern, cycled over num_layers.
    # entries: 'attn' | 'rglru'
    block_pattern: Optional[Tuple[str, ...]] = None
    rglru_width: int = 0            # lru width (0 -> d_model)
    local_attn_window: int = 2048   # hybrid local attention window
    # enc-dec
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # frontend stub ('none' | 'audio_frames' | 'vq_tokens')
    frontend: str = "none"
    # training / numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat_policy: str = "full"      # none | dots | full
    grad_accum: int = 1             # microbatch accumulation steps
    seq_parallel: bool = False      # sequence-parallel residual (train)
    # distribution overrides
    shard_attn_heads: bool = True   # False when heads < TP degree (gemma-2b)
    # metadata
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 (TP divisibility + MXU lanes).
        Padded logit slots are masked to -inf in logits_from_hidden."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state, RG-LRU+local attn, or SWA."""
        return (
            self.family == "ssm"
            or self.family == "hybrid"
            or self.sliding_window is not None
        )

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length num_layers."""
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        return ("attn",) * self.num_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6 N D) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        unembed = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            if self.mla:
                a = self.mla
                return (d * n_q * a.qk_head_dim
                        + d * (a.kv_lora_rank + a.qk_rope_head_dim)
                        + a.kv_lora_rank
                        + a.kv_lora_rank * n_q * (a.qk_nope_head_dim
                                                  + a.v_head_dim)
                        + n_q * a.v_head_dim * d)
            return d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d

        def mlp_params(ff: int) -> int:
            # gated (swiglu/geglu): in, gate, out
            return 3 * d * ff

        def ssm_params() -> int:
            assert self.ssm is not None
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_ch = d_in + 2 * s.n_groups * s.state_dim
            in_proj = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nheads)
            return in_proj + conv_ch * s.conv_dim + d_in * d + d_in + 2 * nheads

        def rglru_params() -> int:
            w = self.rglru_width or d
            # in/out proj (x and gate branches) + conv + per-channel gates
            return 2 * d * w + w * d + w * self.ssm_conv() + 3 * w

        total = embed + unembed
        for i, kind in enumerate(self.layer_kinds()):
            total += 2 * d  # two norms
            if kind == "attn":
                total += attn_params() + mlp_params(self.d_ff)
            elif kind == "ssm":
                total += ssm_params() + (mlp_params(self.d_ff) if self.d_ff else 0)
            elif kind == "rglru":
                total += rglru_params() + mlp_params(self.d_ff)
            if self.is_moe and kind == "attn" \
                    and i >= self.first_dense_layers:
                m = self.moe
                total -= mlp_params(self.d_ff)
                n_e = m.top_k if active_only else m.num_experts
                total += 3 * d * m.d_ff_expert * n_e + d * m.routed_experts
                total += 3 * d * m.d_ff_expert * m.num_shared_experts
        total += d  # final norm
        return int(total)

    def ssm_conv(self) -> int:
        return self.ssm.conv_dim if self.ssm else 4

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch '{arch_id}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


_ARCH_MODULES = [
    "llama3_405b", "gemma_2b", "granite_3_8b", "h2o_danube_1_8b",
    "mamba2_370m", "recurrentgemma_9b", "chameleon_34b", "whisper_medium",
    "olmoe_1b_7b", "kimi_k2_1t_a32b",
]

_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(arch_id)
    kw = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.block_pattern else len(cfg.block_pattern)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        rglru_width=128 if cfg.rglru_width else 0,
        local_attn_window=64,
        sliding_window=64 if cfg.sliding_window else None,
        remat_policy="none",
        param_dtype="float32",
        dtype="float32",
    )
    if cfg.moe:
        # capacity 8.0: zero token drops at smoke scale, so decode ==
        # full forward exactly (capacity drops are exercised separately
        # in tests/test_moe.py::test_capacity_drops_tokens)
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_ff_expert=64,
            capacity_factor=8.0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk=32)
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = 2
    return cfg.replace(**kw)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Applicable assigned shapes for an arch (long_500k only if sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)
