"""Model/shape configuration dataclasses shared by all architectures."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048  # near the measured optimum g* ~= 2600 that
                                # balances expert-weight streaming (amortized
                                # by big groups) against g^2-scaling dispatch
                                # one-hots — §Perf-4

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style shared attention block)
    attn_period: int = 0             # every k-th layer also runs the shared block

    # encdec
    enc_layers: int = 0              # 0 => decoder-only

    # vlm / audio stub frontends
    num_prefix_embeds: int = 0       # precomputed patch/frame embeddings
    prefix_lm: bool = False          # bidirectional attention over the prefix

    # numerics / execution
    dtype: str = "bfloat16"
    attn_chunk: int = 1024           # blockwise-attention KV chunk
    remat: bool = True
    scan_layers: bool = True

    # sharding profile
    shard_attn_heads: bool = True    # heads -> model axis (replicate if False)
    shard_ffn: bool = True
    shard_vocab: bool = True
    shard_experts: bool = True
    tp_divisor: int = 16             # model-axis extent the weights are laid
                                     # out for (1 = exact published config)

    # ---- TP-adaptation (DESIGN.md §6): input arrays must shard evenly, so
    # heads/experts/vocab are padded (and KV heads replicated) at init when
    # they don't divide the model axis.  MODEL_FLOPS in the roofline uses
    # the TRUE config; the HLO ratio exposes the padding overhead. ----
    @property
    def eff_num_kv_heads(self) -> int:
        K, tp = self.num_kv_heads, self.tp_divisor
        if not self.shard_attn_heads or tp <= 1 or K == 0 or K % tp == 0:
            return K
        import math
        r = tp // math.gcd(K, tp)
        return K * r

    @property
    def eff_num_heads(self) -> int:
        H, Ke = self.num_heads, self.eff_num_kv_heads
        if H == 0 or Ke == 0:
            return H
        G = -(-H // Ke)
        return Ke * G

    @property
    def eff_num_experts(self) -> int:
        E, tp = self.num_experts, self.tp_divisor
        if not self.shard_experts or tp <= 1 or E == 0 or E % tp == 0:
            return E
        return -(-E // tp) * tp

    @property
    def vocab_padded(self) -> int:
        V, tp = self.vocab_size, self.tp_divisor
        if not self.shard_vocab or tp <= 1 or V % tp == 0:
            return V
        return -(-V // tp) * tp

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for roofline's
        MODEL_FLOPS = 6*N*D."""
        d, V = self.d_model, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm"):
            att = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim + self.num_heads * self.head_dim * d
            per_layer += att
            if self.family == "moe":
                per_layer += 3 * d * self.expert_d_ff * (self.num_experts + self.num_shared_experts)
                per_layer += d * self.num_experts  # router
            else:
                per_layer += 3 * d * self.d_ff
        elif self.family == "ssm":
            per_layer += self._mamba_params()
        elif self.family == "hybrid":
            per_layer += self._mamba_params()
        elif self.family == "encdec":
            att = 4 * d * self.num_heads * self.head_dim
            per_layer += att + 3 * d * self.d_ff          # decoder self
            per_layer += att                               # cross attn approx
        total = emb + per_layer * self.num_layers
        if self.family == "hybrid" and self.attn_period:
            att = 4 * self.d_model * self.num_heads * self.head_dim
            total += att + 3 * self.d_model * self.d_ff    # one shared block
        if self.family == "encdec":
            enc = (4 * d * self.num_heads * self.head_dim + 3 * d * self.d_ff)
            total += enc * self.enc_layers
        return total

    def _mamba_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H = self.ssm_heads
        in_proj = d * (2 * di + 2 * N + H)
        out_proj = di * d
        conv = (di + 2 * N) * self.conv_width
        return in_proj + out_proj + conv + 3 * H

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE uses top_k + shared experts."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        att = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim + self.num_heads * self.head_dim * d
        per_layer = att + 3 * d * self.expert_d_ff * (self.top_k + self.num_shared_experts) + d * self.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + per_layer * self.num_layers


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose attention is quadratic-only: long_500k is skipped (DESIGN.md §5)
FULL_ATTENTION_FAMILIES = ("dense", "moe", "vlm", "encdec")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family in FULL_ATTENTION_FAMILIES:
        return False, "long_500k needs sub-quadratic attention; pure full-attention arch"
    return True, ""


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect registration
    from . import ALL_ARCHS  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_chunk=64,
        ssm_chunk=32,
        scan_layers=cfg.scan_layers,
        tp_divisor=1,
    )
    if cfg.family == "moe":
        kw.update(num_experts=4, top_k=2, num_shared_experts=min(cfg.num_shared_experts, 1), expert_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16, d_model=64)
    if cfg.family == "hybrid":
        kw.update(attn_period=2)
    if cfg.family == "encdec":
        kw.update(enc_layers=2)
    if cfg.family == "vlm":
        kw.update(num_prefix_embeds=8)
    return replace(cfg, name=cfg.name + "-smoke", **kw)
