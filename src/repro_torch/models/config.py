"""Model configuration for the assigned architecture pool: a copy of the
JAX package's ``models/config.py``, which imports no JAX, kept here so
the port imports nothing of that package."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeek/Kimi style
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'rwkv6' | 'mamba_hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention flavor flags
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # MoE
    moe: Optional[MoEConfig] = None
    # VLM: a cross-attention layer every `cross_attn_every` layers
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    # audio backbone: inputs are precomputed frame embeddings (stub frontend)
    embed_inputs: bool = True
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_heads: int = 0  # 0 -> n_heads; Zamba2 uses expand=2 (d_inner = 2*d_model)
    attn_every: int = 0  # hybrid: shared attention block period (Zamba2)
    # numerics / memory
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "nothing"  # 'nothing' | 'dots' | 'none'
    kv_shard: str = "model"  # 'model' | 'replicated' (GQA kv_heads < |model|)
    q_chunk: int = 2048  # query chunking for long-sequence XLA attention
    # training
    optimizer: str = "adamw"  # 'adamw' | 'adafactor'
    grad_dtype: str = "float32"  # bf16 accumulation for the 1T config
    microbatches: int = 8

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv6"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("rwkv6", "mamba_hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.hd
        n = V * D * 2  # embed + head
        if self.family == "rwkv6":
            per = D * (self.n_heads * hd) * 4 + self.n_heads * hd * D  # r,k,v,g,out
            per += 2 * (64 * D)  # decay lora
            per += D * F + F * D + D * D  # channel mix (k, v, r)
            return n + L * per
        if self.family == "mamba_hybrid":
            Hs = self.ssm_heads or self.n_heads
            d_in = Hs * self.ssm_head_dim
            # mamba mixer only per block (no per-block MLP in Zamba2)
            per = D * (2 * d_in + 2 * self.ssm_state + Hs) + d_in * D
            blocks = n + L * per
            # one shared attention+MLP block (parameters reused)
            shared = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
            shared += 3 * D * F
            return blocks + shared
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
        if self.moe:
            ffn = self.moe.n_experts * 3 * D * F + D * self.moe.n_experts
            ffn += self.moe.n_shared * 3 * D * F
        else:
            ffn = 3 * D * F
        per = attn + ffn
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            per_cross = attn  # cross-attn layers replace self-attn FLOPs-wise
            return n + L * per + n_cross * per_cross
        return n + L * per

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts)."""
        if not self.moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        hd = self.hd
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
        ffn = (self.moe.top_k + self.moe.n_shared) * 3 * D * F + D * self.moe.n_experts
        return self.vocab * D * 2 + L * (attn + ffn)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=max(2, (cfg.attn_every or 0) and cfg.attn_every),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        n_img_tokens=8 if cfg.cross_attn_every else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_heads=8 if cfg.ssm_heads else 0,
        attn_every=2 if cfg.attn_every else 0,
        moe=MoEConfig(4, 2, cfg.moe.n_shared and 1, cfg.moe.capacity_factor) if cfg.moe else None,
        param_dtype="float32",
        compute_dtype="float32",
        microbatches=1,
        q_chunk=64,
    )
    if cfg.attn_every:
        small["n_layers"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
