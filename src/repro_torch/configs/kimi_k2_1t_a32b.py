"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per expert) vocab=163840, MoE 384 experts top-8 + 1 shared
(fine-grained, DeepSeek-V3-style).  [arXiv:2501.kimi2; unverified]

1T total / ~32B active params; the optimizer defaults to Adafactor, as
in the JAX package's copy of this config.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1),
    rope_theta=50_000.0,
    optimizer="adafactor",
    grad_dtype="bfloat16",
    microbatches=8,
)
