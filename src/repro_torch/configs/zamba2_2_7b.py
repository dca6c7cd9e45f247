"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + ONE shared attention
block applied every 6 layers (parameter sharing per the Zamba2 design).
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="mamba_hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=80,
    ssm_heads=64,  # expand=2: d_inner = 5120
    attn_every=6,
    rope_theta=10_000.0,
    optimizer="adamw",
    microbatches=2,
)
