"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    head_dim=128,
    rope_theta=1_000_000.0,
    optimizer="adamw",
    microbatches=4,
)
