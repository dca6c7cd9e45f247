"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — RWKV6 "Finch", data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # RWKV6 head_size = 64
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    optimizer="adamw",
    microbatches=8,
)
