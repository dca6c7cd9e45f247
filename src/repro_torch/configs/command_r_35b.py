"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no biases.  [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    rope_theta=8_000_000.0,
    optimizer="adamw",
    microbatches=8,
)
