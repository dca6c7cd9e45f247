"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  The EnCodec frontend is
a STUB: input_specs() provides precomputed frame embeddings
(embed_inputs=False).  [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    embed_inputs=False,
    rope_theta=10_000.0,
    optimizer="adamw",
    microbatches=2,
)
