"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attention image layers every 5th layer.
The vision frontend is a STUB: input_specs() provides precomputed
patch embeddings (assignment note).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="dense",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    n_img_tokens=1600,
    rope_theta=500_000.0,
    optimizer="adamw",
    microbatches=8,
)
