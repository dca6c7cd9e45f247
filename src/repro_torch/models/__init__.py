"""LM stack of the port: every decoder family of the JAX package (dense,
MoE, RWKV6, the Mamba2 hybrid, cross-attention layers, embedding inputs).

Plain PyTorch around two hand-written kernels: GQA attention
(``kernels.flash_attention``) in every attention layer's prefill, causal
or, in cross-attention, not, and the RWKV6 recurrence (``kernels.wkv6``)
in every RWKV6 layer.  Weights are ``lm.Params`` modules read by name as
the JAX package reads its pytrees.
"""
