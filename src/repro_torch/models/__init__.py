"""LM stack of the port: the dense and RWKV6 decoder families.

Plain PyTorch around two hand-written kernels: causal GQA attention
(``kernels.flash_attention``) in every dense layer's prefill, and the
RWKV6 recurrence (``kernels.wkv6``) in every RWKV6 layer.  Weights are
``lm.Params`` modules read by name as the JAX package reads its pytrees.
"""
