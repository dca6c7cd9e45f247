"""TensorFrame on PyTorch and CUDA: the port of the JAX package ``repro``.

The modules mirror the JAX package's paths (``repro_torch/core/join.py``
ports ``repro/core/join.py``).  Entry points run on the CUDA device
unless the caller asks for the CPU (``device="cpu"``); the group-by sum
and the substring predicates run through hand-written CUDA kernels
(``repro_torch.kernels``).
"""
